// Fused generalized-FAVOR+ attention layer, backward (kernel C'), for Hopper
// (sm_90a).
//
// Replaces rosettafold_tpu/ops/pallas/fused_performer.py `_backward` (the
// pl.pallas_call at :601, kernel `_bwd_kernel` :185), which every entry of
// that file reaches: `_bwd_rule` (:584), `_bwd_rule_axis1` (:547) and, after
// LN(x) is recomputed and its cotangent routed outside, `_bwd_rule_lnres`
// (:484) and its axis-1 form. Given the layer's input y (the LN output in LN
// mode) and the cotangent gy of att . Wo + bo, per row-problem and head:
//
//   q, k, v, phi_q, phi_k, ctx = phi_k^T [v | 1] recomputed as the forward
//   go = gy . Wo^T (float32);  r = 1 / max(num[:, dh], 1e-12),  o = num[:, :dh] r
//   gnum = go r,  gden = -sum(go o) r,  gnum_ext = [gnum | gden]
//   g_phi_q = gnum_ext . ctx^T          (the gden column picks up ksum)
//   g_ctx_ext = phi_q^T gnum_ext        (its last column is g_ksum)
//   g_phi_k = [v | 1] . g_ctx_ext^T     (zero past the valid L)
//   gq = ((g_phi_q * [s_q > 0]) . P) s,  gk likewise,  gv = phi_k . g_ctx
//   dy = gq Wq^T + gk Wk^T + gv Wv^T
//   dWq = y^T gq, dWk = y^T gk, dWv = y^T gv, dWo = att^T gy, dbo = sum gy
//
// with `_bwd_kernel`'s rounding points (:207-292): q, k, v, phi, ctx, gnum_ext,
// g_ctx_ext, the masked g_phi, gq, gk, gv and att rounded to the compute dtype,
// every product accumulated in float32, go and the weight gradients float32.
//
// What bounds it on this card: operations (about twice the forward's: the
// feature maps are recomputed and each forward product has two transposes);
// the scratch between the launches (q/k/v, go, att, [gq | gk | gv]: 1.7 GB
// written and read at B=4, L=128) sets a floor above that. One head's ctx and
// g_ctx are 320 x 65 float32 each, so as in the forward the layer runs as
// five launches:
//   1. proj:  q/k/v = y . W{q,k,v} (rows read in place through strides) and
//             go = gy . Wo^T into scratch (two kernels in bfloat16);
//   2. favor: per (problem, head) the positions are streamed four times
//             (phi_k -> ctx; phi_q -> att, gnum_ext and gq; phi_q -> g_ctx;
//             phi_k -> gk, gv); the (L, 320) maps never reach device memory;
//   3. dx:    [gq | gk | gv] . [Wq | Wk | Wv]^T, written in place;
//   4. wgrad: the four weight gradients as split-K products over the rows,
//             one float32 partial a split;
//   5. reduce: the partials summed in a fixed order. TPU grids accumulate
//             the weight gradients sequentially; blocks here run in parallel,
//             so the sum is a second pass, deterministic and without atomics.
// bfloat16: TMA + wgmma in every launch: 1 and 3 are csrc/performer_wg.cuh's
// row products (also kernel C's), 2 is favor_bwd_wgmma_kernel (five
// warpgroups, one 64-feature slice each), 4 is wgrad_wgmma_kernel (tiles of
// 128 x 288, both operands MN-major). float32: the CUDA-core kernels
// (mma.sync tiles of common.cuh), one block per (problem, head) in launch 2
// with ctx and g_ctx in float32 shared memory.

#include "common.cuh"
#include "hopper.cuh"
#include "performer_wg.cuh"

using namespace rf;

namespace {

constexpr int D = 288;     // pair width
constexpr int DH = 64;     // dim_head
constexpr int HEADS = 8;
constexpr int HD = HEADS * DH;  // 512
constexpr int MF = 320;    // random features
constexpr int EP = 72;     // dh + 1 (the ones column) padded to 8
constexpr int NTHREADS = 256;

// float32 on the CUDA cores (proj_kernel, favor_kernel, dx_kernel,
// wgrad_kernel); bfloat16 runs the wgmma launches below
template <typename T>
struct GemmCfg {
  static constexpr int BM = 32;
  static constexpr int WR = BM / 16, WC = 8 / WR;
};

// ------------------------------------------------------------ 1. projection
constexpr int NC1 = 64;  // output columns per chunk
constexpr int LD1 = D + 8;

template <typename T>
constexpr size_t proj_smem() {
  return sizeof(T) * (GemmCfg<T>::BM + NC1) * LD1;
}

// qkv[row] = [y Wq s | y Wk s | y Wv] (compute dtype), go[row] = gy Wo^T
// (float32). wq, wk, wv (512, 288) nn.Linear layout; wo (512, 288) as the JAX
// function takes it.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
proj_kernel(const T* __restrict__ y, const T* __restrict__ gy, Rows rows_,
            const T* __restrict__ wq, const T* __restrict__ wk, const T* __restrict__ wv,
            const T* __restrict__ wo, float scale, T* __restrict__ qkv, float* __restrict__ go,
            long long M) {
  using G = GemmCfg<T>;
  constexpr int NT = NC1 / (8 * G::WC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ys = reinterpret_cast<T*>(smem_raw);  // [BM][LD1]
  T* Ws = Ys + G::BM * LD1;                 // [NC1][LD1]
  const long long r0 = (long long)blockIdx.x * G::BM;
  const int rows = (int)min((long long)G::BM, M - r0);
  const int warp = threadIdx.x >> 5, rg = warp % G::WR, cg = warp / G::WR;
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? y : gy;
    __syncthreads();
    ln_rows<T, D>(Ys, LD1, [=](int r) { return src + rows_.offset(r0 + r); }, G::BM, rows,
                  nullptr, nullptr, 0.f);
    for (int c0 = 0; c0 < (pass == 0 ? 3 * HD : HD); c0 += NC1) {
      const T* w = pass == 1 ? wo : (c0 < HD ? wq : (c0 < 2 * HD ? wk : wv));
      __syncthreads();
      stage<T>(Ws, LD1, w + (long long)(c0 % HD) * D, D, NC1, NC1, D);
      __syncthreads();
      float acc[NT][4];
      zero(acc);
      warp_gemm<NT>(acc, Ys + rg * 16 * LD1, LD1, Ws + cg * NT * 8 * LD1, LD1, D);
      const float s = pass == 0 && c0 < 2 * HD ? scale : 1.f;
      for_each(acc, [&](int r, int c, float v) {
        const int gr = rg * 16 + r, col = c0 + cg * NT * 8 + c;
        if (gr >= rows) return;
        if (pass == 0)
          qkv[(r0 + gr) * (3 * HD) + col] = from_f<T>(v * s);
        else
          go[(r0 + gr) * HD + col] = v;
      });
    }
  }
}

// ----------------------------------------------------------------- 2. FAVOR+
template <typename T>
struct FavorCfg {
  static constexpr int V = 16 / sizeof(T);              // elements per 16 bytes
  static constexpr int LC = 16;  // positions per chunk
  static constexpr int EK = EP;  // contraction over [dh | 1]
  static constexpr int LDD = DH + V, LDL = LC + V, LDM = MF + V;
  static constexpr int LDE = EK;
  static constexpr int LDNUM = EP + 4;
  static constexpr size_t ACC = sizeof(float) * MF * EP;  // ctx, then g_ctx
  static constexpr size_t CTXR = sizeof(T) * MF * LDE;    // their rounded copy
  // pass 1: Ks [LC][LDD], Vt [EP][LDL], PhiKt [MF][LDL]
  static constexpr size_t P1 = sizeof(T) * (LC * LDD + EP * LDL + MF * LDL);
  // pass 2: Qs [LC][LDD], PhiQ [LC][LDM], Gnum [LC][LDE], NumS float [LC][LDNUM],
  // Mask [LC][MF] bytes
  static constexpr size_t P2 = sizeof(T) * (LC * LDD + LC * LDM + LC * LDE) +
                               sizeof(float) * LC * LDNUM + LC * MF;
  // pass 3: Ks [LC][LDD], Vext [LC][LDE], PhiK [LC][LDM], Mask [LC][MF]
  static constexpr size_t P3 = sizeof(T) * (LC * LDD + LC * LDE + LC * LDM) + LC * MF;
  static constexpr size_t CHUNK = P1 > P2 ? (P1 > P3 ? P1 : P3) : (P2 > P3 ? P2 : P3);
  static constexpr size_t SMEM = ACC + CTXR + CHUNK;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
favor_kernel(const T* __restrict__ qkv, const float* __restrict__ go, const T* __restrict__ proj,
             float scale, float kernel_eps, T* __restrict__ att, T* __restrict__ g3, int L) {
  using F = FavorCfg<T>;
  constexpr int LC = F::LC, EK = F::EK, LDD = F::LDD, LDL = F::LDL, LDM = F::LDM;
  constexpr int LDE = F::LDE, LDNUM = F::LDNUM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Acc = reinterpret_cast<float*>(smem_raw);     // [MF][EP]
  T* CtxR = reinterpret_cast<T*>(smem_raw + F::ACC);  // [MF][LDE]
  unsigned char* chunk = smem_raw + F::ACC + F::CTXR;
  T* Ks = reinterpret_cast<T*>(chunk);  // passes 1 and 3 (Qs in pass 2)
  T* Vt = Ks + LC * LDD;                // pass 1
  T* PhiKt = Vt + EP * LDL;
  T* PhiQ = Ks + LC * LDD;              // pass 2 (then g_phi_q masked)
  T* Gnum = PhiQ + LC * LDM;
  float* NumS = reinterpret_cast<float*>(Gnum + LC * LDE);
  unsigned char* Mask2 = reinterpret_cast<unsigned char*>(NumS + LC * LDNUM);
  T* Vext = Ks + LC * LDD;              // pass 3
  T* PhiK = Vext + LC * LDE;            // (then g_phi_k masked)
  unsigned char* Mask3 = reinterpret_cast<unsigned char*>(PhiK + LC * LDM);

  const int h = blockIdx.x;
  const long long p = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int NW = NTHREADS / 32;
  const T* base = qkv + p * L * (3 * HD);
  const T* qb = base + h * DH;
  const T* kb = base + HD + h * DH;
  const T* vb = base + 2 * HD + h * DH;

  // phi = relu(rows . P^T) + eps for LC rows (rows >= nl: 0 when zero_pad),
  // into Phi[l][m] (or transposed, PhiT[m][l]); mask[l][m] = (s > 0)
  auto feature_map = [&](const T* X, int nl, T* Phi, bool transposed, bool zero_pad,
                         unsigned char* mask) {
    for (int it = warp; it < (LC / 16) * (MF / 64); it += NW) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[8][4];
      zero(acc);
      warp_gemm<8>(acc, X + rg * 16 * LDD, LDD, proj + cb * 64 * DH, DH, DH);
      for_each(acc, [&](int r, int c, float s) {
        const int l = rg * 16 + r, m = cb * 64 + c;
        const float phi = zero_pad && l >= nl ? 0.f : fmaxf(s, 0.f) + kernel_eps;
        if (transposed)
          Phi[m * LDL + l] = from_f<T>(phi);
        else
          Phi[l * LDM + m] = from_f<T>(phi);
        if (mask) mask[l * MF + m] = s > 0.f;
      });
    }
  };
  // CtxR = Acc rounded (zero columns past EP), then Acc = 0
  auto round_acc = [&]() {
    __syncthreads();
    for (int e = tid; e < MF * EK; e += NTHREADS) {
      const int m = e / EK, c = e % EK;
      CtxR[m * LDE + c] = from_f<T>(c < EP ? Acc[m * EP + c] : 0.f);
    }
    __syncthreads();
    for (int e = tid; e < MF * EP; e += NTHREADS) Acc[e] = 0.f;
  };
  // out[(p * L + l0 + l) * ld + col0 + d] = from A (LC x MF) . B (MF x DH),
  // B element (d, m) at B[m * b_k + d], times `mul`, rows l < nl
  auto features_to_head = [&](const T* A, const T* B, int b_k, float mul, T* out, int ld,
                              int col0, int l0, int nl) {
    for (int it = warp; it < (LC / 16) * 2; it += NW) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[4][4];
      zero(acc);
      warp_gemm_any<4>(acc, A + rg * 16 * LDM, LDM, 1, B + cb * 32, 1, b_k, MF);
      for_each(acc, [&](int r, int c, float v) {
        const int l = rg * 16 + r;
        if (l < nl) out[(p * L + l0 + l) * ld + col0 + cb * 32 + c] = from_f<T>(v * mul);
      });
    }
  };

  for (int e = tid; e < MF * EP; e += NTHREADS) Acc[e] = 0.f;

  // pass 1: ctx = sum over positions of phi_k^T [v | 1]
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<T>(Ks, LDD, kb + (long long)l0 * 3 * HD, 3 * HD, LC, nl, DH);
    for (int e = tid; e < EP * LC; e += NTHREADS) {
      const int l = e % LC, c = e / LC;
      float val = 0.f;
      if (l < nl) val = c < DH ? to_f(vb[(long long)(l0 + l) * 3 * HD + c]) : (c == DH ? 1.f : 0.f);
      Vt[c * LDL + l] = from_f<T>(val);
    }
    __syncthreads();
    feature_map(Ks, nl, PhiKt, true, true, nullptr);
    __syncthreads();
    for (int rg = warp; rg < MF / 16; rg += NW) {
      float acc[EP / 8][4];
      zero(acc);
      warp_gemm<EP / 8>(acc, PhiKt + rg * 16 * LDL, LDL, Vt, LDL, LC);
      for_each(acc, [&](int r, int c, float v) { Acc[(rg * 16 + r) * EP + c] += v; });
    }
  }
  round_acc();  // CtxR = ctx in the compute dtype; Acc accumulates g_ctx next

  // pass 2: att, gq and g_ctx_ext = phi_q^T gnum_ext
  T* Qs = Ks;
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<T>(Qs, LDD, qb + (long long)l0 * 3 * HD, 3 * HD, LC, nl, DH);
    __syncthreads();
    feature_map(Qs, nl, PhiQ, false, false, Mask2);
    __syncthreads();
    // num = phi_q . ctx (LC x EP): ctx element (c, m) at CtxR[m * LDE + c]
    for (int it = warp; it < (LC / 16) * 3; it += NW) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[3][4];
      zero(acc);
      warp_gemm_any<3>(acc, PhiQ + rg * 16 * LDM, LDM, 1, CtxR + cb * 24, 1, LDE, MF);
      for_each(acc, [&](int r, int c, float v) {
        NumS[(rg * 16 + r) * LDNUM + cb * 24 + c] = v;
      });
    }
    __syncthreads();
    for (int l = warp; l < LC; l += NW) {  // one warp per position
      const float r = 1.f / fmaxf(NumS[l * LDNUM + DH], 1e-12f);
      const long long row = p * L + l0 + l;
      float gn[2], s = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = lane + 32 * t;
        const float o = NumS[l * LDNUM + d] * r;
        const float g = l < nl ? go[row * HD + h * DH + d] : 0.f;
        gn[t] = g * r;
        s += g * o;
        if (l < nl) att[row * HD + h * DH + d] = from_f<T>(o);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
      for (int t = 0; t < 2; ++t) Gnum[l * LDE + lane + 32 * t] = from_f<T>(gn[t]);
      for (int c = DH + lane; c < EK; c += 32) Gnum[l * LDE + c] = from_f<T>(c == DH ? -s * r : 0.f);
    }
    __syncthreads();
    // g_ctx_ext (MF x EP) += phi_q^T gnum_ext
    for (int rg = warp; rg < MF / 16; rg += NW) {
      float acc[EP / 8][4];
      zero(acc);
      warp_gemm_any<EP / 8>(acc, PhiQ + rg * 16, 1, LDM, Gnum, 1, LDE, LC);
      for_each(acc, [&](int r, int c, float v) { Acc[(rg * 16 + r) * EP + c] += v; });
    }
    __syncthreads();
    // g_phi_q = gnum_ext . ctx^T, masked by s_q > 0 and rounded, over PhiQ
    for (int it = warp; it < (LC / 16) * (MF / 64); it += NW) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[8][4];
      zero(acc);
      warp_gemm<8>(acc, Gnum + rg * 16 * LDE, LDE, CtxR + cb * 64 * LDE, LDE, EK);
      for_each(acc, [&](int r, int c, float v) {
        const int l = rg * 16 + r, m = cb * 64 + c;
        PhiQ[l * LDM + m] = from_f<T>(Mask2[l * MF + m] ? v : 0.f);
      });
    }
    __syncthreads();
    features_to_head(PhiQ, proj, DH, scale, g3, 3 * HD, h * DH, l0, nl);  // gq
  }
  round_acc();  // CtxR = g_ctx_ext in the compute dtype

  // pass 3: gv = phi_k . g_ctx, gk from g_phi_k = [v | 1] . g_ctx_ext^T
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<T>(Ks, LDD, kb + (long long)l0 * 3 * HD, 3 * HD, LC, nl, DH);
    for (int e = tid; e < LC * EK; e += NTHREADS) {
      const int l = e / EK, c = e % EK;
      float val = 0.f;
      if (l < nl) val = c < DH ? to_f(vb[(long long)(l0 + l) * 3 * HD + c]) : (c == DH ? 1.f : 0.f);
      Vext[l * LDE + c] = from_f<T>(val);
    }
    __syncthreads();
    feature_map(Ks, nl, PhiK, false, true, Mask3);
    __syncthreads();
    features_to_head(PhiK, CtxR, LDE, 1.f, g3, 3 * HD, 2 * HD + h * DH, l0, nl);  // gv
    __syncthreads();
    for (int it = warp; it < (LC / 16) * (MF / 64); it += NW) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[8][4];
      zero(acc);
      warp_gemm<8>(acc, Vext + rg * 16 * LDE, LDE, CtxR + cb * 64 * LDE, LDE, EK);
      for_each(acc, [&](int r, int c, float v) {
        const int l = rg * 16 + r, m = cb * 64 + c;
        PhiK[l * LDM + m] = from_f<T>(l < nl && Mask3[l * MF + m] ? v : 0.f);
      });
    }
    __syncthreads();
    features_to_head(PhiK, proj, DH, scale, g3, 3 * HD, HD + h * DH, l0, nl);  // gk
  }
}

// ---------------------------------------------- 2. FAVOR+, bfloat16 on wgmma
// A persistent grid (one block an SM) walks the (problem, head) items; the
// block's five warpgroups each own 64 of the 320 features (slice s = the
// warpgroup). P (320 x 64) is loaded by TMA once a block and stays. Every
// phase streams the item's positions in chunks of 64 through one TMA ring
// (K and V, or Q) that runs on into the block's next item:
//  1. ctx_s = phi_k,s^T [v | 1]: phi_k^T (P_s . K^T) -> relu + eps, zero past
//     L, rounded to bf16 straight into the A fragments of ctx_s += phi_k^T .
//     V (V an MN-major B tile); ctx_s and its ones column (den) rounded to
//     bf16 into shared memory ([dh][feature] tiles);
//  2. per chunk: phi_q,s (Q . P_s^T) and num_s = phi_q,s . ctx_s with its den
//     column; the five slices' partials are summed in a fixed order by the
//     rows' warps, which form att, gnum = go r and gden (rounded to bf16:
//     the A tile gnum_ext, and a copy in device memory for phase 2b); then
//     g_phi_q,s = gnum_ext . ctx_s^T (+ gden den_s), masked by s_q > 0 and
//     rounded into A fragments of gq_s = g_phi_q,s . P_s, summed over the
//     slices as num was, times the scale, into the gq scratch;
//  2b. g_ctx_s = phi_q,s^T gnum_ext over all positions (phi_q^T = P_s . Q^T
//     again, gnum_ext read back chunk by chunk), its ones column g_ksum beside
//     it; rounded to bf16 over ctx's tiles;
//  3. per chunk: phi_k,s and gv_s = phi_k,s . g_ctx_s; g_phi_k,s = v . g_ctx_s^T
//     (+ g_ksum), masked by s_k > 0, into A fragments of gk_s = g_phi_k,s .
//     P_s; gv and gk summed over the slices in a fixed order into scratch.
// The sums over slices go through float32 tiles in shared memory, one a
// warpgroup, so a result does not depend on the order the warpgroups finish
// (two calls give equal bits). Every thread runs the ring's issue code in
// step and thread 0 alone issues. A 640-thread block gets 96 registers a
// thread: the products that feed a 32-register accumulator form their
// feature maps in m64n32 halves (phi_product); ptxas still spills a little
// and serialises some wgmmas (C7512). An item is a chain of small dependent
// products, barriers and row sums: its time is latency, not tensor work.
namespace favor_wg {

using namespace rf::hopper;

constexpr int NWG = MF / 64;  // warpgroups: one 64-feature slice each
constexpr int NT = NWG * 128;
constexpr int NWARP = NT / 32;
constexpr int LC = 64;          // positions a chunk
constexpr int TILE = 64 * 128;  // 64 rows of 64 bf16, 128-byte swizzle
constexpr int STAGES = 2;       // ring stages of two tiles: (K, V) or (Q, -)
constexpr int LDR = DH + 8;     // float row stride of the slices' partial tiles
// shared memory from a 1024-byte boundary
constexpr int P_OFF = 0;                              // NWG tiles [feature][dh]
constexpr int CT_OFF = P_OFF + NWG * TILE;            // NWG tiles [dh][feature]: ctx, then g_ctx
constexpr int RING_OFF = CT_OFF + NWG * TILE;         // STAGES x 2 tiles [pos][dh]
constexpr int GN_OFF = RING_OFF + STAGES * 2 * TILE;  // gnum_ext's tile [pos][dh]
constexpr int RED_OFF = GN_OFF + TILE;                // NWG float tiles [pos][LDR]
constexpr int DEN_OFF = RED_OFF + NWG * LC * LDR * 4;  // MF floats: den, then g_ksum
constexpr int DENP_OFF = DEN_OFF + MF * 4;            // NWG x LC floats: num's den partials
constexpr int GDEN_OFF = DENP_OFF + NWG * LC * 4;     // LC floats: the chunk's gden
constexpr int BAR_OFF = GDEN_OFF + LC * 4;            // p_full, full[STAGES], empty[STAGES]
constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
static_assert(SMEM <= 232448, "shared memory");

// a 64 x 64 accumulator d of this thread (warp wq of its warpgroup, lane
// 4g + t) as float2 pairs into tile `red` (row stride LDR)
__device__ __forceinline__ void store_partial(float* red, const float (&d)[32], int wq, int g,
                                              int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(red + (16 * wq + g + 8 * h) * LDR + 8 * n + 2 * t) =
          make_float2(d[4 * n + 2 * h], d[4 * n + 2 * h + 1]);
}

// a 64 x 64 accumulator (row f, column c) rounded to bf16 into a [column][row]
// tile (the 128-byte swizzle): element (f, c) at tile row c
__device__ __forceinline__ void store_transposed(unsigned char* tile, const float (&d)[32], int wq,
                                                 int g, int t) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int f = 16 * wq + g + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + 2 * t + (e & 1);
    *reinterpret_cast<bf16*>(tile + c * 128 + ((((f >> 3) ^ (c & 7)) << 4) | ((f & 7) << 1))) =
        __float2bfloat16(d[e]);
  }
}

// d (64 x 64) rounded to bf16 into A fragments, element e kept where bit e of
// `mask` is set (zero elsewhere), after adding add(row half, column)
template <typename Add>
__device__ __forceinline__ void masked_fragments(uint32_t (&a)[4][4], const float (&d)[32],
                                                 uint32_t mask, Add add) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 8 * ks + 2 * k;
      const float v0 = (mask >> e) & 1 ? d[e] + add(e) : 0.f;
      const float v1 = (mask >> (e + 1)) & 1 ? d[e + 1] + add(e + 1) : 0.f;
      a[ks][k] = pack_bf16(v0, v1);
    }
}

// bit e set where d[e] > 0
template <int N>
__device__ __forceinline__ uint32_t positive_mask(const float (&d)[N]) {
  uint32_t m = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) m |= (d[e] > 0.f ? 1u : 0u) << e;
  return m;
}

template <int N>
__device__ __forceinline__ void zeros(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) d[e] = 0.f;
}

__global__ void __launch_bounds__(NT, 1)
favor_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                       const __grid_constant__ CUtensorMap p_map, const float* __restrict__ go,
                       float scale, float kernel_eps, bf16* __restrict__ att,
                       bf16* __restrict__ g3, bf16* __restrict__ gn, float* __restrict__ gden,
                       int L, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + RED_OFF);
  float* den_s = reinterpret_cast<float*>(smem + DEN_OFF);
  float* denp = reinterpret_cast<float*>(smem + DENP_OFF);
  float* gden_s = reinterpret_cast<float*>(smem + GDEN_OFF);
  unsigned char* gn_tile = smem + GN_OFF;
  const uint32_t p_full = base + BAR_OFF, full = p_full + 8, empty = full + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t leader = threadIdx.x == 0;
  const uint32_t p_tile = base + P_OFF + wg * TILE, ct = base + CT_OFF + wg * TILE;
  const uint32_t gnt = base + GN_OFF;
  float* my_red = red + wg * LC * LDR;
  const float* my_den = den_s + 64 * wg;
  if (leader) {
    mbar_init(p_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, NWARP);
    }
    fence_mbar_init();
  }
  __syncthreads();
  mbar_arrive_expect_tx(p_full, NWG * TILE, leader);
  for (int s = 0; s < NWG; ++s)
    tma_load_2d(base + P_OFF + s * TILE, &p_map, p_full, 0, 64 * s, leader);

  const int nc = (L + LC - 1) / LC;
  // the ring's loads in the order the phases take them: (K, V) of every
  // chunk, Q twice, (K, V) again; then the next item
  int ld_item = blockIdx.x;
  int ld_step = 0, n_ld = 0;
  auto issue = [&](int released) {
    while (ld_item < items && n_ld < released + STAGES) {
      const int st = n_ld % STAGES;
      mbar_wait(empty + 8 * st, ((n_ld / STAGES) & 1) ^ 1);
      const int h = (int)(ld_item % HEADS);
      const int row = (int)(ld_item / HEADS * L) + (ld_step % nc) * LC;
      const int phase = ld_step / nc;
      const uint32_t kv = phase == 0 || phase == 3;
      const uint32_t dst = base + RING_OFF + st * 2 * TILE, bar = full + 8 * st;
      mbar_arrive_expect_tx(bar, (1 + kv) * TILE, leader);
      tma_load_2d(dst, &qkv_map, bar, (kv ? HD : 0) + h * DH, row, leader);
      tma_load_2d(dst + TILE, &qkv_map, bar, 2 * HD + h * DH, row, leader && kv);
      ++n_ld;
      if (++ld_step == 4 * nc) {
        ld_step = 0;
        ld_item += gridDim.x;
      }
    }
  };
  int used = 0;  // ring loads this thread has taken
  auto take = [&]() {
    const int st = used % STAGES;
    mbar_wait(full + 8 * st, (used / STAGES) & 1);
    return base + RING_OFF + st * 2 * TILE;
  };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (used % STAGES));
    issue(++used);
  };
  issue(0);
  mbar_wait(p_full, 0);

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int h = item % HEADS;
    const int row0 = item / HEADS * L;  // P * L < 2^31: the TMA coordinates are int32

    // the rows of the slices' partials summed in a fixed order, times `mul`,
    // into the scratch's columns col0 + h * DH
    auto rows_out = [&](int c, int col0, float mul) {
      __syncthreads();
      for (int r = warp; r < LC; r += NWARP) {
        const int l = c * LC + r;
        float2 v = make_float2(0.f, 0.f);
#pragma unroll
        for (int s = 0; s < NWG; ++s) {
          const float2 p = *reinterpret_cast<const float2*>(red + (s * LC + r) * LDR + 2 * lane);
          v.x += p.x;
          v.y += p.y;
        }
        if (l < L)
          *reinterpret_cast<uint32_t*>(g3 + (long long)(row0 + l) * (3 * HD) + col0 + h * DH +
                                       2 * lane) = pack_bf16(v.x * mul, v.y * mul);
      }
      __syncthreads();
    };

    // acc += phi . B over the slice's features: phi = relu(X . P_s^T) + eps for
    // the 64 positions of tile xt (q or k), B the slice's [dh][feature] tile
    // (ctx, then g_ctx), in two halves of 32 features (an m64n32 accumulator
    // for s: fewer live registers); mask gains s > 0 (bit e of the 64 x 64
    // layout), dq gains phi . den_s per row half
    auto phi_product = [&](uint32_t xt, float(&acc)[32], uint32_t& mask, float(&dq)[2]) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float d[16];
        zeros(d);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<32>::ss(d, desc_sw128(xt + ks * 32), desc_sw128(p_tile + hf * 4096 + ks * 32), 1);
        wgmma_commit();
        wgmma_wait<0>();
        mask |= positive_mask(d) << (16 * hf);
        uint32_t a[2][4];
        float unused[2] = {0.f, 0.f};
        favor_features<2>(a, d, kernel_eps, 32, t, unused);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[ks][kk]);
            const float* dn = my_den + 32 * hf + 16 * ks + 8 * (kk >> 1) + 2 * t;
            dq[kk & 1] += __low2float(v) * dn[0] + __high2float(v) * dn[1];
          }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          Wgmma<64>::rs<0>(acc, a[ks], desc_sw128(ct + (2 * hf + ks) * 32), 1);
        wgmma_commit();
        wgmma_wait<0>();
      }
    };

    // phase 1: ctx_s = phi_k,s^T [v | 1]; each chunk in two halves of 32
    // positions (phi_k^T in an m64n32 accumulator: fewer live registers)
    {
      float ctx[32], den[2] = {0.f, 0.f};
      zeros(ctx);
      for (int c = 0; c < nc; ++c) {
        const uint32_t kt = take(), vt = kt + TILE;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float d[16];
          zeros(d);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            Wgmma<32>::ss(d, desc_sw128(p_tile + ks * 32), desc_sw128(kt + hf * 4096 + ks * 32), 1);
          wgmma_commit();
          wgmma_wait<0>();
          uint32_t a[2][4];
          favor_features<2>(a, d, kernel_eps, L - c * LC - 32 * hf, t, den);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            Wgmma<64>::rs<1>(ctx, a[ks], desc_sw128_mn(vt + (2 * hf + ks) * 2048, TILE), 1);
          wgmma_commit();
          wgmma_wait<0>();
        }
        release();
      }
      store_transposed(smem + CT_OFF + wg * TILE, ctx, wq, g, t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = den[hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) den_s[64 * wg + 16 * wq + g + 8 * hh] = __bfloat162float(__float2bfloat16(v));
      }
      fence_proxy_async();
      __syncthreads();
    }

    // phase 2: att, gnum_ext (scratch), gq
    for (int c = 0; c < nc; ++c) {
      uint32_t mask = 0;
      {
        float num[32], dq[2] = {0.f, 0.f};
        zeros(num);
        phi_product(take(), num, mask, dq);
        release();
        store_partial(my_red, num, wq, g, t);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v = dq[hh];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) denp[LC * wg + 16 * wq + g + 8 * hh] = v;
        }
      }
      __syncthreads();
      // the rows: num summed over the slices, att, gnum_ext
      for (int r = warp; r < LC; r += NWARP) {
        const int l = c * LC + r;
        const bool valid = l < L;
        float2 nm = make_float2(0.f, 0.f);
        float dn = 0.f;
#pragma unroll
        for (int s = 0; s < NWG; ++s) {
          const float2 v = *reinterpret_cast<const float2*>(red + (s * LC + r) * LDR + 2 * lane);
          nm.x += v.x;
          nm.y += v.y;
          dn += denp[LC * s + r];
        }
        const float rr = 1.f / fmaxf(dn, 1e-12f);
        const float2 o = make_float2(nm.x * rr, nm.y * rr);
        const long long row = row0 + l;
        const float2 gv =
            valid ? *reinterpret_cast<const float2*>(go + row * HD + h * DH + 2 * lane)
                  : make_float2(0.f, 0.f);
        float sum = gv.x * o.x + gv.y * o.y;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const uint32_t gnum = valid ? pack_bf16(gv.x * rr, gv.y * rr) : 0u;
        const float gd = valid ? __bfloat162float(__float2bfloat16(-sum * rr)) : 0.f;
        *reinterpret_cast<uint32_t*>(gn_tile + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) +
                                     4 * (lane & 3)) = gnum;
        if (lane == 0) gden_s[r] = gd;
        if (valid) {
          *reinterpret_cast<uint32_t*>(att + row * HD + h * DH + 2 * lane) = pack_bf16(o.x, o.y);
          *reinterpret_cast<uint32_t*>(gn + row * HD + h * DH + 2 * lane) = gnum;
          if (lane == 0) gden[row * HEADS + h] = gd;
        }
      }
      fence_proxy_async();
      __syncthreads();
      {
        // g_phi_q,s = gnum_ext . ctx_s^T, masked, into gq_s = g_sq,s . P_s
        float gp[32];
        zeros(gp);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<64>::ss<1, 0>(gp, desc_sw128(gnt + ks * 32), desc_sw128_mn(ct + ks * 2048, TILE),
                              1);
        wgmma_commit();
        wgmma_wait<0>();
        uint32_t a[4][4];
        const float gd[2] = {gden_s[16 * wq + g], gden_s[16 * wq + g + 8]};
        masked_fragments(a, gp, mask, [&](int e) {
          return gd[(e >> 1) & 1] * my_den[8 * (e >> 2) + 2 * t + (e & 1)];
        });
        float gq[32];
        zeros(gq);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<64>::rs<1>(gq, a[ks], desc_sw128_mn(p_tile + ks * 2048, TILE), 1);
        wgmma_commit();
        wgmma_wait<0>();
        store_partial(my_red, gq, wq, g, t);
      }
      rows_out(c, 0, scale);
    }

    // phase 2b: g_ctx_s = phi_q,s^T gnum_ext, g_ksum_s beside it
    {
      float gctx[32], gks[2] = {0.f, 0.f};
      zeros(gctx);
      for (int c = 0; c < nc; ++c) {
        // gnum_ext of the chunk back from the scratch (zeros past L)
        for (int e = threadIdx.x; e < LC * 8; e += NT) {
          const int r = e >> 3, ch = e & 7, l = c * LC + r;
          const bool ok = l < L;
          const bf16* src = ok ? gn + (long long)(row0 + l) * HD + h * DH + 8 * ch : gn;
          cp_async_16z(gn_tile + r * 128 + ((ch ^ (r & 7)) << 4), src, ok);
        }
        if (threadIdx.x < LC) {
          const int l = c * LC + threadIdx.x;
          gden_s[threadIdx.x] = l < L ? gden[(long long)(row0 + l) * HEADS + h] : 0.f;
        }
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();
        const uint32_t qt = take();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // positions 32 hf .. 32 hf + 31
          float d[16];
          zeros(d);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            Wgmma<32>::ss(d, desc_sw128(p_tile + ks * 32), desc_sw128(qt + hf * 4096 + ks * 32), 1);
          wgmma_commit();
          wgmma_wait<0>();
          uint32_t a[2][4];
          float unused[2] = {0.f, 0.f};
          favor_features<2>(a, d, kernel_eps, 32, t, unused);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[ks][kk]);
              const float* gdp = gden_s + 32 * hf + 16 * ks + 8 * (kk >> 1) + 2 * t;
              gks[kk & 1] += __low2float(v) * gdp[0] + __high2float(v) * gdp[1];
            }
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            Wgmma<64>::rs<1>(gctx, a[ks], desc_sw128_mn(gnt + (2 * hf + ks) * 2048, TILE), 1);
          wgmma_commit();
          wgmma_wait<0>();
        }
        release();
        __syncthreads();  // the gnum tile is read before the next chunk's copy
      }
      store_transposed(smem + CT_OFF + wg * TILE, gctx, wq, g, t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = gks[hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) den_s[64 * wg + 16 * wq + g + 8 * hh] = __bfloat162float(__float2bfloat16(v));
      }
      fence_proxy_async();
      __syncthreads();
    }

    // phase 3: gv = phi_k . g_ctx, gk from g_phi_k = [v | 1] . g_ctx_ext^T
    for (int c = 0; c < nc; ++c) {
      const uint32_t vt = take() + TILE;
      uint32_t mask = 0;
      {
        float gv[32], unused[2] = {0.f, 0.f};
        zeros(gv);
        phi_product(vt - TILE, gv, mask, unused);
        store_partial(my_red, gv, wq, g, t);
      }
      rows_out(c, 2 * HD, 1.f);
      {
        float gp[32];
        zeros(gp);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<64>::ss<1, 0>(gp, desc_sw128(vt + ks * 32), desc_sw128_mn(ct + ks * 2048, TILE), 1);
        wgmma_commit();
        wgmma_wait<0>();
        release();
        uint32_t a[4][4];
        masked_fragments(a, gp, mask,
                         [&](int e) { return my_den[8 * (e >> 2) + 2 * t + (e & 1)]; });
        float gk[32];
        zeros(gk);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<64>::rs<1>(gk, a[ks], desc_sw128_mn(p_tile + ks * 2048, TILE), 1);
        wgmma_commit();
        wgmma_wait<0>();
        store_partial(my_red, gk, wq, g, t);
      }
      rows_out(c, HD, scale);
    }
  }
}

cudaError_t launch(const bf16* qkv, const float* go, const bf16* proj, float scale,
                   float kernel_eps, bf16* att, bf16* g3, bf16* gn, float* gden, long long P, int L,
                   cudaStream_t st) {
  CUtensorMap qkv_map, p_map;
  const cuuint64_t qdims[2] = {3 * HD, (cuuint64_t)(P * L)}, qstrides[1] = {3 * HD * 2};
  const cuuint64_t pdims[2] = {DH, MF}, pstrides[1] = {DH * 2};
  const cuuint32_t box[2] = {64, 64};
  if (P * L > 0x7fffffffLL || gn == nullptr || gden == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = encode_bf16_sw128(&qkv_map, qkv, 2, qdims, qstrides, box);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_sw128(&p_map, proj, 2, pdims, pstrides, box)) != cudaSuccess) return err;
  if ((err = set_smem(favor_bwd_wgmma_kernel, SMEM)) != cudaSuccess) return err;
  const int items = (int)(P * HEADS);
  const unsigned grid = (unsigned)(items < sm_count() ? items : sm_count());
  favor_bwd_wgmma_kernel<<<grid, NT, SMEM, st>>>(qkv_map, p_map, go, scale, kernel_eps, att, g3,
                                                 gn, gden, L, items);
  return cudaGetLastError();
}

}  // namespace favor_wg

// ------------------------------------------------------------------- 3. dx
constexpr int KC3 = 64;
constexpr int LD3 = KC3 + 8;

template <typename T>
constexpr size_t dx_smem() {
  return sizeof(T) * (GemmCfg<T>::BM + D) * LD3;
}

// dx[row] = g3[row] . w3^T: g3 (M, 1536) = [gq | gk | gv], w3 (288, 1536) =
// [Wq | Wk | Wv] in the JAX layout; written through the row strides
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dx_kernel(const T* __restrict__ g3, const T* __restrict__ w3, T* __restrict__ dx, Rows rows_,
          long long M) {
  using G = GemmCfg<T>;
  constexpr int NT = D / (8 * G::WC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [BM][LD3]
  T* Ws = As + G::BM * LD3;                 // [D][LD3]
  const long long r0 = (long long)blockIdx.x * G::BM;
  const int rows = (int)min((long long)G::BM, M - r0);
  const int warp = threadIdx.x >> 5, rg = warp % G::WR, cg = warp / G::WR;
  float acc[NT][4];
  zero(acc);
  for (int k0 = 0; k0 < 3 * HD; k0 += KC3) {
    __syncthreads();
    stage<T>(As, LD3, g3 + r0 * 3 * HD + k0, 3 * HD, G::BM, rows, KC3);
    stage<T>(Ws, LD3, w3 + k0, 3 * HD, D, D, KC3);
    __syncthreads();
    warp_gemm<NT>(acc, As + rg * 16 * LD3, LD3, Ws + cg * NT * 8 * LD3, LD3, KC3);
  }
  for_each(acc, [&](int r, int c, float v) {
    const int gr = rg * 16 + r;
    if (gr < rows) dx[rows_.offset(r0 + gr) + cg * NT * 8 + c] = from_f<T>(v);
  });
}

// ---------------------------------------------------------------- 4. wgrad
// Product z < 3: dW{q,k,v}[d][j] = sum_rows y[row][d] g3[row][z * 512 + j]
// (288 x 512); z = 3: dWo_ext[j][d] = sum_rows att_ext[row][j] gy[row][d]
// (513 x 288) with att_ext[row][512] = 1, so its last row is dbo.
constexpr int WT = 64;   // output tile
constexpr int KR = 32;   // rows per chunk
constexpr int W_ELEMS = 3 * D * HD + (HD + 1) * D;  // one partial of all four
constexpr int TILES_QKV = ((D + WT - 1) / WT) * (HD / WT);           // 5 x 8 per z
constexpr int TILES_O = ((HD + 1 + WT - 1) / WT) * ((D + WT - 1) / WT);  // 9 x 5
constexpr int W_TILES = 3 * TILES_QKV + TILES_O;

template <typename T>
struct WgradCfg {
  static constexpr int LDK = KR + 16 / sizeof(T);
  static constexpr size_t SMEM = sizeof(T) * 2 * WT * LDK;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const T* __restrict__ y, const T* __restrict__ gy, Rows rows_,
             const T* __restrict__ g3, const T* __restrict__ att, float* __restrict__ part,
             long long M, long long rows_per_split) {
  constexpr int LDK = WgradCfg<T>::LDK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* At = reinterpret_cast<T*>(smem_raw);  // [WT][LDK]: output rows x chunk rows
  T* Bt = At + WT * LDK;                    // [WT][LDK]: output columns x chunk rows
  int t = blockIdx.x, z, m0, n0, nm, nn;
  if (t < 3 * TILES_QKV) {
    z = t / TILES_QKV;
    t %= TILES_QKV;
    m0 = t / (HD / WT) * WT;
    n0 = t % (HD / WT) * WT;
    nm = D;
    nn = HD;
  } else {
    z = 3;
    t -= 3 * TILES_QKV;
    m0 = t / ((D + WT - 1) / WT) * WT;
    n0 = t % ((D + WT - 1) / WT) * WT;
    nm = HD + 1;
    nn = D;
  }
  const long long k_lo = blockIdx.y * rows_per_split;
  const long long k_hi = min(M, k_lo + rows_per_split);
  const int warp = threadIdx.x >> 5, rg = warp & 3, cg = warp >> 2;
  float acc[4][4];
  zero(acc);
  for (long long k0 = k_lo; k0 < k_hi; k0 += KR) {
    __syncthreads();
    for (int e = threadIdx.x; e < KR * WT; e += NTHREADS) {
      const int r = e / WT, i = e % WT;
      const long long row = k0 + r;
      const int m = m0 + i, n = n0 + i;
      float a = 0.f, b = 0.f;
      if (row < k_hi) {
        if (z < 3) {
          if (m < nm) a = to_f(y[rows_.offset(row) + m]);
          if (n < nn) b = to_f(g3[row * 3 * HD + z * HD + n]);
        } else {
          if (m < HD) a = to_f(att[row * HD + m]);
          else if (m == HD) a = 1.f;
          if (n < nn) b = to_f(gy[rows_.offset(row) + n]);
        }
      }
      At[i * LDK + r] = from_f<T>(a);
      Bt[i * LDK + r] = from_f<T>(b);
    }
    __syncthreads();
    warp_gemm<4>(acc, At + rg * 16 * LDK, LDK, Bt + cg * 32 * LDK, LDK, KR);
  }
  float* out = part + blockIdx.y * (long long)W_ELEMS + (z < 3 ? (long long)z * D * HD : 3LL * D * HD);
  for_each(acc, [&](int r, int c, float v) {
    const int m = m0 + rg * 16 + r, n = n0 + cg * 32 + c;
    if (m < nm && n < nn) out[(long long)m * nn + n] = v;
  });
}

// ------------------------------------------- 4. wgrad, bfloat16 on wgmma
// The four weight gradients as 16 output tiles of 128 x 288, C[j][d] = sum
// over rows of G[row][j] . Y[row][d]: z < 3 takes G = g3's z-th 512 columns
// and Y = y (dW_z = C^T), z = 3 takes G = att and Y = gy (dWo = C; the tile
// of j 0-127 also sums gy's columns: dbo). A block owns one tile and one of
// `splits` ranges of row chunks and writes its float32 partial in the final
// layout; wgrad_reduce_kernel sums the partials in a fixed order. A row
// chunk is 64 positions of one problem: y and gy are read in place through
// the row strides by a 4-D TMA map, the scratch by a 3-D one, positions past
// L are zero-filled on both sides. Both operands are MN-major bf16 tiles (rows =
// K); each warpgroup holds 64 j x 288 d in an m64n256 and an m64n32
// accumulator; a 3-stage ring of 56 KB stages (G: 2 boxes, Y: 4.5 boxes)
// keeps one chunk's products in flight.
namespace wgrad_wg {

using namespace rf::hopper;

constexpr int NT = 256;
constexpr int BOX = 64 * 128;    // 64 rows x 64 columns, 128-byte swizzle
constexpr int A_BYTES = 2 * BOX;  // G: 64 rows x 128 j
constexpr int B_BYTES = 5 * BOX;  // Y: 64 rows x 288 d (TMA zero-fills the last half box)
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int STAGES = 3;
constexpr int TILES = 16;
constexpr int BAR_OFF = STAGES * STAGE;
constexpr size_t SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
static_assert(SMEM <= 232448, "shared memory");

struct Maps {
  CUtensorMap g3, att, y, gy;
};

template <bool DBO>
__device__ __forceinline__ void run(const Maps& maps, unsigned char* smem, float* __restrict__ out,
                                    int z, int j0, int L, int p_inner, long long q_lo,
                                    long long q_hi) {
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + BAR_OFF, empty = full + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t leader = threadIdx.x == 0;
  const int ncl = (L + 63) / 64;
  const CUtensorMap* gmap = z < 3 ? &maps.g3 : &maps.att;
  const CUtensorMap* ymap = z < 3 ? &maps.y : &maps.gy;
  const int gcol = (z < 3 ? z * HD : 0) + j0;

  long long q_ld = q_lo;
  int n_ld = 0;
  auto issue = [&](int released) {
    while (q_ld < q_hi && n_ld < released + STAGES) {
      const int s = n_ld % STAGES;
      mbar_wait(empty + 8 * s, ((n_ld / STAGES) & 1) ^ 1);
      const int p = (int)(q_ld / ncl), l0 = (int)(q_ld % ncl) * 64;
      const uint32_t dst = base + s * STAGE, bar = full + 8 * s;
      mbar_arrive_expect_tx(bar, STAGE, leader);
      tma_load_3d(dst, gmap, bar, gcol, l0, p, leader);
      tma_load_3d(dst + BOX, gmap, bar, gcol + 64, l0, p, leader);
#pragma unroll
      for (int bx = 0; bx < 5; ++bx)
        tma_load_4d(dst + A_BYTES + bx * BOX, ymap, bar, 64 * bx, l0, p % p_inner, p / p_inner,
                    leader);
      ++n_ld;
      ++q_ld;
    }
  };
  issue(0);

  float acc[128], acc2[16];  // columns d 0-255 and 256-287
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) acc2[e] = 0.f;
  float dbo[2] = {0.f, 0.f};  // columns threadIdx.x and 256 + threadIdx.x (< 288)
  const long long n = q_hi - q_lo;
  for (long long i = 0; i < n; ++i) {
    const int s = (int)(i % STAGES);
    mbar_wait(full + 8 * s, (int)(i / STAGES) & 1);
    const uint32_t a = base + s * STAGE + wg * BOX, b = base + s * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<256>::ss<1, 1>(acc, desc_sw128_mn(a + ks * 2048, BOX),
                           desc_sw128_mn(b + ks * 2048, BOX), 1);
      Wgmma<32>::ss<1, 1>(acc2, desc_sw128_mn(a + ks * 2048, BOX),
                          desc_sw128_mn(b + 4 * BOX + ks * 2048, BOX), 1);
    }
    wgmma_commit();
    if (DBO) {  // gy's column sums from the same tile (CUDA cores, beside the products)
      const unsigned char* bt = smem + s * STAGE + A_BYTES;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int d = threadIdx.x + 256 * k;
        if (d < PAIR_D) {
          const unsigned char* col = bt + (d >> 6) * BOX + ((d & 7) << 1);
          const int c8 = (d & 63) >> 3;
          float sum = 0.f;
          for (int r = 0; r < 64; ++r)
            sum += __bfloat162float(
                *reinterpret_cast<const bf16*>(col + r * 128 + ((c8 ^ (r & 7)) << 4)));
          dbo[k] += sum;
        }
      }
    }
    wgmma_wait<1>();  // the last chunk's products are done: release its stage
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
      issue((int)i);
    }
  }
  wgmma_wait<0>();
  if (DBO) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int d = threadIdx.x + 256 * k;
      if (d < PAIR_D) out[3LL * PAIR_D * HD + (long long)HD * PAIR_D + d] = dbo[k];
    }
  }
  // the tile's float32 partial in the final layout: dW_z[d][j] or dWo[j][d]
  auto put = [&](int j, int d, float v0, float v1) {
    if (z < 3) {
      float* o = out + (long long)z * PAIR_D * HD;
      o[(long long)d * HD + j] = v0;
      o[(long long)(d + 1) * HD + j] = v1;
    } else {
      *reinterpret_cast<float2*>(out + 3LL * PAIR_D * HD + (long long)j * PAIR_D + d) =
          make_float2(v0, v1);
    }
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + 64 * wg + 16 * wq + g + 8 * h;
#pragma unroll
    for (int i = 0; i < 32; ++i) put(j, 8 * i + 2 * t, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      put(j, 256 + 8 * i + 2 * t, acc2[4 * i + 2 * h], acc2[4 * i + 2 * h + 1]);
  }
}

__global__ void __launch_bounds__(NT, 1)
wgrad_wgmma_kernel(const __grid_constant__ Maps maps, float* __restrict__ part, int L,
                   int p_inner, long long chunks, long long per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(smem) + BAR_OFF, empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NT / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int z = blockIdx.x / 4, j0 = 128 * (blockIdx.x % 4);
  const long long q_lo = min(chunks, (long long)blockIdx.y * per_split);
  const long long q_hi = min(chunks, q_lo + per_split);
  float* out = part + (long long)blockIdx.y * W_ELEMS;
  if (z == 3 && j0 == 0)  // uniform: each branch's loop issues its wgmmas unconditionally
    run<true>(maps, smem, out, z, j0, L, p_inner, q_lo, q_hi);
  else
    run<false>(maps, smem, out, z, j0, L, p_inner, q_lo, q_hi);
}

// y, gy read through the row strides (elements); scratch g3 (P * L, 1536) and
// att (P * L, 512)
cudaError_t launch(const bf16* y, const bf16* gy, Rows rows_, long long P, const bf16* g3,
                   const bf16* att, float* part, int splits, cudaStream_t st) {
  Maps maps;
  const int L = rows_.L;
  const cuuint32_t box3[3] = {64, 64, 1}, box4[4] = {64, 64, 1, 1};
  const cuuint64_t gdims[3] = {3 * HD, (cuuint64_t)L, (cuuint64_t)P};
  const cuuint64_t gstr[2] = {3 * HD * 2, (cuuint64_t)L * 3 * HD * 2};
  const cuuint64_t adims[3] = {HD, (cuuint64_t)L, (cuuint64_t)P};
  const cuuint64_t astr[2] = {HD * 2, (cuuint64_t)L * HD * 2};
  const cuuint64_t ydims[4] = {PAIR_D, (cuuint64_t)L, (cuuint64_t)rows_.p_inner,
                               (cuuint64_t)(P / rows_.p_inner)};
  const cuuint64_t ystr[3] = {(cuuint64_t)rows_.s_pos * 2, (cuuint64_t)rows_.s_lo * 2,
                              (cuuint64_t)rows_.s_hi * 2};
  if (P % rows_.p_inner) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = encode_bf16_sw128(&maps.g3, g3, 3, gdims, gstr, box3)) != cudaSuccess) return err;
  if ((err = encode_bf16_sw128(&maps.att, att, 3, adims, astr, box3)) != cudaSuccess) return err;
  if ((err = encode_bf16_sw128(&maps.y, y, 4, ydims, ystr, box4)) != cudaSuccess) return err;
  if ((err = encode_bf16_sw128(&maps.gy, gy, 4, ydims, ystr, box4)) != cudaSuccess) return err;
  if ((err = set_smem(wgrad_wgmma_kernel, SMEM)) != cudaSuccess) return err;
  const long long chunks = P * ((L + 63) / 64);
  const long long per = (chunks + splits - 1) / splits;
  wgrad_wgmma_kernel<<<dim3(TILES, splits), NT, SMEM, st>>>(maps, part, L, rows_.p_inner, chunks,
                                                            per);
  return cudaGetLastError();
}

}  // namespace wgrad_wg

// ---------------------------------------------------------------- 5. reduce
__global__ void __launch_bounds__(NTHREADS)
wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int splits) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= W_ELEMS) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long long)k * W_ELEMS + i];
  out[i] = s;
}

// float32: the CUDA-core launches
template <typename T>
cudaError_t launch(const void* y_, const void* gy_, Rows rows_, long long P, const void* wq,
                   const void* wk, const void* wv, const void* wo, const void* w3,
                   const void* proj, float scale, float kernel_eps, void* qkv, float* go,
                   void* att, void* g3, void* dx, float* part, int splits, float* wgrad,
                   cudaStream_t st) {
  using G = GemmCfg<T>;
  const T* y = static_cast<const T*>(y_);
  const T* gy = static_cast<const T*>(gy_);
  const long long M = P * rows_.L;
  const unsigned gm = (unsigned)((M + G::BM - 1) / G::BM);
  cudaError_t err;
  if ((err = set_smem(proj_kernel<T>, proj_smem<T>())) != cudaSuccess) return err;
  if ((err = set_smem(favor_kernel<T>, FavorCfg<T>::SMEM)) != cudaSuccess) return err;
  if ((err = set_smem(dx_kernel<T>, dx_smem<T>())) != cudaSuccess) return err;
  proj_kernel<T><<<gm, NTHREADS, proj_smem<T>(), st>>>(
      y, gy, rows_, static_cast<const T*>(wq), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<const T*>(wo), scale, static_cast<T*>(qkv), go, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  favor_kernel<T><<<dim3(HEADS, (unsigned)P), NTHREADS, FavorCfg<T>::SMEM, st>>>(
      static_cast<const T*>(qkv), go, static_cast<const T*>(proj), scale, kernel_eps,
      static_cast<T*>(att), static_cast<T*>(g3), rows_.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dx_kernel<T><<<gm, NTHREADS, dx_smem<T>(), st>>>(
      static_cast<const T*>(g3), static_cast<const T*>(w3), static_cast<T*>(dx), rows_, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long per = (M + splits - 1) / splits;
  wgrad_kernel<T><<<dim3(W_TILES, splits), NTHREADS, WgradCfg<T>::SMEM, st>>>(
      y, gy, rows_, static_cast<const T*>(g3), static_cast<const T*>(att), part, M, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wgrad_reduce_kernel<<<(W_ELEMS + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(part, wgrad,
                                                                               splits);
  return cudaGetLastError();
}

// bfloat16: TMA + wgmma. 1. q/k/v and go (proj_wgmma_kernel, performer_wg.cuh:
// no LN, bf16 tiles; float32 rows); 2. FAVOR+ (favor_wg); 3. dx
// (out_wgmma_kernel with K = 1536, no bias); 4. the weight-gradient partials
// (wgrad_wg); 5. their sum
cudaError_t launch_bf16(const bf16* y, const bf16* gy, Rows rows_, long long P, const bf16* wq,
                        const bf16* wk, const bf16* wv, const bf16* wo, const bf16* w3,
                        const bf16* proj, float scale, float kernel_eps, bf16* qkv, float* go,
                        bf16* att, bf16* g3, bf16* gn, float* gden, bf16* dx, float* part,
                        int splits, float* wgrad, cudaStream_t st) {
  const long long M = P * rows_.L;
  if (M > 0x7fffffffLL) return cudaErrorInvalidValue;  // TMA coordinates are int32
  cudaError_t err = performer_wg::proj::launch_qkv(y, rows_, nullptr, nullptr, 0.f, wq, wk, wv,
                                                   scale, qkv, M, st);
  if (err != cudaSuccess) return err;
  if ((err = performer_wg::proj::launch_f32(gy, rows_, wo, go, M, st)) != cudaSuccess) return err;
  err = favor_wg::launch(qkv, go, proj, scale, kernel_eps, att, g3, gn, gden, P, rows_.L, st);
  if (err != cudaSuccess) return err;
  err = performer_wg::out::launch<3 * HD / 64>(g3, w3, nullptr, nullptr, dx, rows_, M, 0, st);
  if (err != cudaSuccess) return err;
  if ((err = wgrad_wg::launch(y, gy, rows_, P, g3, att, part, splits, st)) != cudaSuccess)
    return err;
  wgrad_reduce_kernel<<<(W_ELEMS + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(part, wgrad,
                                                                               splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of one weight-gradient partial (and of `wgrad`): dWq, dWk, dWv
// (288 x 512 each, the JAX layout), then dWo with dbo as its last row
// (513 x 288).
int fused_performer_bwd_wgrad_elems() { return W_ELEMS; }

// y, gy, dx: P problems of L positions of D = 288 values, problem p and
// position l at (p / p_inner) * s_hi + (p % p_inner) * s_lo + l * s_pos.
// wq, wk, wv (512, 288) nn.Linear layout; wo (512, 288) and w3 (288, 1536) =
// [Wq | Wk | Wv] the JAX layout; proj (320, 64) in the compute dtype.
// Scratch: qkv (P * L, 1536), att (P * L, 512), g3 (P * L, 1536) in the
// compute dtype; go (P * L, 512) and part (splits, W_ELEMS) float32; bfloat16
// also gn (P * L, 512) bf16 and gden (P * L, 8) float32 (gnum_ext between
// the FAVOR+ launch's phases; null for float32). Output: dx, and wgrad
// (W_ELEMS) float32. dtype: 0 float32, 1 bfloat16.
int fused_performer_bwd(const void* y, const void* gy, const void* wq, const void* wk,
                        const void* wv, const void* wo, const void* w3, const void* proj,
                        float scale, float kernel_eps, void* qkv, float* go, void* att, void* g3,
                        void* gn, float* gden, void* dx, float* part, int splits, float* wgrad,
                        long long P, int L,
                        long long s_hi, long long s_lo, long long s_pos, int p_inner, int d,
                        int heads, int dim_head, int m, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d != D || heads != HEADS || dim_head != DH || m != MF || P <= 0 || L <= 0 ||
      p_inner <= 0 || P > 65535 || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  Rows rows_{s_hi, s_lo, s_pos, p_inner, L};
  if (dtype == 0)
    return launch<float>(y, gy, rows_, P, wq, wk, wv, wo, w3, proj, scale, kernel_eps, qkv, go,
                         att, g3, dx, part, splits, wgrad, st);
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(y), static_cast<const bf16*>(gy), rows_, P,
                       static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
                       static_cast<const bf16*>(wv), static_cast<const bf16*>(wo),
                       static_cast<const bf16*>(w3), static_cast<const bf16*>(proj), scale,
                       kernel_eps, static_cast<bf16*>(qkv), go, static_cast<bf16*>(att),
                       static_cast<bf16*>(g3), static_cast<bf16*>(gn), gden, static_cast<bf16*>(dx),
                       part, splits, wgrad, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
