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
// feature maps are recomputed and each forward product has two transposes).
// One head's ctx and g_ctx are 320 x 65 float32 each, so as in the forward a
// block owns one (row-problem, head) and the layer runs as five launches:
//   1. proj:  q/k/v = y . W{q,k,v} (rows read in place through strides) and
//             go = gy . Wo^T into scratch;
//   2. favor: one block per (problem, head) streams its positions three
//             times: phi_k -> ctx; phi_q -> att, gq and g_ctx; phi_k -> gk, gv.
//             ctx (then g_ctx) is accumulated in float32 shared memory beside
//             its rounded copy; the (L, 320) maps exist only in shared memory;
//   3. dx:    [gq | gk | gv] . [Wq | Wk | Wv]^T, written in place;
//   4. wgrad: the four weight gradients as split-K products over the rows:
//             each block writes one float32 partial of a 64 x 64 tile for its
//             share of the rows (dbo rides dWo as a ones column of att);
//   5. reduce: the partials summed in a fixed order. TPU grids accumulate
//             the weight gradients sequentially; blocks here run in parallel,
//             so the sum is a second pass, deterministic and without atomics.
// bfloat16: tensor cores (mma.sync m16n8k16); float32: CUDA cores.

#include "common.cuh"

using namespace rf;

namespace {

constexpr int D = 288;     // pair width
constexpr int DH = 64;     // dim_head
constexpr int HEADS = 8;
constexpr int HD = HEADS * DH;  // 512
constexpr int MF = 320;    // random features
constexpr int EP = 72;     // dh + 1 (the ones column) padded to 8
constexpr int NTHREADS = 256;

template <typename T>
struct GemmCfg {
  static constexpr int BM = sizeof(T) == 2 ? 64 : 32;
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
  static constexpr int LC = sizeof(T) == 2 ? 32 : 16;   // positions per chunk
  static constexpr int EK = sizeof(T) == 2 ? 80 : EP;   // contraction over [dh | 1]
  static constexpr int LDD = DH + V, LDL = LC + V, LDM = MF + V;
  static constexpr int LDE = sizeof(T) == 2 ? EK + 8 : EK;
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

// ---------------------------------------------------------------- 5. reduce
__global__ void __launch_bounds__(NTHREADS)
reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int splits) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= W_ELEMS) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long long)k * W_ELEMS + i];
  out[i] = s;
}

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
  reduce_kernel<<<(W_ELEMS + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(part, wgrad, splits);
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
// compute dtype; go (P * L, 512) and part (splits, W_ELEMS) float32. Output:
// dx, and wgrad (W_ELEMS) float32. dtype: 0 float32, 1 bfloat16.
int fused_performer_bwd(const void* y, const void* gy, const void* wq, const void* wk,
                        const void* wv, const void* wo, const void* w3, const void* proj,
                        float scale, float kernel_eps, void* qkv, float* go, void* att, void* g3,
                        void* dx, float* part, int splits, float* wgrad, long long P, int L,
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
    return launch<bf16>(y, gy, rows_, P, wq, wk, wv, wo, w3, proj, scale, kernel_eps, qkv, go,
                        att, g3, dx, part, splits, wgrad, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
