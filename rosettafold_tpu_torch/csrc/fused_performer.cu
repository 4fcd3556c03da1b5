// Fused generalized-FAVOR+ attention layer (kernel C) for Hopper (sm_90a):
//
//   y = LayerNorm(x)                  (LN/residual mode; else y = x)
//   q = (y.Wq) s, k = (y.Wk) s, v = y.Wv              s = dim_head^-1/4
//   per head h:  phi_q = relu(q_h . P^T) + eps,  phi_k = relu(k_h . P^T) + eps
//                ctx   = phi_k^T . [v_h | 1]          (m x (dh + 1))
//                att_h = num[:, :dh] / max(num[:, dh], 1e-12),  num = phi_q . ctx
//   out = x + att.Wo + bo             (LN/residual mode; else att.Wo + bo)
//
// per row-problem: the L positions of one row (or column) of the pair map.
// Replaces rosettafold_tpu/ops/pallas/fused_performer.py `_forward_lnres`
// (:398, entry `fused_ln_performer_residual` :460), `_forward_axis1_lnres`
// (:434, entry :498) and, with the mode flag off, `_forward` (:322) and
// `_forward_axis1` (:361). Rounding points as `_layer_math` (:125-182): q, k,
// v, phi_q, phi_k (zero past the valid L), ctx and att are rounded to the
// compute dtype; every product accumulates in float32.
//
// Layout: one problem stride and one position stride. The row step attends
// over axis 1 of (B, L1, L2, D) and the column step over axis 2; both are
// read and written in place, so no transpose of the pair map is ever made.
//
// What bounds it on this card: operations (164 GFLOP at B=4, L=128: 77 in the
// projections, 87 in the feature maps and contractions). One head's ctx is
// 320 x 65 float32 (83 KB), so a block cannot hold all 8 heads, and the layer
// runs as three launches with scratch in device memory:
//   1. proj:  LN and the q/k/v projections, M = rows, N = 3 * 512, K = 288;
//   2. favor: per (problem, head) the positions are streamed twice: phi_k
//             chunks -> ctx, then phi_q chunks . ctx; the (L, m) feature maps
//             never reach device memory. bfloat16: a persistent grid on
//             wgmma, ctx in the accumulators of five warpgroups (64 features
//             each), P resident in shared memory (favor_wgmma_kernel);
//             float32: one block per (problem, head) on the CUDA cores, ctx
//             in shared memory;
//   3. out:   att . Wo + bo (+ x), M = rows, N = 288, K = 512.
// The scratch (q/k/v and att, 4 * 512 values per position) is the price of
// the split.
//
// The proj and out launches in bfloat16 (proj_wgmma_kernel,
// out_wgmma_kernel, csrc/performer_wg.cuh, shared with kernel C') are bound
// by bytes (the 201 MB q/k/v write at B=4, L=128; att, x and out), and their
// weights (884 KB and 295 KB) are read from L2 by every block: a block owns
// 128 rows, two warpgroups of 64, so a weight chunk read once serves 128
// rows. proj keeps LN(x) as bf16 A fragments in registers for all 24 chunks
// of 64 output columns and TMA-stores the q/k/v tiles; out walks tiles of
// 128 rows on a persistent grid, att and Wo through a TMA ring.
// float32 runs the proj and out launches on the CUDA cores (mma.sync tiles
// of common.cuh: performer_proj_kernel, performer_out_kernel).

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

template <typename T>
struct GemmCfg {
  static constexpr int BM = 32;  // float32; bfloat16 runs the wgmma launches
  static constexpr int WR = BM / 16, WC = 8 / WR;
};

// ------------------------------------------------------------ 1. projection
constexpr int NC1 = 64;  // output columns per chunk
constexpr int LD1 = D + 8;

template <typename T>
constexpr size_t proj_smem() {
  return sizeof(T) * (GemmCfg<T>::BM + NC1) * LD1;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
performer_proj_kernel(const T* __restrict__ x, Rows rows_, const float* __restrict__ gamma,
            const float* __restrict__ beta, float ln_eps, const T* __restrict__ wq,
            const T* __restrict__ wk, const T* __restrict__ wv, float scale,
            T* __restrict__ qkv, long long M) {
  using G = GemmCfg<T>;
  constexpr int NT = NC1 / (8 * G::WC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ys = reinterpret_cast<T*>(smem_raw);  // [BM][LD1]
  T* Ws = Ys + G::BM * LD1;                 // [NC1][LD1]
  const long long r0 = (long long)blockIdx.x * G::BM;
  const int rows = (int)min((long long)G::BM, M - r0);
  const int warp = threadIdx.x >> 5, rg = warp % G::WR, cg = warp / G::WR;
  ln_rows<T, D>(Ys, LD1, [=](int r) { return x + rows_.offset(r0 + r); }, G::BM, rows, gamma,
                beta, ln_eps);
  for (int c0 = 0; c0 < 3 * HD; c0 += NC1) {
    const T* w = c0 < HD ? wq : (c0 < 2 * HD ? wk : wv);
    __syncthreads();
    stage<T>(Ws, LD1, w + (long long)(c0 % HD) * D, D, NC1, NC1, D);
    __syncthreads();
    float acc[NT][4];
    zero(acc);
    warp_gemm<NT>(acc, Ys + rg * 16 * LD1, LD1, Ws + cg * NT * 8 * LD1, LD1, D);
    const float s = c0 < 2 * HD ? scale : 1.f;
    for_each(acc, [&](int r, int c, float v) {
      const int gr = rg * 16 + r;
      if (gr < rows) qkv[(r0 + gr) * (3 * HD) + c0 + cg * NT * 8 + c] = from_f<T>(v * s);
    });
  }
}

// ------------------------------------------------------ 2. FAVOR+, float32
// float32: the CUDA-core kernel; one block per (head, problem) streams the
// positions twice, ctx in float32 shared memory (bfloat16: favor_wgmma_kernel).
template <typename T>
struct FavorCfg {
  static constexpr int LC = 32;  // positions per chunk
  static constexpr int LDD = DH + 8, LDL = LC + 8, LDM = MF + 8, LDNUM = EP + 4;
  static constexpr size_t CTX = sizeof(float) * MF * EP;
  // phase 1: Ks [LC][LDD], Vt [EP][LDL], PhiKt [MF][LDL]
  static constexpr size_t P1 = sizeof(T) * (LC * LDD + EP * LDL + MF * LDL);
  // phase 2: Qs [LC][LDD], PhiQ [LC][LDM], NumS float [LC][LDNUM]
  static constexpr size_t P2 = sizeof(T) * (LC * LDD + LC * LDM) + sizeof(float) * LC * LDNUM;
  static constexpr size_t SMEM = CTX + (P1 > P2 ? P1 : P2);
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
favor_f32_kernel(const T* __restrict__ qkv, const T* __restrict__ proj, float kernel_eps,
             T* __restrict__ att, int L) {
  using F = FavorCfg<T>;
  constexpr int LC = F::LC, LDD = F::LDD, LDL = F::LDL, LDM = F::LDM, LDNUM = F::LDNUM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ctx = reinterpret_cast<float*>(smem_raw);  // [MF][EP]
  unsigned char* r1 = smem_raw + F::CTX;
  T* Ks = reinterpret_cast<T*>(r1);  // phase 1
  T* Vt = Ks + LC * LDD;
  T* PhiKt = Vt + EP * LDL;
  T* Qs = reinterpret_cast<T*>(r1);  // phase 2
  T* PhiQ = Qs + LC * LDD;
  float* NumS = reinterpret_cast<float*>(PhiQ + LC * LDM);

  const int h = blockIdx.x;
  const long long p = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const T* base = qkv + p * L * (3 * HD);
  const T* qb = base + h * DH;
  const T* kb = base + HD + h * DH;
  const T* vb = base + 2 * HD + h * DH;

  for (int e = tid; e < MF * EP; e += NTHREADS) Ctx[e] = 0.f;

  // phase 1: ctx = sum over positions of phi_k^T [v | 1]
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
    // phi_k^T: (LC x 320) = Ks . P^T, items (row group, 64-column block)
    for (int it = warp; it < (LC / 16) * (MF / 64); it += NTHREADS / 32) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[8][4];
      zero(acc);
      warp_gemm<8>(acc, Ks + rg * 16 * LDD, LDD, proj + cb * 64 * DH, DH, DH);
      for_each(acc, [&](int r, int c, float v) {
        const int l = rg * 16 + r;
        PhiKt[(cb * 64 + c) * LDL + l] = from_f<T>(l < nl ? fmaxf(v, 0.f) + kernel_eps : 0.f);
      });
    }
    __syncthreads();
    // ctx (320 x 72) += PhiKt (320 x LC) . Vt^T; warp w owns row groups w, w+8, w+16
    for (int rg = warp; rg < MF / 16; rg += NTHREADS / 32) {
      float acc[EP / 8][4];
      zero(acc);
      warp_gemm<EP / 8>(acc, PhiKt + rg * 16 * LDL, LDL, Vt, LDL, LC);
      for_each(acc, [&](int r, int c, float v) { Ctx[(rg * 16 + r) * EP + c] += v; });
    }
  }
  __syncthreads();

  // phase 2: att = (phi_q . ctx)[:, :dh] / max((phi_q . ctx)[:, dh], 1e-12)
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<T>(Qs, LDD, qb + (long long)l0 * 3 * HD, 3 * HD, LC, nl, DH);
    __syncthreads();
    for (int it = warp; it < (LC / 16) * (MF / 64); it += NTHREADS / 32) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[8][4];
      zero(acc);
      warp_gemm<8>(acc, Qs + rg * 16 * LDD, LDD, proj + cb * 64 * DH, DH, DH);
      for_each(acc, [&](int r, int c, float v) {
        PhiQ[(rg * 16 + r) * LDM + cb * 64 + c] = from_f<T>(fmaxf(v, 0.f) + kernel_eps);
      });
    }
    __syncthreads();
    for (int rg = warp; rg < LC / 16; rg += NTHREADS / 32) {
      float acc[EP / 8][4];
      zero(acc);
      warp_gemm_strided<EP / 8>(acc, reinterpret_cast<const float*>(PhiQ) + rg * 16 * LDM, LDM,
                                Ctx, 1, EP, MF);
      for_each(acc, [&](int r, int c, float v) { NumS[(rg * 16 + r) * LDNUM + c] = v; });
    }
    __syncthreads();
    for (int e = tid; e < nl * DH; e += NTHREADS) {
      const int l = e / DH, c = e % DH;
      const float den = fmaxf(NumS[l * LDNUM + DH], 1e-12f);
      att[(p * L + l0 + l) * HD + h * DH + c] = from_f<T>(NumS[l * LDNUM + c] / den);
    }
  }
}

// -------------------------------------------- 2. FAVOR+, bfloat16 on wgmma
// A persistent grid (one block an SM) walks the (problem, head) items; the
// block's five warpgroups each own 64 of the 320 features:
//  * the projection P (320 x 64) is loaded by TMA once a block and stays;
//  * phase 1, per chunk of 64 positions (K and V by TMA, a 3-stage ring that
//    runs ahead into the block's next item): phi_k^T of the warpgroup's
//    features (P_s . K^T, m64n64k16, both operands in shared memory) ->
//    relu + eps, zero past L, rounded to bf16 straight into the A fragments
//    (registers) of ctx_s += phi_k^T . V (V an MN-major B tile); ctx_s
//    (64 x 64) stays in the warpgroup's float32 accumulators over all L, and
//    the ones column (the normalizer) is summed from the same bf16 values;
//  * ctx_s and its normalizer, rounded to bf16, go to shared memory as
//    phase 2's B operand ([dh][feature] tiles);
//  * phase 2: warpgroup w takes the position chunks w, w + 5, ... (its own
//    2-stage Q ring): for each feature slice s, phi_q (Q . P_s^T) -> relu +
//    eps -> bf16 A fragments of num += phi_q . ctx_s, the normalizer as the
//    dot of the same values with ctx's ones column; att = num / max(den,
//    1e-12) into the scratch.
// Nothing of the (L, 320) feature maps leaves the registers. Every thread
// runs the K/V issue code in step and thread 0 alone issues (a branch around
// it serialises the wgmmas); each warpgroup's thread 0 issues its Q loads.
namespace favor_wg {

using namespace rf::hopper;

constexpr int NWG = MF / 64;  // warpgroups: one 64-feature slice each
constexpr int NT = NWG * 128;
constexpr int LC = 64;         // positions a chunk
constexpr int TILE = 64 * 128;  // 64 rows of 64 bf16, 128-byte swizzle
constexpr int KV_STAGES = 3, Q_STAGES = 2;
// shared memory from a 1024-byte boundary
constexpr int P_OFF = 0;                              // NWG tiles [feature][dh]
constexpr int CTX_OFF = P_OFF + NWG * TILE;           // NWG tiles [dh][feature]
constexpr int KV_OFF = CTX_OFF + NWG * TILE;          // KV_STAGES x (K, V) tiles [pos][dh]
constexpr int Q_OFF = KV_OFF + KV_STAGES * 2 * TILE;  // NWG x Q_STAGES tiles [pos][dh]
constexpr int DEN_OFF = Q_OFF + NWG * Q_STAGES * TILE;  // MF floats: ctx's ones column
constexpr int BAR_OFF = DEN_OFF + MF * 4;
// p_full, kv_full[KV_STAGES], kv_empty[KV_STAGES], q_full[NWG][Q_STAGES]
constexpr int NBARS = 1 + 2 * KV_STAGES + NWG * Q_STAGES;
constexpr size_t SMEM = 1024 + BAR_OFF + 8 * NBARS;

__global__ void __launch_bounds__(NT, 1)
favor_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap p_map, float kernel_eps,
                   bf16* __restrict__ att, int L, long long items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* den_s = reinterpret_cast<float*>(smem + DEN_OFF);
  const uint32_t p_full = base + BAR_OFF, kv_full = p_full + 8,
                 kv_empty = kv_full + 8 * KV_STAGES, q_full = kv_empty + 8 * KV_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t leader = threadIdx.x == 0, wg_leader = (threadIdx.x & 127) == 0;
  if (leader) {
    mbar_init(p_full, 1);
    for (int st = 0; st < KV_STAGES; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, NT / 32);
    }
    for (int st = 0; st < NWG * Q_STAGES; ++st) mbar_init(q_full + 8 * st, 1);
    fence_mbar_init();
  }
  __syncthreads();
  mbar_arrive_expect_tx(p_full, NWG * TILE, leader);
  for (int s = 0; s < NWG; ++s)
    tma_load_2d(base + P_OFF + s * TILE, &p_map, p_full, 0, 64 * s, leader);

  const int nc = (L + LC - 1) / LC;
  // the K/V loads in the order phase 1 takes them over the block's items
  long long kv_item = blockIdx.x;
  int kv_chunk = 0, kv_n = 0;
  auto issue_kv = [&](int released) {
    while (kv_item < items && kv_n < released + KV_STAGES) {
      const int st = kv_n % KV_STAGES;
      mbar_wait(kv_empty + 8 * st, ((kv_n / KV_STAGES) & 1) ^ 1);
      const int h = (int)(kv_item % HEADS);
      const int row = (int)(kv_item / HEADS * L) + kv_chunk * LC;
      const uint32_t dst = base + KV_OFF + st * 2 * TILE, full = kv_full + 8 * st;
      mbar_arrive_expect_tx(full, 2 * TILE, leader);
      tma_load_2d(dst, &qkv_map, full, HD + h * DH, row, leader);
      tma_load_2d(dst + TILE, &qkv_map, full, 2 * HD + h * DH, row, leader);
      ++kv_n;
      if (++kv_chunk == nc) {
        kv_chunk = 0;
        kv_item += gridDim.x;
      }
    }
  };
  int kv_used = 0;  // K/V stages this warpgroup has taken
  int q_n = 0;      // Q chunks this warpgroup has taken
  issue_kv(0);
  mbar_wait(p_full, 0);

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int h = (int)(item % HEADS), row0 = (int)(item / HEADS * L);
    const int nq = wg < nc ? (nc - 1 - wg) / NWG + 1 : 0;  // this warpgroup's Q chunks
    auto issue_q = [&](int k) {
      if (k >= nq) return;
      const int st = wg * Q_STAGES + (q_n + k) % Q_STAGES;
      mbar_arrive_expect_tx(q_full + 8 * st, TILE, wg_leader);
      tma_load_2d(base + Q_OFF + st * TILE, &qkv_map, q_full + 8 * st, h * DH,
                  row0 + (wg + k * NWG) * LC, wg_leader);
    };
    __syncthreads();  // the last item's ctx tiles and Q stages are no longer read
    for (int k = 0; k < Q_STAGES; ++k) issue_q(k);

    // phase 1: ctx_s = phi_k^T [v | 1] over the features of this warpgroup
    const uint32_t p_tile = base + P_OFF + wg * TILE;
    float ctx[32], den[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) ctx[e] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int st = kv_used % KV_STAGES;
      mbar_wait(kv_full + 8 * st, (kv_used / KV_STAGES) & 1);
      const uint32_t kt = base + KV_OFF + st * 2 * TILE, vt = kt + TILE;
      float d[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) d[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<64>::ss(d, desc_sw128(p_tile + ks * 32), desc_sw128(kt + ks * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      uint32_t a[4][4];
      favor_features(a, d, kernel_eps, L - c * LC, t, den);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<64>::rs<1>(ctx, a[ks], desc_sw128_mn(vt + ks * 2048, TILE), 1);
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * st);
      issue_kv(++kv_used);
    }
    // ctx_s -> bf16 [dh][feature] tile (the 128-byte swizzle), den -> den_s
    unsigned char* ct = smem + CTX_OFF + wg * TILE;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int f = 16 * wq + g + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + 2 * t + (e & 1);
      *reinterpret_cast<bf16*>(ct + c * 128 + ((((f >> 3) ^ (c & 7)) << 4) | ((f & 7) << 1))) =
          __float2bfloat16(ctx[e]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = den[hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) den_s[64 * wg + 16 * wq + g + 8 * hh] = __bfloat162float(__float2bfloat16(v));
    }
    fence_proxy_async();
    __syncthreads();

    // phase 2: att = num[:, :dh] / max(num[:, dh], 1e-12), num = phi_q . ctx
    for (int k = 0; k < nq; ++k) {
      const int c = wg + k * NWG, st = wg * Q_STAGES + (q_n + k) % Q_STAGES;
      mbar_wait(q_full + 8 * st, ((q_n + k) / Q_STAGES) & 1);
      const uint32_t qt = base + Q_OFF + st * TILE;
      float num[32], dq[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) num[e] = 0.f;
      for (int s = 0; s < NWG; ++s) {
        float d[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) d[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<64>::ss(d, desc_sw128(qt + ks * 32), desc_sw128(base + P_OFF + s * TILE + ks * 32),
                        1);
        wgmma_commit();
        wgmma_wait<0>();
        uint32_t a[4][4];
        float unused[2] = {0.f, 0.f};
        favor_features(a, d, kernel_eps, LC, t, unused);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[ks][kk]);
            const float* dn = den_s + 64 * s + 16 * ks + 8 * (kk >> 1) + 2 * t;
            dq[kk & 1] += __low2float(v) * dn[0] + __high2float(v) * dn[1];
          }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<64>::rs<0>(num, a[ks], desc_sw128(base + CTX_OFF + s * TILE + ks * 32), 1);
        wgmma_commit();
        wgmma_wait<0>();
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = dq[hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const float den_row = fmaxf(v, 1e-12f);
        const int l = c * LC + 16 * wq + g + 8 * hh;
        if (l < L) {
          bf16* o = att + (long long)(row0 + l) * HD + h * DH + 2 * t;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(
                num[4 * n + 2 * hh] / den_row, num[4 * n + 2 * hh + 1] / den_row);
        }
      }
      named_barrier(1 + wg, 128);  // the warpgroup is done with this Q stage
      issue_q(k + Q_STAGES);
    }
    q_n += nq;
  }
}

cudaError_t launch(const bf16* qkv, const bf16* proj, float kernel_eps, bf16* att, long long P,
                   int L, cudaStream_t st) {
  CUtensorMap qkv_map, p_map;
  const cuuint64_t qdims[2] = {3 * HD, (cuuint64_t)(P * L)}, qstrides[1] = {3 * HD * 2};
  const cuuint64_t pdims[2] = {DH, MF}, pstrides[1] = {DH * 2};
  const cuuint32_t box[2] = {64, 64};
  if (P * L > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = encode_bf16_sw128(&qkv_map, qkv, 2, qdims, qstrides, box);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_sw128(&p_map, proj, 2, pdims, pstrides, box)) != cudaSuccess) return err;
  if ((err = set_smem(favor_wgmma_kernel, SMEM)) != cudaSuccess) return err;
  const long long items = P * HEADS;
  const unsigned grid = (unsigned)(items < sm_count() ? items : sm_count());
  favor_wgmma_kernel<<<grid, NT, SMEM, st>>>(qkv_map, p_map, kernel_eps, att, L, items);
  return cudaGetLastError();
}

}  // namespace favor_wg

// ------------------------------------------------------- 3. out projection
constexpr int KC3 = 64;
constexpr int LD3 = KC3 + 8;

template <typename T>
constexpr size_t out_smem() {
  return sizeof(T) * (GemmCfg<T>::BM + D) * LD3;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
performer_out_kernel(const T* __restrict__ att, const T* __restrict__ wo,
                     const float* __restrict__ bo,
           const T* __restrict__ x, T* __restrict__ out, Rows rows_, long long M, int residual) {
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
  for (int k0 = 0; k0 < HD; k0 += KC3) {
    __syncthreads();
    stage<T>(As, LD3, att + r0 * HD + k0, HD, G::BM, rows, KC3);
    stage<T>(Ws, LD3, wo + k0, HD, D, D, KC3);
    __syncthreads();
    warp_gemm<NT>(acc, As + rg * 16 * LD3, LD3, Ws + cg * NT * 8 * LD3, LD3, KC3);
  }
  for_each(acc, [&](int r, int c, float v) {
    const int gr = rg * 16 + r, col = cg * NT * 8 + c;
    if (gr < rows) {
      const long long o = rows_.offset(r0 + gr) + col;
      float y = v + bo[col];
      if (residual) y = to_f(x[o]) + y;
      out[o] = from_f<T>(y);
    }
  });
}


cudaError_t launch_bf16(const bf16* x, const float* gamma, const float* beta, float ln_eps,
                        const bf16* wq, const bf16* wk, const bf16* wv, const bf16* wo,
                        const float* bo, const bf16* proj, float scale, float kernel_eps,
                        bf16* qkv, bf16* attn, bf16* out, Rows rows_, long long P,
                        cudaStream_t st) {
  const long long M = P * rows_.L;
  if (M > 0x7fffffffLL) return cudaErrorInvalidValue;  // TMA coordinates are int32
  cudaError_t err = performer_wg::proj::launch_qkv(x, rows_, gamma, beta, ln_eps, wq, wk, wv,
                                                   scale, qkv, M, st);
  if (err != cudaSuccess) return err;
  if ((err = favor_wg::launch(qkv, proj, kernel_eps, attn, P, rows_.L, st)) != cudaSuccess)
    return err;
  return performer_wg::out::launch<HD / 64>(attn, wo, bo, x, out, rows_, M, gamma != nullptr, st);
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta, float ln_eps,
                   const void* wq, const void* wk, const void* wv, const void* wo,
                   const float* bo, const void* proj, float scale, float kernel_eps, void* qkv,
                   void* attn, void* out, Rows rows_, long long P, cudaStream_t st) {
  using G = GemmCfg<T>;
  const long long M = P * rows_.L;
  const unsigned gm = (unsigned)((M + G::BM - 1) / G::BM);
  cudaError_t err;
  if ((err = set_smem(performer_proj_kernel<T>, proj_smem<T>())) != cudaSuccess) return err;
  if ((err = set_smem(performer_out_kernel<T>, out_smem<T>())) != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  performer_proj_kernel<T><<<gm, NTHREADS, proj_smem<T>(), st>>>(
      xt, rows_, gamma, beta, ln_eps, static_cast<const T*>(wq), static_cast<const T*>(wk),
      static_cast<const T*>(wv), scale, static_cast<T*>(qkv), M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(favor_f32_kernel<T>, FavorCfg<T>::SMEM)) != cudaSuccess) return err;
  favor_f32_kernel<T><<<dim3(HEADS, (unsigned)P), NTHREADS, FavorCfg<T>::SMEM, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(proj), kernel_eps,
      static_cast<T*>(attn), rows_.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  performer_out_kernel<T><<<gm, NTHREADS, out_smem<T>(), st>>>(
      static_cast<const T*>(attn), static_cast<const T*>(wo), bo, xt, static_cast<T*>(out),
      rows_, M, gamma != nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: P problems of L positions of D = 288 values; problem p, position l
// at (p / p_inner) * s_hi + (p % p_inner) * s_lo + l * s_pos (elements).
// gamma, beta: LN parameters (float32), both null for the no-LN, no-residual
// mode. wq, wk, wv (512, 288) and wo (288, 512) in nn.Linear layout; bo
// (288) float32; proj (320, 64). qkv (P * L, 1536) and attn (P * L, 512)
// are scratch. bfloat16: x, out and every matrix 16-byte aligned. dtype: 0
// float32, 1 bfloat16.
int fused_performer_fwd(const void* x, const float* gamma, const float* beta, float ln_eps,
                        const void* wq, const void* wk, const void* wv, const void* wo,
                        const float* bo, const void* proj, float scale, float kernel_eps,
                        void* qkv, void* attn, void* out, long long P, int L, long long s_hi,
                        long long s_lo, long long s_pos, int p_inner, int d, int heads,
                        int dim_head, int m, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d != D || heads != HEADS || dim_head != DH || m != MF || P <= 0 || L <= 0 ||
      p_inner <= 0 || P > 65535 || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  Rows rows_{s_hi, s_lo, s_pos, p_inner, L};
  if (dtype == 0)
    return launch<float>(x, gamma, beta, ln_eps, wq, wk, wv, wo, bo, proj, scale, kernel_eps,
                         qkv, attn, out, rows_, P, st);
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(x), gamma, beta, ln_eps,
                       static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
                       static_cast<const bf16*>(wv), static_cast<const bf16*>(wo), bo,
                       static_cast<const bf16*>(proj), scale, kernel_eps, static_cast<bf16*>(qkv),
                       static_cast<bf16*>(attn), static_cast<bf16*>(out), rows_, P, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
