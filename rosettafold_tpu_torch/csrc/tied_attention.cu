// Tied row attention, forward (kernel A), for Hopper (sm_90a).
//
// Replaces rosettafold_tpu/ops/pallas/tied_attention.py `_forward`
// (the pl.pallas_call at :99, public entry `tied_flash_attention` :134).
//
//   s[i, j]   = sum_e q[bh, i, e] * k[bh, j, e]      (e runs over N*d: one map
//                                                    tied over the N MSA rows)
//   out[i, :] = sum_j softmax_j(s)[i, j] * v[bh, j, :]
//   lse[i]    = logsumexp_j s[i, j]                  (kept for a flash backward)
//
// Layouts: q, k (BH, L, ND); v, out (BH, L, NDv); lse (BH, L) float32.
// q already carries the position-wise weights and 1/sqrt(d).
//
// What bounds it on this card: bytes at the batch shape (BH = 48, L = 128,
// ND = NDv = 256: 12.6 MB in and out against 0.8 GFLOP), operations at the
// long requests' (L = 1100, ND = NDv = 1024 or L = 512, ND = 2048: 26-60
// GFLOP against 0.1 GB). Online softmax in one pass would hold a 64-row q
// tile (256 KB at ND = 2048) or restage it per key step, and split NDv over
// blocks that each recompute every logit (8x at ND = 2048). So bfloat16 (the
// serving trunk) runs two launches on wgmma (see the bfloat16 section):
//  * the logits once, a batched GEMM q . k^T into float32 scratch, whose
//    blocks each stage their q rows once per 64 x BN tile;
//  * the softmax and P . V, whose blocks split NDv and recompute only the
//    exponentials of the logits they read back from L2;
// and one launch where a block can hold a whole row of logits and every
// output column (L <= 128, 64 < NDv <= 256: the batch shape), which keeps the
// logits in registers and P in shared memory.
// The scratch (4 L^2 bytes per (b, head): 58 MB at L = 1100, 12 heads) is
// written once and read once per column block. Ragged L is masked inside
// the kernels (no padding to 128). float32 runs on the CUDA cores with
// online softmax, so its products stay exact float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- float32 --
// CUDA-core kernel: 32 query rows x (256 * CPT) output columns per block.

constexpr int F_BQ = 32;   // query rows per block
constexpr int F_BK = 32;   // keys per online-softmax step
constexpr int F_DK = 32;   // contraction chunk
constexpr int F_NT = 256;  // threads per block

template <int CPT>
__global__ void __launch_bounds__(F_NT)
tied_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int L, int ND, int NDv) {
  constexpr int DV = F_NT * CPT;  // output columns per block
  extern __shared__ float smem[];
  float* Qs = smem;                       // [F_BQ][F_DK + 1]
  float* Ks = Qs + F_BQ * (F_DK + 1);     // [F_BK][F_DK + 1]
  float* Ps = Ks + F_BK * (F_DK + 1);     // [F_BQ][F_BK + 1]
  float* m_s = Ps + F_BQ * (F_BK + 1);    // [F_BQ] running max
  float* l_s = m_s + F_BQ;                // [F_BQ] running denominator
  float* a_s = l_s + F_BQ;                // [F_BQ] rescale factor of this step
  float* Vs = a_s + F_BQ;                 // [F_BK][DV]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * F_BQ;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * DV;
  const float* qb = q + (size_t)bh * L * ND;
  const float* kb = k + (size_t)bh * L * ND;
  const float* vb = v + (size_t)bh * L * NDv;

  if (tid < F_BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  float acc[F_BQ][CPT];
#pragma unroll
  for (int r = 0; r < F_BQ; ++r)
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[r][u] = 0.f;

  // logits micro-tile of this thread: row sr, columns sc .. sc + 3
  const int sr = tid >> 3;
  const int sc = (tid & 7) * 4;

  for (int j0 = 0; j0 < L; j0 += F_BK) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < ND; d0 += F_DK) {
      for (int e = tid; e < F_BQ * F_DK; e += F_NT) {
        const int r = e / F_DK, c = e % F_DK;
        const int gc = d0 + c;
        const int qr = q0 + r, kr = j0 + r;
        Qs[r * (F_DK + 1) + c] = (qr < L && gc < ND) ? qb[(size_t)qr * ND + gc] : 0.f;
        Ks[r * (F_DK + 1) + c] = (kr < L && gc < ND) ? kb[(size_t)kr * ND + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < F_DK; ++c) {
        const float qv = Qs[sr * (F_DK + 1) + c];
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] += qv * Ks[(sc + u) * (F_DK + 1) + c];
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      Ps[sr * (F_BK + 1) + sc + u] = (j0 + sc + u < L) ? s[u] : -INFINITY;

    // stage this step's V tile while the softmax runs
    for (int e = tid; e < F_BK * DV; e += F_NT) {
      const int r = e / DV, c = e % DV;
      const int gr = j0 + r, gc = c0 + c;
      Vs[r * DV + c] = (gr < L && gc < NDv) ? vb[(size_t)gr * NDv + gc] : 0.f;
    }
    __syncthreads();

    if (tid < F_BQ) {  // online softmax, one thread per query row
      const float m_old = m_s[tid];
      float mx = m_old;
      for (int c = 0; c < F_BK; ++c) mx = fmaxf(mx, Ps[tid * (F_BK + 1) + c]);
      // column j0 < L is always valid, so mx is finite here
      const float alpha = expf(m_old - mx);
      float sum = 0.f;
      for (int c = 0; c < F_BK; ++c) {
        const float p = expf(Ps[tid * (F_BK + 1) + c] - mx);
        sum += p;
        Ps[tid * (F_BK + 1) + c] = p;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mx;
      a_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < F_BQ; ++r) {
      const float a = a_s[r];
#pragma unroll
      for (int u = 0; u < CPT; ++u) acc[r][u] *= a;
    }
    for (int kk = 0; kk < F_BK; ++kk) {
      float vv[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) vv[u] = Vs[kk * DV + tid + u * F_NT];
#pragma unroll
      for (int r = 0; r < F_BQ; ++r) {
        const float p = Ps[r * (F_BK + 1) + kk];
#pragma unroll
        for (int u = 0; u < CPT; ++u) acc[r][u] += p * vv[u];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < F_BQ; ++r) {
    const int gr = q0 + r;
    if (gr >= L) break;
    const float inv = 1.f / l_s[r];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int gc = c0 + tid + u * F_NT;
      if (gc < NDv) out[((size_t)bh * L + gr) * NDv + gc] = acc[r][u] * inv;
    }
  }
  if (blockIdx.z == 0 && tid < F_BQ && q0 + tid < L)
    lse[(size_t)bh * L + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <int CPT>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* out,
                       float* lse, int BH, int L, int ND, int NDv, cudaStream_t st) {
  constexpr int DV = F_NT * CPT;
  const size_t smem = sizeof(float) * (F_BQ * (F_DK + 1) + F_BK * (F_DK + 1) +
                                       F_BQ * (F_BK + 1) + 3 * F_BQ + F_BK * DV);
  auto kern = tied_fwd_f32<CPT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + F_BQ - 1) / F_BQ, BH, (NDv + DV - 1) / DV);
  kern<<<grid, F_NT, smem, st>>>(q, k, v, out, lse, L, ND, NDv);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16 --
// Two launches on wgmma (one at L <= 128, 64 < NDv <= 256: 3. below), each fed by
// TMA through a ring of full / empty mbarriers; one warpgroup (128 threads)
// a block.
//  1. tied_logits_kernel<BN>: s = q . k^T in float32 into scratch (BH, L,
//     LS), LS = L rounded up to 4. A block owns 64 query rows x BN keys and
//     streams q and k in 64-wide chunks of ND (4 stages), m64nBNk16 with both
//     operands in shared memory, accumulated in float32 registers over the
//     whole ND. Every logit is computed once, whatever NDv. The epilogue
//     also writes each row's (max, sum of exp(s - max)) over the tile's keys.
//  2. tied_pv_kernel<BC>: a block owns 64 query rows x BC output columns. It
//     combines the tiles' statistics into each row's max m and sum l of
//     exp(s - m), then walks the keys in chunks of 64: p =
//     bf16(exp(s - m)) goes from the logits straight into the wgmma A
//     fragments (registers; the next chunk's logits are loaded while this
//     chunk's products run), V arrives by TMA as an MN-major B tile (3
//     stages), m64nBCk16; out = acc * (1 / l) in bf16 through shared memory
//     as 16-byte vectors, lse = m + log(l).
// The probabilities are rounded exactly where the plain version rounds them:
// exp(s - m) with the row's final max, before P.V; the denominator sums the
// unrounded values (tile by tile, rescaled to the final max). BN and BC are
// 128 and 256 where the grid keeps two blocks on each SM, else 64 and 128
// (64 at NDv <= 64), so the batch shape (BH = 48, L = 128) runs 192 blocks
// of each kind on the 132 SMs. TMA's zero fill covers the ragged ends of L,
// ND and NDv; rows and keys past L are masked, columns past NDv are not
// stored. The bf16 path needs ND, NDv % 8 == 0 and 16-byte aligned q, k, v
// (the TMA row stride); ND = NDv = N * 32 on the model path.

namespace tma_wg {

using namespace rf::hopper;

constexpr int NT = 128;       // one warpgroup
constexpr int BM = 64;        // query rows a block
constexpr int KC = 64;        // ND chunk and key chunk: one 128-byte row of bf16
constexpr int S_STAGES = 4;   // logits ring
constexpr int V_STAGES = 3;   // P.V ring
constexpr int TILE = KC * 128;  // one 64-row x 64-column box (bytes)

constexpr size_t logits_smem(int BN) { return 1024 + S_STAGES * (BM + BN) * 128 + 16 * S_STAGES; }
constexpr size_t pv_smem(int BC) { return 1024 + V_STAGES * (BC / 64) * TILE + 16 * V_STAGES; }
constexpr size_t fused_smem(int BC) {
  return 1024 + S_STAGES * (BM + 128) * 128 + 2 * (BC / 64) * TILE + 2 * TILE + 4 * BM * 4 +
         16 * S_STAGES + 8;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// acc += q . k^T over the nch chunks of ND in the ring (stage c % S_STAGES at
// base + stage * (BM + BN) * 128: 64 q rows, then BN k rows, of which this
// warpgroup multiplies the N from row k_row on; full / empty barriers at
// bars): one chunk's products run while the next chunk's are issued; a stage
// is released, and its next chunk issued, once its products are done
template <int N, int BN, typename Issue>
__device__ __forceinline__ void logits_loop(float (&acc)[N / 2], uint32_t base, uint32_t bars,
                                            int nch, int k_row, int lane, Issue& issue) {
  constexpr int STAGE = (BM + BN) * 128;
  for (int c = 0; c < nch; ++c) {
    const int st = c % S_STAGES;
    mbar_wait(bars + 8 * st, (c / S_STAGES) & 1);
    const uint32_t qt = base + st * STAGE, kt = qt + (BM + k_row) * 128;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      Wgmma<N>::ss(acc, desc_sw128(qt + ks * 32), desc_sw128(kt + ks * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1's products are done
    if (c > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S_STAGES + (c - 1) % S_STAGES));
      if (c - 1 + S_STAGES < nch) issue(c - 1 + S_STAGES);
    }
  }
  wgmma_wait<0>();
}

// A warpgroup's 64 x N slice of the output (accumulator o, row half h
// scaled by inv[h]) into columns col .. col + N of a staging tile in shared
// memory (`tile`, row stride LDO, free, 16-byte aligned); then the block's
// THREADS store whole 16-byte vectors of its rows < L and of the tile's
// `cols` columns < NDv, from output column c0 on
template <int N, int LDO, int THREADS>
__device__ __forceinline__ void store_out(__nv_bfloat16* tile, const float (&o)[N / 2],
                                          const float (&inv)[2], int col,
                                          __nv_bfloat16* __restrict__ out, int bh, int i0,
                                          int c0, int cols, int L, int NDv) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8 * h) * LDO + col + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[4 * n + 2 * h] * inv[h], o[4 * n + 2 * h + 1] * inv[h]);
  __syncthreads();
  const int nrows = min(BM, L - i0), vecs = min(cols, NDv - c0) / 8;
  for (int e = threadIdx.x; e < nrows * vecs; e += THREADS) {
    const int row = e / vecs, c = (e % vecs) * 8;
    *reinterpret_cast<uint4*>(out + ((size_t)bh * L + i0 + row) * NDv + c0 + c) =
        *reinterpret_cast<const uint4*>(tile + row * LDO + c);
  }
}

template <int BN>
__global__ void __launch_bounds__(NT)
tied_logits_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap, float* __restrict__ s,
                   float2* __restrict__ stats, int L, int LS, int ND) {
  constexpr int STAGE = (BM + BN) * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(align1024(smem_raw));
  const uint32_t bars = base + S_STAGES * STAGE;  // full[S_STAGES], empty[S_STAGES]
  const int i0 = blockIdx.x * BM, j0 = blockIdx.y * BN, bh = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t leader = threadIdx.x == 0;
  if (leader) {
    for (int st = 0; st < S_STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (S_STAGES + st), NT / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int nch = (ND + KC - 1) / KC;
  // chunk c into stage c % S_STAGES once its last use is released; every
  // thread runs this in step, thread 0 alone issues
  auto issue = [&](int c) {
    const int st = c % S_STAGES;
    mbar_wait(bars + 8 * (S_STAGES + st), ((c / S_STAGES) & 1) ^ 1);
    const uint32_t dst = base + st * STAGE, full = bars + 8 * st;
    mbar_arrive_expect_tx(full, STAGE, leader);
    tma_load_3d(dst, &qmap, full, c * KC, i0, bh, leader);
    tma_load_3d(dst + BM * 128, &kmap, full, c * KC, j0, bh, leader);
  };
  for (int c = 0; c < nch && c < S_STAGES; ++c) issue(c);

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  logits_loop<BN, BN>(acc, base, bars, nch, 0, lane, issue);

  const int t = lane & 3, r = i0 + warp * 16 + (lane >> 2), cc = j0 + 2 * t;
  float* sb = s + (size_t)bh * L * LS;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = cc + 8 * n;  // even; col + 1 < LS
    if (col < L) {
      if (r < L)
        *reinterpret_cast<float2*>(sb + (size_t)r * LS + col) =
            make_float2(acc[4 * n], acc[4 * n + 1]);
      if (r + 8 < L)
        *reinterpret_cast<float2*>(sb + (size_t)(r + 8) * LS + col) =
            make_float2(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
  // the tile's softmax statistics per row: (max, sum of exp(s - max)) over
  // its valid keys (at least key j0); a row's BN keys lie in one quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (cc + 8 * n + e < L) mx = fmaxf(mx, acc[4 * n + 2 * h + e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (cc + 8 * n + e < L) sum += expf(acc[4 * n + 2 * h + e] - mx);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r + 8 * h;
    if (t == 0 && row < L)
      stats[((size_t)bh * L + row) * gridDim.y + blockIdx.y] = make_float2(mx, sum);
  }
}

template <int BC>
__global__ void __launch_bounds__(NT)
tied_pv_kernel(const float* __restrict__ s, const float2* __restrict__ stats, int tiles,
               const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, int L, int LS, int NDv) {
  constexpr int BOXES = BC / 64, STAGE = BOXES * TILE;
  static_assert(BM * (BC + 8) * 2 <= V_STAGES * STAGE, "the output tile fits the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + V_STAGES * STAGE;  // full[V_STAGES], empty[V_STAGES]
  const int i0 = blockIdx.x * BM, c0 = blockIdx.y * BC, bh = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t leader = threadIdx.x == 0;
  if (leader) {
    for (int st = 0; st < V_STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (V_STAGES + st), NT / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int nkc = (L + KC - 1) / KC;
  // the boxes of this block's columns that hold any column < NDv; the rest
  // are left unloaded (their products land in columns that are not stored)
  const int boxes = min(BOXES, (NDv - c0 + 63) / 64);
  auto issue = [&](int c) {
    const int st = c % V_STAGES;
    mbar_wait(bars + 8 * (V_STAGES + st), ((c / V_STAGES) & 1) ^ 1);
    const uint32_t dst = base + st * STAGE, full = bars + 8 * st;
    mbar_arrive_expect_tx(full, boxes * TILE, leader);
    for (int b = 0; b < boxes; ++b)
      tma_load_3d(dst + b * TILE, &vmap, full, c0 + 64 * b, c * KC, bh, leader);
  };
  for (int c = 0; c < nkc && c < V_STAGES; ++c) issue(c);

  // this thread's A fragment rows (lo, hi) and columns 2t, 2t + 1 (+ 8);
  // each row's max m and sum l of exp(s - m) from the logits tiles' own
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  float ms[2] = {0.f, 0.f}, ls[2] = {1.f, 1.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (rows[h] < L) {
      const float2* st = stats + ((size_t)bh * L + rows[h]) * tiles;
      float m = -INFINITY, l = 0.f;
      for (int i = 0; i < tiles; ++i) m = fmaxf(m, st[i].x);
      for (int i = 0; i < tiles; ++i) l += st[i].y * expf(st[i].x - m);
      ms[h] = m;
      ls[h] = l;
    }
  const float* sb = s + (size_t)bh * L * LS;
  // logits of chunk c at register k (row half k & 1, column half k >> 1)
  float2 sv[KC / 16][4];
  auto load = [&](int c) {
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = rows[k & 1], j = c * KC + 16 * ks + 8 * (k >> 1) + 2 * t;
        sv[ks][k] = (row < L && j < L)
                        ? *reinterpret_cast<const float2*>(sb + (size_t)row * LS + j)
                        : make_float2(-INFINITY, -INFINITY);
      }
  };
  load(0);

  float acc[BC / 2];
#pragma unroll
  for (int e = 0; e < BC / 2; ++e) acc[e] = 0.f;
  for (int c = 0; c < nkc; ++c) {
    uint32_t a[KC / 16][4];
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = c * KC + 16 * ks + 8 * (k >> 1) + 2 * t;
        const float m = ms[k & 1];
        a[ks][k] = pack_bf16(j < L ? expf(sv[ks][k].x - m) : 0.f,
                             j + 1 < L ? expf(sv[ks][k].y - m) : 0.f);
      }
    if (c + 1 < nkc) load(c + 1);
    const int st = c % V_STAGES;
    mbar_wait(bars + 8 * st, (c / V_STAGES) & 1);
    const uint32_t vt = base + st * STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      Wgmma<BC>::template rs<1>(acc, a[ks], desc_sw128_mn(vt + ks * 2048, TILE), 1);
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (V_STAGES + st));
    if (c + V_STAGES < nkc) issue(c + V_STAGES);
  }

  if (blockIdx.y == 0 && t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rows[h] < L) lse[(size_t)bh * L + rows[h]] = ms[h] + logf(ls[h]);
  // through the ring's shared memory, free since the last chunk
  const float inv[2] = {1.f / ls[0], 1.f / ls[1]};
  store_out<BC, BC + 8, NT>(reinterpret_cast<__nv_bfloat16*>(smem), acc, inv, 0, out, bh, i0, c0,
                            BC, L, NDv);
}

// 3. tied_fused_kernel<BC>: L <= 128 and 64 < NDv <= BC <= 256 in one launch.
//    A block of two warpgroups owns 64 query rows, every key and every
//    output column. Warpgroup w takes keys 64w .. 64w + 63 of the logits
//    (m64n64k16 over ND; q and k fed as in 1., one ring for both) and output
//    columns w BC / 2 .. of P.V. The row statistics are combined through
//    shared memory; each warpgroup writes its bf16 probabilities there as
//    half of P.V's A operand (K-major, swizzled), so both multiply the whole
//    P by their half of V (m64n(BC/2)k16, both operands in shared memory; V,
//    L x BC, arrives by TMA behind the first q and k chunks). The output tile
//    leaves as 16-byte vectors. Each logit is computed once.
constexpr int NT2 = 2 * NT;

template <int BC>
__global__ void __launch_bounds__(NT2)
tied_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, int L, int ND, int NDv) {
  constexpr int BN = 128, STAGE = (BM + BN) * 128, BOXES = BC / 64, HALF = BC / 2;
  constexpr int V_OFF = S_STAGES * STAGE, P_OFF = V_OFF + 2 * BOXES * TILE;
  constexpr int RED_OFF = P_OFF + 2 * TILE, BAR_OFF = RED_OFF + 4 * BM * 4;
  static_assert(BM * (BC + 8) * 2 <= V_OFF, "the output tile fits the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem), v_tiles = base + V_OFF, p_tiles = base + P_OFF;
  float* red = reinterpret_cast<float*>(smem + RED_OFF);  // [half][max, sum][row]
  const uint32_t bars = base + BAR_OFF, v_full = bars + 16 * S_STAGES;
  const int i0 = blockIdx.x * BM, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, t = lane & 3, wg = threadIdx.x / NT;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r, r + 8 of the tile
  const uint32_t leader = threadIdx.x == 0;
  if (leader) {
    for (int st = 0; st < S_STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (S_STAGES + st), NT2 / 32);
    }
    mbar_init(v_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int nch = (ND + KC - 1) / KC;
  auto issue = [&](int c) {
    const int st = c % S_STAGES;
    mbar_wait(bars + 8 * (S_STAGES + st), ((c / S_STAGES) & 1) ^ 1);
    const uint32_t dst = base + st * STAGE, full = bars + 8 * st;
    mbar_arrive_expect_tx(full, STAGE, leader);
    tma_load_3d(dst, &qmap, full, c * KC, i0, bh, leader);
    tma_load_3d(dst + BM * 128, &kmap, full, c * KC, 0, bh, leader);
  };
  for (int c = 0; c < nch && c < S_STAGES; ++c) issue(c);
  // V after the first q, k chunks, which the products need first
  const int nkc = (L + KC - 1) / KC, boxes = min(BOXES, (NDv + 63) / 64);
  mbar_arrive_expect_tx(v_full, nkc * boxes * TILE, leader);
  for (int c = 0; c < nkc; ++c)
    for (int b = 0; b < boxes; ++b)
      tma_load_3d(v_tiles + (c * BOXES + b) * TILE, &vmap, v_full, 64 * b, c * KC, bh, leader);

  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  logits_loop<64, BN>(s, base, bars, nch, 64 * wg, lane, issue);

  // softmax over the valid keys: each half's row max, then the row's; p =
  // exp(s - m) rounded to bf16 into this half of P; l sums the unrounded p
  const int k0 = 64 * wg + 2 * t;  // key of s[0] (s[4n + 2h + e]: key k0 + 8n + e)
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * n + e < L) mx = fmaxf(mx, s[4 * n + 2 * h + e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (t == 0) red[(2 * wg) * BM + r + 8 * h] = mx;
  }
  named_barrier(1, NT2);
  unsigned char* p_half = smem + P_OFF + wg * TILE;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    m[h] = fmaxf(red[row], red[2 * BM + row]);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = k0 + 8 * n + e < L ? expf(s[4 * n + 2 * h + e] - m[h]) : 0.f;
        sum += p[e];
      }
      const int kk = 8 * n + 2 * t;  // key within the half, even
      *reinterpret_cast<uint32_t*>(p_half + row * 128 + ((((kk >> 3) ^ (row & 7)) << 4) |
                                                         ((kk & 7) << 1))) = pack_bf16(p[0], p[1]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (t == 0) red[(2 * wg + 1) * BM + row] = sum;
  }
  fence_proxy_async();
  named_barrier(1, NT2);
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = red[BM + r + 8 * h] + red[3 * BM + r + 8 * h];

  float o[HALF / 2];
#pragma unroll
  for (int e = 0; e < HALF / 2; ++e) o[e] = 0.f;
  mbar_wait(v_full, 0);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks)
    if (16 * ks < L)
      Wgmma<HALF>::template ss<1>(
          o, desc_sw128(p_tiles + (ks / 4) * TILE + (ks % 4) * 32),
          desc_sw128_mn(v_tiles + ((ks / 4) * BOXES + wg * BOXES / 2) * TILE + (ks % 4) * 2048,
                        TILE),
          1);
  wgmma_commit();
  wgmma_wait<0>();

  if (wg == 0 && t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (i0 + r + 8 * h < L) lse[(size_t)bh * L + i0 + r + 8 * h] = m[h] + logf(l[h]);
  // through the ring's shared memory, free since the logits
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_out<HALF, BC + 8, NT2>(reinterpret_cast<__nv_bfloat16*>(smem), o, inv, wg * HALF, out,
                               bh, i0, 0, BC, L, NDv);
}

// the dynamic shared-memory size of a kernel, set once a process
template <typename K>
cudaError_t set_smem_once(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <int BN>
cudaError_t launch_logits(const CUtensorMap& qmap, const CUtensorMap& kmap, float* s,
                          float2* stats, int BH, int L, int LS, int ND, cudaStream_t st) {
  static bool ready = false;
  cudaError_t err = set_smem_once(tied_logits_kernel<BN>, logits_smem(BN), ready);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BM - 1) / BM, (L + BN - 1) / BN, BH);
  tied_logits_kernel<BN><<<grid, NT, logits_smem(BN), st>>>(qmap, kmap, s, stats, L, LS, ND);
  return cudaGetLastError();
}

template <int BC>
cudaError_t launch_pv(const float* s, const float2* stats, int tiles, const CUtensorMap& vmap,
                      __nv_bfloat16* out, float* lse, int BH, int L, int LS, int NDv,
                      cudaStream_t st) {
  static bool ready = false;
  cudaError_t err = set_smem_once(tied_pv_kernel<BC>, pv_smem(BC), ready);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BM - 1) / BM, (NDv + BC - 1) / BC, BH);
  tied_pv_kernel<BC><<<grid, NT, pv_smem(BC), st>>>(s, stats, tiles, vmap, out, lse, L, LS, NDv);
  return cudaGetLastError();
}

// a bf16 (BH, L, D) tensor as a 3-D map of boxes of 64 features x `rows` rows
cudaError_t map_rows(CUtensorMap* map, const void* t, int BH, int L, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {KC, (cuuint32_t)rows, 1};
  return encode_bf16_sw128(map, t, 3, dims, strides, box);
}

template <int BC>
cudaError_t launch_fused(const CUtensorMap& qmap, const CUtensorMap& kmap,
                         const CUtensorMap& vmap, __nv_bfloat16* out, float* lse, int BH, int L,
                         int ND, int NDv, cudaStream_t st) {
  static bool ready = false;
  cudaError_t err = set_smem_once(tied_fused_kernel<BC>, fused_smem(BC), ready);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BM - 1) / BM, 1, BH);
  tied_fused_kernel<BC><<<grid, NT2, fused_smem(BC), st>>>(qmap, kmap, vmap, out, lse, L, ND,
                                                            NDv);
  return cudaGetLastError();
}

// L <= 128 and 64 < NDv <= 256: one launch (tied_fused_kernel), no scratch. Else
// scratch: the logits (BH, L, LS) and then each logits tile's row statistics
// (BH, L, tiles) float2, tiles = ceil(L / BN) <= ceil(L / 64)
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        __nv_bfloat16* out, float* lse, float* scratch, int BH, int L, int ND,
                        int NDv, cudaStream_t st) {
  if (ND % 8 || NDv % 8 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err;
  if (L <= 128 && NDv > 64 && NDv <= 256) {
    if ((err = map_rows(&qmap, q, BH, L, ND, BM)) != cudaSuccess) return err;
    if ((err = map_rows(&kmap, k, BH, L, ND, 128)) != cudaSuccess) return err;
    if ((err = map_rows(&vmap, v, BH, L, NDv, KC)) != cudaSuccess) return err;
    if (NDv <= 128) return launch_fused<128>(qmap, kmap, vmap, out, lse, BH, L, ND, NDv, st);
    return launch_fused<256>(qmap, kmap, vmap, out, lse, BH, L, ND, NDv, st);
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int LS = (L + 3) & ~3, nq = (L + BM - 1) / BM, full = 2 * sm_count();
  const bool wide_n = (long long)nq * ((L + 127) / 128) * BH >= full;
  const int tiles = wide_n ? (L + 127) / 128 : (L + 63) / 64;
  float2* stats = reinterpret_cast<float2*>(scratch + (size_t)BH * L * LS);
  const int BC = NDv <= 64 ? 64 : ((long long)nq * ((NDv + 255) / 256) * BH >= full ? 256 : 128);
  if ((err = map_rows(&qmap, q, BH, L, ND, BM)) != cudaSuccess) return err;
  if ((err = map_rows(&kmap, k, BH, L, ND, wide_n ? 128 : 64)) != cudaSuccess) return err;
  if ((err = map_rows(&vmap, v, BH, L, NDv, KC)) != cudaSuccess) return err;
  err = wide_n ? launch_logits<128>(qmap, kmap, scratch, stats, BH, L, LS, ND, st)
               : launch_logits<64>(qmap, kmap, scratch, stats, BH, L, LS, ND, st);
  if (err != cudaSuccess) return err;
  if (BC == 256)
    return launch_pv<256>(scratch, stats, tiles, vmap, out, lse, BH, L, LS, NDv, st);
  if (BC == 128)
    return launch_pv<128>(scratch, stats, tiles, vmap, out, lse, BH, L, LS, NDv, st);
  return launch_pv<64>(scratch, stats, tiles, vmap, out, lse, BH, L, LS, NDv, st);
}

}  // namespace tma_wg

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. scratch: bfloat16's float32 scratch of
// BH * L * (LS + 2 * ceil(L / 64)) values (LS = L rounded up to 4), null for
// float32 and for bfloat16 at L <= 128, 64 < NDv <= 256 (one launch). Returns the
// cudaError_t of the launch.
int tied_attention_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, float* scratch, int BH, int L, int ND, int NDv, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    auto* qf = static_cast<const float*>(q);
    auto* kf = static_cast<const float*>(k);
    auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(out);
    return NDv > F_NT ? launch_f32<2>(qf, kf, vf, of, lse, BH, L, ND, NDv, st)
                      : launch_f32<1>(qf, kf, vf, of, lse, BH, L, ND, NDv, st);
  }
  if (dtype == 1)
    return tma_wg::launch_bf16(static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<__nv_bfloat16*>(out), lse, scratch, BH, L, ND, NDv, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
