// Tied row attention, backward (kernel G), for Hopper (sm_90a).
//
// Replaces rosettafold_tpu/ops/pallas/tied_attention.py `_bwd` (:222): its
// two pl.pallas_calls, `_dkv_kernel` (:241) and `_dq_kernel` (:273). From
// the forward's saved (q, k, v, out, lse) and the cotangent g:
//
//   dsum[i]  = sum_c g[i, c] out[i, c]                    (float32)
//   p[i, j]  = exp(q_i . k_j - lse[i])                    (float32, recomputed)
//   ds[i, j] = p[i, j] (g_i . v_j - dsum[i])
//   dv = p^T g,  dk = ds^T q,  dq = ds k   (dq from ds rounded to k's dtype)
//
// Layouts: q, k, dq, dk (BH, L, ND); v, g, dv (BH, L, NDv); lse, dsum (BH, L).
// Ragged L is masked in the kernels: query rows past L contribute nothing,
// keys past L are never stored. No padding copies of the inputs.
//
// What bounds it on this card: bytes at the training shape (B*H = 48, L =
// 128, ND = NDv = 512: 31 MB of inputs and 19 MB of outputs against 6 GFLOP
// of bf16 products), operations as L grows (6 L^2 ND multiply-adds at ND =
// NDv, 8 with the split below). The contraction width ND = N * 32 grows with
// the MSA depth (256 at N = 8, 2048 at N = 64), so no block can hold a
// 64-key tile's dk and dv over the whole ND. The bfloat16 path (training's)
// therefore forms the two L x L products once and the three outputs from
// them, in three launches, all on wgmma with operands fed by TMA:
//  1. dsum, one warp per row;
//  2. tied_bwd_sdp_kernel: per (64-row query tile, 64-key tile, bh), S = q . k^T and
//     dP = g . v^T (m64n64k16, bf16 in, float32 accumulate), q / k then g /
//     v streamed in 64-wide chunks of ND and NDv through one 4-stage ring.
//     The epilogue forms p and ds in registers and writes each as a bf16
//     high part and a bf16 remainder (about 16 bits of the float32 value) to
//     scratch (4 arrays of (BH, L, LS) bf16, LS = L rounded up to 8);
//  3. tied_bwd_grad_kernel: per (64-row tile, bh, 128-column slice) one of
//       dv = p^T g and dk = ds^T q (M = keys; p or ds the A operand read
//         MN-major as TMA lays the scratch rows down, two products, high and
//         low, against the bf16 g or q: JAX forms these from the float32 p
//         and ds);
//       dq = ds k (M = queries; ds's high part, which is ds rounded to k's
//         dtype as JAX rounds it, K-major);
//     the K dimension (query or key positions) streamed in 64-row chunks
//     through a 3-stage ring; 16-byte row stores through shared memory.
// Each logit and each g . v^T is computed once, whatever ND: the column
// slices of step 3 share the scratch (which L2 holds at the training shape:
// 6.3 MB) instead of recomputing both 64 x 64 products over the full width
// for every 128-column slice of dk, dv and dq (S 12 times and g . v^T 8
// times at ND = NDv = 512). At large L the scratch is B*H*L^2 * 8 bytes: the
// wrapper bounds it and the host loop here runs launches 2 and 3 over chunks
// of bh (`bh_chunk`).
// float32 (the parity path) runs on the CUDA cores: per-slice recomputation,
// exact float32 products.

#include "common.cuh"
#include "hopper.cuh"

using namespace rf;

namespace {

// ---------------------------------------------------------------- float32 --
// One block per (tile, bh, 128-column slice), recomputing the 64 x 64 tiles
// of p (and ds) for its slice, the contraction in 64-wide chunks.

constexpr int BT = 64;   // query rows or keys per tile
constexpr int KC = 64;   // contraction chunk (feature columns)
constexpr int DC = 128;  // output columns per block
constexpr int NTHREADS = 256;
constexpr int LDS = BT + 4;   // float tile row stride
constexpr int LDC = KC + 4;   // staged chunk row stride
constexpr int LDT = BT + 4;   // transposed operand row stride
// Ss, Gs (logits, g . v^T) | As, Bs (chunks) | Mt (p or ds, transposed) | Xt
constexpr size_t F32_SMEM = sizeof(float) * (2 * BT * LDS + 2 * BT * LDC + BT * LDT + DC * LDT);

// rows [r0, r0 + BT) x columns [c0, c0 + KC) of a (., ld) matrix, zero at
// rows >= nrows or columns >= ncols (ncols % 4 == 0)
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, long long ld, int r0,
                                            int nrows, int c0, int ncols) {
  constexpr int PER = KC / 4;
  for (int e = threadIdx.x; e < BT * PER; e += NTHREADS) {
    const int r = e / PER, c = e % PER * 4;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < nrows && c0 + c < ncols)
      u = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * ld + c0 + c);
    *reinterpret_cast<float4*>(dst + r * LDC + c) = u;
  }
}

// Out[r][c] = X[x0 + r] . Y[y0 + c] over `ncols` features (ld LDS); rows
// past L read as zero. Whole block; 8 warps as 4 (rows) x 2 (columns).
__device__ void tile_xyT(float* Out, const float* X, const float* Y, long long ld, int x0,
                         int y0, int L, int ncols, float* As, float* Bs) {
  const int warp = threadIdx.x >> 5, rg = warp & 3, cg = warp >> 2;
  float acc[4][4];
  zero(acc);
  for (int c0 = 0; c0 < ncols; c0 += KC) {
    __syncthreads();
    stage_chunk(As, X, ld, x0, L, c0, ncols);
    stage_chunk(Bs, Y, ld, y0, L, c0, ncols);
    __syncthreads();
    warp_gemm<4>(acc, As + rg * 16 * LDC, LDC, Bs + cg * 32 * LDC, LDC, KC);
  }
  for_each(acc, [&](int r, int c, float v) { Out[(rg * 16 + r) * LDS + cg * 32 + c] = v; });
}

// Xt[c][i] = X[r0 + i][c0 + c] for a DC x BT slice, zero outside (L, ncols)
__device__ __forceinline__ void stage_t(float* Xt, const float* X, long long ld, int r0, int L,
                                        int c0, int ncols) {
  for (int e = threadIdx.x; e < BT * (DC / 4); e += NTHREADS) {
    const int i = e % BT, c = e / BT * 4;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + i < L && c0 + c < ncols)
      u = *reinterpret_cast<const float4*>(X + (long long)(r0 + i) * ld + c0 + c);
    Xt[c * LDT + i] = u.x;
    Xt[(c + 1) * LDT + i] = u.y;
    Xt[(c + 2) * LDT + i] = u.z;
    Xt[(c + 3) * LDT + i] = u.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
tied_bwd_dsum_kernel(const T* __restrict__ g, const T* __restrict__ out,
                     float* __restrict__ dsum, long long rows, int NDv) {
  const long long row = (long long)blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = 8 * lane; c < NDv; c += 256) {  // NDv % 8 == 0: 8 values a load
    float a[8], b[8];
    load8(a, g + row * NDv + c);
    load8(b, out + row * NDv + c);
#pragma unroll
    for (int u = 0; u < 8; ++u) s += a[u] * b[u];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) dsum[row] = s;
}

// One block per (key tile, bh, column slice): blockIdx.z < nzk is a slice of
// dk (ds^T q), else of dv (p^T g).
__global__ void __launch_bounds__(NTHREADS)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ dsum, const float* __restrict__ lse,
               float* __restrict__ dk, float* __restrict__ dv, int L, int ND, int NDv, int nzk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ss = reinterpret_cast<float*>(smem_raw);  // [BT][LDS] logits
  float* Gs = Ss + BT * LDS;                        // [BT][LDS] g . v^T
  float* As = Gs + BT * LDS;                        // [BT][LDC]
  float* Bs = As + BT * LDC;                        // [BT][LDC]
  float* Mt = Bs + BT * LDC;                        // [BT keys][LDT] p^T or ds^T
  float* Xt = Mt + BT * LDT;                        // [DC][LDT] q^T or g^T slice

  const int tid = threadIdx.x, warp = tid >> 5, rg = warp & 3, cg = warp >> 2;
  const int j0 = blockIdx.x * BT;
  const long long bh = blockIdx.y;
  const bool is_dk = (int)blockIdx.z < nzk;
  const int c0 = (is_dk ? blockIdx.z : blockIdx.z - nzk) * DC;
  const int ncol = is_dk ? ND : NDv;
  const float* qb = q + bh * L * ND;
  const float* kb = k + bh * L * ND;
  const float* vb = v + bh * L * NDv;
  const float* gb = g + bh * L * NDv;
  const float* lse_b = lse + bh * L;
  const float* dsum_b = dsum + bh * L;

  float acc[8][4];  // keys rg*16.., columns cg*64.. of the slice
  zero(acc);
  for (int i0 = 0; i0 < L; i0 += BT) {
    tile_xyT(Ss, qb, kb, ND, i0, j0, L, ND, As, Bs);
    if (is_dk) tile_xyT(Gs, gb, vb, NDv, i0, j0, L, NDv, As, Bs);
    __syncthreads();
    for (int e = tid; e < BT * BT; e += NTHREADS) {
      const int i = e % BT, j = e / BT, gi = i0 + i;
      float val = 0.f;
      if (gi < L) {
        val = expf(Ss[i * LDS + j] - lse_b[gi]);
        if (is_dk) val *= Gs[i * LDS + j] - dsum_b[gi];
      }
      Mt[j * LDT + i] = val;
    }
    stage_t(Xt, is_dk ? qb : gb, ncol, i0, L, c0, ncol);
    __syncthreads();
    warp_gemm<8>(acc, Mt + rg * 16 * LDT, LDT, Xt + cg * 64 * LDT, LDT, BT);
  }
  float* ob = (is_dk ? dk + bh * L * ND : dv + bh * L * NDv);
  for_each(acc, [&](int r, int c, float val) {
    const int gj = j0 + rg * 16 + r, gc = c0 + cg * 64 + c;
    if (gj < L && gc < ncol) ob[(long long)gj * ncol + gc] = val;
  });
}

// One block per (query tile, bh, column slice of dq), walking the key tiles.
__global__ void __launch_bounds__(NTHREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ dsum, const float* __restrict__ lse,
              float* __restrict__ dq, int L, int ND, int NDv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ss = reinterpret_cast<float*>(smem_raw);
  float* Gs = Ss + BT * LDS;
  float* As = Gs + BT * LDS;
  float* Bs = As + BT * LDC;
  float* Ms = Bs + BT * LDC;  // [BT queries][LDT] ds
  float* Kt = Ms + BT * LDT;  // [DC][LDT] k^T slice

  const int tid = threadIdx.x, warp = tid >> 5, rg = warp & 3, cg = warp >> 2;
  const int i0 = blockIdx.x * BT;
  const long long bh = blockIdx.y;
  const int c0 = blockIdx.z * DC;
  const float* qb = q + bh * L * ND;
  const float* kb = k + bh * L * ND;
  const float* vb = v + bh * L * NDv;
  const float* gb = g + bh * L * NDv;
  const float* lse_b = lse + bh * L;
  const float* dsum_b = dsum + bh * L;

  float acc[8][4];  // queries rg*16.., columns cg*64.. of the slice
  zero(acc);
  for (int j0 = 0; j0 < L; j0 += BT) {
    tile_xyT(Ss, qb, kb, ND, i0, j0, L, ND, As, Bs);
    tile_xyT(Gs, gb, vb, NDv, i0, j0, L, NDv, As, Bs);
    __syncthreads();
    for (int e = tid; e < BT * BT; e += NTHREADS) {
      const int i = e / BT, j = e % BT, gi = i0 + i;
      float val = 0.f;
      if (gi < L && j0 + j < L)
        val = expf(Ss[i * LDS + j] - lse_b[gi]) * (Gs[i * LDS + j] - dsum_b[gi]);
      Ms[i * LDT + j] = val;
    }
    stage_t(Kt, kb, ND, j0, L, c0, ND);
    __syncthreads();
    warp_gemm<8>(acc, Ms + rg * 16 * LDT, LDT, Kt + cg * 64 * LDT, LDT, BT);
  }
  float* ob = dq + bh * L * ND;
  for_each(acc, [&](int r, int c, float val) {
    const int gi = i0 + rg * 16 + r, gc = c0 + cg * 64 + c;
    if (gi < L && gc < ND) ob[(long long)gi * ND + gc] = val;
  });
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* out,
                       const float* lse, const float* g, float* dsum, float* dq, float* dk,
                       float* dv, int BH, int L, int ND, int NDv, cudaStream_t st) {
  cudaError_t err;
  if ((err = set_smem(dkv_f32_kernel, F32_SMEM)) != cudaSuccess) return err;
  if ((err = set_smem(dq_f32_kernel, F32_SMEM)) != cudaSuccess) return err;
  const long long rows = (long long)BH * L;
  const unsigned rb = (unsigned)((rows + NTHREADS / 32 - 1) / (NTHREADS / 32));
  tied_bwd_dsum_kernel<float><<<rb, NTHREADS, 0, st>>>(g, out, dsum, rows, NDv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (L + BT - 1) / BT;
  const int nzk = (ND + DC - 1) / DC, nzv = (NDv + DC - 1) / DC;
  dkv_f32_kernel<<<dim3(tiles, BH, nzk + nzv), NTHREADS, F32_SMEM, st>>>(q, k, v, g, dsum, lse,
                                                                        dk, dv, L, ND, NDv, nzk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_f32_kernel<<<dim3(tiles, BH, nzk), NTHREADS, F32_SMEM, st>>>(q, k, v, g, dsum, lse, dq, L,
                                                                  ND, NDv);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16 --

namespace wg {

using namespace rf::hopper;

constexpr int NT = 128;         // one warpgroup
constexpr int TILE = 64 * 128;  // a 64-row x 64-column bf16 box (bytes)
constexpr int S_STAGES = 4;  // tied_bwd_sdp_kernel's ring: a q (or g) and a k (or v) box
constexpr int G_STAGES = 3;  // tied_bwd_grad_kernel's ring
constexpr int BC = 128;      // tied_bwd_grad_kernel's output columns a block
constexpr int G_STAGE = 2 * TILE + (BC / 64) * TILE;  // A high, A low, B boxes
constexpr size_t SDP_SMEM = 1024 + S_STAGES * 2 * TILE + 16 * S_STAGES;
constexpr size_t GRAD_SMEM = 1024 + G_STAGES * G_STAGE + 16 * G_STAGES;
static_assert(64 * (BC + 8) * 2 <= G_STAGES * G_STAGE, "the output tile fits the ring");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// acc += A . B^T over chunks [c0, c1) of the ring (stage c % S_STAGES at
// base + stage * 2 TILE: the A box, then the B box, both K-major; full /
// empty barriers at bars): one chunk's products run while the next chunk's
// are issued; a stage is released, and chunk c + S_STAGES issued, once its
// products are done
template <typename Issue>
__device__ __forceinline__ void sdp_loop(float (&acc)[32], uint32_t base, uint32_t bars, int c0,
                                         int c1, int nch, int lane, Issue& issue) {
  for (int c = c0; c < c1; ++c) {
    const int st = c % S_STAGES;
    mbar_wait(bars + 8 * st, (c / S_STAGES) & 1);
    const uint32_t at = base + st * 2 * TILE, bt = at + TILE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Wgmma<64>::ss(acc, desc_sw128(at + ks * 32), desc_sw128(bt + ks * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1's products are done
    if (c > c0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S_STAGES + (c - 1) % S_STAGES));
      if (c - 1 + S_STAGES < nch) issue(c - 1 + S_STAGES);
    }
  }
  wgmma_wait<0>();
  __syncwarp();
  if (lane == 0) mbar_arrive(bars + 8 * (S_STAGES + (c1 - 1) % S_STAGES));
  if (c1 - 1 + S_STAGES < nch) issue(c1 - 1 + S_STAGES);
}

// p and ds of a 64-query x 64-key tile into the scratch: ph, pl, dh, dl
// (each (bh, L, LS) bf16), the high part and remainder of p and of ds
__global__ void __launch_bounds__(NT)
tied_bwd_sdp_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse,
                    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ scratch, int L,
                    int LS, int ND, int NDv, int bh0, long long plane) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(align1024(smem_raw));
  const uint32_t bars = base + S_STAGES * 2 * TILE;  // full[S_STAGES], empty[S_STAGES]
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * 64, bhl = blockIdx.z, bh = bh0 + bhl;
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

  // chunks [0, nq) are q / k chunks of ND, [nq, nq + nv) g / v chunks of NDv
  const int nq = (ND + 63) / 64, nch = nq + (NDv + 63) / 64;
  auto issue = [&](int c) {
    const int st = c % S_STAGES;
    mbar_wait(bars + 8 * (S_STAGES + st), ((c / S_STAGES) & 1) ^ 1);
    const uint32_t dst = base + st * 2 * TILE, full = bars + 8 * st;
    mbar_arrive_expect_tx(full, 2 * TILE, leader);
    const bool qk = c < nq;
    const int col = 64 * (qk ? c : c - nq);
    tma_load_3d(dst, qk ? &qmap : &gmap, full, col, i0, bh, leader);
    tma_load_3d(dst + TILE, qk ? &kmap : &vmap, full, col, j0, bh, leader);
  };
  for (int c = 0; c < nch && c < S_STAGES; ++c) issue(c);

  float s[32], dp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
  sdp_loop(s, base, bars, 0, nq, nch, lane, issue);
  sdp_loop(dp, base, bars, nq, nch, nch, lane, issue);

  // s[4n + 2h + e], dp[..]: row i0 + 16 warp + g + 8h, key j0 + 8n + 2t + e
  const int g = lane >> 2, t = lane & 3;
  const size_t off = (size_t)bhl * L * LS;
  __nv_bfloat16* ph = scratch + off;
  __nv_bfloat16* pl = ph + plane;
  __nv_bfloat16* dh = pl + plane;
  __nv_bfloat16* dl = dh + plane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = i0 + warp * 16 + g + 8 * h;
    if (row >= L) continue;
    const float lr = lse[(size_t)bh * L + row], dr = dsum[(size_t)bh * L + row];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = j0 + 8 * n + 2 * t;  // even; j + 1 < LS
      if (j >= L) continue;
      float p[2], d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = j + e < L;
        p[e] = in ? expf(s[4 * n + 2 * h + e] - lr) : 0.f;
        d[e] = p[e] * (dp[4 * n + 2 * h + e] - dr);
      }
      const __nv_bfloat162 p_hi = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 d_hi = __floats2bfloat162_rn(d[0], d[1]);
      const float2 pf = __bfloat1622float2(p_hi), df = __bfloat1622float2(d_hi);
      const size_t at = (size_t)row * LS + j;
      *reinterpret_cast<__nv_bfloat162*>(ph + at) = p_hi;
      *reinterpret_cast<__nv_bfloat162*>(pl + at) = __floats2bfloat162_rn(p[0] - pf.x, p[1] - pf.y);
      *reinterpret_cast<__nv_bfloat162*>(dh + at) = d_hi;
      *reinterpret_cast<__nv_bfloat162*>(dl + at) = __floats2bfloat162_rn(d[0] - df.x, d[1] - df.y);
    }
  }
}

// One block per (64-row tile, bh, BC-column slice): blockIdx.z < nzk a slice
// of dk = ds^T q, < nzk + nzv of dv = p^T g, else of dq = ds k. The K chunks
// (64 positions) arrive through the ring: the A box (or boxes: high and
// remainder) from the scratch maps, then the B boxes of the slice (MN-major:
// rows are K, 64 columns a box, LBO = TILE).
__global__ void __launch_bounds__(NT)
tied_bwd_grad_kernel(const __grid_constant__ CUtensorMap phmap,
                     const __grid_constant__ CUtensorMap plmap,
                     const __grid_constant__ CUtensorMap dhmap,
                     const __grid_constant__ CUtensorMap dlmap,
                     const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap gmap, __nv_bfloat16* __restrict__ dq,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int L,
                     int ND, int NDv, int nzk, int nzv, int bh0) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + G_STAGES * G_STAGE;  // full[G_STAGES], empty[G_STAGES]
  const int r0 = blockIdx.x * 64, bhl = blockIdx.y, bh = bh0 + bhl, z = blockIdx.z;
  const int role = z < nzk ? 0 : (z < nzk + nzv ? 1 : 2);  // dk, dv, dq
  const int c0 = BC * (role == 0 ? z : (role == 1 ? z - nzk : z - nzk - nzv));
  const int ncol = role == 1 ? NDv : ND;
  const CUtensorMap* amap_hi = role == 1 ? &phmap : &dhmap;
  const CUtensorMap* amap_lo = role == 1 ? &plmap : &dlmap;
  const CUtensorMap* bmap = role == 0 ? &qmap : (role == 1 ? &gmap : &kmap);
  const int lane = threadIdx.x & 31;
  const uint32_t leader = threadIdx.x == 0;
  if (leader) {
    for (int st = 0; st < G_STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (G_STAGES + st), NT / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int nkc = (L + 63) / 64;
  const int boxes = min(BC / 64, (ncol - c0 + 63) / 64);  // boxes holding columns < ncol
  const int a_boxes = role == 2 ? 1 : 2;
  auto issue = [&](int c) {
    const int st = c % G_STAGES;
    mbar_wait(bars + 8 * (G_STAGES + st), ((c / G_STAGES) & 1) ^ 1);
    const uint32_t dst = base + st * G_STAGE, full = bars + 8 * st;
    mbar_arrive_expect_tx(full, (a_boxes + boxes) * TILE, leader);
    // dk, dv: A = scratch rows (queries) c*64.., keys r0..: MN-major (M = keys)
    // dq:     A = scratch rows (queries) r0.., keys c*64..: K-major
    const int ax = role == 2 ? 64 * c : r0, ay = role == 2 ? r0 : 64 * c;
    tma_load_3d(dst, amap_hi, full, ax, ay, bhl, leader);
    tma_load_3d(dst + TILE, amap_lo, full, ax, ay, bhl, leader && role != 2);
    for (int b = 0; b < boxes; ++b)
      tma_load_3d(dst + (2 + b) * TILE, bmap, full, c0 + 64 * b, 64 * c, bh, leader);
  };
  for (int c = 0; c < nkc && c < G_STAGES; ++c) issue(c);

  float acc[BC / 2];
#pragma unroll
  for (int e = 0; e < BC / 2; ++e) acc[e] = 0.f;
  for (int c = 0; c < nkc; ++c) {
    const int st = c % G_STAGES;
    mbar_wait(bars + 8 * st, (c / G_STAGES) & 1);
    const uint32_t at = base + st * G_STAGE, bt = at + 2 * TILE;
    wgmma_fence();
    if (role == 2) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<BC>::ss<1, 0>(acc, desc_sw128(at + ks * 32), desc_sw128_mn(bt + ks * 2048, TILE),
                            1);
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wgmma<BC>::ss<1, 1>(acc, desc_sw128_mn(at + ks * 2048, TILE),
                            desc_sw128_mn(bt + ks * 2048, TILE), 1);
        Wgmma<BC>::ss<1, 1>(acc, desc_sw128_mn(at + TILE + ks * 2048, TILE),
                            desc_sw128_mn(bt + ks * 2048, TILE), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (G_STAGES + st));
    if (c + G_STAGES < nkc) issue(c + G_STAGES);
  }

  // the 64 x BC tile through the ring's shared memory (free since the last
  // chunk), then whole 16-byte vectors of rows < L and columns < ncol
  constexpr int LDO = BC + 8;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int t = lane & 3, r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  __syncthreads();
#pragma unroll
  for (int n = 0; n < BC / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8 * h) * LDO + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  __syncthreads();
  __nv_bfloat16* ob = role == 0 ? dk : (role == 1 ? dv : dq);
  const int nrows = min(64, L - r0), vecs = min(BC, ncol - c0) / 8;
  for (int e = threadIdx.x; e < nrows * vecs; e += NT) {
    const int row = e / vecs, c = (e % vecs) * 8;
    *reinterpret_cast<uint4*>(ob + ((size_t)bh * L + r0 + row) * ncol + c0 + c) =
        *reinterpret_cast<const uint4*>(tile + row * LDO + c);
  }
}

// a bf16 (n, L, D) tensor (row stride `ld` elements) as a 3-D map of 64 x 64 boxes
cudaError_t map_rows(CUtensorMap* map, const void* t, int n, int L, int D, int ld) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)L * ld * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_bf16_sw128(map, t, 3, dims, strides, box);
}

template <typename K>
cudaError_t set_smem_once(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

// scratch: 4 * bh_chunk * L * LS bf16 (LS = L rounded up to 8)
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        const __nv_bfloat16* out, const float* lse, const __nv_bfloat16* g,
                        float* dsum, __nv_bfloat16* scratch, int bh_chunk, __nv_bfloat16* dq,
                        __nv_bfloat16* dk, __nv_bfloat16* dv, int BH, int L, int ND, int NDv,
                        cudaStream_t st) {
  if (ND % 8 || NDv % 8 || bh_chunk < 1 || scratch == nullptr ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g | (uintptr_t)scratch) % 16)
    return cudaErrorInvalidValue;
  static bool ready_sdp = false, ready_grad = false;
  cudaError_t err;
  if ((err = set_smem_once(tied_bwd_sdp_kernel, SDP_SMEM, ready_sdp)) != cudaSuccess) return err;
  if ((err = set_smem_once(tied_bwd_grad_kernel, GRAD_SMEM, ready_grad)) != cudaSuccess) return err;
  const long long rows = (long long)BH * L;
  const unsigned rb = (unsigned)((rows + NTHREADS / 32 - 1) / (NTHREADS / 32));
  tied_bwd_dsum_kernel<__nv_bfloat16><<<rb, NTHREADS, 0, st>>>(g, out, dsum, rows, NDv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap, gmap;
  if ((err = map_rows(&qmap, q, BH, L, ND, ND)) != cudaSuccess) return err;
  if ((err = map_rows(&kmap, k, BH, L, ND, ND)) != cudaSuccess) return err;
  if ((err = map_rows(&vmap, v, BH, L, NDv, NDv)) != cudaSuccess) return err;
  if ((err = map_rows(&gmap, g, BH, L, NDv, NDv)) != cudaSuccess) return err;
  const int LS = (L + 7) & ~7, tiles = (L + 63) / 64;
  const long long plane = (long long)bh_chunk * L * LS;
  const int nzk = (ND + BC - 1) / BC, nzv = (NDv + BC - 1) / BC;
  for (int bh0 = 0; bh0 < BH; bh0 += bh_chunk) {
    const int n = min(bh_chunk, BH - bh0);
    tied_bwd_sdp_kernel<<<dim3(tiles, tiles, n), NT, SDP_SMEM, st>>>(
        qmap, kmap, gmap, vmap, lse, dsum, scratch, L, LS, ND, NDv, bh0, plane);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    CUtensorMap sm[4];
    for (int a = 0; a < 4; ++a)
      if ((err = map_rows(&sm[a], scratch + a * plane, n, L, L, LS)) != cudaSuccess) return err;
    tied_bwd_grad_kernel<<<dim3(tiles, n, 2 * nzk + nzv), NT, GRAD_SMEM, st>>>(
        sm[0], sm[1], sm[2], sm[3], qmap, kmap, gmap, dq, dk, dv, L, ND, NDv, nzk, nzv, bh0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace wg

}  // namespace

extern "C" {

// q, k, dq, dk (BH, L, ND); v, out, g, dv (BH, L, NDv); lse (BH, L) float32
// from the forward; dsum (BH, L) float32 scratch. ND % 8 == 0, NDv % 8 == 0,
// rows 16-byte aligned. dtype: 0 float32, 1 bfloat16. bfloat16 also takes
// `scratch`, 4 * bh_chunk * L * LS bf16 (LS = L rounded up to 8; 16-byte
// aligned), and runs its p / ds launches over chunks of bh_chunk (b, head)s.
int tied_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                       const float* lse, const void* g, float* dsum, void* scratch,
                       int bh_chunk, void* dq, void* dk, void* dv, int BH, int L, int ND,
                       int NDv, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH > 65535 || L <= 0 || ND <= 0 || NDv <= 0 || ND % 8 || NDv % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<const float*>(out), lse,
                      static_cast<const float*>(g), dsum, static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv), BH, L, ND, NDv, st);
  if (dtype == 1)
    return wg::launch_bf16(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(out), lse, static_cast<const bf16*>(g), dsum,
        static_cast<bf16*>(scratch), bh_chunk, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), BH, L, ND, NDv, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
