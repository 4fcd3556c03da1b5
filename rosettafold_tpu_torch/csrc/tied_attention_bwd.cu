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
// Ragged L is masked in the kernel: query rows past L contribute nothing,
// keys past L are never stored (dk/dv) or get p = 0 (dq). No padding copies.
//
// What bounds it on this card: operations (the logits and g.v^T are
// recomputed per tile; 6 L^2 ND multiply-adds in all at ND = NDv). The
// contraction width ND = N * 32 grows with the MSA depth (256 at N = 8, 2048
// at N = 64), so a block's float32 dk/dv accumulators (64 keys x ND) would
// outgrow registers and shared memory: as in the forward kernel, each block
// owns one 128-column slice of dk, dv or dq and recomputes the 64 x 64 tiles
// of p (and ds) for it, the contraction running in 64-wide chunks through
// shared memory. Three launches:
//   1. dsum, one warp per row;
//   2. dk/dv: one block per (key tile, bh, column slice of [dk | dv]), walking
//      the query tiles, accumulating in float32 registers;
//   3. dq: one block per (query tile, bh, column slice of dq), walking the
//      key tiles.
// bfloat16 runs every product on the tensor cores (mma.sync m16n8k16, float32
// accumulation). JAX forms dk and dv from the float32 p and ds: here each is
// split into a bf16 high part and a bf16 remainder, two products against the
// bf16 q or g, which keeps about 16 bits of p and ds. float32 runs on the CUDA
// cores. Pipelined staging and wgmma are later work.

#include "common.cuh"

using namespace rf;

namespace {

constexpr int BT = 64;   // query rows or keys per tile
constexpr int KC = 64;   // contraction chunk (feature columns)
constexpr int DC = 128;  // output columns per block
constexpr int NTHREADS = 256;
constexpr int LDS = BT + 4;  // float tile row stride

template <typename T>
struct Cfg {
  static constexpr int PAD = 16 / sizeof(T);  // one 16-byte vector
  static constexpr int LDC = KC + PAD;        // staged chunk row stride
  static constexpr int LDT = BT + PAD;        // transposed operand row stride
  static constexpr bool SPLIT = sizeof(T) == 2;
  // Ss, Gs (float) | As, Bs (chunks) | Mt, Ml (p or ds, transposed) | Xt
  static constexpr size_t SMEM = sizeof(float) * 2 * BT * LDS +
                                 sizeof(T) * (2 * BT * LDC + 2 * BT * LDT + DC * LDT);
};

// rows [r0, r0 + BT) x columns [c0, c0 + KC) of a (., ld) matrix, zero at
// rows >= nrows or columns >= ncols (ncols % vector width == 0)
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src, long long ld, int r0,
                                            int nrows, int c0, int ncols) {
  constexpr int V = 16 / sizeof(T), PER = KC / V;
  for (int e = threadIdx.x; e < BT * PER; e += NTHREADS) {
    const int r = e / PER, c = e % PER * V;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c0 + c < ncols)
      u = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * Cfg<T>::LDC + c) = u;
  }
}

// Out[r][c] = X[x0 + r] . Y[y0 + c] over `ncols` features (float, ld LDS);
// rows past L read as zero. Whole block; 8 warps as 4 (rows) x 2 (columns).
template <typename T>
__device__ void tile_xyT(float* Out, const T* X, const T* Y, long long ld, int x0, int y0,
                         int L, int ncols, T* As, T* Bs) {
  constexpr int LDC = Cfg<T>::LDC;
  const int warp = threadIdx.x >> 5, rg = warp & 3, cg = warp >> 2;
  float acc[4][4];
  zero(acc);
  for (int c0 = 0; c0 < ncols; c0 += KC) {
    __syncthreads();
    stage_chunk<T>(As, X, ld, x0, L, c0, ncols);
    stage_chunk<T>(Bs, Y, ld, y0, L, c0, ncols);
    __syncthreads();
    warp_gemm<4>(acc, As + rg * 16 * LDC, LDC, Bs + cg * 32 * LDC, LDC, KC);
  }
  for_each(acc, [&](int r, int c, float v) { Out[(rg * 16 + r) * LDS + cg * 32 + c] = v; });
}

// Xt[c][i] = X[r0 + i][c0 + c] for a DC x BT slice, zero outside (L, ncols)
template <typename T>
__device__ __forceinline__ void stage_t(T* Xt, const T* X, long long ld, int r0, int L, int c0,
                                        int ncols) {
  constexpr int V = 16 / sizeof(T), LDT = Cfg<T>::LDT;
  for (int e = threadIdx.x; e < BT * (DC / V); e += NTHREADS) {
    const int i = e % BT, c = e / BT * V;
    __align__(16) T tmp[V];
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + i < L && c0 + c < ncols)
      u = *reinterpret_cast<const uint4*>(X + (long long)(r0 + i) * ld + c0 + c);
    *reinterpret_cast<uint4*>(tmp) = u;
#pragma unroll
    for (int t = 0; t < V; ++t) Xt[(c + t) * LDT + i] = tmp[t];
  }
}

// v as a bf16 high part plus a bf16 remainder (float32: the value itself)
template <typename T>
__device__ __forceinline__ void split_store(T* hi, T* lo, float v) {
  const T h = from_f<T>(v);
  *hi = h;
  if (Cfg<T>::SPLIT) *lo = from_f<T>(v - to_f(h));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dsum_kernel(const T* __restrict__ g, const T* __restrict__ out, float* __restrict__ dsum,
            long long rows, int NDv) {
  const long long row = (long long)blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < NDv; c += 32) s += to_f(g[row * NDv + c]) * to_f(out[row * NDv + c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) dsum[row] = s;
}

// One block per (key tile, bh, column slice): blockIdx.z < nzk is a slice of
// dk (ds^T q), else of dv (p^T g).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ g, const float* __restrict__ dsum,
           const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv, int L,
           int ND, int NDv, int nzk) {
  using C = Cfg<T>;
  constexpr int LDC = C::LDC, LDT = C::LDT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ss = reinterpret_cast<float*>(smem_raw);  // [BT][LDS] logits
  float* Gs = Ss + BT * LDS;                        // [BT][LDS] g . v^T
  T* As = reinterpret_cast<T*>(Gs + BT * LDS);      // [BT][LDC]
  T* Bs = As + BT * LDC;                            // [BT][LDC]
  T* Mt = Bs + BT * LDC;                            // [BT keys][LDT] p^T or ds^T
  T* Ml = Mt + BT * LDT;                            // its bf16 remainder
  T* Xt = Ml + BT * LDT;                            // [DC][LDT] q^T or g^T slice

  const int tid = threadIdx.x, warp = tid >> 5, rg = warp & 3, cg = warp >> 2;
  const int j0 = blockIdx.x * BT;
  const long long bh = blockIdx.y;
  const bool is_dk = (int)blockIdx.z < nzk;
  const int c0 = (is_dk ? blockIdx.z : blockIdx.z - nzk) * DC;
  const int ncol = is_dk ? ND : NDv;
  const T* qb = q + bh * L * ND;
  const T* kb = k + bh * L * ND;
  const T* vb = v + bh * L * NDv;
  const T* gb = g + bh * L * NDv;
  const float* lse_b = lse + bh * L;
  const float* dsum_b = dsum + bh * L;

  float acc[8][4];  // keys rg*16.., columns cg*64.. of the slice
  zero(acc);
  for (int i0 = 0; i0 < L; i0 += BT) {
    tile_xyT<T>(Ss, qb, kb, ND, i0, j0, L, ND, As, Bs);
    if (is_dk) tile_xyT<T>(Gs, gb, vb, NDv, i0, j0, L, NDv, As, Bs);
    __syncthreads();
    for (int e = tid; e < BT * BT; e += NTHREADS) {
      const int i = e % BT, j = e / BT, gi = i0 + i;
      float val = 0.f;
      if (gi < L) {
        val = expf(Ss[i * LDS + j] - lse_b[gi]);
        if (is_dk) val *= Gs[i * LDS + j] - dsum_b[gi];
      }
      split_store<T>(Mt + j * LDT + i, Ml + j * LDT + i, val);
    }
    stage_t<T>(Xt, is_dk ? qb : gb, ncol, i0, L, c0, ncol);
    __syncthreads();
    warp_gemm<8>(acc, Mt + rg * 16 * LDT, LDT, Xt + cg * 64 * LDT, LDT, BT);
    if (C::SPLIT) warp_gemm<8>(acc, Ml + rg * 16 * LDT, LDT, Xt + cg * 64 * LDT, LDT, BT);
  }
  T* ob = (is_dk ? dk + bh * L * ND : dv + bh * L * NDv);
  for_each(acc, [&](int r, int c, float val) {
    const int gj = j0 + rg * 16 + r, gc = c0 + cg * 64 + c;
    if (gj < L && gc < ncol) ob[(long long)gj * ncol + gc] = from_f<T>(val);
  });
}

// One block per (query tile, bh, column slice of dq), walking the key tiles.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ g, const float* __restrict__ dsum,
          const float* __restrict__ lse, T* __restrict__ dq, int L, int ND, int NDv) {
  using C = Cfg<T>;
  constexpr int LDC = C::LDC, LDT = C::LDT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ss = reinterpret_cast<float*>(smem_raw);
  float* Gs = Ss + BT * LDS;
  T* As = reinterpret_cast<T*>(Gs + BT * LDS);
  T* Bs = As + BT * LDC;
  T* Ms = Bs + BT * LDC;  // [BT queries][LDT] ds in k's dtype
  T* Kt = Ms + 2 * BT * LDT;  // [DC][LDT] k^T slice

  const int tid = threadIdx.x, warp = tid >> 5, rg = warp & 3, cg = warp >> 2;
  const int i0 = blockIdx.x * BT;
  const long long bh = blockIdx.y;
  const int c0 = blockIdx.z * DC;
  const T* qb = q + bh * L * ND;
  const T* kb = k + bh * L * ND;
  const T* vb = v + bh * L * NDv;
  const T* gb = g + bh * L * NDv;
  const float* lse_b = lse + bh * L;
  const float* dsum_b = dsum + bh * L;

  float acc[8][4];  // queries rg*16.., columns cg*64.. of the slice
  zero(acc);
  for (int j0 = 0; j0 < L; j0 += BT) {
    tile_xyT<T>(Ss, qb, kb, ND, i0, j0, L, ND, As, Bs);
    tile_xyT<T>(Gs, gb, vb, NDv, i0, j0, L, NDv, As, Bs);
    __syncthreads();
    for (int e = tid; e < BT * BT; e += NTHREADS) {
      const int i = e / BT, j = e % BT, gi = i0 + i;
      float val = 0.f;
      if (gi < L && j0 + j < L)
        val = expf(Ss[i * LDS + j] - lse_b[gi]) * (Gs[i * LDS + j] - dsum_b[gi]);
      Ms[i * LDT + j] = from_f<T>(val);
    }
    stage_t<T>(Kt, kb, ND, j0, L, c0, ND);
    __syncthreads();
    warp_gemm<8>(acc, Ms + rg * 16 * LDT, LDT, Kt + cg * 64 * LDT, LDT, BT);
  }
  T* ob = dq + bh * L * ND;
  for_each(acc, [&](int r, int c, float val) {
    const int gi = i0 + rg * 16 + r, gc = c0 + cg * 64 + c;
    if (gi < L && gc < ND) ob[(long long)gi * ND + gc] = from_f<T>(val);
  });
}

template <typename T>
cudaError_t launch(const void* q_, const void* k_, const void* v_, const void* out_,
                   const float* lse, const void* g_, float* dsum, void* dq_, void* dk_, void* dv_,
                   int BH, int L, int ND, int NDv, cudaStream_t st) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* g = static_cast<const T*>(g_);
  cudaError_t err;
  if ((err = set_smem(dkv_kernel<T>, Cfg<T>::SMEM)) != cudaSuccess) return err;
  if ((err = set_smem(dq_kernel<T>, Cfg<T>::SMEM)) != cudaSuccess) return err;
  const long long rows = (long long)BH * L;
  const unsigned rb = (unsigned)((rows + NTHREADS / 32 - 1) / (NTHREADS / 32));
  dsum_kernel<T><<<rb, NTHREADS, 0, st>>>(g, static_cast<const T*>(out_), dsum, rows, NDv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (L + BT - 1) / BT;
  const int nzk = (ND + DC - 1) / DC, nzv = (NDv + DC - 1) / DC;
  dkv_kernel<T><<<dim3(tiles, BH, nzk + nzv), NTHREADS, Cfg<T>::SMEM, st>>>(
      q, k, v, g, dsum, lse, static_cast<T*>(dk_), static_cast<T*>(dv_), L, ND, NDv, nzk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<T><<<dim3(tiles, BH, nzk), NTHREADS, Cfg<T>::SMEM, st>>>(
      q, k, v, g, dsum, lse, static_cast<T*>(dq_), L, ND, NDv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, dq, dk (BH, L, ND); v, out, g, dv (BH, L, NDv); lse (BH, L) float32
// from the forward; dsum (BH, L) float32 scratch. ND % 8 == 0, NDv % 8 == 0,
// rows 16-byte aligned. dtype: 0 float32, 1 bfloat16.
int tied_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                       const float* lse, const void* g, float* dsum, void* dq, void* dk, void* dv,
                       int BH, int L, int ND, int NDv, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH > 65535 || L <= 0 || ND <= 0 || NDv <= 0 || ND % 8 || NDv % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, g, dsum, dq, dk, dv, BH, L, ND, NDv, st);
  if (dtype == 1)
    return launch<bf16>(q, k, v, out, lse, g, dsum, dq, dk, dv, BH, L, ND, NDv, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
