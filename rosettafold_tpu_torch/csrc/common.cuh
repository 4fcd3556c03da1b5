// Building blocks shared by the pair-track kernels (fused_ff, conv3x3,
// outer_product, fused_performer): warp-level tile products and tile staging.
//
// A warp computes a 16 x (8 * NT) tile C += A . B^T with A row-major
// (16 x K, leading dimension lda) and B stored n-major ([n][k], ldb), so that
// a weight in nn.Linear layout (out, in) is B as it lies in memory.
//  * bfloat16: tensor cores, mma.sync m16n8k16 (bf16 in, float32 accumulate).
//  * float32: CUDA cores with the same fragment ownership (exact float32
//    products, fmaf), so a kernel's epilogue is written once for both types.
// The accumulator element acc[n][i] is row g + 8 * (i >> 1), column
// n * 8 + 2 * tg + (i & 1) of the tile (g = lane / 4, tg = lane % 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rf {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// bf16: K % 16 == 0; lda, ldb even
template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const bf16* A, int lda,
                                          const bf16* B, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    a[0] = ld32(A + g * lda + k + 2 * tg);
    a[1] = ld32(A + (g + 8) * lda + k + 2 * tg);
    a[2] = ld32(A + g * lda + k + 2 * tg + 8);
    a[3] = ld32(A + (g + 8) * lda + k + 2 * tg + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* b = B + (n * 8 + g) * ldb + k + 2 * tg;
      mma_bf16(acc[n], a, ld32(b), ld32(b + 8));
    }
  }
}

// float32, B element (n, k) at B[n * ldb_n + k * ldb_k]
template <int NT>
__device__ __forceinline__ void warp_gemm_strided(float (&acc)[NT][4], const float* A, int lda,
                                                  const float* B, int ldb_n, int ldb_k, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = B + (n * 8 + 2 * tg) * ldb_n + k * ldb_k;
      const float b0 = b[0], b1 = b[ldb_n];
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const float* A, int lda,
                                          const float* B, int ldb, int K) {
  warp_gemm_strided<NT>(acc, A, lda, B, ldb, 1, K);
}

// Any layout: A element (row, k) at A[row * a_r + k * a_k], B element (n, k)
// at B[n * b_n + k * b_k]. bfloat16 packs each fragment pair from two scalar
// loads (K % 16 == 0); float32 is warp_gemm_strided with a strided A.
template <int NT>
__device__ __forceinline__ void warp_gemm_any(float (&acc)[NT][4], const bf16* A, int a_r,
                                              int a_k, const bf16* B, int b_n, int b_k, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  auto pack = [](const bf16* p, int step) {
    const uint32_t lo = __bfloat16_as_ushort(p[0]), hi = __bfloat16_as_ushort(p[step]);
    return lo | (hi << 16);
  };
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    a[0] = pack(A + g * a_r + (k + 2 * tg) * a_k, a_k);
    a[1] = pack(A + (g + 8) * a_r + (k + 2 * tg) * a_k, a_k);
    a[2] = pack(A + g * a_r + (k + 2 * tg + 8) * a_k, a_k);
    a[3] = pack(A + (g + 8) * a_r + (k + 2 * tg + 8) * a_k, a_k);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* b = B + (n * 8 + g) * b_n + (k + 2 * tg) * b_k;
      mma_bf16(acc[n], a, pack(b, b_k), pack(b + 8 * b_k, b_k));
    }
  }
}

template <int NT>
__device__ __forceinline__ void warp_gemm_any(float (&acc)[NT][4], const float* A, int a_r,
                                              int a_k, const float* B, int b_n, int b_k, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * a_r + k * a_k], a1 = A[(g + 8) * a_r + k * a_k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = B + (n * 8 + 2 * tg) * b_n + k * b_k;
      const float b0 = b[0], b1 = b[b_n];
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

// Row (problem p, position l) of a pair tensor read in place: problem p at
// (p / p_inner) * s_hi + (p % p_inner) * s_lo, position l at l * s_pos
// (elements). The row step of the axial attention attends over axis 1 of
// (B, L1, L2, D) and the column step over axis 2; both are such strides.
struct Rows {
  long long s_hi, s_lo, s_pos;
  int p_inner, L;
  __device__ __forceinline__ long long offset(long long row) const {
    const long long p = row / L;
    const int l = (int)(row % L);
    return (p / p_inner) * s_hi + (p % p_inner) * s_lo + l * s_pos;
  }
};

// f(row, col, value) for each accumulator element this thread holds
template <int NT, typename F>
__device__ __forceinline__ void for_each(float (&acc)[NT][4], F&& f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) f(g + 8 * (i >> 1), n * 8 + 2 * tg + (i & 1), acc[n][i]);
}

// 8 consecutive elements <-> float32 registers (16-byte aligned addresses)
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// rows [0, rows) x columns [0, cols) of a matrix into shared memory (ldd),
// row r read from row_ptr(r), zeros for rows >= valid. cols % 8 == 0, every
// row start 16-byte aligned. Whole block.
template <typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(T* dst, int ldd, RowPtr row_ptr, int rows, int valid,
                                           int cols) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int per_row = cols / V;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * V;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) u = *reinterpret_cast<const uint4*>(row_ptr(r) + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = u;
  }
}

template <typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src, long long lds, int rows,
                                      int valid, int cols) {
  stage_rows<T>(dst, ldd, [=](int r) { return src + r * lds; }, rows, valid, cols);
}

// ys[r][:] = LayerNorm(row r) in T (float32 statistics, var = E[x^2] - E[x]^2,
// as flax's fast variance), or a plain copy when gamma is null; zeros for
// rows >= valid. One warp per row. Whole block.
template <typename T, int D, typename RowPtr>
__device__ __forceinline__ void ln_rows(T* ys, int ldy, RowPtr row_ptr, int rows, int valid,
                                        const float* gamma, const float* beta, float eps) {
  static_assert(D % 32 == 0, "row width must be a multiple of 32");
  constexpr int PER = D / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nw) {
    T* y = ys + r * ldy;
    if (r >= valid) {
#pragma unroll
      for (int t = 0; t < PER; ++t) y[lane + 32 * t] = from_f<T>(0.f);
      continue;
    }
    const T* x = row_ptr(r);
    float v[PER];
#pragma unroll
    for (int t = 0; t < PER; ++t) v[t] = to_f(x[lane + 32 * t]);
    if (gamma == nullptr) {
#pragma unroll
      for (int t = 0; t < PER; ++t) y[lane + 32 * t] = from_f<T>(v[t]);
      continue;
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      s += v[t];
      ss += v[t] * v[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / D;
    const float var = fmaxf(ss / D - mu * mu, 0.f);
    const float inv = rsqrtf(var + eps);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int c = lane + 32 * t;
      y[c] = from_f<T>((v[t] - mu) * inv * gamma[c] + beta[c]);
    }
  }
}

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace rf

extern "C" const char* last_error_string(int err);
