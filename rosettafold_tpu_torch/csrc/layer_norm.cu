// Row LayerNorm (kernel LN) for Hopper (sm_90a):
//
//   y = (x - mu) * rsqrt(max(E[x^2] - mu^2, 0) + eps) * w + b
//
// over the last axis of x (rows of C), float32 statistics, float32 output,
// w and b float32: models/layers.py `layer_norm` (flax's LayerNorm with the
// mean-of-squares variance) is its plain version.
//
// It replaces no TPU kernel. On the TPU, XLA fuses that function into one
// pass by itself; in eager PyTorch it runs as 12 launches (13 from bf16: the
// cast, two means, x*x, five on the statistics, four float32 broadcast
// passes), about 54 bytes of device traffic an element of a bf16 row. The
// model calls it 267 times a forward, 48 of them over the L x L pair, so
// this one launch takes the place of about 3,000 a request.
//
// What bounds it on this card: bytes. Each element of x is read once and
// its float32 result written once: 6 bytes an element from bf16, 8 from
// float32; w and b (C floats each) come from the read-only cache. The least
// time is rows * C * (sizeof(x) + 4) / 3.35 TB/s: 0.62 ms for the bf16 pair
// at L = 1100 (1.21 M rows of 288).
//
// Design:
//  * a group of G = 4, 8, 16 or 32 lanes of one warp owns a row: the host
//    takes the smallest G whose lanes hold the row in at most NV loads each,
//    so a warp owns 32 / G rows and few lanes idle (the bf16 pair row of 288
//    is 8 lanes x 5 loads of 8 channels, 36 of 40 slots). NV is 5 and not 9
//    (4 lanes x 9 loads): 62 registers a thread against 80 and more warps in
//    flight, 0.759 ms against 0.846 at the L = 1100 pair on the H100;
//  * x is read in 16-byte vectors (8 bf16 or 4 float32) when every row
//    start, w and b are 16-byte aligned and C is a multiple of the vector;
//    one element a load otherwise (the SE(3) layers' C = 361 in float32).
//    Consecutive lanes read consecutive vectors, and a row stays in
//    registers, as loaded, from the statistics to the output;
//  * each lane sums x and x^2 in float32, xor shuffles within the group
//    finish both sums, and the output follows the plain version's order,
//    ((x - mu) * r) * w + b, each step rounded (no fma contraction), stored
//    in 16-byte vectors on the vector path;
//  * rows are read in place from a view whose last axis is contiguous: the
//    row index splits over up to three leading axes with their own strides
//    (the wrapper folds the rest), as the transposed MSA of the
//    sequence-wise layers gives; the output is contiguous;
//  * a row longer than G x NV loads (float32 above 640 channels, bf16 above
//    1280, one element a load above 384) is read twice: the sums chunk by
//    chunk, then each chunk again for the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NV_VEC = 5;   // 16-byte loads a lane holds: 20 registers
constexpr int NV_ONE = 12;  // single-element loads a lane holds

// Row r of x starts at x + i0 * s0 + i1 * s1 + i2 * s2 (elements), where
// r = (i0 * n1 + i1) * n2 + i2.
struct Rows {
  unsigned n1, n2;
  long long s0, s1, s2;
};

// One load: 16 bytes on the vector path, one element of T otherwise.
template <typename T, int VEC>
struct Load {
  using type = uint4;
};
template <typename T>
struct Load<T, 1> {
  using type = T;
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4], float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const __nv_bfloat16& v, float (&f)[1], __nv_bfloat16) {
  f[0] = __bfloat162float(v);
}
__device__ __forceinline__ void unpack(const float& v, float (&f)[1], float) { f[0] = v; }

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ y, unsigned M, int C, int G,
               Rows rows, float eps) {
  using V = typename Load<T, VEC>::type;
  constexpr int NV = VEC == 1 ? NV_ONE : NV_VEC;
  const int lane = threadIdx.x & (G - 1);
  const unsigned row = (unsigned)(((unsigned long long)blockIdx.x * NTHREADS + threadIdx.x) / G);
  const bool live = row < M;  // a dead group still joins its warp's shuffles
  unsigned r = live ? row : 0;
  const unsigned i2 = r % rows.n2;
  r /= rows.n2;
  const unsigned i1 = r % rows.n1, i0 = r / rows.n1;
  const V* xr = reinterpret_cast<const V*>(x + i0 * rows.s0 + i1 * rows.s1 + i2 * rows.s2);
  float* yr = y + (long long)row * C;
  const int nvec = C / VEC, chunk = G * NV;

  V raw[NV];
  auto load = [&](int c0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = c0 + j * G + lane;
      if (live && k < nvec) raw[j] = xr[k];
    }
  };
  float s = 0.f, ss = 0.f;
  for (int c0 = 0; c0 < nvec; c0 += chunk) {
    load(c0);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (live && c0 + j * G + lane < nvec) {
        float f[VEC];
        unpack(raw[j], f, T());
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s += f[i];
          ss = fmaf(f[i], f[i], ss);
        }
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (!live) return;
  const float inv_c = 1.f / (float)C;
  const float mu = __fmul_rn(s, inv_c);
  const float var = fmaxf(__fsub_rn(__fmul_rn(ss, inv_c), __fmul_rn(mu, mu)), 0.f);
  const float rs = rsqrtf(__fadd_rn(var, eps));

  auto write = [&](int c0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = c0 + j * G + lane;
      if (k < nvec) {
        float f[VEC];
        unpack(raw[j], f, T());
        const int c = k * VEC;
        if constexpr (VEC == 1) {
          yr[c] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[0], mu), rs), __ldg(w + c)),
                            __ldg(b + c));
        } else {
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q) {
            const float4 wq = __ldg(reinterpret_cast<const float4*>(w + c) + q);
            const float4 bq = __ldg(reinterpret_cast<const float4*>(b + c) + q);
            const float* f4 = f + 4 * q;
            float4 o;
            o.x = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f4[0], mu), rs), wq.x), bq.x);
            o.y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f4[1], mu), rs), wq.y), bq.y);
            o.z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f4[2], mu), rs), wq.z), bq.z);
            o.w = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f4[3], mu), rs), wq.w), bq.w);
            reinterpret_cast<float4*>(yr + c)[q] = o;
          }
        }
      }
    }
  };
  if (nvec <= chunk) {  // the row is in registers
    write(0);
    return;
  }
  for (int c0 = 0; c0 < nvec; c0 += chunk) {
    load(c0);
    write(c0);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* w, const float* b, float* y, unsigned M, int C,
                   const Rows& rows, float eps, cudaStream_t st) {
  constexpr int NV = VEC == 1 ? NV_ONE : NV_VEC;
  const int nvec = C / VEC;
  int G = 4;
  while (G < 32 && G * NV < nvec) G *= 2;
  const unsigned long long blocks = ((unsigned long long)M * G + NTHREADS - 1) / NTHREADS;
  ln_rows_kernel<T, VEC><<<(unsigned)blocks, NTHREADS, 0, st>>>(
      static_cast<const T*>(x), w, b, y, M, C, G, rows, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// x: M rows of C (dtype 0 float32, 1 bfloat16), row r at the offset `Rows`
// describes (n1, n2 sizes; s0, s1, s2 element strides); y (M, C) float32,
// contiguous; w, b (C,) float32. vec 1: 16-byte loads (x, every row start,
// w, b and y 16-byte aligned, C a multiple of 16 bytes of x), 0: one element
// a load. M < 2^31, n1 * n2 divides M.
int layer_norm_fwd(const void* x, const float* w, const float* b, float* y, long long M, int C,
                   long long n1, long long n2, long long s0, long long s1, long long s2,
                   float eps, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || M >= (1LL << 31) || C <= 0 || n1 <= 0 || n2 <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  if (vec && ((C * esize) % 16 || !aligned16(x) || !aligned16(w) || !aligned16(b) ||
              !aligned16(y) || (s0 * esize) % 16 || (s1 * esize) % 16 || (s2 * esize) % 16))
    return (int)cudaErrorInvalidValue;
  const Rows rows{(unsigned)n1, (unsigned)n2, s0, s1, s2};
  const unsigned m = (unsigned)M;
  if (dtype == 0)
    return vec ? launch<float, 4>(x, w, b, y, m, C, rows, eps, st)
               : launch<float, 1>(x, w, b, y, m, C, rows, eps, st);
  return vec ? launch<__nv_bfloat16, 8>(x, w, b, y, m, C, rows, eps, st)
             : launch<__nv_bfloat16, 1>(x, w, b, y, m, C, rows, eps, st);
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
