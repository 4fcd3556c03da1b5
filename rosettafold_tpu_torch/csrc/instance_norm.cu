// InstanceNorm over the pixels of an NHWC map (kernel IN) for Hopper (sm_90a):
//
//   statistics:  inv = w / sqrt(var + eps),  shift = b - mean * inv
//   apply:       out = elu([x +] y * inv + shift)
//
// per image and channel, the mean and the biased variance taken over the H x W
// pixels of y (B, H, W, C), float32 arithmetic, inv and shift (B, C) float32:
// models/resnet.py `instance_stats` and `affine_elu_rows` are its plain
// versions, JAX's `_InStats(return_affine=True)` and the conv block's epilogue.
//
// It replaces no TPU kernel. On the TPU, XLA fuses both functions into the
// kernel path's passes by itself; in eager PyTorch the statistics take a float32
// copy of y, a mean, a Welford variance and five launches on (B, C), and the
// epilogue a float32 copy of y and of x, two broadcast passes, an add, the ELU
// and a cast: about 28 bytes of device traffic an element for the statistics
// and 54 for the epilogue of a bf16 map. The pair ResNets run 23 conv blocks
// (two statistics and one epilogue each) and 4 input norms a forward.
//
// What bounds it on this card: bytes. The statistics read y once (2 bytes an
// element from bf16); the epilogue reads y and x once and writes the output
// once (6 bytes from bf16 to bf16). The least time at the L = 1100 pair (1.21 M
// pixels of 288 bf16 channels) is 0.208 ms for the statistics and 0.624 ms for
// the epilogue with its residual at 3.35 TB/s.
//
// Design:
//  * a pixel's C channels are `lanes` 16-byte vectors (C = 288 in bf16: 36 of
//    8); a block is R = 288 / lanes rows of `lanes` threads (288 threads in
//    bf16 and in float32), each thread owning one vector of channels, so its
//    statistics, or its inv and shift, stay in registers; a block reads R
//    whole pixels, contiguous, a step;
//  * statistics in two launches. The first gives each image nb equal,
//    contiguous slices of its pixels, one a block: nb fills the card with the
//    resident blocks the occupancy allows (one wave), but gives each thread at
//    least UNROLL pixels; a thread reads rows r, r + R, ... of its slice with
//    UNROLL 16-byte loads in flight and sums (y - s) and (y - s)^2 in float32,
//    s the image's first pixel (a shift, so that the square sum does not hold
//    mean^2 beside the variance); the R rows of a block are summed in shared
//    memory in a fixed order into one partial a block and channel. The second
//    sums the nb partials of a channel in float64, in a fixed order (32
//    strided lanes, then the 32 in order), and writes inv and shift in the
//    plain version's float32 steps. No atomics: every call gives the same bits;
//  * the epilogue is one launch that reads y (and x) and writes the output
//    once: a grid of small blocks of R x 2 pixels (R x 4 without x), each
//    thread two rows of y and x (or four of y) in flight, its pixels found
//    without a division, at most 56 registers so that four blocks share an
//    SM. The ELU's expm1f makes the launch as much instructions as bytes: on
//    the H100 at the L = 1100 pair a persistent grid with four rows of both
//    maps a thread (84 registers, two blocks an SM) read 74 % of the byte
//    bound, small blocks that split their pixels by a 64-bit division 80 %,
//    these 88 %. Its float32 steps are the plain version's, each rounded (no
//    fma contraction): t = y * inv; t = x + t; elu(t + shift), the ELU as
//    PyTorch's (t <= 0 ? expm1f(t) : t), so the output equals the plain one
//    bit for bit for the same inv and shift;
//  * y and x are contiguous, 16-byte aligned, C a multiple of 16 bytes: the
//    wrapper refuses anything else (the model's maps are fresh allocations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROW_THREADS = 288;   // a block's threads at most: R rows of `lanes`
constexpr int UNROLL = 4;          // pixel rows a thread has in flight (the statistics)
constexpr int COMBINE_LANES = 32;  // partial lanes a channel in the combine launch

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements of one 16-byte load
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <typename TO, int N>
__device__ __forceinline__ void store(TO* dst, const float (&f)[N]) {
  if constexpr (std::is_same_v<TO, float>) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2],
                                                      f[4 * q + 3]);
  } else {
    __nv_bfloat162 h[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    if constexpr (N == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Per block and channel: the sums of (y - s) and (y - s)^2 over the block's
// pixels, s = the image's first pixel; part[(b * nb + blk) * 2 * C + {0, C} + c].
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
instance_stats_kernel(const T* __restrict__ y, float* __restrict__ part, long long P, int lanes,
                      int R, int nb) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float smem[];  // [2][R][C]
  const int C = lanes * N;
  const int lane = threadIdx.x % lanes, r = threadIdx.x / lanes, b = blockIdx.y;
  // the block's slice [p0, p1) of the image's pixels
  const long long p0 = blockIdx.x * P / nb, p1 = (blockIdx.x + 1) * P / nb;
  const uint4* yb = reinterpret_cast<const uint4*>(y) + (long long)b * P * lanes + lane;
  float s[N], a1[N], a2[N];
  unpack(__ldg(yb), s);
#pragma unroll
  for (int i = 0; i < N; ++i) a1[i] = a2[i] = 0.f;
  for (long long p = p0 + r; p < p1; p += (long long)R * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u * R < p1) v[u] = __ldg(yb + (p + u * R) * lanes);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * R < p1) {
        float f[N];
        unpack(v[u], f);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float d = __fsub_rn(f[i], s[i]);
          a1[i] += d;
          a2[i] = fmaf(d, d, a2[i]);
        }
      }
    }
  }
  float* s1 = smem;
  float* s2 = smem + R * C;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s1[r * C + lane * N + i] = a1[i];
    s2[r * C + lane * N + i] = a2[i];
  }
  __syncthreads();
  float* out = part + ((long long)b * nb + blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < R; ++k) {
      t1 += s1[k * C + c];
      t2 += s2[k * C + c];
    }
    out[c] = t1;
    out[C + c] = t2;
  }
}

// inv and shift of 32 channels of one image from the nb partials, in float64.
template <typename T>
__global__ void __launch_bounds__(32 * COMBINE_LANES)
instance_combine_kernel(const T* __restrict__ y, const float* __restrict__ part,
                        const float* __restrict__ w, const float* __restrict__ bias,
                        float* __restrict__ inv, float* __restrict__ shift, long long P, int C,
                        int nb, float eps) {
  __shared__ double d1[COMBINE_LANES][32], d2[COMBINE_LANES][32];
  const int cl = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + cl, b = blockIdx.y;
  double t1 = 0.0, t2 = 0.0;
  if (c < C) {
    const float* pb = part + (long long)b * nb * 2 * C + c;
#pragma unroll 4
    for (int k = j; k < nb; k += COMBINE_LANES) {
      t1 += (double)pb[(long long)k * 2 * C];
      t2 += (double)pb[(long long)k * 2 * C + C];
    }
  }
  d1[j][cl] = t1;
  d2[j][cl] = t2;
  __syncthreads();
  if (j != 0 || c >= C) return;
#pragma unroll
  for (int k = 1; k < COMBINE_LANES; ++k) {
    t1 += d1[k][cl];
    t2 += d2[k][cl];
  }
  const double m1 = t1 / (double)P;  // mean of y - s
  const double var = fmax(t2 / (double)P - m1 * m1, 0.0);
  const float mean = (float)((double)to_float(y[(long long)b * P * C + c]) + m1);
  // the plain version's float32 steps: w / sqrt(var + eps), b - mean * inv
  const float iv = __fdiv_rn(w[c], __fsqrt_rn(__fadd_rn((float)var, eps)));
  inv[(long long)b * C + c] = iv;
  shift[(long long)b * C + c] = __fsub_rn(bias[c], __fmul_rn(mean, iv));
}

// Rows a thread of the epilogue has in flight: two of y and x, or four of y.
template <bool RES>
struct ApplyUnroll {
  static constexpr int value = RES ? 2 : 4;
};

template <typename T, typename TO, bool RES>
__global__ void __launch_bounds__(ROW_THREADS, 4)
instance_apply_kernel(const T* __restrict__ y, const T* __restrict__ x,
                      const float* __restrict__ inv, const float* __restrict__ shift,
                      TO* __restrict__ out, long long P, int lanes, int R) {
  constexpr int N = Vec<T>::N, U = ApplyUnroll<RES>::value;
  const int C = lanes * N;
  const int lane = threadIdx.x % lanes, r = threadIdx.x / lanes, b = blockIdx.y;
  // the block's R * U pixels: this thread's are p, p + R, ..., p + (U - 1) * R
  const long long p = (long long)blockIdx.x * R * U + r;
  const float4* iv4 = reinterpret_cast<const float4*>(inv + (long long)b * C + lane * N);
  const float4* sh4 = reinterpret_cast<const float4*>(shift + (long long)b * C + lane * N);
  float iv[N], sh[N];
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = __ldg(iv4 + q), z = __ldg(sh4 + q);
    iv[4 * q] = a.x, iv[4 * q + 1] = a.y, iv[4 * q + 2] = a.z, iv[4 * q + 3] = a.w;
    sh[4 * q] = z.x, sh[4 * q + 1] = z.y, sh[4 * q + 2] = z.z, sh[4 * q + 3] = z.w;
  }
  const long long base = (long long)b * P * lanes + lane;
  const uint4* yb = reinterpret_cast<const uint4*>(y) + base;
  const uint4* xb = RES ? reinterpret_cast<const uint4*>(x) + base : nullptr;
  TO* ob = out + (long long)b * P * C + lane * N;
  uint4 v[U], xv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (p + u * R < P) {
      v[u] = __ldcs(yb + (p + u * R) * lanes);
      if constexpr (RES) xv[u] = __ldcs(xb + (p + u * R) * lanes);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (p + u * R < P) {
      float f[N], g[N], o[N];
      unpack(v[u], f);
      if constexpr (RES) unpack(xv[u], g);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float t = __fmul_rn(f[i], iv[i]);
        if constexpr (RES) t = __fadd_rn(g[i], t);
        t = __fadd_rn(t, sh[i]);
        o[i] = t <= 0.f ? expm1f(t) : t;
      }
      store<TO, N>(ob + (p + u * R) * C, o);
    }
  }
}

// Resident blocks an SM holds of `kernel` at `threads` and `smem`, cached.
int occupancy(const void* kernel, int threads, size_t smem) {
  struct Entry {
    const void* kernel;
    int threads;
    size_t smem;
    int occ;
  };
  static Entry cache[32];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].threads == threads && cache[i].smem == smem)
      return cache[i].occ;
  int occ = 1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem) != cudaSuccess ||
      occ < 1)
    occ = 1;
  if (used < 32) cache[used++] = {kernel, threads, smem, occ};
  return occ;
}

// Blocks an image: one wave of the resident blocks over the B images, at most
// `cap` blocks in all, each thread at least UNROLL pixels.
int blocks_per_image(const void* kernel, int threads, size_t smem, long long P, int R, int B,
                     long long cap) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  long long fill = (long long)sms[dev] * occupancy(kernel, threads, smem);
  if (fill > cap) fill = cap;
  long long nb = (P + (long long)R * UNROLL - 1) / ((long long)R * UNROLL);
  const long long most = fill / B > 0 ? fill / B : 1;
  if (nb > most) nb = most;
  return (int)(nb > 0 ? nb : 1);
}

struct Shape {
  int lanes, R, threads;
};

template <typename T>
Shape shape_of(int C) {
  const int lanes = C / Vec<T>::N;
  const int R = lanes >= ROW_THREADS ? 1 : ROW_THREADS / lanes;
  return {lanes, R, lanes * R};
}

template <typename T>
cudaError_t affine(const void* y, const float* w, const float* b, float* part, long long cap,
                   float* inv, float* shift, int B, long long P, int C, float eps,
                   cudaStream_t st) {
  const Shape s = shape_of<T>(C);
  const size_t smem = 2 * sizeof(float) * (size_t)s.R * C;  // at most 18 KB
  if (s.threads > ROW_THREADS) return cudaErrorInvalidValue;
  const int nb = blocks_per_image((const void*)instance_stats_kernel<T>, s.threads, smem, P, s.R,
                                  B, cap);
  if ((long long)nb * B > cap) return cudaErrorInvalidValue;
  instance_stats_kernel<T><<<dim3(nb, B), s.threads, smem, st>>>(static_cast<const T*>(y), part,
                                                                  P, s.lanes, s.R, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_combine_kernel<T><<<dim3((C + 31) / 32, B), 32 * COMBINE_LANES, 0, st>>>(
      static_cast<const T*>(y), part, w, b, inv, shift, P, C, nb, eps);
  return cudaGetLastError();
}

template <typename T, typename TO, bool RES>
cudaError_t apply(const void* y, const void* x, const float* inv, const float* shift, void* out,
                  int B, long long P, int C, cudaStream_t st) {
  const Shape s = shape_of<T>(C);
  if (s.threads > ROW_THREADS) return cudaErrorInvalidValue;
  const long long rows = (long long)s.R * ApplyUnroll<RES>::value;  // pixels a block
  const long long nb = (P + rows - 1) / rows;
  if (nb >= (1LL << 31)) return cudaErrorInvalidValue;
  instance_apply_kernel<T, TO, RES><<<dim3((unsigned)nb, B), s.threads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(x), inv, shift, static_cast<TO*>(out), P,
      s.lanes, s.R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply_to(const void* y, const void* x, const float* inv, const float* shift,
                     void* out, int B, long long P, int C, int out_f32, cudaStream_t st) {
  if (out_f32)
    return x ? apply<T, float, true>(y, x, inv, shift, out, B, P, C, st)
             : apply<T, float, false>(y, x, inv, shift, out, B, P, C, st);
  return x ? apply<T, __nv_bfloat16, true>(y, x, inv, shift, out, B, P, C, st)
           : apply<T, __nv_bfloat16, false>(y, x, inv, shift, out, B, P, C, st);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool valid(const void* y, int B, long long P, int C, int dtype) {
  const int esize = dtype == 0 ? 4 : 2;
  return B > 0 && B < 65536 && P > 0 && C > 0 && (dtype == 0 || dtype == 1) &&
         (C * esize) % 16 == 0 && aligned16(y);
}

}  // namespace

extern "C" {

// y (B, P, C) contiguous (dtype 0 float32, 1 bfloat16), 16-byte aligned, C a
// multiple of 16 bytes; w, b (C,) float32; part: `cap` blocks' partials (cap
// * 2 * C floats), at least B; inv, shift (B, C) float32 out. Two launches.
int instance_affine(const void* y, const float* w, const float* b, float* part, long long cap,
                    float* inv, float* shift, int B, long long P, int C, float eps, int dtype,
                    void* stream) {
  if (!valid(y, B, P, C, dtype) || cap < B) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? affine<float>(y, w, b, part, cap, inv, shift, B, P, C, eps, st)
                    : affine<__nv_bfloat16>(y, w, b, part, cap, inv, shift, B, P, C, eps, st);
}

// out = elu([x +] y * inv + shift): y and x (null: no residual) as above, of one
// dtype; inv, shift (B, C) float32, 16-byte aligned; out (B, P, C) contiguous,
// float32 (out_f32 1) or bfloat16, 16-byte aligned. One launch.
int instance_apply(const void* y, const void* x, const float* inv, const float* shift, void* out,
                   int B, long long P, int C, int dtype, int out_f32, void* stream) {
  if (!valid(y, B, P, C, dtype) || (x && !aligned16(x)) || !aligned16(out) || !aligned16(inv) ||
      !aligned16(shift))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? apply_to<float>(y, x, inv, shift, out, B, P, C, out_f32, st)
                    : apply_to<__nv_bfloat16>(y, x, inv, shift, out, B, P, C, out_f32, st);
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
