// Fused 3x3 dilated SAME convolution, NHWC (kernel F), for Hopper (sm_90a):
//
//   out[b, i, j, :] = sum_{ki, kj} a[b, i + (ki-1)d, j + (kj-1)d, :] . W[ki, kj]
//   a = elu(x * inv[b] + shift[b])   with the optional pre-op, else a = x
//
// Replaces rosettafold_tpu/ops/pallas/conv3x3.py `_forward` (the
// pl.pallas_call at :134, public entry `conv3x3_fused` :208). As there, the
// pre-op (InstanceNorm affine + ELU between a ResBlock's two convs) is applied
// in float32 and rounded to the compute dtype while the input is read, and
// the out-of-image halo is zero AFTER it (SAME padding pads the activated
// tensor); products accumulate in float32. The output is written in the input
// dtype or, for the input gradient of the conv's backward (`_bwd_rule` :250:
// this kernel with flipped, transposed weights), in float32.
//
// What bounds it on this card: operations (2 * 9 * C * Co per pixel, 98 GFLOP
// at B=4, L=128, C = Co = 288), against one read of x per tap (from L2) and
// one write of out. An implicit GEMM: a block owns 64 pixels of one image row
// and all 288 output channels, and walks K = 9 taps x C in chunks of 96
// input channels; each chunk stages the shifted, pre-activated input tile
// and the tap's weight slice in shared memory and runs mma.sync (bf16) or
// float32 FMAs (float32). No im2col buffer and no activated copy of x exist
// in device memory. Unlike the TPU kernel there is no row-tile condition
// (H % T, d <= T, a VMEM budget): any H, W and dilation run. Pipelined
// staging (cp.async / TMA) and wgmma are later work.

#include "common.cuh"

using namespace rf;

namespace {

constexpr int CO = 288;  // output channels; the wrapper checks it
constexpr int BP = 64;   // output pixels per block (one image row)
constexpr int KC = 96;   // input channels per K chunk
constexpr int LDK = KC + 8;
constexpr int NTHREADS = 256;
constexpr int WR = 4, WC = 2, NT = CO / (8 * WC);  // warp grid, 18 n8 tiles

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (BP * LDK + CO * LDK);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ pre,
               TO* __restrict__ out, int H, int W, int C, int dil) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [BP][LDK] shifted input pixels
  T* Bs = As + BP * LDK;                    // [CO][LDK] weight slice [co][ci]

  const int b = blockIdx.z, i = blockIdx.y, j0 = blockIdx.x * BP;
  const int warp = threadIdx.x >> 5, rg = warp % WR, cg = warp / WR;
  const T* xb = x + (long long)b * H * W * C;
  const float* inv = pre ? pre + (long long)b * 2 * C : nullptr;
  const float* shift = pre ? inv + C : nullptr;

  float acc[NT][4];
  zero(acc);
  for (int tap = 0; tap < 9; ++tap) {
    const int ii = i + (tap / 3 - 1) * dil, dj = (tap % 3 - 1) * dil;
    const bool row_in = ii >= 0 && ii < H;
    for (int c0 = 0; c0 < C; c0 += KC) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < BP * (KC / 8); e += NTHREADS) {
        const int p = e / (KC / 8), c = (e % (KC / 8)) * 8;
        const int jj = j0 + p + dj;
        float v[8];
        if (row_in && jj >= 0 && jj < W) {
          load8(v, xb + ((long long)ii * W + jj) * C + c0 + c);
          if (pre) {
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float a = v[t] * inv[c0 + c + t] + shift[c0 + c + t];
              v[t] = a > 0.f ? a : expm1f(a);
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] = 0.f;
        }
        store8(As + p * LDK + c, v);
      }
      stage<T>(Bs, LDK, w + (long long)tap * CO * C + c0, C, CO, CO, KC);
      __syncthreads();
      warp_gemm<NT>(acc, As + rg * 16 * LDK, LDK, Bs + cg * NT * 8 * LDK, LDK, KC);
    }
  }
  TO* ob = out + ((long long)b * H + i) * W * CO;
  for_each(acc, [&](int r, int c, float v) {
    const int j = j0 + rg * 16 + r;
    if (j < W) ob[(long long)j * CO + cg * NT * 8 + c] = from_f<TO>(v);
  });
}

template <typename T, typename TO>
cudaError_t launch(const void* x, const void* w, const float* pre, void* out, int B, int H,
                   int W, int C, int dil, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = set_smem(conv3x3_kernel<T, TO>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((W + BP - 1) / BP, H, B);
  conv3x3_kernel<T, TO><<<grid, NTHREADS, smem, st>>>(static_cast<const T*>(x),
                                                      static_cast<const T*>(w), pre,
                                                      static_cast<TO*>(out), H, W, C, dil);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, C) NHWC; w (9, 288, C): tap-major, [co][ci] per tap; pre null
// or (B, 2, C) float32 [inv; shift]; out (B, H, W, 288). C % 96 == 0.
// dtype: 0 float32, 1 bfloat16; out_f32: 1 writes a float32 out whatever
// the input dtype, 0 writes the input dtype.
int conv3x3_fwd(const void* x, const void* w, const float* pre, void* out, int B, int H, int W,
                int C, int Co, int dil, int dtype, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Co != CO || C % KC != 0 || dil < 1 || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, float>(x, w, pre, out, B, H, W, C, dil, st);
  if (dtype == 1 && out_f32) return launch<bf16, float>(x, w, pre, out, B, H, W, C, dil, st);
  if (dtype == 1) return launch<bf16, bf16>(x, w, pre, out, B, H, W, C, dil, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
