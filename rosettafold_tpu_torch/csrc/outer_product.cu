// Fused outer-product mean (kernel E) for Hopper (sm_90a):
//
//   op[b, i, j, u*32 + v] = sum_n x[b, n, i, u] * y[b, n, j, v]
//   out[b, i, j, :]       = LayerNorm_1024(op[b, i, j, :]) . W + bias
//
// Replaces rosettafold_tpu/ops/pallas/outer_product.py `_forward` (the
// pl.pallas_call at :88, public entry `fused_outer_product_mean` :143).
// Rounding points as the TPU kernel: x is rounded to y's dtype first (its
// block-diagonal BD, :58), products accumulate in float32, LN statistics are
// float32 with the two-pass variance, the LN output is rounded to the compute
// dtype, then . W + bias in float32, rounded once to the output.
//
// What bounds it on this card: operations, nearly all in the 1024 -> 288
// projection (2 * 1024 * 288 per pair, 40 GFLOP at B=4, L=128). The
// (B, L, L, 1024) slab never reaches device memory: a block owns one row i
// and 16 columns j. It forms op for those 16 pairs as one GEMM
// C[u][(j, v)] = X_i^T (32 x N) . Y (N x 512) in chunks of 16 MSA rows,
// keeps the 16 x 1024 float32 tile in shared memory (64 KB), normalizes each
// pair's 1024 values with one warp in place (the rounded LN output
// overwrites the row's first half), and projects it with W staged in
// 64-wide K chunks. bfloat16: tensor cores (mma.sync); float32: CUDA cores.
// W is re-read from L2 by every block (0.6 MB in bf16); larger j tiles or a
// resident W are later work.

#include "common.cuh"

using namespace rf;

namespace {

constexpr int U = 32, UV = U * U, DP = 288;  // d_proj, its square, d_pair
constexpr int BJ = 16;                       // pairs (columns j) per block
constexpr int NC = 16;                       // MSA rows per chunk
constexpr int NTHREADS = 256;
constexpr int LDO = UV + 8;  // float32 row stride of the op tile
constexpr int LDN = NC + 8;  // stride of the staged x / y chunks
constexpr int NTILE_OUT = DP / 8;  // 36 n8 tiles of the projection

template <typename T>
struct Cfg {
  static constexpr int KW = sizeof(T) == 2 ? 64 : 32;  // W chunk along K
  static constexpr int LDW = KW + 8;
  static constexpr size_t OP = sizeof(float) * BJ * LDO;
  static constexpr size_t XS = sizeof(T) * U * LDN;
  static constexpr size_t YS = sizeof(T) * BJ * U * LDN;
  static constexpr size_t WS = sizeof(T) * DP * LDW;
  static constexpr size_t SMEM = OP + XS + (YS > WS ? YS : WS);
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
opm_kernel(const float* __restrict__ x, const T* __restrict__ y, const float* __restrict__ gamma,
           const float* __restrict__ beta, const T* __restrict__ wt,
           const float* __restrict__ bias, T* __restrict__ out, int N, int L, float eps) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Op = reinterpret_cast<float*>(smem_raw);             // [BJ][LDO]
  T* Xs = reinterpret_cast<T*>(smem_raw + C::OP);             // [U][LDN]: x[n, i, u]^T
  T* Ys = reinterpret_cast<T*>(smem_raw + C::OP + C::XS);     // [BJ*U][LDN]: y[n, j, v]^T
  T* Ws = Ys;                                                 // [DP][LDW] (after op is done)

  const int b = blockIdx.z, i = blockIdx.y, j0 = blockIdx.x * BJ;
  const int nj = min(BJ, L - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long plane = (long long)L * U;  // one MSA row of x or y
  const float* xb = x + (long long)b * N * plane + (long long)i * U;
  const T* yb = y + (long long)b * N * plane + (long long)j0 * U;

  // 1. op tile: C[u][(j, v)], warp w owns u 0..31 x columns w*64 .. w*64+63
  float acc[2][8][4];
  zero(acc[0]);
  zero(acc[1]);
  for (int n0 = 0; n0 < N; n0 += NC) {
    __syncthreads();
    for (int e = tid; e < U * NC; e += NTHREADS) {
      const int n = e / U, u = e % U;
      Xs[u * LDN + n] = from_f<T>(n0 + n < N ? xb[(long long)(n0 + n) * plane + u] : 0.f);
    }
    for (int e = tid; e < NC * BJ * U; e += NTHREADS) {
      const int n = e / (BJ * U), jv = e % (BJ * U);
      const bool in = n0 + n < N && jv / U < nj;
      Ys[jv * LDN + n] = in ? yb[(long long)(n0 + n) * plane + jv] : from_f<T>(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      warp_gemm<8>(acc[h], Xs + h * 16 * LDN, LDN, Ys + warp * 64 * LDN, LDN, NC);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    for_each(acc[h], [&](int r, int c, float v) {
      const int u = h * 16 + r, jv = warp * 64 + c;
      Op[(jv / U) * LDO + u * U + jv % U] = v;
    });
  __syncthreads();

  // 2. LayerNorm over each pair's 1024 values, one warp per pair, in place
  constexpr int PER = UV / 32;
  for (int j = warp; j < BJ; j += NTHREADS / 32) {
    float* row = Op + j * LDO;
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      v[t] = row[lane + 32 * t];
      s += v[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / UV;
    float ss = 0.f;
#pragma unroll
    for (int t = 0; t < PER; ++t) ss += (v[t] - mu) * (v[t] - mu);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float rs = rsqrtf(ss / UV + eps);
    __syncwarp();
    T* lrow = reinterpret_cast<T*>(row);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int k = lane + 32 * t;
      lrow[k] = from_f<T>((v[t] - mu) * rs * gamma[k] + beta[k]);
    }
  }

  // 3. out (BJ x 288) = LN . W + bias; warp w owns n8 tiles w, w + 8, ...
  const T* A = reinterpret_cast<const T*>(Op);
  constexpr int LDA = LDO * (int)(sizeof(float) / sizeof(T));
  float acc3[5][1][4];
#pragma unroll
  for (int t = 0; t < 5; ++t) zero(acc3[t]);
  for (int k0 = 0; k0 < UV; k0 += C::KW) {
    __syncthreads();  // LN written / previous W chunk consumed
    stage<T>(Ws, C::LDW, wt + k0, UV, DP, DP, C::KW);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int tile = warp + 8 * t;
      if (tile < NTILE_OUT)
        warp_gemm<1>(acc3[t], A + k0, LDA, Ws + tile * 8 * C::LDW, C::LDW, C::KW);
    }
  }
  T* ob = out + (((long long)b * L + i) * L + j0) * DP;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const int tile = warp + 8 * t;
    if (tile >= NTILE_OUT) continue;
    for_each(acc3[t], [&](int r, int c, float v) {
      const int col = tile * 8 + c;
      if (r < nj) ob[(long long)r * DP + col] = from_f<T>(v + bias[col]);
    });
  }
}

template <typename T>
cudaError_t launch(const float* x, const void* y, const float* gamma, const float* beta,
                   const void* wt, const float* bias, void* out, int B, int N, int L, float eps,
                   cudaStream_t st) {
  using C = Cfg<T>;
  cudaError_t err = set_smem(opm_kernel<T>, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BJ - 1) / BJ, L, B);
  opm_kernel<T><<<grid, NTHREADS, C::SMEM, st>>>(x, static_cast<const T*>(y), gamma, beta,
                                                 static_cast<const T*>(wt), bias,
                                                 static_cast<T*>(out), N, L, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, N, L, 32) float32 (i side); y (B, N, L, 32) (j side); gamma, beta
// (1024) float32; wt (288, 1024) in nn.Linear layout; bias (288) float32;
// out (B, L, L, 288) in y's dtype. dtype: 0 float32, 1 bfloat16.
int outer_product_fwd(const float* x, const void* y, const float* gamma, const float* beta,
                      const void* wt, const float* bias, void* out, int B, int N, int L, int u,
                      int dp, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u != U || dp != DP || B <= 0 || N <= 0 || L <= 0 || L > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, y, gamma, beta, wt, bias, out, B, N, L, eps, st);
  if (dtype == 1) return launch<bf16>(x, y, gamma, beta, wt, bias, out, B, N, L, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
