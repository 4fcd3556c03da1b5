// Fused pre-LN feed-forward residual (kernel D) for Hopper (sm_90a):
//
//   out = x + fc2(relu(fc1(LayerNorm(x))))      per row of x (M, D = 288)
//
// Replaces rosettafold_tpu/ops/pallas/fused_ff.py `_forward` (the
// pl.pallas_call at :58, public entry `fused_ln_ff_residual` :97).
// Rounding points as the TPU kernel: LN statistics in float32, the LN output
// rounded to the compute dtype, h = relu(y.W1 + b1) rounded to it, then
// h.W2 + b2 + x in float32, rounded once to the output.
//
// What bounds it on this card: operations. Per row 2 * 2 * D * F
// multiply-adds (87 GFLOP at B=4, L=128) against 2 * D elements of traffic.
// The (rows, F = 1152) hidden never reaches device memory: a block owns BM
// rows, keeps their LN output in shared memory, and walks the hidden width in
// chunks of 64: h_chunk = relu(Y . W1[chunk]^T + b1) goes to shared memory and
// is at once contracted with W2[:, chunk] into the block's (BM x 288) float32
// accumulators, which stay in registers for the whole walk. Weights are
// re-read from L2 by every block (1.3 MB per block in bf16); a resident,
// pipelined weight ring (TMA, wgmma) is later work.
// bfloat16: tensor cores (mma.sync m16n8k16); float32: CUDA cores.

#include "common.cuh"

using namespace rf;

namespace {

constexpr int D = 288;  // the pair width; the wrapper checks it
constexpr int FC = 64;  // hidden chunk
constexpr int NTHREADS = 256;
constexpr int LDY = D + 8;
constexpr int LDH = FC + 8;

template <typename T>
struct Cfg {
  static constexpr int BM = sizeof(T) == 2 ? 64 : 32;  // rows per block
  static constexpr int WR = BM / 16, WC = 8 / WR;       // warp grid
  static constexpr int NT_H = FC / (8 * WC), NT_O = D / (8 * WC);
  static constexpr size_t SMEM = sizeof(T) * (BM * LDY + FC * LDY + BM * LDH + D * LDH);
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fused_ff_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ w1,
                const float* __restrict__ b1, const T* __restrict__ w2,
                const float* __restrict__ b2, T* __restrict__ out, long long M, int F,
                float eps) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ys = reinterpret_cast<T*>(smem_raw);  // [BM][LDY] LN(x) rows
  T* W1s = Ys + C::BM * LDY;                // [FC][LDY] fc1 rows of this chunk
  T* Hs = W1s + FC * LDY;                   // [BM][LDH] hidden chunk
  T* W2s = Hs + C::BM * LDH;                // [D][LDH]  fc2 columns of this chunk

  const long long r0 = (long long)blockIdx.x * C::BM;
  const int rows = (int)min((long long)C::BM, M - r0);
  const int warp = threadIdx.x >> 5, rg = warp % C::WR, cg = warp / C::WR;
  const T* xb = x + r0 * D;

  ln_rows<T, D>(Ys, LDY, [=](int r) { return xb + (long long)r * D; }, C::BM, rows, gamma,
                beta, eps);

  float acc[C::NT_O][4];
  zero(acc);
  for (int c0 = 0; c0 < F; c0 += FC) {
    __syncthreads();  // Hs / W2s of the previous chunk are consumed
    stage<T>(W1s, LDY, w1 + (long long)c0 * D, D, FC, FC, D);
    stage<T>(W2s, LDH, w2 + c0, F, D, D, FC);
    __syncthreads();
    float h[C::NT_H][4];
    zero(h);
    const int hc = cg * C::NT_H * 8;
    warp_gemm<C::NT_H>(h, Ys + rg * 16 * LDY, LDY, W1s + hc * LDY, LDY, D);
    for_each(h, [&](int r, int c, float v) {
      Hs[(rg * 16 + r) * LDH + hc + c] = from_f<T>(fmaxf(v + b1[c0 + hc + c], 0.f));
    });
    __syncthreads();
    warp_gemm<C::NT_O>(acc, Hs + rg * 16 * LDH, LDH, W2s + cg * C::NT_O * 8 * LDH, LDH, FC);
  }
  for_each(acc, [&](int r, int c, float v) {
    const int gr = rg * 16 + r, col = cg * C::NT_O * 8 + c;
    if (gr < rows) {
      const long long o = (r0 + gr) * D + col;
      out[o] = from_f<T>(v + b2[col] + to_f(x[o]));
    }
  });
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, long long M,
                   int F, float eps, cudaStream_t st) {
  using C = Cfg<T>;
  cudaError_t err = set_smem(fused_ff_kernel<T>, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (M + C::BM - 1) / C::BM;
  fused_ff_kernel<T><<<(unsigned)blocks, NTHREADS, C::SMEM, st>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), M, F, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out (M, 288); w1 (F, 288) and w2 (288, F) in nn.Linear layout; gamma,
// beta, b1, b2 float32. F % 64 == 0. dtype: 0 float32, 1 bfloat16.
int fused_ff_fwd(const void* x, const float* gamma, const float* beta, const void* w1,
                 const float* b1, const void* w2, const float* b2, void* out, long long M,
                 int D_, int F, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D_ != D || F % FC != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, gamma, beta, w1, b1, w2, b2, out, M, F, eps, st);
  if (dtype == 1) return launch<bf16>(x, gamma, beta, w1, b1, w2, b2, out, M, F, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
