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
// The (rows, F = 1152) hidden never leaves the registers.
//
// bfloat16: wgmma, weights streamed by TMA (ff_wgmma_kernel):
//  * a block of 256 threads owns 128 rows; each of its two warpgroups holds
//    64 rows x 288 outputs in float32 registers (two m64n144 accumulators,
//    144 a thread, as kernel F: a producer warp besides would cap the block
//    at 168 registers a thread and spill them);
//  * the threads compute Y = LN(x) of their rows once, as wgmma A fragments:
//    its first 256 columns go into a 128-byte-swizzled K-major tile in
//    shared memory, the A operand of every hidden chunk, and its last 32
//    (half a box of 64) stay in registers (8 a thread), so Y takes 64 KB;
//  * per hidden chunk of 64: h = Y . W1[:, chunk] (m64n64k16: 16 K steps with
//    both operands in shared memory, the last 2 with A in registers), relu(h
//    + b1) rounded to bf16 straight into the A fragments (registers) of
//    out += h . W2[chunk, :] (m64n144k16 rs); both weights K-major, their
//    nn.Linear layouts. The next chunk's first product is issued before the
//    last one's second completes;
//  * W1 chunks (64 rows x 288: 4.5 boxes, TMA zero-fills the half, 40 KB)
//    and W2 chunks (288 rows x 64, 36 KB) arrive by TMA through two 2-stage
//    rings with full / empty mbarriers, the first stages issued before the
//    LayerNorm; every thread runs the issue code in step and thread 0 issues
//    (a branch around it serialises the wgmmas). A W1 stage is released when
//    its product is done, a W2 stage one chunk later;
//  * the epilogue stages each warpgroup's rows in shared memory (Y's space)
//    and reads x and writes out as whole 16-byte vectors of each row.
// The weights (1.3 MB) are read from L2 once a block: 0.68 GB at B=4, L=128.
// float32: the CUDA-core kernel (fused_ff_kernel): a block of 32 rows walks
// the hidden width in chunks of 64 through shared memory; its weights are
// re-read from L2 by every block.

#include "common.cuh"
#include "hopper.cuh"

using namespace rf;

namespace {

constexpr int D = 288;  // the pair width; the wrapper checks it
constexpr int FC = 64;  // hidden chunk
constexpr int NTHREADS = 256;
constexpr int LDY = D + 8;
constexpr int LDH = FC + 8;

template <typename T>
struct Cfg {
  static constexpr int BM = 32;  // rows per block (float32; bfloat16 is ff_wgmma_kernel)
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

// ---- bfloat16: TMA + wgmma ----------------------------------------------------
namespace wg {

using namespace rf::hopper;

constexpr int BM = 128;               // rows a block: two warpgroups of 64
constexpr int NTHREADS = 256;
constexpr int BOX = 64 * 128;         // 64 rows x 64 columns, 128-byte swizzle
constexpr int Y_KSTEPS = 16;          // Y's K steps in shared memory; 2 more in registers
constexpr int Y_WG = 4 * BOX;         // a warpgroup's 64 rows x 256
constexpr int W1_STAGE = 5 * BOX;     // 64 rows (hidden) x 288 of K: 4.5 boxes
constexpr int W2_STAGE = D * 128;     // 288 rows (out) x 64 of K
constexpr int W2_HALF = W2_STAGE / 2;  // a TMA box and an m64n144's B: 144 rows
constexpr int STAGES = 2;
static_assert(PAIR_D == D && PAIR_STAGE_BYTES <= Y_WG, "epilogue staging exceeds Y");
// shared memory from a 1024-byte boundary
constexpr int Y_OFF = 0;
constexpr int W1_OFF = Y_OFF + 2 * Y_WG;
constexpr int W2_OFF = W1_OFF + STAGES * W1_STAGE;
constexpr int BAR_OFF = W2_OFF + STAGES * W2_STAGE;
// w1 full, w1 empty, w2 full, w2 empty: STAGES each
constexpr size_t SMEM = 1024 + BAR_OFF + 4 * STAGES * 8;

__global__ void __launch_bounds__(NTHREADS, 1)
ff_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ b1, const float* __restrict__ b2,
                bf16* __restrict__ out, long long M, int F, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t w1_full = base + BAR_OFF, w1_empty = w1_full + 8 * STAGES,
                 w2_full = w1_empty + 8 * STAGES, w2_empty = w2_full + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t leader = threadIdx.x == 0;
  const long long row0 = (long long)blockIdx.x * BM + 64 * wg;  // the warpgroup's rows
  const int valid = (int)max(0LL, min(64LL, M - row0));
  const int nc = F / 64;

  if (leader) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(w1_full + 8 * s, 1);
      mbar_init(w1_empty + 8 * s, NTHREADS / 32);
      mbar_init(w2_full + 8 * s, 1);
      mbar_init(w2_empty + 8 * s, NTHREADS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the chunks' loads, W1 and W2 each in order, a stage refilled once both
  // warpgroups have released it
  int n1 = 0, n2 = 0;
  auto issue = [&](int released1, int released2) {
    for (; n1 < nc && n1 < released1 + STAGES; ++n1) {
      const int s = n1 % STAGES;
      mbar_wait(w1_empty + 8 * s, ((n1 / STAGES) & 1) ^ 1);
      const uint32_t dst = base + W1_OFF + s * W1_STAGE;
      mbar_arrive_expect_tx(w1_full + 8 * s, W1_STAGE, leader);
#pragma unroll
      for (int kb = 0; kb < 5; ++kb)
        tma_load_2d(dst + kb * BOX, &w1_map, w1_full + 8 * s, 64 * kb, 64 * n1, leader);
    }
    for (; n2 < nc && n2 < released2 + STAGES; ++n2) {
      const int s = n2 % STAGES;
      mbar_wait(w2_empty + 8 * s, ((n2 / STAGES) & 1) ^ 1);
      const uint32_t dst = base + W2_OFF + s * W2_STAGE;
      mbar_arrive_expect_tx(w2_full + 8 * s, W2_STAGE, leader);
      tma_load_2d(dst, &w2_map, w2_full + 8 * s, 64 * n2, 0, leader);
      tma_load_2d(dst + W2_HALF, &w2_map, w2_full + 8 * s, 64 * n2, D / 2, leader);
    }
  };
  issue(0, 0);

  // Y = LN(x) of the warpgroup's rows: K steps 0-15 into its swizzled
  // K-major tile, 16 and 17 kept as A fragments
  const uint32_t y_tile = base + Y_OFF + wg * Y_WG;
  uint32_t y_tail[PAIR_KSTEPS - Y_KSTEPS][4];
  {
    const int rlo = 16 * wq + g;
    uint32_t a[PAIR_KSTEPS][4];
    ln_a_fragments(a, rlo < valid ? x + (row0 + rlo) * D : nullptr,
                   rlo + 8 < valid ? x + (row0 + rlo + 8) * D : nullptr, gamma, beta, eps, t);
    unsigned char* yt = smem + Y_OFF + wg * Y_WG;
#pragma unroll
    for (int ks = 0; ks < Y_KSTEPS; ++ks)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = rlo + 8 * (k & 1), col = 16 * ks + 8 * (k >> 1) + 2 * t;
        const int chunk = (col & 63) >> 3;
        *reinterpret_cast<uint32_t*>(yt + (col >> 6) * BOX + r * 128 +
                                     ((chunk ^ (r & 7)) << 4) + (col & 7) * 2) = a[ks][k];
      }
#pragma unroll
    for (int ks = Y_KSTEPS; ks < PAIR_KSTEPS; ++ks)
#pragma unroll
      for (int k = 0; k < 4; ++k) y_tail[ks - Y_KSTEPS][k] = a[ks][k];
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  float acc0[72], acc1[72];  // output columns 0-143 and 144-287
#pragma unroll
  for (int e = 0; e < 72; ++e) acc0[e] = acc1[e] = 0.f;
  uint32_t ha[4][4];  // the hidden chunk as bf16 A fragments of its 4 K steps
  for (int c = 0; c < nc; ++c) {
    const int s = c % STAGES;
    const uint32_t parity = (c / STAGES) & 1;
    const uint32_t w1 = base + W1_OFF + s * W1_STAGE, w2 = base + W2_OFF + s * W2_STAGE;
    // h = Y . W1[:, chunk]
    float h[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) h[e] = 0.f;
    mbar_wait(w1_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Y_KSTEPS; ++ks)
      Wgmma<64>::ss(h, desc_sw128(y_tile + (ks >> 2) * BOX + (ks & 3) * 32),
                    desc_sw128(w1 + (ks >> 2) * BOX + (ks & 3) * 32), 1);
#pragma unroll
    for (int ks = Y_KSTEPS; ks < PAIR_KSTEPS; ++ks)
      Wgmma<64>::rs<0>(h, y_tail[ks - Y_KSTEPS],
                       desc_sw128(w1 + (ks >> 2) * BOX + (ks & 3) * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();  // this chunk's h and the last chunk's out += h . W2
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(w1_empty + 8 * s);
      if (c > 0) mbar_arrive(w2_empty + 8 * ((c - 1) % STAGES));
    }
    issue(c + 1, c);
    // relu(h + b1) -> bf16 A fragments
    const float* bc = b1 + 64 * c + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bc + 8 * i));
      ha[i >> 1][2 * (i & 1)] =
          pack_bf16(fmaxf(h[4 * i] + b.x, 0.f), fmaxf(h[4 * i + 1] + b.y, 0.f));
      ha[i >> 1][2 * (i & 1) + 1] =
          pack_bf16(fmaxf(h[4 * i + 2] + b.x, 0.f), fmaxf(h[4 * i + 3] + b.y, 0.f));
    }
    // out += h . W2[chunk, :]
    mbar_wait(w2_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<144>::rs<0>(acc0, ha[ks], desc_sw128(w2 + ks * 32), 1);
      Wgmma<144>::rs<0>(acc1, ha[ks], desc_sw128(w2 + W2_HALF + ks * 32), 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();

  // epilogue: the warpgroup's rows through Y's space (no longer read)
  const bf16* xb = x + row0 * D;
  bf16* ob = out + row0 * D;
  epilogue_rows_288(
      reinterpret_cast<bf16*>(smem + Y_OFF + wg * Y_WG), acc0, acc1, b2, 1,
      [=](int r) { return xb + (long long)r * D; }, [=](int r) { return ob + (long long)r * D; },
      valid, 1 + wg);
}

cudaError_t launch(const bf16* x, const float* gamma, const float* beta, const bf16* w1,
                   const float* b1, const bf16* w2, const float* b2, bf16* out, long long M,
                   int F, float eps, cudaStream_t st) {
  // w1 (F, 288) [hidden][d]: 64 of d x 64 rows a box; w2 (288, F) [out][hidden]:
  // 64 of hidden x 144 rows
  CUtensorMap w1_map, w2_map;
  const cuuint64_t w1dims[2] = {D, (cuuint64_t)F}, w1strides[1] = {D * 2};
  const cuuint32_t w1box[2] = {64, 64};
  cudaError_t err = encode_bf16_sw128(&w1_map, w1, 2, w1dims, w1strides, w1box);
  if (err != cudaSuccess) return err;
  const cuuint64_t w2dims[2] = {(cuuint64_t)F, D}, w2strides[1] = {(cuuint64_t)F * 2};
  const cuuint32_t w2box[2] = {64, D / 2};
  if ((err = encode_bf16_sw128(&w2_map, w2, 2, w2dims, w2strides, w2box)) != cudaSuccess)
    return err;
  if ((err = set_smem(ff_wgmma_kernel, SMEM)) != cudaSuccess) return err;
  const long long blocks = (M + BM - 1) / BM;
  ff_wgmma_kernel<<<(unsigned)blocks, NTHREADS, SMEM, st>>>(w1_map, w2_map, x, gamma, beta, b1,
                                                            b2, out, M, F, eps);
  return cudaGetLastError();
}

}  // namespace wg

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
// beta, b1, b2 float32. F % 64 == 0. dtype: 0 float32, 1 bfloat16 (x, out,
// w1, w2 16-byte aligned).
int fused_ff_fwd(const void* x, const float* gamma, const float* beta, const void* w1,
                 const float* b1, const void* w2, const float* b2, void* out, long long M,
                 int D_, int F, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D_ != D || F % FC != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, gamma, beta, w1, b1, w2, b2, out, M, F, eps, st);
  if (dtype == 1)
    return wg::launch(static_cast<const bf16*>(x), gamma, beta, static_cast<const bf16*>(w1), b1,
                      static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), M, F, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
