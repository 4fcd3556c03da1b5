// The FAVOR+ layer's row products in bfloat16 on TMA + wgmma, shared by
// kernel C (fused_performer.cu: its projection and output launches) and
// kernel C' (fused_performer_bwd.cu: its projection launches and dx):
//
//  * proj_wgmma_kernel<NCHUNK, F32>: out[row] = LN(x[row]) . W^T for NCHUNK
//    chunks of 64 output columns of W (nn.Linear layout (out, 288), K-major;
//    chunk n from map n / 8, rows 64 (n % 8)); C's q/k/v (24 chunks of Wq |
//    Wk | Wv, q and k times `scale`, bf16 tiles by TMA store into the q/k/v
//    scratch) and C''s go = gy . Wo^T (8 chunks, float32 stores, no LN).
//    A block of 256 threads owns 128 rows, two warpgroups of 64. Each thread
//    reads its two rows of x in place through `Rows` (the 4-byte pairs it
//    holds in a wgmma A operand: LN needs every value in registers anyway,
//    and a tile of 64 rows crosses a problem's end where L is no multiple of
//    64, which a TMA box cannot follow) and keeps LN(x) as bf16 A fragments
//    (72 registers) for every chunk: m64n64k16 rs (only B is read from
//    shared memory). A chunk of W (40 KB: K = 288 is 4.5 boxes of 64) comes
//    through a 4-stage ring; two accumulators, so a chunk's epilogue can
//    overlap the next chunk's products.
//  * out_wgmma_kernel<KB>: out[row] = a[row] . W^T (+ bias) (+ x[row]), K =
//    64 KB (a (M, 64 KB) scratch, W (288, 64 KB) K-major), written through
//    `Rows`: C's att . Wo + bo (+ x) (KB = 8) and C''s dx = [gq | gk | gv] .
//    [Wq | Wk | Wv]^T (KB = 24, no bias). A persistent grid (a block an SM)
//    walks tiles of 128 rows; a tiles (TMA, 64 rows x 64 of K a warpgroup)
//    and W (64 of K x 288 a stage) come through a 3-stage ring whose loads
//    run on into the next tile during a tile's epilogue; each warpgroup
//    holds 64 rows x 288 in two m64n144 accumulators (both operands in
//    shared memory), one K block's products in flight; the epilogue stages
//    each half of the rows in shared memory and reads x (bulk prefetched
//    into L2 when the tile starts) and writes out as whole 16-byte vectors.
// Weights stream by TMA through full / empty mbarrier rings, issued ahead by
// thread 0 with every thread running the issue code in step (a branch around
// it serialises the wgmmas).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace rf {
namespace performer_wg {
namespace {  // each library keeps its own copy of the kernels

using namespace rf::hopper;

constexpr int D = PAIR_D;  // the pair width
constexpr int HD = 512;    // heads x dim_head

// ----------------------------------------------------------- projection
namespace proj {

constexpr int NWG = 2;                // warpgroups a block, 64 rows each
constexpr int BM = 64 * NWG;
constexpr int NTHREADS = 128 * NWG;
constexpr int W_BOX = 64 * 128;       // 64 columns (N) x 64 of K, K-major
constexpr int W_STAGE = 5 * W_BOX;    // K = 288: 4.5 boxes (TMA zero-fills the half)
constexpr int STAGES = 4;
constexpr int OUT_TILE = 64 * 128;    // 64 rows x 64 columns, 128-byte swizzle
// shared memory from a 1024-byte boundary
constexpr int W_OFF = 0;
constexpr int OUT_OFF = W_OFF + STAGES * W_STAGE;      // two tiles a warpgroup
constexpr int BAR_OFF = OUT_OFF + NWG * 2 * OUT_TILE;  // full, empty: STAGES each
constexpr size_t SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;

// F32: float32 rows of 64 NCHUNK columns stored straight to out_f32; else
// bf16 tiles by TMA store through out_map, chunks below 16 times `scale`
template <int NCHUNK, bool F32>
__global__ void __launch_bounds__(NTHREADS, 1)
proj_wgmma_kernel(const __grid_constant__ CUtensorMap w0_map,
                  const __grid_constant__ CUtensorMap w1_map,
                  const __grid_constant__ CUtensorMap w2_map,
                  const __grid_constant__ CUtensorMap out_map, float* __restrict__ out_f32,
                  const bf16* __restrict__ x, Rows rows_, const float* __restrict__ gamma,
                  const float* __restrict__ beta, float ln_eps, float scale, long long M) {
  static_assert(NCHUNK % 2 == 0, "the chunk loop takes two chunks a turn");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + BAR_OFF, empty = full + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t leader = threadIdx.x == 0, wg_leader = (threadIdx.x & 127) == 0;
  const long long row0 = (long long)blockIdx.x * BM + 64 * wg;  // the warpgroup's rows
  const int valid = (int)max(0LL, min(64LL, M - row0));

  if (leader) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NTHREADS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the weight chunks in order (map n / 8), a stage refilled once every
  // warpgroup has released it
  int n = 0;
  auto issue = [&](int released) {
    for (; n < NCHUNK && n < released + STAGES; ++n) {
      const int s = n % STAGES;
      mbar_wait(empty + 8 * s, ((n / STAGES) & 1) ^ 1);
      const CUtensorMap* map = n < 8 ? &w0_map : (n < 16 ? &w1_map : &w2_map);
      const uint32_t dst = base + W_OFF + s * W_STAGE;
      mbar_arrive_expect_tx(full + 8 * s, W_STAGE, leader);
#pragma unroll
      for (int kb = 0; kb < 5; ++kb)
        tma_load_2d(dst + kb * W_BOX, map, full + 8 * s, 64 * kb, 64 * (n % 8), leader);
    }
  };
  issue(0);

  // Y = LN(x) of the thread's two rows, as the A fragments of all 18 K steps
  uint32_t ya[PAIR_KSTEPS][4];
  {
    const int rlo = 16 * wq + g;
    ln_a_fragments(ya, rlo < valid ? x + rows_.offset(row0 + rlo) : nullptr,
                   rlo + 8 < valid ? x + rows_.offset(row0 + rlo + 8) : nullptr, gamma, beta,
                   ln_eps, t);
  }

  auto gemm = [&](float(&acc)[32], int j) {  // acc = Y . W[:, chunk j]
    const int s = j % STAGES;
    mbar_wait(full + 8 * s, (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < PAIR_KSTEPS; ++ks)
      Wgmma<64>::rs<0>(
          acc, ya[ks],
          desc_sw128(base + W_OFF + s * W_STAGE + (ks >> 2) * W_BOX + (ks & 3) * 32), ks > 0);
    wgmma_commit();
  };
  // chunk j's products are done: release its stage, and store its columns
  auto epilogue = [&](const float(&acc)[32], int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (j % STAGES));
    issue(j + 1);
    if (F32) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + g + 8 * h;
          if (r < valid)
            *reinterpret_cast<float2*>(out_f32 + (row0 + r) * (64 * NCHUNK) + 64 * j + 8 * i +
                                       2 * t) =
                make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      return;
    }
    const float sc = j < 16 ? scale : 1.f;  // q and k are scaled, v is not
    const int buf = OUT_OFF + (2 * wg + (j & 1)) * OUT_TILE;
    unsigned char* ot = smem + buf;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wq + g + 8 * h;
        *reinterpret_cast<uint32_t*>(ot + r * 128 + ((i ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16(acc[4 * i + 2 * h] * sc, acc[4 * i + 2 * h + 1] * sc);
      }
    fence_proxy_async();
    bulk_wait_read<0>(wg_leader);  // the last chunk's store has read its tile
    named_barrier(1 + wg, 128);
    tma_store_2d(&out_map, base + buf, 64 * j, (int)row0, wg_leader && valid > 0);
    bulk_commit(wg_leader);
  };
  // two accumulators: chunk j's epilogue runs while chunk j + 1's products
  // do; the last two chunks are peeled, so the loop body has no branch (with
  // one, ptxas could not follow the wgmma groups and injected a wait, C7517)
  float acc_a[32], acc_b[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc_a[e] = acc_b[e] = 0.f;
  gemm(acc_a, 0);
  for (int j = 0; j < NCHUNK - 2; j += 2) {
    gemm(acc_b, j + 1);
    wgmma_wait<1>();
    epilogue(acc_a, j);
    gemm(acc_a, j + 2);
    wgmma_wait<1>();
    epilogue(acc_b, j + 1);
  }
  gemm(acc_b, NCHUNK - 1);
  wgmma_wait<1>();
  epilogue(acc_a, NCHUNK - 2);
  wgmma_wait<0>();
  epilogue(acc_b, NCHUNK - 1);
  if (!F32) bulk_wait_read<0>(wg_leader);
}

// a weight (rows, 288) [column][d] as a map of 64 of d x 64 rows a box
inline cudaError_t weight_map(CUtensorMap* map, const bf16* w, int rows) {
  const cuuint64_t dims[2] = {D, (cuuint64_t)rows}, strides[1] = {D * 2};
  const cuuint32_t box[2] = {64, 64};
  return encode_bf16_sw128(map, w, 2, dims, strides, box);
}

// out (M, 64 NCHUNK) = LN(x) . [w0 | w1 | w2]^T in bf16 (q, k times scale),
// each w (512, 288) [column][d]
inline cudaError_t launch_qkv(const bf16* x, Rows rows_, const float* gamma, const float* beta,
                              float ln_eps, const bf16* wq, const bf16* wk, const bf16* wv,
                              float scale, bf16* qkv, long long M, cudaStream_t st) {
  CUtensorMap maps[3], qkv_map;
  const bf16* w[3] = {wq, wk, wv};
  cudaError_t err;
  for (int i = 0; i < 3; ++i)
    if ((err = weight_map(&maps[i], w[i], HD)) != cudaSuccess) return err;
  const cuuint64_t qdims[2] = {3 * HD, (cuuint64_t)M}, qstrides[1] = {3 * HD * 2};
  const cuuint32_t qbox[2] = {64, 64};
  if ((err = encode_bf16_sw128(&qkv_map, qkv, 2, qdims, qstrides, qbox)) != cudaSuccess)
    return err;
  auto kernel = proj_wgmma_kernel<3 * HD / 64, false>;
  if ((err = set_smem(kernel, SMEM)) != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((M + BM - 1) / BM);
  kernel<<<blocks, NTHREADS, SMEM, st>>>(maps[0], maps[1], maps[2], qkv_map, nullptr, x, rows_,
                                         gamma, beta, ln_eps, scale, M);
  return cudaGetLastError();
}

// out (M, 512) float32 = x . w^T, w (512, 288) [column][d] (no LN)
inline cudaError_t launch_f32(const bf16* x, Rows rows_, const bf16* w, float* out, long long M,
                              cudaStream_t st) {
  CUtensorMap map;
  cudaError_t err = weight_map(&map, w, HD);
  if (err != cudaSuccess) return err;
  auto kernel = proj_wgmma_kernel<HD / 64, true>;
  if ((err = set_smem(kernel, SMEM)) != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((M + BM - 1) / BM);
  kernel<<<blocks, NTHREADS, SMEM, st>>>(map, map, map, map, out, x, rows_, nullptr, nullptr, 0.f,
                                         1.f, M);
  return cudaGetLastError();
}

}  // namespace proj

// ---------------------------------------------------------------- output
namespace out {

constexpr int BM = 128;                // rows a tile: two warpgroups of 64
constexpr int NTHREADS = 256;
constexpr int A_TILE = 64 * 128;       // a warpgroup's 64 rows x 64 of K
constexpr int W_STAGE = D * 128;       // 288 rows (N) x 64 of K, K-major: 36 KB
constexpr int W_HALF = W_STAGE / 2;    // a TMA box and an m64n144's B: 144 rows
constexpr int STAGE = 2 * A_TILE + W_STAGE;
constexpr int STAGES = 3;
static_assert(STAGES > 1, "one K block's products stay in flight");
// shared memory from a 1024-byte boundary: the ring, each warpgroup's
// epilogue staging, the tile's row offsets, the barriers (full, empty:
// STAGES each)
constexpr int ST_OFF = STAGES * STAGE;
constexpr int ROFF_OFF = ST_OFF + 2 * PAIR_STAGE_BYTES;
constexpr int BAR_OFF = ROFF_OFF + BM * 8;
constexpr size_t SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;

// A persistent grid walks the tiles of 128 rows. Thread 0 issues the ring's
// loads in the order the products take them over the block's tiles, so the
// next tile's first K blocks arrive during a tile's epilogue. KB: K blocks
// of 64; bias may be null.
template <int KB>
__global__ void __launch_bounds__(NTHREADS, 1)
out_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                 const bf16* __restrict__ x, bf16* __restrict__ out, Rows rows_, long long M,
                 int residual, long long tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + BAR_OFF, empty = full + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const uint32_t leader = threadIdx.x == 0;
  bf16* st = reinterpret_cast<bf16*>(smem + ST_OFF + wg * PAIR_STAGE_BYTES);

  if (leader) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NTHREADS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  long long ld_tile = blockIdx.x;  // the next load's tile and K block
  int ld_kb = 0, n = 0;
  auto issue = [&](int released) {
    while (ld_tile < tiles && n < released + STAGES) {
      const int s = n % STAGES;
      mbar_wait(empty + 8 * s, ((n / STAGES) & 1) ^ 1);
      const int blk = (int)(ld_tile * BM);
      const uint32_t two = blk + 64 < M;  // warpgroup 1 may have no rows
      const uint32_t dst = base + s * STAGE, bar = full + 8 * s;
      mbar_arrive_expect_tx(bar, W_STAGE + (1 + two) * A_TILE, leader);
      tma_load_2d(dst, &a_map, bar, 64 * ld_kb, blk, leader);
      tma_load_2d(dst + A_TILE, &a_map, bar, 64 * ld_kb, blk + 64, leader && two);
      tma_load_2d(dst + 2 * A_TILE, &w_map, bar, 64 * ld_kb, 0, leader);
      tma_load_2d(dst + 2 * A_TILE + W_HALF, &w_map, bar, 64 * ld_kb, D / 2, leader);
      ++n;
      if (++ld_kb == KB) {
        ld_kb = 0;
        ld_tile += gridDim.x;
      }
    }
  };
  issue(0);

  int used = 0;  // stages this warpgroup has taken
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BM + 64 * wg;  // the warpgroup's rows
    const int valid = (int)max(0LL, min(64LL, M - row0));
    // the rows' offsets (the last epilogue ended on a barrier), and x's rows
    // fetched into L2 for this one
    long long* ro = reinterpret_cast<long long*>(smem + ROFF_OFF) + wg * 64;
    if (tid < 64) {
      const long long o = tid < valid ? rows_.offset(row0 + tid) : 0;
      ro[tid] = o;
      if (residual && tid < valid) prefetch_l2(x + o, D * 2);
    }
    named_barrier(1 + wg, 128);

    float acc0[72], acc1[72];  // output columns 0-143 and 144-287
#pragma unroll
    for (int e = 0; e < 72; ++e) acc0[e] = acc1[e] = 0.f;
    for (int kb = 0; kb < KB; ++kb, ++used) {
      const int s = used % STAGES;
      mbar_wait(full + 8 * s, (used / STAGES) & 1);
      const uint32_t a = base + s * STAGE + wg * A_TILE, w = base + s * STAGE + 2 * A_TILE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wgmma<144>::ss(acc0, desc_sw128(a + ks * 32), desc_sw128(w + ks * 32), 1);
        Wgmma<144>::ss(acc1, desc_sw128(a + ks * 32), desc_sw128(w + W_HALF + ks * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the last K block's products are done: release its stage
      if (kb > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((used - 1) % STAGES));
        issue(used);
      }
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ((used - 1) % STAGES));
    issue(used);  // the next tile's first K blocks load during the epilogue

    epilogue_rows_288(
        st, acc0, acc1, bias, residual, [=](int r) { return x + ro[r]; },
        [=](int r) { return out + ro[r]; }, valid, 1 + wg);
  }
}

// out = a . w^T (+ bias) (+ x), a (M, 64 KB) contiguous, w (288, 64 KB)
// [out][k], out and x through `rows_`
template <int KB>
cudaError_t launch(const bf16* a, const bf16* w, const float* bias, const bf16* x, bf16* out,
                   Rows rows_, long long M, int residual, cudaStream_t st) {
  CUtensorMap a_map, w_map;
  const cuuint64_t adims[2] = {64 * KB, (cuuint64_t)M}, astrides[1] = {64 * KB * 2};
  const cuuint32_t abox[2] = {64, 64};
  cudaError_t err = encode_bf16_sw128(&a_map, a, 2, adims, astrides, abox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {64 * KB, D}, wstrides[1] = {64 * KB * 2};
  const cuuint32_t wbox[2] = {64, D / 2};
  if ((err = encode_bf16_sw128(&w_map, w, 2, wdims, wstrides, wbox)) != cudaSuccess) return err;
  if ((err = set_smem(out_wgmma_kernel<KB>, SMEM)) != cudaSuccess) return err;
  const long long tiles = (M + BM - 1) / BM;
  const unsigned grid = (unsigned)(tiles < sm_count() ? tiles : sm_count());
  out_wgmma_kernel<KB><<<grid, NTHREADS, SMEM, st>>>(a_map, w_map, bias, x, out, rows_, M,
                                                     residual, tiles);
  return cudaGetLastError();
}

}  // namespace out

}  // namespace
}  // namespace performer_wg
}  // namespace rf
