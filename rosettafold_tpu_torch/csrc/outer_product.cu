// Fused outer-product mean (kernel E) for Hopper (sm_90a):
//
//   op[b, i, j, u*32 + v] = sum_n x[b, n, i, u] * y[b, n, j, v]
//   out[b, i, j, :]       = LayerNorm_1024(op[b, i, j, :]) . W + bias
//
// Replaces rosettafold_tpu/ops/pallas/outer_product.py `_forward` (the
// pl.pallas_call at :88, public entry `fused_outer_product_mean` :143).
// Rounding points as the TPU kernel: x is rounded to y's dtype first (its
// block-diagonal BD, :58), products accumulate in float32, LN statistics are
// float32 with the two-pass variance's accuracy, the LN output is rounded to
// the compute dtype, then . W + bias in float32, rounded once to the output.
//
// What bounds it on this card: operations, nearly all in the 1024 -> 288
// projection (2 * 1024 * 288 per pair, 40 GFLOP at B=4, L=128). The
// (B, L, L, 1024) slab never reaches device memory.
//
// bfloat16 (opm_wgmma_kernel): a persistent grid (a block an SM) walks tiles
// of 8 rows i x 16 columns j = 128 pairs; each of the block's two warpgroups
// owns 8 i x 8 j = 64 pairs and holds their 64 x 288 float32 projection in
// two m64n144 accumulators (144 registers a thread, as kernel D).
//  * op on the tensor cores. The 1024 values of a pair are cut into 16 K
//    chunks of 8 u x 8 v. A chunk's op for the warpgroup's 64 pairs is one
//    m64n64 tile C[(i, u), (j, v)] = X^T . Y over K = MSA rows (padded to 16
//    with zeros): both operands MN-major bf16 in shared memory, x rounded to
//    bf16 by the threads that stage it, y copied by cp.async. Up to 64 MSA
//    rows of the tile's x and y stay resident for the whole tile (more rows
//    are staged group by group, chunk by chunk: MULTI).
//  * Each pair's 64 values of a chunk lie in one warp (8 u on the lanes'
//    groups, 8 v on their quads), so LN statistics need no shared memory:
//    pass 1 forms the 16 chunks and merges mean and M2 chunk by chunk and then across the warp's lanes (Chan's formula, as
//    accurate as the two-pass variance); pass 2 forms each chunk again,
//    normalizes it, rounds it to bf16 into a 128-byte-swizzled K-major A
//    tile (the projection's rows are pairs, so the chunk goes through shared
//    memory), and multiplies it by the chunk's 64 rows of W (m64n144k16 x 2).
//    The next chunk's op products run while this chunk's projection does.
//    Variants on the H100 (probes/opm_variants.py) show a call bound by its
//    chain of small op products, LN steps and barriers: cutting the
//    projection's products or W's loads saves little of its time.
//  * W streams by TMA in 64-deep K chunks (36 KB) through a full / empty
//    mbarrier ring that runs on into the next tile; thread 0 issues with
//    every thread running the issue code in step (a branch around it
//    serialises the wgmmas). W stays hot in L2: it is read 576 KB a tile of
//    128 pairs. The wrapper permutes W's rows into the chunk order.
//  * The epilogue adds the bias, rounds to bf16 and writes whole 16-byte
//    vectors of each pair's row (pairs past L are not written).
// float32 (opm_f32_kernel): CUDA cores; a block owns one row i and 16
// columns j, op in shared memory (64 KB), one warp a pair's LayerNorm, W
// staged in 32-wide K chunks.

#include "common.cuh"
#include "hopper.cuh"

using namespace rf;

namespace {

constexpr int U = 32, UV = U * U, DP = 288;  // d_proj, its square, d_pair

// ---- float32: CUDA cores ----------------------------------------------------
constexpr int BJ = 16;  // pairs (columns j) per block
constexpr int NC = 16;  // MSA rows per chunk
constexpr int NTHREADS = 256;
constexpr int LDO = UV + 8;        // row stride of the op tile
constexpr int LDN = NC + 8;        // stride of the staged x / y chunks
constexpr int NTILE_OUT = DP / 8;  // 36 n8 tiles of the projection
constexpr int KW = 32;             // W chunk along K
constexpr int LDW = KW + 8;
constexpr size_t F32_OP = sizeof(float) * BJ * LDO;
constexpr size_t F32_XS = sizeof(float) * U * LDN;
constexpr size_t F32_YS = sizeof(float) * BJ * U * LDN;
constexpr size_t F32_WS = sizeof(float) * DP * LDW;
constexpr size_t F32_SMEM = F32_OP + F32_XS + (F32_YS > F32_WS ? F32_YS : F32_WS);

__global__ void __launch_bounds__(NTHREADS)
opm_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ wt, const float* __restrict__ bias,
               float* __restrict__ out, int N, int L, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Op = reinterpret_cast<float*>(smem_raw);                 // [BJ][LDO]
  float* Xs = reinterpret_cast<float*>(smem_raw + F32_OP);        // [U][LDN]: x[n, i, u]^T
  float* Ys = reinterpret_cast<float*>(smem_raw + F32_OP + F32_XS);  // [BJ*U][LDN]
  float* Ws = Ys;                                                 // [DP][LDW] (after op)

  const int b = blockIdx.z, i = blockIdx.y, j0 = blockIdx.x * BJ;
  const int nj = min(BJ, L - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long plane = (long long)L * U;  // one MSA row of x or y
  const float* xb = x + (long long)b * N * plane + (long long)i * U;
  const float* yb = y + (long long)b * N * plane + (long long)j0 * U;

  // 1. op tile: C[u][(j, v)], warp w owns u 0..31 x columns w*64 .. w*64+63
  float acc[2][8][4];
  zero(acc[0]);
  zero(acc[1]);
  for (int n0 = 0; n0 < N; n0 += NC) {
    __syncthreads();
    for (int e = tid; e < U * NC; e += NTHREADS) {
      const int n = e / U, u = e % U;
      Xs[u * LDN + n] = n0 + n < N ? xb[(long long)(n0 + n) * plane + u] : 0.f;
    }
    for (int e = tid; e < NC * BJ * U; e += NTHREADS) {
      const int n = e / (BJ * U), jv = e % (BJ * U);
      const bool in = n0 + n < N && jv / U < nj;
      Ys[jv * LDN + n] = in ? yb[(long long)(n0 + n) * plane + jv] : 0.f;
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
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int k = lane + 32 * t;
      row[k] = (v[t] - mu) * rs * gamma[k] + beta[k];
    }
  }

  // 3. out (BJ x 288) = LN . W + bias; warp w owns n8 tiles w, w + 8, ...
  float acc3[5][1][4];
#pragma unroll
  for (int t = 0; t < 5; ++t) zero(acc3[t]);
  for (int k0 = 0; k0 < UV; k0 += KW) {
    __syncthreads();  // LN written / previous W chunk consumed
    stage<float>(Ws, LDW, wt + k0, UV, DP, DP, KW);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int tile = warp + 8 * t;
      if (tile < NTILE_OUT)
        warp_gemm<1>(acc3[t], Op + k0, LDO, Ws + tile * 8 * LDW, LDW, KW);
    }
  }
  float* ob = out + (((long long)b * L + i) * L + j0) * DP;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const int tile = warp + 8 * t;
    if (tile >= NTILE_OUT) continue;
    for_each(acc3[t], [&](int r, int c, float v) {
      const int col = tile * 8 + c;
      if (r < nj) ob[(long long)r * DP + col] = v + bias[col];
    });
  }
}

cudaError_t launch_f32(const float* x, const float* y, const float* gamma, const float* beta,
                       const float* wt, const float* bias, float* out, int B, int N, int L,
                       float eps, cudaStream_t st) {
  if (L > 65535 || B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(opm_f32_kernel, F32_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BJ - 1) / BJ, L, B);
  opm_f32_kernel<<<grid, NTHREADS, F32_SMEM, st>>>(x, y, gamma, beta, wt, bias, out, N, L, eps);
  return cudaGetLastError();
}

// ---- bfloat16: TMA + wgmma ------------------------------------------------------
namespace wg {

using namespace rf::hopper;

constexpr int TI = 8, TJ = 16;        // a tile: 8 rows i x 16 columns j
constexpr int NCHUNK = UV / 64;       // K chunks of 8 u x 8 v; chunk c = 4 * (u / 8) + v / 8
constexpr int W_STAGE = DP * 128;     // 288 rows (N) x 64 of K, K-major: 36 KB
constexpr int W_HALF = W_STAGE / 2;   // a TMA box and an m64n144's B: 144 rows
constexpr int A_TILE = 64 * 128;      // 64 pairs x 64 of K, K-major
constexpr int GROUP = 64;             // MSA rows resident at most

// Shared memory from a 1024-byte boundary, for NKS K steps of 16 MSA rows:
// the W ring; x's four u chunks (MN-major: a row of 8 i x 8 u per MSA row);
// per warpgroup y's four v chunks (8 j x 8 v per MSA row) and two A tiles
// (also the epilogue's staging); each pair's mean and 1/std; the barriers.
template <int NKS>
struct Layout {
  static constexpr int XT = NKS * 2048;  // one chunk of x or y: NKS * 16 MSA rows x 128 bytes
  static constexpr int STAGES = NKS >= 4 ? 2 : 3;
  static constexpr int X_OFF = STAGES * W_STAGE;
  static constexpr int WG_BYTES = 4 * XT + 2 * A_TILE;
  static constexpr int WG_OFF = X_OFF + 4 * XT;
  static constexpr int STAT_OFF = WG_OFF + 2 * WG_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + 2 * 64 * 8;  // full, empty: STAGES each
  static constexpr size_t SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(WG_BYTES >= PAIR_STAGE_BYTES, "the epilogue's staging exceeds a warpgroup's area");
  static_assert(SMEM <= 232448, "shared memory");
};

// NKS: K steps of 16 MSA rows resident (N <= 64: ceil(N / 16)); MULTI: N >
// 64, the rows staged 64 at a time for each chunk (not on the served path).
template <int NKS, bool MULTI>
__global__ void __launch_bounds__(NTHREADS, 1)
opm_wgmma_kernel(const __grid_constant__ CUtensorMap w_map, const float* __restrict__ x,
                 const bf16* __restrict__ y, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ bias,
                 bf16* __restrict__ out, int N, int L, float eps, long long tiles) {
  using Ly = Layout<NKS>;
  constexpr int STAGES = Ly::STAGES, XT = Ly::XT, NR = NKS * 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + Ly::BAR_OFF, empty = full + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t leader = threadIdx.x == 0;
  const uint32_t xs = base + Ly::X_OFF;                     // x chunk tiles
  const int wg_off = Ly::WG_OFF + wg * Ly::WG_BYTES;        // this warpgroup's area
  const uint32_t ys = base + wg_off, as = ys + 4 * XT;      // its y chunks, A tiles
  float2* stat = reinterpret_cast<float2*>(smem + Ly::STAT_OFF) + 64 * wg;  // mean, 1/std
  const int tiles_i = (L + TI - 1) / TI, tiles_j = (L + TJ - 1) / TJ;

  if (leader) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NTHREADS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // W's chunks in the order the products take them over the block's tiles
  long long ld_tile = blockIdx.x;
  int ld_c = 0, n_ld = 0;
  auto issue = [&](int released) {
    while (ld_tile < tiles && n_ld < released + STAGES) {
      const int s = n_ld % STAGES;
      mbar_wait(empty + 8 * s, ((n_ld / STAGES) & 1) ^ 1);
      const uint32_t dst = base + s * W_STAGE, bar = full + 8 * s;
      mbar_arrive_expect_tx(bar, W_STAGE, leader);
      tma_load_2d(dst, &w_map, bar, 64 * ld_c, 0, leader);
      tma_load_2d(dst + W_HALF, &w_map, bar, 64 * ld_c, DP / 2, leader);
      ++n_ld;
      if (++ld_c == NCHUNK) {
        ld_c = 0;
        ld_tile += gridDim.x;
      }
    }
  };
  issue(0);
  int n_used = 0;  // W chunks this warpgroup has released

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = (int)(tile / ((long long)tiles_i * tiles_j));
    const int rem = (int)(tile % ((long long)tiles_i * tiles_j));
    const int i0 = TI * (rem / tiles_j), j0 = TJ * (rem % tiles_j);

    // MSA rows n0 .. n0 + NR of the tile's x (rounded to bf16) and y into
    // their chunk tiles (only u chunk `uc` and v chunk `vc` when >= 0); rows
    // past N and pairs past L read as zeros. Whole block.
    auto stage = [&](int n0, int uc_only, int vc_only) {
      __syncthreads();  // the tiles are no longer read
      for (int e = threadIdx.x; e < NR * TI * 4; e += NTHREADS) {
        const int uc = e & 3, il = (e >> 2) & 7, n = e >> 5;
        if (uc_only >= 0 && uc != uc_only) continue;
        const int nn = n0 + n, i = i0 + il;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (nn < N && i < L) {
          const float4* p = reinterpret_cast<const float4*>(
              x + (((long long)b * N + nn) * L + i) * U + 8 * uc);
          const float4 a = __ldg(p), c = __ldg(p + 1);
          v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(c.x, c.y),
                         pack_bf16(c.z, c.w));
        }
        *reinterpret_cast<uint4*>(smem + Ly::X_OFF + uc * XT + n * 128 + ((il ^ (n & 7)) << 4)) =
            v;
      }
      for (int e = threadIdx.x; e < NR * TJ * 4; e += NTHREADS) {
        const int vc = e & 3, jj = (e >> 2) & 15, n = e >> 6;
        if (vc_only >= 0 && vc != vc_only) continue;
        const int nn = n0 + n, j = j0 + jj;
        const bool ok = nn < N && j < L;
        const bf16* src = ok ? y + (((long long)b * N + nn) * L + j) * U + 8 * vc : y;
        cp_async_16z(smem + Ly::WG_OFF + (jj >> 3) * Ly::WG_BYTES + vc * XT + n * 128 +
                         (((jj & 7) ^ (n & 7)) << 4),
                     src, ok);
      }
      cp_async_wait_all();
      fence_proxy_async();
      __syncthreads();
    };

    // d = chunk c's op for the warpgroup's 64 pairs (+= d with `accumulate`):
    // row 8 i + u, column 8 j + v of C = X^T . Y
    auto op_issue = [&](float(&d)[32], int c, int accumulate) {
      const uint32_t xa = xs + (c >> 2) * XT, yb = ys + (c & 3) * XT;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        Wgmma<64>::ss<1, 1>(d, desc_sw128_mn(xa + ks * 2048, XT), desc_sw128_mn(yb + ks * 2048, XT),
                            ks > 0 || accumulate);
      wgmma_commit();
    };
    // MULTI: chunk c's op summed over the groups of 64 MSA rows
    auto op_groups = [&](float(&d)[32], int c) {
      for (int n0 = 0; n0 < N; n0 += GROUP) {
        stage(n0, c >> 2, c & 3);
        op_issue(d, c, n0 > 0);
        wgmma_wait<0>();
      }
    };

    // The thread's 16 pairs: p = 8 h + m is pair (i0 + 2 wq + h, j0 + 8 wg + m),
    // the warpgroup's row 16 wq + 8 h + m, with the values d[4m + 2h], d[4m + 2h + 1]
    // at u = 8 (c / 4) + g, v = 8 (c % 4) + 2t, +1. Pass 1: mean and M2 of each
    // pair's values merged chunk by chunk (2 values a chunk; Chan's formula).
    float mean[16], m2[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) mean[p] = m2[p] = 0.f;
    auto stats = [&](const float(&d)[32], int c) {
      const float inv = 1.f / (float)(c + 1), w2 = 2.f * (float)c * inv;
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 8 * h + m;
          const float a = d[4 * m + 2 * h], bb = d[4 * m + 2 * h + 1];
          const float mab = 0.5f * (a + bb), dab = a - bb, delta = mab - mean[p];
          mean[p] += delta * inv;
          m2[p] += 0.5f * dab * dab + delta * delta * w2;
        }
    };

    // chunk c normalized, rounded to bf16, into A tile `a` (row = pair, K =
    // 8 u + v within the chunk; the 128-byte swizzle)
    auto normalize = [&](const float(&d)[32], int c, uint32_t a) {
      const int k = 32 * (8 * (c >> 2) + g) + 8 * (c & 3) + 2 * t;
      const float2 ga = __ldg(reinterpret_cast<const float2*>(gamma + k));
      const float2 be = __ldg(reinterpret_cast<const float2*>(beta + k));
      unsigned char* at = smem + (a - base);
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + 8 * h + m;
          const float2 s = stat[r];
          *reinterpret_cast<uint32_t*>(at + r * 128 + ((g ^ m) << 4) + 4 * t) =
              pack_bf16((d[4 * m + 2 * h] - s.x) * s.y * ga.x + be.x,
                        (d[4 * m + 2 * h + 1] - s.x) * s.y * ga.y + be.y);
        }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
    };

    float acc0[72], acc1[72];  // output columns 0-143 and 144-287
    // acc += A tile (chunk c) . W chunk (the next W stage)
    auto proj = [&](int c, int w_idx) {
      const int s = w_idx % STAGES;
      mbar_wait(full + 8 * s, (w_idx / STAGES) & 1);
      const uint32_t a = as + (c & 1) * A_TILE, w = base + s * W_STAGE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wgmma<144>::ss(acc0, desc_sw128(a + ks * 32), desc_sw128(w + ks * 32), 1);
        Wgmma<144>::ss(acc1, desc_sw128(a + ks * 32), desc_sw128(w + W_HALF + ks * 32), 1);
      }
      wgmma_commit();
    };
    auto release = [&]() {  // the oldest W chunk in use is no longer read
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (n_used % STAGES));
      issue(++n_used);
    };

    // pass 1: each chunk's op products, then its statistics (keeping the next
    // chunk's products in flight meanwhile made ptxas serialise the wgmmas,
    // C7514; four chunks a wgmma group were no faster)
    float d0[32];
    if (!MULTI) stage(0, -1, -1);
    for (int c = 0; c < NCHUNK; ++c) {
      if (MULTI) {
        op_groups(d0, c);
      } else {
        op_issue(d0, c, 0);
        wgmma_wait<0>();
      }
      stats(d0, c);
    }
    // merge the lanes' statistics (each lane holds 32 values of each pair)
    float cnt = 32.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const float mb = __shfl_xor_sync(0xffffffffu, mean[p], off);
        const float qb = __shfl_xor_sync(0xffffffffu, m2[p], off);
        const float delta = mb - mean[p];
        mean[p] = 0.5f * (mean[p] + mb);
        m2[p] = m2[p] + qb + delta * delta * (0.5f * cnt);
      }
      cnt *= 2.f;
    }
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if (lane == p) stat[16 * wq + p] = make_float2(mean[p], rsqrtf(m2[p] / UV + eps));
    __syncwarp();

    // pass 2: acc = LN(op) . W, chunk by chunk
#pragma unroll
    for (int e = 0; e < 72; ++e) acc0[e] = acc1[e] = 0.f;
    const int w0 = n_used;  // the tile's first W chunk
    if (!MULTI) {
      // chunk c + 1's op products run beside chunk c's projection; the ends
      // are peeled, so the loop body issues its wgmmas unconditionally
      op_issue(d0, 0, 0);
      wgmma_wait<0>();
      normalize(d0, 0, as);
      op_issue(d0, 1, 0);
      proj(0, w0);
      wgmma_wait<1>();
      normalize(d0, 1, as + A_TILE);
      for (int c = 1; c < NCHUNK - 1; ++c) {
        op_issue(d0, c + 1, 0);
        proj(c, w0 + c);
        wgmma_wait<1>();  // chunk c + 1's op and chunk c - 1's projection are done
        release();
        normalize(d0, c + 1, as + ((c + 1) & 1) * A_TILE);
      }
      proj(NCHUNK - 1, w0 + NCHUNK - 1);
      wgmma_wait<0>();
      release();
      release();
    } else {
      for (int c = 0; c < NCHUNK; ++c) {
        op_groups(d0, c);
        normalize(d0, c, as + (c & 1) * A_TILE);
        proj(c, w0 + c);
        wgmma_wait<0>();
        release();
      }
    }

    // epilogue: the warpgroup's 64 pairs (row 8 il + jl) through its area
    const long long row0 = ((long long)b * L + i0) * L + j0 + 8 * wg;
    epilogue_rows_288(
        reinterpret_cast<bf16*>(smem + wg_off), acc0, acc1, bias, 0,
        [=](int r) { return out; },
        [=](int r) -> bf16* {
          const int il = r >> 3, jl = r & 7;
          return i0 + il < L && j0 + 8 * wg + jl < L ? out + (row0 + (long long)il * L + jl) * DP
                                                     : nullptr;
        },
        64, 1 + wg);
  }
}

template <int NKS, bool MULTI>
cudaError_t launch(const CUtensorMap& w_map, const float* x, const bf16* y, const float* gamma,
                   const float* beta, const float* bias, bf16* out, int B, int N, int L,
                   float eps, cudaStream_t st) {
  using Ly = Layout<NKS>;
  cudaError_t err = set_smem(opm_wgmma_kernel<NKS, MULTI>, Ly::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((L + TI - 1) / TI) * ((L + TJ - 1) / TJ);
  const unsigned grid = (unsigned)(tiles < sm_count() ? tiles : sm_count());
  opm_wgmma_kernel<NKS, MULTI><<<grid, NTHREADS, Ly::SMEM, st>>>(w_map, x, y, gamma, beta, bias,
                                                                   out, N, L, eps, tiles);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const float* x, const bf16* y, const float* gamma, const float* beta,
                        const bf16* wt, const float* bias, bf16* out, int B, int N, int L,
                        float eps, cudaStream_t st) {
  if (((uintptr_t)x | (uintptr_t)y | (uintptr_t)wt | (uintptr_t)out) % 16)
    return cudaErrorInvalidValue;
  // wt (288, 1024) [out][k], K in chunk order: 64 of K x 144 rows a box
  CUtensorMap w_map;
  const cuuint64_t dims[2] = {UV, DP}, strides[1] = {UV * 2};
  const cuuint32_t box[2] = {64, DP / 2};
  cudaError_t err = encode_bf16_sw128(&w_map, wt, 2, dims, strides, box);
  if (err != cudaSuccess) return err;
  if (N > GROUP) return launch<4, true>(w_map, x, y, gamma, beta, bias, out, B, N, L, eps, st);
  switch ((N + 15) / 16) {
    case 1: return launch<1, false>(w_map, x, y, gamma, beta, bias, out, B, N, L, eps, st);
    case 2: return launch<2, false>(w_map, x, y, gamma, beta, bias, out, B, N, L, eps, st);
    case 3: return launch<3, false>(w_map, x, y, gamma, beta, bias, out, B, N, L, eps, st);
    default: return launch<4, false>(w_map, x, y, gamma, beta, bias, out, B, N, L, eps, st);
  }
}

}  // namespace wg

}  // namespace

extern "C" {

// x (B, N, L, 32) float32 (i side); y (B, N, L, 32) (j side); gamma, beta
// (1024) float32; wt (288, 1024): W^T, nn.Linear layout (float32), or with
// K in the bf16 kernel's chunk order (bfloat16: column 64 c + 8 ul + vl is
// W's row 32 (8 (c / 4) + ul) + 8 (c % 4) + vl); bias (288) float32; out
// (B, L, L, 288) in y's dtype. dtype: 0 float32, 1 bfloat16 (x, y, wt, out
// 16-byte aligned).
int outer_product_fwd(const float* x, const void* y, const float* gamma, const float* beta,
                      const void* wt, const float* bias, void* out, int B, int N, int L, int u,
                      int dp, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u != U || dp != DP || B <= 0 || N <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(x, static_cast<const float*>(y), gamma, beta, static_cast<const float*>(wt),
                      bias, static_cast<float*>(out), B, N, L, eps, st);
  if (dtype == 1)
    return wg::launch_bf16(x, static_cast<const bf16*>(y), gamma, beta,
                           static_cast<const bf16*>(wt), bias, static_cast<bf16*>(out), B, N, L,
                           eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
