// One GSE3Res layer's V/K partial convolutions plus its equivariant
// attention, dense and gather layouts: a kernel for Hopper (sm_90a).
//
// Replaces rosettafold_tpu/ops/pallas/se3_attend.py `_forward_planes`
// (the pl.pallas_call at :486, public entries `gse3_attend_planes` :607 and
// `gse3_attend` :721), with `dense=True` and, fed by `gather_h_planes` (:405),
// `dense=False`. Same math as that file's `xla_reference` (:509).
//
// Per edge (dst j, src s) and per degree pair p = (branch, d_in, d_out):
//   R    = fc3(relu(LN(fc2(relu(LN(fc1(feat)))))))   radial MLP, 32 wide
//   t    = sum_n basis[m, n, f] * h_src[c, n]
//   msg[o, m] += sum_{f, c} R[o, f, c] * t[m, f, c]
// then per head: e = k_msg . q_dst / sqrt(n_key), softmax over the sources s
// (masked logits -1e9, masked weights zeroed), out = sum_s att * v_msg.
//
// Layouts are the natural ones of `xla_reference`, not the TPU's
// edges-in-lanes planes (those exist for Mosaic's (8, 128) tiling):
//   feat (B, J, S, ed); basis '{di},{do}' (B, J, S, 2do+1, 2di+1, nf);
//   h0 (B, L, m0, 1), h1 (B, L, m1, 3); mask (B, J, S) uint8;
//   qh (B, J, H*ck); out (B, J, F) with columns (degree, channel, m).
// Source slot s of destination j is node s (dense layout, S == L) or, when
// src_idx (B, J, S) int32 is given (gather layout, any L), node
// src_idx[b, j, s], read from h in place. A masked slot's index is never
// read: the bucket layout leaves arbitrary indices in its empty slots.
// Weights are `stack_weights`' operands as they lie: w1t (32P, ed), misc
// (32P, 6), w2t (32P, 32), and fc3 rows permuted to (o, f, c) order, 8-row
// padded per pair: w3t (NW3, 32), w3b (NW3). Every weight is K-major (rows
// of the contraction), the only layout TF32 wgmma takes.
//
// What bounds it on this card: operations. Each edge runs 2 |pairs| radial
// MLPs (about 50k-100k multiply-adds at the layers' widths) against ~300
// bytes of edge input; fc3 is most of them (1136 x 32 at the first layer,
// 768 x 32 at the second). float32 accuracy is the contract (the plain
// version's 2e-5), so the MLPs run on the tensor cores in TF32 with a 3-pass
// split: x = big + small (tf32_split: big is x cut to TF32, small the exact
// rest) and a . b = small.big + big.small + big.big in float32 accumulation
// (x kept to 2^-21; one TF32 pass keeps 2^-11). That is up to 495 / 3 = 165
// TFLOP/s, against 67 for float32 FMAs on the CUDA cores.
// The design:
//  * a block per SM (at most), with an equal share of all unmasked edges:
//    every block counts the mask's rows and takes the destinations whose
//    first edge falls in its share, so a destination's edges stay in one
//    block (in-degrees vary widely: with equal destination counts a block,
//    the busiest blocks held far more than the mean share);
//  * the block lists its unmasked slots (a prefix sum over the mask) and
//    walks them in tiles of 64 edges, the M of m64nNk8, a tile spanning
//    destinations: no thread waits on a masked edge;
//  * per tile it stages the edges' features, basis values and their
//    sources' h rows; two warpgroups then run the value pairs and the key
//    pairs side by side (they write disjoint messages), each with its own
//    weights: per degree pair fc1 (N = 32, K = 32 * floor(ed / 32); the
//    other ed % 32 columns, the radius at ed = 65, are float32 FMAs into the
//    accumulators before the products: no padded copy of feat) and fc2 on
//    wgmma, LayerNorm and relu on the accumulator fragments (a row's 32
//    values lie in one quad), the activations back to shared memory as the
//    next product's A operand, then fc3 in 64-column chunks (N = 64, K = 32);
//  * every operand arrives by cp.async (4-byte copies where rows are not
//    16-byte aligned: feat, w1t) and is split into big and small in place;
//    a pair's fc1 / fc2 weights are copied during the previous pair's fc3,
//    each fc3 chunk during the previous chunk's contraction;
//  * the basis contraction runs on the CUDA cores from a chunk of R staged
//    in shared memory: two threads an edge, each over alternate c,
//    contracting c first (u = sum_c R h_src, then the basis once per (o, f)),
//    joined by a shuffle; value messages collect in shared memory, key
//    messages go straight into the logits (k . q is linear in k);
//  * at the end of each tile, per destination in it (a segment), the softmax
//    over its edges, online across tiles (the destination that continues
//    into the next tile carries its max, denominator and weighted sum), and
//    the attention-weighted sum of the value messages; a destination whose
//    edges end in the tile is written out.
// The weights come from L2 (under 0.5 MB a layer); no copy, split or launch
// is added to a call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// Kernel parameters, passed by value. Global scope: the extern "C" entry
// takes a pointer to Meta, and a type of internal linkage would give that
// entry internal linkage too.
constexpr int MAX_PAIRS = 8;

struct PairDesc {
  int branch;   // 0: value, 1: key
  int di, dout, mi, mo, nf;
  int w3_off;   // first row of this pair in w3t / w3b
  int msg_off;  // offset of degree dout in the branch's message array
};

struct Meta {
  int npairs, ed, H, nv, nk, ck;
  int m_in[2];   // input multiplicities per degree
  int mk[2];     // key multiplicities per degree
  int k_off[2];  // offset of degree d in the key messages
  int hoff[2];   // column offset of degree d inside one head block of q
  int mv[2];     // value multiplicities per degree
  int v_off[2];  // offset of degree d in the value messages (= out columns)
  float inv_sqrt;
  PairDesc p[MAX_PAIRS];
};

namespace {

using namespace rf::hopper;

constexpr int MID = 32;      // radial MLP width
constexpr int NWG = 2;       // warpgroups: value pairs, key pairs
constexpr int NT = 128 * NWG;
constexpr int TE = 64;       // edges a tile (wgmma's M)
constexpr int LDR = 66;      // row stride of a staged R chunk (floats)
constexpr int MAX_H = 16;
constexpr int NB = 1 + 3 + 3 + 27;  // basis values an edge: '0,0', '0,1', '1,0', '1,1'
constexpr int BLD = NB + 1;         // their row stride in shared memory

// shared memory (bytes from a 1024-aligned base); every wgmma tile is a
// K-major tile of rows of 32 floats in the 128-byte swizzle. The features
// are shared; each warpgroup has its own weights, activations and R.
constexpr int FEAT_OFF = 0;                   // big [2], small [2]: 64 x 32
constexpr int WG_OFF = FEAT_OFF + 4 * 8192;   // warpgroup w at WG_OFF + w * WG_BYTES:
constexpr int W1_OFF = 0;                     //   big [2], small [2]: 32 x 32
constexpr int W2_OFF = W1_OFF + 4 * 4096;     //   big, small: 32 x 32
constexpr int ACT_OFF = W2_OFF + 2 * 4096;    //   big, small: 64 x 32
constexpr int W3_OFF = ACT_OFF + 2 * 8192;    //   big, small: 64 x 32 (an fc3 chunk)
constexpr int RS_OFF = W3_OFF + 2 * 8192;     //   [TE][LDR] float: R of the chunk
constexpr int MISC_OFF = RS_OFF + TE * LDR * 4;  // [32][6] float: the pair's misc rows
constexpr int B3_OFF = MISC_OFF + MID * 6 * 4;   // [64] float: the chunk's fc3 bias
constexpr int WG_BYTES = (B3_OFF + 64 * 4 + 1023) / 1024 * 1024;
constexpr int VAR_OFF = WG_OFF + NWG * WG_BYTES;  // the arrays sized per call

// the byte of a float at (row, k) of a swizzled tile of rows of 32 floats
__device__ __forceinline__ uint32_t sw_off(int row, int k) {
  return row * 128 + ((((k >> 2) ^ (row & 7)) << 4) | ((k & 3) << 2));
}

// `bytes` of float32 at `big` (whole tiles, as copied) split in place by
// `n` threads (thread i of them): big keeps x's TF32 part, big +
// small_delta gets the rest (tf32_split)
__device__ __forceinline__ void split_tiles(unsigned char* big, int small_delta, int bytes, int i,
                                            int n) {
  for (int off = 16 * i; off < bytes; off += 16 * n) {
    const float4 x = *reinterpret_cast<float4*>(big + off);
    float4 b, s;
    tf32_split(x.x, b.x, s.x);
    tf32_split(x.y, b.y, s.y);
    tf32_split(x.z, b.z, s.z);
    tf32_split(x.w, b.w, s.w);
    *reinterpret_cast<float4*>(big + off) = b;
    *reinterpret_cast<float4*>(big + small_delta + off) = s;
  }
}

// rows of 32 floats (16-byte aligned) into a swizzled tile by a warpgroup
// (thread lt of 128), rows >= valid zero-filled
template <int ROWS>
__device__ __forceinline__ void copy_rows32(unsigned char* tile, const float* __restrict__ src,
                                            int valid, int lt) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / 128; ++i) {
    const int e = lt + i * 128, r = e >> 3, c = e & 7;
    cp_async_16z(tile + r * 128 + ((c ^ (r & 7)) << 4), r < valid ? src + r * MID + 4 * c : src,
                 r < valid);
  }
}

// acc (64 x N) = A . B^T over KC chunks of K = 32, in three TF32 passes
// (small . big, big . small, big . big): A tiles at a_big / a_small + ch *
// a_step, B tiles at b_big / b_small + ch * b_step. Issued, not waited for.
template <int N, int KC>
__device__ __forceinline__ void mma3(float (&acc)[N / 2], uint32_t a_big, uint32_t a_small,
                                     uint32_t a_step, uint32_t b_big, uint32_t b_small,
                                     uint32_t b_step) {
  wgmma_fence();
#pragma unroll
  for (int ch = 0; ch < KC; ++ch)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t ao = ch * a_step + ks * 32, bo = ch * b_step + ks * 32;
      WgmmaTf32<N>::ss(acc, desc_sw128(a_small + ao), desc_sw128(b_big + bo), 1);
      WgmmaTf32<N>::ss(acc, desc_sw128(a_big + ao), desc_sw128(b_small + bo), 1);
      WgmmaTf32<N>::ss(acc, desc_sw128(a_big + ao), desc_sw128(b_big + bo), 1);
    }
  wgmma_commit();
}

// A LayerNorm's parameters for the fragment columns 8i + 2t + e of a
// thread (index 2i + e): bias, gamma, beta from the pair's [32][6] misc rows
// at columns col0, col0 + 1, col0 + 2
struct LnParams {
  float bias[8], gamma[8], beta[8];
};

__device__ __forceinline__ LnParams ln_params(const float* misc, int col0, int t) {
  LnParams q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* m = misc + (8 * i + 2 * t + e) * 6 + col0;
      q.bias[2 * i + e] = m[0];
      q.gamma[2 * i + e] = m[1];
      q.beta[2 * i + e] = m[2];
    }
  return q;
}

// bias, LayerNorm (float32 statistics, var = E[x^2] - E[x]^2) and relu of
// the fragment rows of a 64 x 32 accumulator, written as big / small into
// the activation tiles (the next product's A operand). x[4i + 2h + e]: row
// 16w + g + 8h, column 8i + 2t + e; a row's 32 values lie in one quad.
__device__ __forceinline__ void ln_relu_store(float (&x)[16], const LnParams& q,
                                              unsigned char* act, int lt) {
  const int lane = lt & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (lt >> 5) * 16 + g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[4 * i + e] += q.bias[2 * i + e];
      x[4 * i + 2 + e] += q.bias[2 * i + e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s += x[4 * i + 2 * h + e];
        ss += x[4 * i + 2 * h + e] * x[4 * i + 2 * h + e];
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    const float mu = s * (1.f / MID);
    const float inv = rsqrtf(ss * (1.f / MID) - mu * mu + 1e-5f);
    const int row = row0 + 8 * h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 8 * i + 2 * t;
      float b[2], sm[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = fmaxf(
            (x[4 * i + 2 * h + e] - mu) * inv * q.gamma[2 * i + e] + q.beta[2 * i + e], 0.f);
        tf32_split(y, b[e], sm[e]);
      }
      const uint32_t off = sw_off(row, n);
      *reinterpret_cast<float2*>(act + off) = make_float2(b[0], b[1]);
      *reinterpret_cast<float2*>(act + 8192 + off) = make_float2(sm[0], sm[1]);
    }
  }
}

// the head of value-message column `col`
__device__ __forceinline__ int head_of(const Meta& meta, int col) {
  const int d = (meta.mv[1] > 0 && col >= meta.v_off[1]) ? 1 : 0;
  return (col - meta.v_off[d]) / (2 * d + 1) / (meta.mv[d] / meta.H);
}

// the next pair of `branch` after pair pi, wrapping to its first (the next
// tile's); -1 if the branch has none
__device__ __forceinline__ int next_pair(const Meta& meta, int branch, int pi) {
  for (int k = 1; k <= meta.npairs; ++k) {
    const int q = (pi + k) % meta.npairs;
    if (meta.p[q].branch == branch) return q;
  }
  return -1;
}

// KC: 32-column chunks of feat on wgmma (ed / 32, 1 or 2)
template <int KC>
__global__ void __launch_bounds__(NT)
se3_attend_kernel(const float* __restrict__ feat, const float* __restrict__ b00,
                  const float* __restrict__ b01, const float* __restrict__ b10,
                  const float* __restrict__ b11, const float* __restrict__ h0,
                  const float* __restrict__ h1, const uint8_t* __restrict__ mask,
                  const float* __restrict__ qh, const float* __restrict__ w1t,
                  const float* __restrict__ misc, const float* __restrict__ w2t,
                  const float* __restrict__ w3t, const float* __restrict__ w3b,
                  const int* __restrict__ src_idx, float* __restrict__ out, int BJ, int J, int S,
                  int L, const __grid_constant__ Meta meta) {
  constexpr int KMAIN = 32 * KC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int H = meta.H, ed = meta.ed, mi0 = meta.m_in[0], mi1 = meta.m_in[1];
  const int tail = ed - KMAIN, hrow = mi0 + 3 * mi1, HC = H * meta.ck;
  const int hld = hrow | 1;  // odd row strides: fewer bank conflicts
  const int nvp = meta.nv | 1;
  float* Hs = reinterpret_cast<float*>(sm + VAR_OFF);  // [TE][hld] h rows of the sources
  float* vS = Hs + TE * hld;                           // [TE][nvp] value messages
  float* eS = vS + TE * nvp;                           // [TE][H] logits, then weights
  float* Bs = eS + TE * H;                             // [TE][BLD] the edges' basis values
  float* fT = Bs + TE * BLD;                           // [TE][tail] feat past KMAIN
  float* w1Ts = fT + TE * tail;                        // [NWG][MID][tail] w1t past KMAIN
  // the destination carried from one tile into the next: its weighted sum
  // (two buffers, read and written in turn), running max and denominator
  float* cO = w1Ts + NWG * MID * tail;                 // [2][nv]
  float* cM = cO + 2 * meta.nv;                        // [H]
  float* cDen = cM + H;                                // [H]
  float* sM = cDen + H;                                // [TE][H] a tile segment's max,
  float* sDen = sM + TE * H;                           // [TE][H] denominator,
  float* sScl = sDen + TE * H;                         // [TE][H] the carried sum's rescale
  int* eIdx = reinterpret_cast<int*>(sScl + TE * H);   // [TE] edge (q * S + s), -1 past ne
  int* eSrc = eIdx + TE;                               // [TE] source row b * L + src
  int* eDst = eSrc + TE;                               // [TE] destination - qa
  int* sStart = eDst + TE;                             // [TE + 1] tile segment starts
  int* wsum = sStart + TE + 1;                         // [NT / 32 + 4] per-warp sums, results
  int* list = wsum + NT / 32 + 4;                      // unmasked (d * S + s) of the block

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, lt = tid & 127;  // warpgroup (= the branch it runs), its thread
  unsigned char* wsm = sm + WG_OFF + wg * WG_BYTES;
  const uint32_t wbase = smem_u32(wsm), fbase = smem_u32(sm + FEAT_OFF);
  float* Rs = reinterpret_cast<float*>(wsm + RS_OFF);
  float* miscS = reinterpret_cast<float*>(wsm + MISC_OFF);
  float* b3S = reinterpret_cast<float*>(wsm + B3_OFF);
  float* w1T = w1Ts + wg * MID * tail;

  // the block's destinations [qa, qb): an equal share of all unmasked edges
  // (E / gridDim.x), cut at destination boundaries (a destination's edges
  // stay in one block); every block reads the whole mask twice (from L2)
  auto row_count = [&](int q) {  // unmasked slots of destination q
    const uint8_t* row = mask + (size_t)q * S;
    int c = 0;
    if ((S & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) & 3) == 0) {
      for (int s = 0; s < S; s += 4)
        c += __popc(*reinterpret_cast<const uint32_t*>(row + s) & 0x01010101u);
    } else {
      for (int s = 0; s < S; ++s) c += row[s];
    }
    return c;
  };
  auto block_scan = [&](int v, int& total) {  // inclusive prefix over the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    total = 0;
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) v += wsum[w];
      total += wsum[w];
    }
    __syncthreads();
    return v;
  };
  int E = 0;
  {
    int c = 0;
    for (int q = tid; q < BJ; q += NT) c += row_count(q);
    block_scan(c, E);
  }
  const long long Ta = (long long)blockIdx.x * E / gridDim.x;
  const long long Tb = (long long)(blockIdx.x + 1) * E / gridDim.x;
  if (tid == 0) wsum[NT / 32] = wsum[NT / 32 + 1] = BJ;
  __syncthreads();
  for (int q0 = 0, run = 0; q0 < BJ; q0 += NT) {  // the first q with prefix >= Ta, >= Tb
    const int q = q0 + tid, c = q < BJ ? row_count(q) : 0;
    int total;
    const int pre = run + block_scan(c, total) - c;
    if (q < BJ && pre >= Ta) atomicMin(&wsum[NT / 32], q);
    if (q < BJ && pre >= Tb) atomicMin(&wsum[NT / 32 + 1], q);
    run += total;
    __syncthreads();
    if (wsum[NT / 32 + 1] < BJ) break;
  }
  const int qa = wsum[NT / 32], qb = blockIdx.x + 1 == gridDim.x ? BJ : wsum[NT / 32 + 1];
  const int nq = qb - qa;
  __syncthreads();
  // a destination with no unmasked edge gives 0; the others are written over
  for (int i = tid; i < nq * meta.nv; i += NT) out[(size_t)qa * meta.nv + i] = 0.f;

  // the unmasked slots of the block's destinations, in order
  int n_e = 0;
  for (int s0 = 0; s0 < nq * S; s0 += NT) {
    const int idx = s0 + tid;
    const bool m = idx < nq * S && mask[(size_t)qa * S + idx];
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int pos = n_e;
    for (int w = 0; w < warp; ++w) pos += wsum[w];
    if (m) list[pos + __popc(bal & ((1u << lane) - 1u))] = idx;
    for (int w = 0; w < NT / 32; ++w) n_e += wsum[w];
    __syncthreads();
  }

  // a warpgroup's copies of a pair's fc1 weights (and their columns past
  // KMAIN), fc2 weights and misc rows, and the split of the weights once
  // every copy has landed
  auto copy_w12 = [&](int pi) {
    const float* w1 = w1t + (size_t)MID * pi * ed;
#pragma unroll
    for (int i = 0; i < MID * KMAIN / 128; ++i) {
      const int e = lt + i * 128, n = e / KMAIN, k = e % KMAIN;
      cp_async_4z(wsm + W1_OFF + (k >> 5) * 4096 + sw_off(n, k & 31), w1 + n * ed + k, true);
    }
    for (int e = lt; e < MID * tail; e += 128)
      cp_async_4z(w1T + e, w1 + (e / tail) * ed + KMAIN + e % tail, true);
    copy_rows32<MID>(wsm + W2_OFF, w2t + (size_t)MID * pi * MID, MID, lt);
    if (lt < MID * 6 / 4) cp_async_16z(miscS + 4 * lt, misc + (size_t)MID * pi * 6 + 4 * lt, true);
  };
  auto split_w12 = [&]() {
    split_tiles(wsm + W1_OFF, 2 * 4096, KC * 4096, lt, 128);
    split_tiles(wsm + W2_OFF, 4096, 4096, lt, 128);
  };
  auto w3_rows = [&](int pi) { return meta.p[pi].mo * meta.p[pi].nf * meta.p[pi].mi; };
  // a warpgroup's copy of 64 rows of w3t (and of w3b) from row `row` of pair pi
  auto copy_w3 = [&](int pi, int row) {
    const int valid = w3_rows(pi) - row, r0 = meta.p[pi].w3_off + row;
    copy_rows32<64>(wsm + W3_OFF, w3t + (size_t)r0 * MID, valid, lt);
    if (lt < 16) cp_async_16z(b3S + 4 * lt, w3b + r0 + 4 * lt, 4 * lt < valid);
  };
  const int bar = 1 + wg;  // the warpgroup's named barrier
  auto wg_sync = [&]() { named_barrier(bar, 128); };

  // the contraction's edge and half; the fragment rows
  const int ce = lt >> 1, part = lt & 1;
  const int g = lane >> 2, t = lane & 3, frow = (warp & 3) * 16 + g;
  const int first = next_pair(meta, wg, meta.npairs - 1);  // the branch's first pair
  if (n_e > 0 && first >= 0) {
    copy_w12(first);
    copy_w3(first, 0);
  }

  bool carry = false;  // the tile's first destination continues the last tile's
  int cur = 0;         // the carried weighted sum's buffer
  for (int t0 = 0; t0 < n_e; t0 += TE) {
    const int ne = min(TE, n_e - t0);
    __syncthreads();  // the last tile's softmax has read eDst, sStart
    if (tid < TE) {
      int gi = -1, srow = 0, d = 0;
      if (tid < ne) {
        const int idx = list[t0 + tid];
        d = idx / S;
        const int s = idx - d * S, q = qa + d;
        gi = q * S + s;
        srow = (q / J) * L + (src_idx ? src_idx[gi] : s);
      }
      eIdx[tid] = gi;
      eSrc[tid] = srow;
      eDst[tid] = d;
    }
    __syncthreads();
    if (tid < TE) {  // the tile's segments: runs of edges of one destination
      const bool start = tid < ne && (tid == 0 || eDst[tid] != eDst[tid - 1]);
      const unsigned bal = __ballot_sync(0xffffffffu, start);
      if (lane == 0) wsum[warp] = __popc(bal);
      named_barrier(3, TE);
      const int pos = (warp == 1 ? wsum[0] : 0) + __popc(bal & ((1u << lane) - 1u));
      if (start) sStart[pos] = tid;
      if (tid == 0) {
        sStart[wsum[0] + wsum[1]] = ne;
        wsum[NT / 32 + 2] = wsum[0] + wsum[1];
      }
    }
    // the tile's features, basis values and sources' h rows; the features
    // split into big and small once every copy has landed
#pragma unroll 4
    for (int i = 0; i < TE * KMAIN / NT; ++i) {
      const int e = tid + i * NT, r = e / KMAIN, k = e % KMAIN, gi = eIdx[r];
      cp_async_4z(sm + FEAT_OFF + (k >> 5) * 8192 + sw_off(r, k & 31),
                  feat + (size_t)max(gi, 0) * ed + k, gi >= 0);
    }
    for (int e = tid; e < TE * tail; e += NT) {
      const int r = e / tail, gi = eIdx[r];
      cp_async_4z(fT + e, feat + (size_t)max(gi, 0) * ed + KMAIN + e % tail, gi >= 0);
    }
    for (int e = tid; e < TE * hrow; e += NT) {
      const int r = e / hrow, c = e % hrow, srow = eSrc[r];
      const float* src = c < mi0 ? h0 + (size_t)srow * mi0 + c
                                 : h1 + (size_t)srow * mi1 * 3 + (c - mi0);
      cp_async_4z(Hs + r * hld + c, src, eIdx[r] >= 0);
    }
    for (int e = tid; e < TE * NB; e += NT) {  // '0,0' | '0,1' | '1,0' | '1,1' per edge
      const int r = e / NB, k = e % NB, gi = max(eIdx[r], 0);
      const float* src = k < 1 ? b00 + gi + k
                       : k < 4 ? b01 + (size_t)gi * 3 + (k - 1)
                       : k < 7 ? b10 + (size_t)gi * 3 + (k - 4) : b11 + (size_t)gi * 27 + (k - 7);
      cp_async_4z(Bs + r * BLD + k, src, eIdx[r] >= 0);
    }
    for (int e = tid; e < TE * nvp; e += NT) vS[e] = 0.f;
    for (int e = tid; e < TE * H; e += NT) eS[e] = 0.f;
    cp_async_wait_all();
    __syncthreads();
    split_tiles(sm + FEAT_OFF, 2 * 8192, KC * 8192, tid, NT);
    fence_proxy_async();
    __syncthreads();
    const int cgi = eIdx[ce];

    // this warpgroup's pairs (its branch), each from the weights copied
    // during the previous pair
    for (int pi = first; pi >= 0;) {
      const PairDesc p = meta.p[pi];
      const int pn = next_pair(meta, wg, pi);
      cp_async_wait_all();
      wg_sync();  // every copy of the warpgroup has landed
      split_w12();
      split_tiles(wsm + W3_OFF, 8192, 8192, lt, 128);
      // the contraction edge's basis values for this pair, [m][n][f]
      const int no = 2 * p.dout + 1, ni = 2 * p.di + 1, nf = p.nf;
      float bk[3][3][3];
      {
        const int boff = p.di == 0 ? (p.dout == 0 ? 0 : 1) : (p.dout == 0 ? 4 : 7);
        const float* bp = Bs + ce * BLD + boff;
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int n = 0; n < 3; ++n)
#pragma unroll
            for (int f = 0; f < 3; ++f)
              bk[m][n][f] = (m < no && n < ni && f < nf) ? bp[(m * ni + n) * nf + f] : 0.f;
      }
      fence_proxy_async();
      wg_sync();

      // fc1: the columns past KMAIN in float32 first (a loop that touches the
      // accumulators after the products are issued makes ptxas serialize
      // them), then the products; bias, LN, relu
      float a[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) a[e] = 0.f;
      for (int k = 0; k < tail; ++k) {
        const float f0 = fT[frow * tail + k], f1 = fT[(frow + 8) * tail + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float w = w1T[(8 * i + 2 * t + e) * tail + k];
            a[4 * i + e] += f0 * w;
            a[4 * i + 2 + e] += f1 * w;
          }
      }
      mma3<32, KC>(a, fbase, fbase + 2 * 8192, 8192, wbase + W1_OFF, wbase + W1_OFF + 2 * 4096,
                   4096);
      wgmma_wait<0>();
      ln_relu_store(a, ln_params(miscS, 0, t), wsm + ACT_OFF, lt);
      fence_proxy_async();
      wg_sync();

      // fc2, bias, LN, relu
#pragma unroll
      for (int e = 0; e < 16; ++e) a[e] = 0.f;
      mma3<32, 1>(a, wbase + ACT_OFF, wbase + ACT_OFF + 8192, 0, wbase + W2_OFF,
                  wbase + W2_OFF + 4096, 0);
      wgmma_wait<0>();
      const LnParams ln2 = ln_params(miscS, 3, t);
      wg_sync();  // every warp's products have read W1, W2 and the activations
      ln_relu_store(a, ln2, wsm + ACT_OFF, lt);
      copy_w12(pn);  // the next pair's (or the next tile's first)

      // an output channel o's message of the contraction edge: a value
      // message into vS, a key message straight into the logits (k . q /
      // sqrt(n_key) is linear in k: no key message is kept)
      auto flush = [&](int o, const float* mc) {
        if (wg == 0) {
          for (int m = 0; m < no; ++m) vS[ce * nvp + p.msg_off + o * no + m] += mc[m];
        } else {
          const int mkh = meta.mk[p.dout] / H, h = o / mkh;
          const float* qd = qh + (size_t)(qa + eDst[ce]) * HC + h * meta.ck +
                            meta.hoff[p.dout] + (o - h * mkh) * no;
          float sum = 0.f;
          for (int m = 0; m < no; ++m) sum += mc[m] * __ldg(qd + m);
          eS[ce * H + h] += sum * meta.inv_sqrt;
        }
      };

      // fc3 in chunks of 64 columns (rows of w3t), each followed by the
      // basis contraction of its columns; the next chunk (of this pair or
      // the next) is copied while the contraction runs
      const int rows3 = w3_rows(pi), nfmi = nf * p.mi;
      const int nch3 = (rows3 + 63) / 64;
      const int hoff = p.di == 0 ? 0 : mi0;
      for (int c3 = 0; c3 < nch3; ++c3) {
        const int n0 = 64 * c3;
        if (c3 > 0) {
          cp_async_wait_all();
          wg_sync();
          split_tiles(wsm + W3_OFF, 8192, 8192, lt, 128);
        }
        fence_proxy_async();
        wg_sync();  // the chunk's weights and bias and the activations are in place
        float acc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
        mma3<64, 1>(acc, wbase + ACT_OFF, wbase + ACT_OFF + 8192, 0, wbase + W3_OFF,
                    wbase + W3_OFF + 8192, 0);
        wgmma_wait<0>();
        // R = acc + bias into Rs
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 8 * i + 2 * t;
          const float2 bias = *reinterpret_cast<const float2*>(b3S + col);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(Rs + (frow + 8 * h) * LDR + col) =
                make_float2(acc[4 * i + 2 * h] + bias.x, acc[4 * i + 2 * h + 1] + bias.y);
        }
        wg_sync();  // every warp's products and bias reads are done: W3 may be refilled
        copy_w3(c3 + 1 < nch3 ? pi : pn, c3 + 1 < nch3 ? n0 + 64 : 0);
        // msg[ce, o, m] += sum_{f, n} basis[m, n, f] u[o, f, n] with u[o, f,
        // n] = sum_c R[ce, (o, f, c)] h_src[c, n], over this chunk's columns
        // (contracting c first: the basis multiplies once per (o, f)); the
        // two threads of an edge take alternate c. Rs is written again only
        // after the next chunk's barrier.
        const int hi = min(n0 + 64, rows3);
        const float* rrow = Rs + ce * LDR - n0;
        const float* hrow_p = Hs + ce * hld + hoff;
        for (int o = n0 / nfmi; o * nfmi < hi; ++o) {
          float macc[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            if (f >= nf) break;
            const int cb = o * nfmi + f * p.mi;  // column of c = 0
            const int c_lo = max(0, n0 - cb) + part, c_hi = min(p.mi, hi - cb);
            float u[3] = {0.f, 0.f, 0.f};
            if (ni == 1) {
#pragma unroll 4
              for (int c = c_lo; c < c_hi; c += 2) u[0] += rrow[cb + c] * hrow_p[c];
            } else {
#pragma unroll 4
              for (int c = c_lo; c < c_hi; c += 2) {
                const float r = rrow[cb + c];
                u[0] += r * hrow_p[3 * c];
                u[1] += r * hrow_p[3 * c + 1];
                u[2] += r * hrow_p[3 * c + 2];
              }
            }
#pragma unroll
            for (int m = 0; m < 3; ++m)
              macc[m] += bk[m][0][f] * u[0] + bk[m][1][f] * u[1] + bk[m][2][f] * u[2];
          }
#pragma unroll
          for (int m = 0; m < 3; ++m) macc[m] += __shfl_xor_sync(0xffffffffu, macc[m], 1);
          if (part == 0 && cgi >= 0) flush(o, macc);
        }
      }
      pi = pn > pi ? pn : -1;  // wrapped: the tile's pairs are done
    }
    __syncthreads();  // both branches' messages and the logits are complete
    // softmax over each destination's edges, online across tiles: one warp
    // per (segment, head); a segment is a destination's edges in this tile,
    // the first one continuing the carried destination's sum if `carry`
    const int nseg = wsum[NT / 32 + 2];
    const bool cont = t0 + ne < n_e && list[t0 + ne] / S == eDst[ne - 1];
    for (int it = warp; it < nseg * H; it += NT / 32) {
      const int i = it / H, h = it % H, e0 = sStart[i], e1 = sStart[i + 1];
      const bool carried = carry && i == 0;
      float mx = -INFINITY;
      for (int e = e0 + lane; e < e1; e += 32) mx = fmaxf(mx, eS[e * H + h]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = carried ? fmaxf(cM[h], mx) : mx;
      float sum = 0.f;
      for (int e = e0 + lane; e < e1; e += 32) {
        const float z = expf(eS[e * H + h] - m_new);
        eS[e * H + h] = z;
        sum += z;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float sc = carried ? expf(cM[h] - m_new) : 0.f;
        sM[it] = m_new;
        sDen[it] = (carried ? cDen[h] * sc : 0.f) + sum;
        sScl[it] = sc;
      }
    }
    __syncthreads();
    // the attention-weighted sums of the value messages: one warp per
    // (segment, column), its lanes over the edges; a destination whose edges
    // end here is written out, the last one carried on if they do not
    for (int it = warp; it < nseg * meta.nv; it += NT / 32) {
      const int i = it / meta.nv, col = it % meta.nv, h = head_of(meta, col);
      const int e0 = sStart[i], e1 = sStart[i + 1], ih = i * H + h;
      float acc = 0.f;
      for (int e = e0 + lane; e < e1; e += 32) acc += eS[e * H + h] * vS[e * nvp + col];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        if (carry && i == 0) acc += cO[cur * meta.nv + col] * sScl[ih];
        if (cont && i == nseg - 1)
          cO[(cur ^ 1) * meta.nv + col] = acc;
        else
          out[(size_t)(qa + eDst[e0]) * meta.nv + col] = sDen[ih] > 0.f ? acc / sDen[ih] : 0.f;
      }
    }
    if (cont && tid < H) {
      cM[tid] = sM[(nseg - 1) * H + tid];
      cDen[tid] = sDen[(nseg - 1) * H + tid];
    }
    carry = cont;
    cur ^= cont;
  }
  cp_async_wait_all();  // no copy outlives the block
}

}  // namespace

extern "C" {

// dynamic shared memory of a launch (bytes) whose blocks list at most
// `list_cap` edges, alignment slack included
size_t se3_attend_smem_bytes(int S, int nv, int H, int ck, int mi0, int mi1, int ed,
                             int list_cap) {
  const int tail = ed % 32;
  const size_t floats = (size_t)TE * (((mi0 + 3 * mi1) | 1) + (nv | 1) + H + BLD + tail) +
                        (size_t)NWG * MID * tail + 2 * nv + 2 * H + 3 * TE * H;
  const size_t ints = 4 * TE + 1 + NT / 32 + 4 + (size_t)list_cap;
  return 1024 + VAR_OFF + 4 * (floats + ints);
}

// src_idx null: the dense layout (S == L). Returns the cudaError_t of the launch.
int se3_attend_fwd(const float* feat, const float* b00, const float* b01,
                   const float* b10, const float* b11, const float* h0,
                   const float* h1, const uint8_t* mask, const float* qh,
                   const float* w1t, const float* misc, const float* w2t,
                   const float* w3t, const float* w3b, const int* src_idx, float* out,
                   int B, int J, int S, int L, const Meta* meta, void* stream) {
  const int kc = meta->ed / 32;
  if (meta->npairs < 1 || meta->npairs > MAX_PAIRS || meta->H < 1 || meta->H > MAX_H ||
      kc < 1 || kc > 2)
    return (int)cudaErrorInvalidValue;
  const int BJ = B * J;
  // a block per SM, each with an equal share of the edges (at most
  // ceil(BJ S / G) + S of them); more blocks where shared memory runs out
  auto smem = [&](int G) {
    const int cap = (int)(((long long)BJ * S + G - 1) / G) + S;
    return se3_attend_smem_bytes(S, meta->nv, meta->H, meta->ck, meta->m_in[0], meta->m_in[1],
                                 meta->ed, cap);
  };
  int G = min(BJ, sm_count());
  while (G < BJ && smem(G) > 232448) G = min(BJ, 2 * G);
  const size_t bytes = smem(G);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = kc == 1 ? se3_attend_kernel<1> : se3_attend_kernel<2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<G, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      feat, b00, b01, b10, b11, h0, h1, mask, qh, w1t, misc, w2t, w3t, w3b, src_idx, out, BJ, J,
      S, L, *meta);
  return (int)cudaGetLastError();
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
