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
// Weights are `stack_weights`' operands: w1 (ed, 32P) (its w1t transposed),
// misc (32P, 6), w2t (32P, 32), and fc3 rows permuted to (o, f, c) order,
// 8-row padded per pair: w3t (NW3, 32), w3b (NW3).
//
// What bounds it on this card: operations, and the reads of the weights. Each
// edge runs 2*|pairs| radial MLPs (about 60k multiply-adds at the first
// layer's widths) against ~300 bytes of edge input; the stacked fc3 weights
// alone are 1136 x 32 float32 (145 KB) at that layer, and with fc1 (256 x 65)
// they do not fit shared memory beside the per-edge state. The design:
//  * one block per (batch, destination) walks its S sources, one thread per
//    edge, so a whole edge's chain stays in registers (the 32-wide MLP
//    activations, the 27 basis values of a pair) and nothing per-edge goes to
//    device memory;
//  * every thread of a warp reads the same weight row at the same time, so
//    the weights stream through L1/L2 as broadcast loads instead of sitting
//    in shared memory;
//  * masked edges are skipped: their attention weight is exactly zero;
//  * shared memory holds only the per-edge V messages and logits for the
//    softmax over S, and the K messages in flight.
// float32 throughout. Tensor-core tiling of the radial MLPs is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int MID = 32;     // radial MLP width
constexpr int NT = 128;     // threads (edges in flight) per block

__device__ __forceinline__ void ln_relu(float (&x)[MID], const float* __restrict__ misc,
                                        int r0, int gcol, int bcol) {
  float mu = 0.f, m2 = 0.f;
#pragma unroll
  for (int i = 0; i < MID; ++i) {
    mu += x[i];
    m2 += x[i] * x[i];
  }
  mu *= 1.f / MID;
  const float var = m2 * (1.f / MID) - mu * mu;
  const float inv = 1.f / sqrtf(var + 1e-5f);
#pragma unroll
  for (int i = 0; i < MID; ++i) {
    const float y = (x[i] - mu) * inv * __ldg(misc + (r0 + i) * 6 + gcol) +
                    __ldg(misc + (r0 + i) * 6 + bcol);
    x[i] = fmaxf(y, 0.f);
  }
}

__device__ __forceinline__ float dot32(const float* __restrict__ row, const float (&a)[MID]) {
  const float4* w = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < MID / 4; ++i) {
    const float4 wv = __ldg(w + i);
    acc += wv.x * a[4 * i] + wv.y * a[4 * i + 1] + wv.z * a[4 * i + 2] + wv.w * a[4 * i + 3];
  }
  return acc;
}

__global__ void __launch_bounds__(NT)
se3_attend_kernel(const float* __restrict__ feat, const float* __restrict__ b00,
                  const float* __restrict__ b01, const float* __restrict__ b10,
                  const float* __restrict__ b11, const float* __restrict__ h0,
                  const float* __restrict__ h1, const uint8_t* __restrict__ mask,
                  const float* __restrict__ qh, const float* __restrict__ w1,
                  const float* __restrict__ misc, const float* __restrict__ w2t,
                  const float* __restrict__ w3t, const float* __restrict__ w3b,
                  const int* __restrict__ src_idx, float* __restrict__ out, int J, int S,
                  int L, Meta meta) {
  extern __shared__ float sm[];
  const int H = meta.H;
  const int nvp = meta.nv | 1;              // odd row stride: no bank conflicts
  float* vS = sm;                           // [S][nvp] value messages per edge
  float* eS = vS + (size_t)S * nvp;         // [S][H] logits, then weights
  float* kS = eS + (size_t)S * H;           // [nk][NT] key messages in flight
  float* qS = kS + (size_t)meta.nk * NT;    // [H * ck] the destination's query

  const int tid = threadIdx.x;
  const int j = blockIdx.x, b = blockIdx.y;
  const size_t bj = (size_t)b * J + j;
  const int P32 = MID * meta.npairs;
  const float* bases[4] = {b00, b01, b10, b11};

  for (int i = tid; i < H * meta.ck; i += NT) qS[i] = qh[bj * H * meta.ck + i];
  __syncthreads();

  for (int s = tid; s < S; s += NT) {
    const size_t e = bj * S + s;
    float* vrow = vS + (size_t)s * nvp;
    for (int i = 0; i < meta.nv; ++i) vrow[i] = 0.f;
    if (!mask[e]) {
      for (int h = 0; h < H; ++h) eS[s * H + h] = -1e9f;
      continue;
    }
    for (int i = 0; i < meta.nk; ++i) kS[i * NT + tid] = 0.f;
    const float* fe = feat + e * meta.ed;
    const int src = src_idx ? src_idx[e] : s;  // the source node of this edge

    for (int pi = 0; pi < meta.npairs; ++pi) {
      const PairDesc p = meta.p[pi];
      const int r0 = MID * pi;
      // fc1 -> LN -> relu
      float a[MID];
#pragma unroll
      for (int i = 0; i < MID; ++i) a[i] = __ldg(misc + (r0 + i) * 6);
      for (int c = 0; c < meta.ed; ++c) {
        const float f = fe[c];
        const float4* w = reinterpret_cast<const float4*>(w1 + (size_t)c * P32 + r0);
#pragma unroll
        for (int i = 0; i < MID / 4; ++i) {
          const float4 wv = __ldg(w + i);
          a[4 * i] += wv.x * f;
          a[4 * i + 1] += wv.y * f;
          a[4 * i + 2] += wv.z * f;
          a[4 * i + 3] += wv.w * f;
        }
      }
      ln_relu(a, misc, r0, 1, 2);
      // fc2 -> LN -> relu
      float g[MID];
#pragma unroll
      for (int o = 0; o < MID; ++o)
        g[o] = __ldg(misc + (r0 + o) * 6 + 3) + dot32(w2t + (size_t)(r0 + o) * MID, a);
      ln_relu(g, misc, r0, 4, 5);

      // this pair's basis values, held in registers as [m][n][f] (3 x 3 x 3)
      const int no = 2 * p.dout + 1, ni = 2 * p.di + 1, nf = p.nf;
      const float* bp = bases[p.di * 2 + p.dout] + e * (size_t)(no * ni * nf);
      float bk[3][3][3];
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int n = 0; n < 3; ++n)
#pragma unroll
          for (int f = 0; f < 3; ++f)
            bk[m][n][f] = (m < no && n < ni && f < nf) ? bp[(m * ni + n) * nf + f] : 0.f;

      const float* hs = (p.di == 0) ? h0 + ((size_t)b * L + src) * p.mi
                                    : h1 + ((size_t)b * L + src) * p.mi * 3;
      for (int o = 0; o < p.mo; ++o) {
        float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          if (f >= nf) break;
          const int row0 = p.w3_off + (o * nf + f) * p.mi;
          for (int c = 0; c < p.mi; ++c) {
            const int row = row0 + c;
            const float r = __ldg(w3b + row) + dot32(w3t + (size_t)row * MID, g);
            float hv[3];
#pragma unroll
            for (int n = 0; n < 3; ++n) hv[n] = (n < ni) ? hs[c * ni + n] : 0.f;
#pragma unroll
            for (int m = 0; m < 3; ++m) {
              const float tm = bk[m][0][f] * hv[0] + bk[m][1][f] * hv[1] + bk[m][2][f] * hv[2];
              acc[m] += r * tm;
            }
          }
        }
        if (p.branch == 0) {
          for (int m = 0; m < no; ++m) vrow[p.msg_off + o * no + m] += acc[m];
        } else {
          for (int m = 0; m < no; ++m) kS[(p.msg_off + o * no + m) * NT + tid] += acc[m];
        }
      }
    }

    // logits of this edge, per head: k_msg . q_dst / sqrt(n_key)
    for (int h = 0; h < H; ++h) {
      float acc = 0.f;
      for (int d = 0; d < 2; ++d) {
        const int nd = 2 * d + 1;
        const int mkh = meta.mk[d] / H;
        for (int lc = 0; lc < mkh; ++lc) {
          const int c = h * mkh + lc;
          for (int m = 0; m < nd; ++m)
            acc += kS[(meta.k_off[d] + c * nd + m) * NT + tid] *
                   qS[h * meta.ck + meta.hoff[d] + lc * nd + m];
        }
      }
      eS[s * H + h] = acc * meta.inv_sqrt;
    }
  }
  __syncthreads();

  // masked softmax over the S sources: one warp per head
  const int warp = tid >> 5, lane = tid & 31;
  for (int h = warp; h < H; h += NT / 32) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, eS[s * H + h]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float den = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float z = mask[bj * S + s] ? expf(eS[s * H + h] - mx) : 0.f;
      eS[s * H + h] = z;
      den += z;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    den = fmaxf(den, 1e-20f);
    for (int s = lane; s < S; s += 32) eS[s * H + h] = eS[s * H + h] / den;
  }
  __syncthreads();

  // attention-weighted sum of the value messages
  for (int col = tid; col < meta.nv; col += NT) {
    const int d = (meta.mv[1] > 0 && col >= meta.v_off[1]) ? 1 : 0;
    const int c = (col - meta.v_off[d]) / (2 * d + 1);
    const int h = c / (meta.mv[d] / H);
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += eS[s * H + h] * vS[(size_t)s * nvp + col];
    out[bj * meta.nv + col] = acc;
  }
}

}  // namespace

extern "C" {

size_t se3_attend_smem_bytes(int S, int nv, int nk, int H, int ck) {
  return sizeof(float) * ((size_t)S * ((nv | 1) + H) + (size_t)nk * NT + (size_t)H * ck);
}

// src_idx null: the dense layout (S == L). Returns the cudaError_t of the launch.
int se3_attend_fwd(const float* feat, const float* b00, const float* b01,
                   const float* b10, const float* b11, const float* h0,
                   const float* h1, const uint8_t* mask, const float* qh,
                   const float* w1, const float* misc, const float* w2t,
                   const float* w3t, const float* w3b, const int* src_idx, float* out,
                   int B, int J, int S, int L, const Meta* meta, void* stream) {
  if (meta->npairs > MAX_PAIRS || meta->H < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = se3_attend_smem_bytes(S, meta->nv, meta->nk, meta->H, meta->ck);
  cudaError_t err = cudaFuncSetAttribute(
      se3_attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(J, B);
  se3_attend_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      feat, b00, b01, b10, b11, h0, h1, mask, qh, w1, misc, w2t, w3t, w3b, src_idx, out,
      J, S, L, *meta);
  return (int)cudaGetLastError();
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
