// Tied row attention, forward: a flash-style kernel for Hopper (sm_90a).
//
// Replaces rosettafold_tpu/ops/pallas/tied_attention.py `_forward`
// (the pl.pallas_call at :99, public entry `tied_flash_attention` :134).
//
//   s[i, j]   = sum_e q[bh, i, e] * k[bh, j, e]      (e runs over N*d: one map
//                                                    tied over the N MSA rows)
//   out[i, :] = sum_j softmax_j(s)[i, j] * v[bh, j, :]
//   lse[i]    = logsumexp_j s[i, j]                  (kept for a flash backward)
//
// Layouts: q, k (BH, L, ND); v, out (BH, L, NDv); lse (BH, L) float32.
// q already carries the position-wise weights and 1/sqrt(d).
//
// What bounds it on this card: operations. Each (i, j) logit costs ND
// multiply-adds and each probability NDv more, against O(L * ND) bytes read
// per row tile; at ND = 2048 (N = 64 MSA rows) the contraction is the cost.
// A Q tile of 64 x 2048 bf16 alone (256 KB) would not fit the 227 KB of
// shared memory a block may use, so neither kernel holds a full row:
//  * the contraction runs in chunks of q and k staged through shared memory,
//    so any ND fits;
//  * the output width is split across the grid (blockIdx.z) with the logits
//    recomputed per split, so each thread keeps its accumulators in registers;
//  * online softmax over key tiles keeps the L x L map out of device memory;
//    ragged L is masked inside the kernel (no padding to 128).
// bfloat16 (the serving trunk) runs both products on the tensor cores with
// mma.sync m16n8k16 (bf16 operands, float32 accumulation); float32 runs on the
// CUDA cores, so its products stay exact float32. The probabilities are
// rounded to the value dtype before the P.V product, as the TPU kernel does.
// wgmma/TMA tiling and a resident Q tile are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- float32 --
// CUDA-core kernel: 32 query rows x (256 * CPT) output columns per block.

constexpr int F_BQ = 32;   // query rows per block
constexpr int F_BK = 32;   // keys per online-softmax step
constexpr int F_DK = 32;   // contraction chunk
constexpr int F_NT = 256;  // threads per block

template <int CPT>
__global__ void __launch_bounds__(F_NT)
tied_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int L, int ND, int NDv) {
  constexpr int DV = F_NT * CPT;  // output columns per block
  extern __shared__ float smem[];
  float* Qs = smem;                       // [F_BQ][F_DK + 1]
  float* Ks = Qs + F_BQ * (F_DK + 1);     // [F_BK][F_DK + 1]
  float* Ps = Ks + F_BK * (F_DK + 1);     // [F_BQ][F_BK + 1]
  float* m_s = Ps + F_BQ * (F_BK + 1);    // [F_BQ] running max
  float* l_s = m_s + F_BQ;                // [F_BQ] running denominator
  float* a_s = l_s + F_BQ;                // [F_BQ] rescale factor of this step
  float* Vs = a_s + F_BQ;                 // [F_BK][DV]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * F_BQ;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * DV;
  const float* qb = q + (size_t)bh * L * ND;
  const float* kb = k + (size_t)bh * L * ND;
  const float* vb = v + (size_t)bh * L * NDv;

  if (tid < F_BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  float acc[F_BQ][CPT];
#pragma unroll
  for (int r = 0; r < F_BQ; ++r)
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[r][u] = 0.f;

  // logits micro-tile of this thread: row sr, columns sc .. sc + 3
  const int sr = tid >> 3;
  const int sc = (tid & 7) * 4;

  for (int j0 = 0; j0 < L; j0 += F_BK) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < ND; d0 += F_DK) {
      for (int e = tid; e < F_BQ * F_DK; e += F_NT) {
        const int r = e / F_DK, c = e % F_DK;
        const int gc = d0 + c;
        const int qr = q0 + r, kr = j0 + r;
        Qs[r * (F_DK + 1) + c] = (qr < L && gc < ND) ? qb[(size_t)qr * ND + gc] : 0.f;
        Ks[r * (F_DK + 1) + c] = (kr < L && gc < ND) ? kb[(size_t)kr * ND + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < F_DK; ++c) {
        const float qv = Qs[sr * (F_DK + 1) + c];
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] += qv * Ks[(sc + u) * (F_DK + 1) + c];
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      Ps[sr * (F_BK + 1) + sc + u] = (j0 + sc + u < L) ? s[u] : -INFINITY;

    // stage this step's V tile while the softmax runs
    for (int e = tid; e < F_BK * DV; e += F_NT) {
      const int r = e / DV, c = e % DV;
      const int gr = j0 + r, gc = c0 + c;
      Vs[r * DV + c] = (gr < L && gc < NDv) ? vb[(size_t)gr * NDv + gc] : 0.f;
    }
    __syncthreads();

    if (tid < F_BQ) {  // online softmax, one thread per query row
      const float m_old = m_s[tid];
      float mx = m_old;
      for (int c = 0; c < F_BK; ++c) mx = fmaxf(mx, Ps[tid * (F_BK + 1) + c]);
      // column j0 < L is always valid, so mx is finite here
      const float alpha = expf(m_old - mx);
      float sum = 0.f;
      for (int c = 0; c < F_BK; ++c) {
        const float p = expf(Ps[tid * (F_BK + 1) + c] - mx);
        sum += p;
        Ps[tid * (F_BK + 1) + c] = p;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mx;
      a_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < F_BQ; ++r) {
      const float a = a_s[r];
#pragma unroll
      for (int u = 0; u < CPT; ++u) acc[r][u] *= a;
    }
    for (int kk = 0; kk < F_BK; ++kk) {
      float vv[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) vv[u] = Vs[kk * DV + tid + u * F_NT];
#pragma unroll
      for (int r = 0; r < F_BQ; ++r) {
        const float p = Ps[r * (F_BK + 1) + kk];
#pragma unroll
        for (int u = 0; u < CPT; ++u) acc[r][u] += p * vv[u];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < F_BQ; ++r) {
    const int gr = q0 + r;
    if (gr >= L) break;
    const float inv = 1.f / l_s[r];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int gc = c0 + tid + u * F_NT;
      if (gc < NDv) out[((size_t)bh * L + gr) * NDv + gc] = acc[r][u] * inv;
    }
  }
  if (blockIdx.z == 0 && tid < F_BQ && q0 + tid < L)
    lse[(size_t)bh * L + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <int CPT>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* out,
                       float* lse, int BH, int L, int ND, int NDv, cudaStream_t st) {
  constexpr int DV = F_NT * CPT;
  const size_t smem = sizeof(float) * (F_BQ * (F_DK + 1) + F_BK * (F_DK + 1) +
                                       F_BQ * (F_BK + 1) + 3 * F_BQ + F_BK * DV);
  auto kern = tied_fwd_f32<CPT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + F_BQ - 1) / F_BQ, BH, (NDv + DV - 1) / DV);
  kern<<<grid, F_NT, smem, st>>>(q, k, v, out, lse, L, ND, NDv);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16 --
// Tensor-core kernel. 8 warps as 2 (query rows) x 4 (output columns): warp
// (rg, cg) computes the logits of rows rg*16.., keys cg*16.. of each 32 x 64
// tile, and accumulates out rows rg*16.., columns c0 + cg*64.. (8 m16n8
// accumulators, 32 registers). Shared-memory rows are padded by 8 bf16 so
// that the 32-bit fragment loads of a warp hit 32 distinct banks. The q and k
// chunks are double-buffered with cp.async, so the next chunk's loads are in
// flight while the tensor cores work on this one. Each chunk's mma sums start
// from zero and are added to the logits in float32, so the tensor cores'
// internal accumulation never carries the whole ND-long sum.

constexpr int B_BQ = 32;           // query rows per block
constexpr int B_BK = 64;           // keys per online-softmax step
constexpr int B_DK = 128;          // contraction chunk
constexpr int B_DV = 256;          // output columns per block
constexpr int B_NT = 256;          // threads per block
constexpr int QK_LD = B_DK + 8;    // row stride of Qs, Ks (bf16)
constexpr int P_LD = B_BK + 8;     // row stride of Ps, Vt (bf16)
constexpr int S_LD = B_BK + 4;     // row stride of Ss (float)

constexpr int QK_BUF = (B_BQ + B_BK) * QK_LD;  // one q chunk + one k chunk (bf16)
constexpr size_t BF16_SMEM =
    sizeof(__nv_bfloat16) * (2 * QK_BUF + B_BQ * P_LD + B_DV * P_LD) +
    sizeof(float) * (B_BQ * S_LD + 3 * B_BQ);

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major, leading dimension ld) at tile origin t
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t, int ld,
                                       int g, int tg) {
  a[0] = ld32(t + g * ld + 2 * tg);
  a[1] = ld32(t + (g + 8) * ld + 2 * tg);
  a[2] = ld32(t + g * ld + 2 * tg + 8);
  a[3] = ld32(t + (g + 8) * ld + 2 * tg + 8);
}

// 16 bytes global -> shared without a register round trip; src_bytes = 0
// writes zeros (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) x columns [d0, d0 + B_DK) of a (., ld) bf16 matrix into
// shared memory, zero outside (nrows, ncols): cp.async where rows are 16-byte
// aligned (vec), plain element loads otherwise
template <int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int r0, int nrows, int d0, int ncols, int ld,
                                           bool vec) {
  constexpr int CHUNKS = B_DK / 8;
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += B_NT) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    const int gr = r0 + r, gc = d0 + c;
    __nv_bfloat16* d = dst + r * QK_LD + c;
    const __nv_bfloat16* p = src + (size_t)gr * ld + gc;
    if (vec) {  // ncols % 8 == 0: a chunk is wholly inside or wholly outside
      const bool inside = gr < nrows && gc < ncols;
      cp_async16(d, inside ? p : src, inside ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = (gr < nrows && gc + i < ncols) ? p[i] : __float2bfloat16(0.f);
    }
  }
}

__global__ void __launch_bounds__(B_NT)
tied_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
              float* __restrict__ lse, int L, int ND, int NDv, bool vec_qk, bool vec_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two buffers of [B_BQ][QK_LD] q rows followed by [B_BK][QK_LD] k rows
  __nv_bfloat16* QKs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ps = QKs + 2 * QK_BUF;                             // [B_BQ][P_LD]
  __nv_bfloat16* Vt = Ps + B_BQ * P_LD;        // [B_DV][P_LD]: V tile transposed
  float* Ss = reinterpret_cast<float*>(Vt + B_DV * P_LD);           // [B_BQ][S_LD]
  float* m_s = Ss + B_BQ * S_LD;  // running max
  float* l_s = m_s + B_BQ;        // running denominator
  float* a_s = l_s + B_BQ;        // rescale factor of this step

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group, thread in group
  const int rg = warp >> 2, cg = warp & 3;
  const int q0 = blockIdx.x * B_BQ;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * B_DV;
  const __nv_bfloat16* qb = q + (size_t)bh * L * ND;
  const __nv_bfloat16* kb = k + (size_t)bh * L * ND;
  const __nv_bfloat16* vb = v + (size_t)bh * L * NDv;

  if (tid < B_BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int j0 = 0; j0 < L; j0 += B_BK) {
    // logits: warp (rg, cg) -> rows rg*16.., keys cg*16.. (two n8 tiles)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int nchunks = (ND + B_DK - 1) / B_DK;
    stage_rows<B_BQ>(QKs, qb, q0, L, 0, ND, ND, vec_qk);
    stage_rows<B_BK>(QKs + B_BQ * QK_LD, kb, j0, L, 0, ND, ND, vec_qk);
    cp_async_commit();
    for (int ch = 0; ch < nchunks; ++ch) {
      if (ch + 1 < nchunks) {  // prefetch the next chunk into the other buffer
        __nv_bfloat16* nxt = QKs + ((ch + 1) & 1) * QK_BUF;
        stage_rows<B_BQ>(nxt, qb, q0, L, (ch + 1) * B_DK, ND, ND, vec_qk);
        stage_rows<B_BK>(nxt + B_BQ * QK_LD, kb, j0, L, (ch + 1) * B_DK, ND, ND, vec_qk);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* Qs = QKs + (ch & 1) * QK_BUF;
      const __nv_bfloat16* Ks = Qs + B_BQ * QK_LD;
      float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < B_DK; kk += 16) {
        uint32_t a[4];
        load_a(a, Qs + rg * 16 * QK_LD + kk, QK_LD, g, tg);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const __nv_bfloat16* kt = Ks + (cg * 16 + n * 8 + g) * QK_LD + kk + 2 * tg;
          mma_bf16(t[n], a, ld32(kt), ld32(kt + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += t[n][i];
      __syncthreads();  // the buffer is refilled two chunks on
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = cg * 16 + n * 8 + 2 * tg;
      float* srow = Ss + (rg * 16 + g) * S_LD + col;
      srow[0] = s[n][0];
      srow[1] = s[n][1];
      srow[8 * S_LD] = s[n][2];
      srow[8 * S_LD + 1] = s[n][3];
    }

    // stage V^T for this step: Vt[c][j] = v[j0 + j, c0 + c]; a warp's lanes
    // take consecutive keys, so the transposed stores do not collide
    for (int e = tid; e < B_BK * (B_DV / 8); e += B_NT) {
      const int j = e % B_BK, c = (e / B_BK) * 8;
      const int gr = j0 + j, gc = c0 + c;
      __align__(16) __nv_bfloat16 tmp[8];
      if (gr < L && vec_v && gc + 8 <= NDv) {
        *reinterpret_cast<uint4*>(tmp) =
            *reinterpret_cast<const uint4*>(vb + (size_t)gr * NDv + gc);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          tmp[i] = (gr < L && gc + i < NDv) ? vb[(size_t)gr * NDv + gc + i]
                                            : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * P_LD + j] = tmp[i];
    }
    __syncthreads();

    {  // online softmax: 8 threads per query row, 8 keys each
      const int r = tid >> 3, part = tid & 7;
      const float m_old = m_s[r];
      float sv[8], mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = part * 8 + i;
        sv[i] = (j0 + c < L) ? Ss[r * S_LD + c] : -INFINITY;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = fmaxf(mx, m_old);  // finite: key j0 < L is always valid
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = expf(sv[i] - mx);
        sum += p;
        Ps[r * P_LD + part * 8 + i] = __float2bfloat16(p);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - mx);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mx;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // out += P . V on rows rg*16.., columns cg*64.. of this block's split
    const float a_lo = a_s[rg * 16 + g], a_hi = a_s[rg * 16 + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
    }
#pragma unroll
    for (int kk = 0; kk < B_BK; kk += 16) {
      uint32_t a[4];
      load_a(a, Ps + rg * 16 * P_LD + kk, P_LD, g, tg);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* vt = Vt + (cg * 64 + n * 8 + g) * P_LD + kk + 2 * tg;
        mma_bf16(acc[n], a, ld32(vt), ld32(vt + 8));
      }
    }
    __syncthreads();
  }

  const int r_lo = rg * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h, gr = q0 + r;
    if (gr >= L) continue;
    const float inv = 1.f / l_s[r];
    __nv_bfloat16* orow = out + ((size_t)bh * L + gr) * NDv;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int gc = c0 + cg * 64 + n * 8 + 2 * tg;
      if (gc < NDv) orow[gc] = __float2bfloat16(acc[n][2 * h] * inv);
      if (gc + 1 < NDv) orow[gc + 1] = __float2bfloat16(acc[n][2 * h + 1] * inv);
    }
  }
  if (blockIdx.z == 0 && tid < B_BQ && q0 + tid < L)
    lse[(size_t)bh * L + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, __nv_bfloat16* out, float* lse, int BH,
                        int L, int ND, int NDv, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      tied_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BF16_SMEM);
  if (err != cudaSuccess) return err;
  // 16-byte vector loads need 16-byte aligned rows
  const bool vec_qk = ND % 8 == 0 && ((uintptr_t)q | (uintptr_t)k) % 16 == 0;
  const bool vec_v = NDv % 8 == 0 && (uintptr_t)v % 16 == 0;
  dim3 grid((L + B_BQ - 1) / B_BQ, BH, (NDv + B_DV - 1) / B_DV);
  tied_fwd_bf16<<<grid, B_NT, BF16_SMEM, st>>>(q, k, v, out, lse, L, ND, NDv, vec_qk,
                                               vec_v);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
int tied_attention_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, int BH, int L, int ND, int NDv, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    auto* qf = static_cast<const float*>(q);
    auto* kf = static_cast<const float*>(k);
    auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(out);
    return NDv > F_NT ? launch_f32<2>(qf, kf, vf, of, lse, BH, L, ND, NDv, st)
                      : launch_f32<1>(qf, kf, vf, of, lse, BH, L, ND, NDv, st);
  }
  if (dtype == 1)
    return launch_bf16(static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v),
                       static_cast<__nv_bfloat16*>(out), lse, BH, L, ND, NDv, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
