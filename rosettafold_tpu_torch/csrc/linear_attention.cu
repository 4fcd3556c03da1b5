// Generalized (ReLU-kernel) FAVOR+ linear attention (kernel H) for Hopper
// (sm_90a), per problem p of P:
//
//   phi_k = relu(k . P^T) + eps          (L, m)
//   ctx   = phi_k^T . [v | 1]            (m, dh + 1): the ones column is ksum
//   phi_q = relu(q . P^T) + eps          (L, m)
//   num   = phi_q . ctx
//   out   = num[:, :dh] / max(num[:, dh], 1e-12)      in q's dtype
//
// Replaces rosettafold_tpu/ops/pallas/linear_attention.py `_forward` (the
// pl.pallas_call at :82, entry `generalized_linear_attention` :105). Rounding
// points as that kernel (:47-68): the feature maps, ctx and ksum stay in
// float32 for bfloat16 inputs too, so only k . P^T and q . P^T take the
// compute dtype. bfloat16: those two products on the tensor cores (mma.sync
// m16n8k16, float32 accumulate, exact bf16 products); every product with a
// float32 operand (phi_k^T . v, phi_q . ctx), and the whole float32 mode, on
// the CUDA cores (fmaf). No bf16 split of the float32 operands: exact, slow.
//
// Layout: q, k, v, out (P, L, 64) contiguous; P^T read from proj (m, 64) in
// the dtype of q, m % 64 == 0, m <= 320.
//
// What bounds it on this card: operations. Per position and feature, the two
// feature maps and the two contractions are 4 * 64 + 2 * 65 multiply-adds
// against 4 * 64 values of input and output: about 3.45e11 operations at
// P = 4096, L = 512, m = 320, against 1.07 GB of traffic. The design is kernel
// C's middle launch (fused_performer.cu), for one head: one block per
// problem streams the positions twice, in chunks of 32 - phi_k chunks into
// ctx, held whole in shared memory (m x 72 float32, 92 KB at m = 320), then
// phi_q chunks against it - so the (L, m) feature maps exist only in shared
// memory and each input is read once.

#include "common.cuh"

using namespace rf;

namespace {

constexpr int DH = 64;         // head width
constexpr int EP = 72;         // dh + 1 (the ones column) padded to 8
constexpr int MAX_M = 320;     // random features
constexpr int LC = 32;         // positions per chunk
constexpr int LDD = DH + 8;    // staged q / k rows
constexpr int LDL = LC + 4;    // phi_k^T and v^T rows (float32)
constexpr int LDN = EP + 4;    // num rows (float32)
constexpr int NTHREADS = 256;
constexpr int NCG = 3;         // column groups of the num product, 3 x 3 tiles of 8

template <typename T>
struct Smem {
  __host__ __device__ static size_t ctx(int m) { return sizeof(float) * m * EP; }
  __host__ __device__ static size_t phase1(int m) {
    return sizeof(T) * LC * LDD + sizeof(float) * (EP * LDL + (size_t)m * LDL);
  }
  __host__ __device__ static size_t phase2(int m) {
    return sizeof(T) * LC * LDD + sizeof(float) * ((size_t)LC * (m + 4) + LC * LDN);
  }
  __host__ __device__ static size_t bytes(int m) {
    return ctx(m) + (phase1(m) > phase2(m) ? phase1(m) : phase2(m));
  }
};

// phi[l][c] = relu(xs[l] . proj[c]) + eps for a chunk of LC staged rows,
// written through store(l, c, value); items (row group, 64-feature block).
template <typename T, typename Store>
__device__ __forceinline__ void feature_map(const T* xs, const T* __restrict__ proj, int m,
                                            float eps, Store&& store) {
  const int warp = threadIdx.x >> 5;
  for (int it = warp; it < (LC / 16) * (m / 64); it += NTHREADS / 32) {
    const int rg = it % (LC / 16), cb = it / (LC / 16);
    float acc[8][4];
    zero(acc);
    warp_gemm<8>(acc, xs + rg * 16 * LDD, LDD, proj + (size_t)cb * 64 * DH, DH, DH);
    for_each(acc, [&](int r, int c, float v) { store(rg * 16 + r, cb * 64 + c, fmaxf(v, 0.f) + eps); });
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ proj, T* __restrict__ out,
                        int L, int m, float kernel_eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ctx = reinterpret_cast<float*>(smem_raw);  // [m][EP]
  unsigned char* region = smem_raw + Smem<T>::ctx(m);
  T* Xs = reinterpret_cast<T*>(region);               // [LC][LDD] k, then q
  float* Vt = reinterpret_cast<float*>(Xs + LC * LDD);  // phase 1: [EP][LDL]
  float* PhiKt = Vt + EP * LDL;                         // phase 1: [m][LDL]
  float* PhiQ = Vt;                                     // phase 2: [LC][m + 4]
  const int ldm = m + 4;
  float* NumS = PhiQ + LC * ldm;                        // phase 2: [LC][LDN]

  const long long p = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  const T* kb = k + p * L * DH;
  const T* vb = v + p * L * DH;
  const T* qb = q + p * L * DH;
  T* ob = out + p * L * DH;

  for (int e = tid; e < m * EP; e += NTHREADS) Ctx[e] = 0.f;

  // phase 1: ctx = sum over positions of phi_k^T [v | 1]
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<T>(Xs, LDD, kb + (long long)l0 * DH, DH, LC, nl, DH);
    for (int e = tid; e < EP * LC; e += NTHREADS) {
      const int l = e % LC, c = e / LC;
      float val = 0.f;
      if (l < nl) val = c < DH ? to_f(vb[(long long)(l0 + l) * DH + c]) : (c == DH ? 1.f : 0.f);
      Vt[c * LDL + l] = val;
    }
    __syncthreads();
    feature_map<T>(Xs, proj, m, kernel_eps, [&](int l, int c, float val) {
      PhiKt[c * LDL + l] = l < nl ? val : 0.f;
    });
    __syncthreads();
    // ctx (m x 72) += PhiKt (m x LC) . Vt^T, one item per 16 features
    for (int rg = warp; rg < m / 16; rg += NTHREADS / 32) {
      float acc[EP / 8][4];
      zero(acc);
      warp_gemm<EP / 8>(acc, PhiKt + rg * 16 * LDL, LDL, Vt, LDL, LC);
      for_each(acc, [&](int r, int c, float val) { Ctx[(rg * 16 + r) * EP + c] += val; });
    }
  }

  // phase 2: out = (phi_q . ctx)[:, :dh] / max((phi_q . ctx)[:, dh], 1e-12)
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<T>(Xs, LDD, qb + (long long)l0 * DH, DH, LC, nl, DH);
    __syncthreads();
    feature_map<T>(Xs, proj, m, kernel_eps,
                   [&](int l, int c, float val) { PhiQ[l * ldm + c] = val; });
    __syncthreads();
    // num (LC x 72) = PhiQ (LC x m) . Ctx, items (row group, 24-column group)
    for (int it = warp; it < (LC / 16) * NCG; it += NTHREADS / 32) {
      const int rg = it % (LC / 16), cg = it / (LC / 16);
      constexpr int NT = EP / 8 / NCG;
      float acc[NT][4];
      zero(acc);
      warp_gemm_strided<NT>(acc, PhiQ + rg * 16 * ldm, ldm, Ctx + cg * NT * 8, 1, EP, m);
      for_each(acc, [&](int r, int c, float val) {
        NumS[(rg * 16 + r) * LDN + cg * NT * 8 + c] = val;
      });
    }
    __syncthreads();
    for (int e = tid; e < nl * DH; e += NTHREADS) {
      const int l = e / DH, c = e % DH;
      const float den = fmaxf(NumS[l * LDN + DH], 1e-12f);
      ob[(long long)(l0 + l) * DH + c] = from_f<T>(NumS[l * LDN + c] / den);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* proj, void* out,
                   long long P, int L, int m, float kernel_eps, cudaStream_t st) {
  const size_t smem = Smem<T>::bytes(m);
  cudaError_t err = set_smem(linear_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  linear_attention_kernel<T><<<(unsigned)P, NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(proj), static_cast<T*>(out), L, m, kernel_eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (P, L, dh = 64) contiguous; proj (m, 64), m % 64 == 0 and
// m <= 320, all of one dtype: 0 float32, 1 bfloat16. Returns the cudaError_t
// of the launch.
int linear_attention_fwd(const void* q, const void* k, const void* v, const void* proj,
                         void* out, long long P, int L, int dh, int m, float kernel_eps,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh != DH || m <= 0 || m % 64 || m > MAX_M || P <= 0 || P > 2147483647LL || L <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(q, k, v, proj, out, P, L, m, kernel_eps, st);
  if (dtype == 1) return launch<bf16>(q, k, v, proj, out, P, L, m, kernel_eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
