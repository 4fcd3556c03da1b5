// Fused generalized-FAVOR+ attention layer (kernel C) for Hopper (sm_90a):
//
//   y = LayerNorm(x)                  (LN/residual mode; else y = x)
//   q = (y.Wq) s, k = (y.Wk) s, v = y.Wv              s = dim_head^-1/4
//   per head h:  phi_q = relu(q_h . P^T) + eps,  phi_k = relu(k_h . P^T) + eps
//                ctx   = phi_k^T . [v_h | 1]          (m x (dh + 1))
//                att_h = num[:, :dh] / max(num[:, dh], 1e-12),  num = phi_q . ctx
//   out = x + att.Wo + bo             (LN/residual mode; else att.Wo + bo)
//
// per row-problem: the L positions of one row (or column) of the pair map.
// Replaces rosettafold_tpu/ops/pallas/fused_performer.py `_forward_lnres`
// (:398, entry `fused_ln_performer_residual` :460), `_forward_axis1_lnres`
// (:434, entry :498) and, with the mode flag off, `_forward` (:322) and
// `_forward_axis1` (:361). Rounding points as `_layer_math` (:125-182): q, k,
// v, phi_q, phi_k (zero past the valid L), ctx and att are rounded to the
// compute dtype; every product accumulates in float32.
//
// Layout: one problem stride and one position stride. The row step attends
// over axis 1 of (B, L1, L2, D) and the column step over axis 2; both are
// read and written in place, so no transpose of the pair map is ever made.
//
// What bounds it on this card: operations (164 GFLOP at B=4, L=128: 77 in the
// projections, 87 in the feature maps and contractions). One head's ctx is
// 320 x 65 float32 (83 KB), so a block cannot hold all 8 heads, and the layer
// runs as three launches with scratch in device memory:
//   1. proj:  LN and the q/k/v projections, M = rows, N = 3 * 512, K = 288;
//   2. favor: one block per (problem, head) streams the positions twice:
//             phi_k chunks -> ctx in shared memory, then phi_q chunks . ctx;
//             the (L, m) feature maps exist only in shared memory;
//   3. out:   att . Wo + bo (+ x), M = rows, N = 288, K = 512.
// The scratch (q/k/v and att, 4 * 512 values per position) is the price of
// the split. bfloat16: tensor cores (mma.sync m16n8k16); float32: CUDA cores.

#include "common.cuh"

using namespace rf;

namespace {

constexpr int D = 288;     // pair width
constexpr int DH = 64;     // dim_head
constexpr int HEADS = 8;
constexpr int HD = HEADS * DH;  // 512
constexpr int MF = 320;    // random features
constexpr int EP = 72;     // dh + 1 (the ones column) padded to 8
constexpr int NTHREADS = 256;

template <typename T>
struct GemmCfg {
  static constexpr int BM = sizeof(T) == 2 ? 64 : 32;
  static constexpr int WR = BM / 16, WC = 8 / WR;
};

// ------------------------------------------------------------ 1. projection
constexpr int NC1 = 64;  // output columns per chunk
constexpr int LD1 = D + 8;

template <typename T>
constexpr size_t proj_smem() {
  return sizeof(T) * (GemmCfg<T>::BM + NC1) * LD1;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
proj_kernel(const T* __restrict__ x, Rows rows_, const float* __restrict__ gamma,
            const float* __restrict__ beta, float ln_eps, const T* __restrict__ wq,
            const T* __restrict__ wk, const T* __restrict__ wv, float scale,
            T* __restrict__ qkv, long long M) {
  using G = GemmCfg<T>;
  constexpr int NT = NC1 / (8 * G::WC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ys = reinterpret_cast<T*>(smem_raw);  // [BM][LD1]
  T* Ws = Ys + G::BM * LD1;                 // [NC1][LD1]
  const long long r0 = (long long)blockIdx.x * G::BM;
  const int rows = (int)min((long long)G::BM, M - r0);
  const int warp = threadIdx.x >> 5, rg = warp % G::WR, cg = warp / G::WR;
  ln_rows<T, D>(Ys, LD1, [=](int r) { return x + rows_.offset(r0 + r); }, G::BM, rows, gamma,
                beta, ln_eps);
  for (int c0 = 0; c0 < 3 * HD; c0 += NC1) {
    const T* w = c0 < HD ? wq : (c0 < 2 * HD ? wk : wv);
    __syncthreads();
    stage<T>(Ws, LD1, w + (long long)(c0 % HD) * D, D, NC1, NC1, D);
    __syncthreads();
    float acc[NT][4];
    zero(acc);
    warp_gemm<NT>(acc, Ys + rg * 16 * LD1, LD1, Ws + cg * NT * 8 * LD1, LD1, D);
    const float s = c0 < 2 * HD ? scale : 1.f;
    for_each(acc, [&](int r, int c, float v) {
      const int gr = rg * 16 + r;
      if (gr < rows) qkv[(r0 + gr) * (3 * HD) + c0 + cg * NT * 8 + c] = from_f<T>(v * s);
    });
  }
}

// ----------------------------------------------------------------- 2. FAVOR+
template <typename T>
struct FavorCfg {
  static constexpr int LC = sizeof(T) == 2 ? 64 : 32;  // positions per chunk
  static constexpr int LDD = DH + 8, LDL = LC + 8, LDM = MF + 8, LDNUM = EP + 4;
  static constexpr size_t CTX = sizeof(float) * MF * EP;
  // phase 1: Ks [LC][LDD], Vt [EP][LDL], PhiKt [MF][LDL]
  static constexpr size_t P1 = sizeof(T) * (LC * LDD + EP * LDL + MF * LDL);
  // phase 2: Qs [LC][LDD], PhiQ [LC][LDM], NumS float [LC][LDNUM]
  static constexpr size_t P2 = sizeof(T) * (LC * LDD + LC * LDM) + sizeof(float) * LC * LDNUM;
  // bf16 keeps ctx^T [EP][LDM] for the mma B operand in the phase-1 region and
  // the phase-2 buffers in the ctx region; float32 reads ctx in place
  static constexpr bool SPLIT = sizeof(T) == 2;
  static constexpr size_t SMEM = SPLIT ? CTX + P1 : CTX + (P1 > P2 ? P1 : P2);
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
favor_kernel(const T* __restrict__ qkv, const T* __restrict__ proj, float kernel_eps,
             T* __restrict__ att, int L) {
  using F = FavorCfg<T>;
  constexpr int LC = F::LC, LDD = F::LDD, LDL = F::LDL, LDM = F::LDM, LDNUM = F::LDNUM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ctx = reinterpret_cast<float*>(smem_raw);  // [MF][EP]
  unsigned char* r1 = smem_raw + F::CTX;
  T* Ks = reinterpret_cast<T*>(r1);  // phase 1
  T* Vt = Ks + LC * LDD;
  T* PhiKt = Vt + EP * LDL;
  unsigned char* r2 = F::SPLIT ? smem_raw : r1;  // phase 2
  T* Qs = reinterpret_cast<T*>(r2);
  T* PhiQ = Qs + LC * LDD;
  float* NumS = reinterpret_cast<float*>(PhiQ + LC * LDM);
  T* CtxT = reinterpret_cast<T*>(r1);  // bf16 only: [EP][LDM]

  const int h = blockIdx.x;
  const long long p = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const T* base = qkv + p * L * (3 * HD);
  const T* qb = base + h * DH;
  const T* kb = base + HD + h * DH;
  const T* vb = base + 2 * HD + h * DH;

  for (int e = tid; e < MF * EP; e += NTHREADS) Ctx[e] = 0.f;

  // phase 1: ctx = sum over positions of phi_k^T [v | 1]
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<T>(Ks, LDD, kb + (long long)l0 * 3 * HD, 3 * HD, LC, nl, DH);
    for (int e = tid; e < EP * LC; e += NTHREADS) {
      const int l = e % LC, c = e / LC;
      float val = 0.f;
      if (l < nl) val = c < DH ? to_f(vb[(long long)(l0 + l) * 3 * HD + c]) : (c == DH ? 1.f : 0.f);
      Vt[c * LDL + l] = from_f<T>(val);
    }
    __syncthreads();
    // phi_k^T: (LC x 320) = Ks . P^T, items (row group, 64-column block)
    for (int it = warp; it < (LC / 16) * (MF / 64); it += NTHREADS / 32) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[8][4];
      zero(acc);
      warp_gemm<8>(acc, Ks + rg * 16 * LDD, LDD, proj + cb * 64 * DH, DH, DH);
      for_each(acc, [&](int r, int c, float v) {
        const int l = rg * 16 + r;
        PhiKt[(cb * 64 + c) * LDL + l] = from_f<T>(l < nl ? fmaxf(v, 0.f) + kernel_eps : 0.f);
      });
    }
    __syncthreads();
    // ctx (320 x 72) += PhiKt (320 x LC) . Vt^T; warp w owns row groups w, w+8, w+16
    for (int rg = warp; rg < MF / 16; rg += NTHREADS / 32) {
      float acc[EP / 8][4];
      zero(acc);
      warp_gemm<EP / 8>(acc, PhiKt + rg * 16 * LDL, LDL, Vt, LDL, LC);
      for_each(acc, [&](int r, int c, float v) { Ctx[(rg * 16 + r) * EP + c] += v; });
    }
  }
  __syncthreads();
  if (F::SPLIT) {  // ctx rounded to the compute dtype, transposed for mma
    for (int e = tid; e < MF * EP; e += NTHREADS) {
      const int m = e % MF, c = e / MF;
      CtxT[c * LDM + m] = from_f<T>(Ctx[m * EP + c]);
    }
  }

  // phase 2: att = (phi_q . ctx)[:, :dh] / max((phi_q . ctx)[:, dh], 1e-12)
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<T>(Qs, LDD, qb + (long long)l0 * 3 * HD, 3 * HD, LC, nl, DH);
    __syncthreads();
    for (int it = warp; it < (LC / 16) * (MF / 64); it += NTHREADS / 32) {
      const int rg = it % (LC / 16), cb = it / (LC / 16);
      float acc[8][4];
      zero(acc);
      warp_gemm<8>(acc, Qs + rg * 16 * LDD, LDD, proj + cb * 64 * DH, DH, DH);
      for_each(acc, [&](int r, int c, float v) {
        PhiQ[(rg * 16 + r) * LDM + cb * 64 + c] = from_f<T>(fmaxf(v, 0.f) + kernel_eps);
      });
    }
    __syncthreads();
    for (int rg = warp; rg < LC / 16; rg += NTHREADS / 32) {
      float acc[EP / 8][4];
      zero(acc);
      if constexpr (F::SPLIT)
        warp_gemm<EP / 8>(acc, PhiQ + rg * 16 * LDM, LDM, CtxT, LDM, MF);
      else
        warp_gemm_strided<EP / 8>(acc, reinterpret_cast<const float*>(PhiQ) + rg * 16 * LDM,
                                  LDM, Ctx, 1, EP, MF);
      for_each(acc, [&](int r, int c, float v) { NumS[(rg * 16 + r) * LDNUM + c] = v; });
    }
    __syncthreads();
    for (int e = tid; e < nl * DH; e += NTHREADS) {
      const int l = e / DH, c = e % DH;
      const float den = fmaxf(NumS[l * LDNUM + DH], 1e-12f);
      att[(p * L + l0 + l) * HD + h * DH + c] = from_f<T>(NumS[l * LDNUM + c] / den);
    }
  }
}

// ------------------------------------------------------- 3. out projection
constexpr int KC3 = 64;
constexpr int LD3 = KC3 + 8;

template <typename T>
constexpr size_t out_smem() {
  return sizeof(T) * (GemmCfg<T>::BM + D) * LD3;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
out_kernel(const T* __restrict__ att, const T* __restrict__ wo, const float* __restrict__ bo,
           const T* __restrict__ x, T* __restrict__ out, Rows rows_, long long M, int residual) {
  using G = GemmCfg<T>;
  constexpr int NT = D / (8 * G::WC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [BM][LD3]
  T* Ws = As + G::BM * LD3;                 // [D][LD3]
  const long long r0 = (long long)blockIdx.x * G::BM;
  const int rows = (int)min((long long)G::BM, M - r0);
  const int warp = threadIdx.x >> 5, rg = warp % G::WR, cg = warp / G::WR;
  float acc[NT][4];
  zero(acc);
  for (int k0 = 0; k0 < HD; k0 += KC3) {
    __syncthreads();
    stage<T>(As, LD3, att + r0 * HD + k0, HD, G::BM, rows, KC3);
    stage<T>(Ws, LD3, wo + k0, HD, D, D, KC3);
    __syncthreads();
    warp_gemm<NT>(acc, As + rg * 16 * LD3, LD3, Ws + cg * NT * 8 * LD3, LD3, KC3);
  }
  for_each(acc, [&](int r, int c, float v) {
    const int gr = rg * 16 + r, col = cg * NT * 8 + c;
    if (gr < rows) {
      const long long o = rows_.offset(r0 + gr) + col;
      float y = v + bo[col];
      if (residual) y = to_f(x[o]) + y;
      out[o] = from_f<T>(y);
    }
  });
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta, float ln_eps,
                   const void* wq, const void* wk, const void* wv, const void* wo,
                   const float* bo, const void* proj, float scale, float kernel_eps, void* qkv,
                   void* attn, void* out, Rows rows_, long long P, cudaStream_t st) {
  using G = GemmCfg<T>;
  const long long M = P * rows_.L;
  const unsigned gm = (unsigned)((M + G::BM - 1) / G::BM);
  cudaError_t err;
  if ((err = set_smem(proj_kernel<T>, proj_smem<T>())) != cudaSuccess) return err;
  if ((err = set_smem(favor_kernel<T>, FavorCfg<T>::SMEM)) != cudaSuccess) return err;
  if ((err = set_smem(out_kernel<T>, out_smem<T>())) != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  proj_kernel<T><<<gm, NTHREADS, proj_smem<T>(), st>>>(
      xt, rows_, gamma, beta, ln_eps, static_cast<const T*>(wq), static_cast<const T*>(wk),
      static_cast<const T*>(wv), scale, static_cast<T*>(qkv), M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  favor_kernel<T><<<dim3(HEADS, (unsigned)P), NTHREADS, FavorCfg<T>::SMEM, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(proj), kernel_eps,
      static_cast<T*>(attn), rows_.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  out_kernel<T><<<gm, NTHREADS, out_smem<T>(), st>>>(
      static_cast<const T*>(attn), static_cast<const T*>(wo), bo, xt, static_cast<T*>(out),
      rows_, M, gamma != nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: P problems of L positions of D = 288 values; problem p, position l
// at (p / p_inner) * s_hi + (p % p_inner) * s_lo + l * s_pos (elements).
// gamma, beta: LN parameters (float32), both null for the no-LN, no-residual
// mode. wq, wk, wv (512, 288) and wo (288, 512) in nn.Linear layout; bo
// (288) float32; proj (320, 64). qkv (P * L, 1536) and attn (P * L, 512)
// are scratch. dtype: 0 float32, 1 bfloat16.
int fused_performer_fwd(const void* x, const float* gamma, const float* beta, float ln_eps,
                        const void* wq, const void* wk, const void* wv, const void* wo,
                        const float* bo, const void* proj, float scale, float kernel_eps,
                        void* qkv, void* attn, void* out, long long P, int L, long long s_hi,
                        long long s_lo, long long s_pos, int p_inner, int d, int heads,
                        int dim_head, int m, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d != D || heads != HEADS || dim_head != DH || m != MF || P <= 0 || L <= 0 ||
      p_inner <= 0 || P > 65535 || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  Rows rows_{s_hi, s_lo, s_pos, p_inner, L};
  if (dtype == 0)
    return launch<float>(x, gamma, beta, ln_eps, wq, wk, wv, wo, bo, proj, scale, kernel_eps,
                         qkv, attn, out, rows_, P, st);
  if (dtype == 1)
    return launch<bf16>(x, gamma, beta, ln_eps, wq, wk, wv, wo, bo, proj, scale, kernel_eps,
                        qkv, attn, out, rows_, P, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
