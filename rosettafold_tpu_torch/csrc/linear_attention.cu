// Generalized (ReLU-kernel) FAVOR+ linear attention (kernel H) for Hopper
// (sm_90a), per problem p of P:
//
//   phi_k = relu(k . P^T) + eps          (L, m)
//   ctx   = phi_k^T . v                  (m, dh),   ksum = sum_L phi_k   (m)
//   phi_q = relu(q . P^T) + eps          (L, m)
//   out   = (phi_q . ctx) / max(phi_q . ksum, 1e-12)      in q's dtype
//
// Replaces rosettafold_tpu/ops/pallas/linear_attention.py `_forward` (the
// pl.pallas_call at :82, entry `generalized_linear_attention` :105). Rounding
// points as that kernel (:47-68): the feature maps, ctx and ksum stay in
// float32 for bfloat16 inputs too; only k . P^T and q . P^T take the compute
// dtype (exact bf16 products, float32 sums), and only the output is rounded.
//
// Layout: q, k, v, out (P, L, 64) contiguous; proj (m, 64) in the dtype of
// q, m % 64 == 0, m <= 320.
//
// What bounds it on this card: operations. At P = 4096, L = 512, m = 320 the
// four products are 3.4e11 FLOP against 1.07 GB of traffic (q, k, v, out).
//
// bfloat16 (la_wgmma_kernel): a persistent grid over the problems, on wgmma,
// modelled on kernel C's FAVOR+ launch (fused_performer.cu) with H's float32
// intermediates carried by a bf16 high/low split. The block's m / 64
// warpgroups each own 64 features:
//  * the projection (m x 64) is loaded by TMA once a block and stays;
//  * phase 1, per chunk of 64 positions (K and V by TMA through 3-D maps
//    (dh, L, P), so positions past L read as zeros and no problem's positions
//    reach another's ctx; a ring that runs ahead into the block's next
//    problem): phi_k^T of the warpgroup's features (P_s . K^T, in two m64n32
//    halves) -> relu + eps in float32, zero past L (masked on a problem's
//    last chunk only) -> bf16 hi and lo A fragments -> ctx_s += hi^T . V +
//    lo^T . V (V an MN-major B tile, exact in bf16) in float32 accumulators;
//    ksum_s from the unrounded values;
//  * ctx_s goes to shared memory as a hi and a lo bf16 tile ([dh][feature],
//    phase 2's K-major B), ksum_s as float32;
//  * phase 2: warpgroup w takes the position chunks w, w + m / 64, ... (its
//    own Q tile by TMA): per feature slice and m64n32 half, phi_q (Q . P_s^T)
//    -> relu + eps -> hi / lo fragments -> num += hi . ctx_hi + hi . ctx_lo +
//    lo . ctx_hi (lo . ctx_lo, about 2^-18 of a term, is dropped); den from
//    the float32 phi_q against ksum on the CUDA cores; out = num / max(den,
//    1e-12), rounded to bf16 and stored where l < L.
// The split costs 1.75x the bf16 products (7 wgmma passes a chunk and slice
// instead of 4). A warpgroup that is done with phase 2 starts the next
// problem's phase 1; the ctx tiles are rewritten only once every warpgroup
// has left phase 2. At m = 320 the 640-thread block has 96 registers a
// thread, which is why the feature maps come in m64n32 halves (no spill).
// Issuing the next half's feature map before the last half's products, to
// split it while they run, gained nothing in phase 1 and spilled in phase 2
// (probes/la_variants.py).
//
// float32 (la_f32_kernel): one block per problem on the CUDA cores (fmaf),
// positions streamed twice in chunks of 32, ctx whole in shared memory
// (m x 72 float32, 92 KB at m = 320; its column 64 is ksum).

#include "common.cuh"
#include "hopper.cuh"

using namespace rf;

namespace {

constexpr int DH = 64;         // head width
constexpr int MAX_M = 320;     // random features

// ------------------------------------------------------------ float32
namespace la_f32 {

constexpr int EP = 72;         // dh + 1 (the ones column) padded to 8
constexpr int LC = 32;         // positions per chunk
constexpr int LDD = DH + 8;    // staged q / k rows
constexpr int LDL = LC + 4;    // phi_k^T and v^T rows
constexpr int LDN = EP + 4;    // num rows
constexpr int NTHREADS = 256;
constexpr int NCG = 3;         // column groups of the num product, 3 x 3 tiles of 8

__host__ __device__ inline size_t ctx_bytes(int m) { return sizeof(float) * m * EP; }
inline size_t smem_bytes(int m) {
  const size_t p1 = sizeof(float) * (LC * LDD + EP * LDL + (size_t)m * LDL);
  const size_t p2 = sizeof(float) * (LC * LDD + (size_t)LC * (m + 4) + LC * LDN);
  return ctx_bytes(m) + (p1 > p2 ? p1 : p2);
}

// phi[l][c] = relu(xs[l] . proj[c]) + eps for a chunk of LC staged rows,
// written through store(l, c, value); items (row group, 64-feature block).
template <typename Store>
__device__ __forceinline__ void feature_map(const float* xs, const float* __restrict__ proj,
                                            int m, float eps, Store&& store) {
  const int warp = threadIdx.x >> 5;
  for (int it = warp; it < (LC / 16) * (m / 64); it += NTHREADS / 32) {
    const int rg = it % (LC / 16), cb = it / (LC / 16);
    float acc[8][4];
    zero(acc);
    warp_gemm<8>(acc, xs + rg * 16 * LDD, LDD, proj + (size_t)cb * 64 * DH, DH, DH);
    for_each(acc, [&](int r, int c, float v) { store(rg * 16 + r, cb * 64 + c, fmaxf(v, 0.f) + eps); });
  }
}

__global__ void __launch_bounds__(NTHREADS)
la_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ proj,
              float* __restrict__ out, int L, int m, float kernel_eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ctx = reinterpret_cast<float*>(smem_raw);  // [m][EP]
  float* Xs = reinterpret_cast<float*>(smem_raw + ctx_bytes(m));  // [LC][LDD] k, then q
  float* Vt = Xs + LC * LDD;                            // phase 1: [EP][LDL]
  float* PhiKt = Vt + EP * LDL;                         // phase 1: [m][LDL]
  float* PhiQ = Vt;                                     // phase 2: [LC][m + 4]
  const int ldm = m + 4;
  float* NumS = PhiQ + LC * ldm;                        // phase 2: [LC][LDN]

  const long long p = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* kb = k + p * L * DH;
  const float* vb = v + p * L * DH;
  const float* qb = q + p * L * DH;
  float* ob = out + p * L * DH;

  for (int e = tid; e < m * EP; e += NTHREADS) Ctx[e] = 0.f;

  // phase 1: ctx = sum over positions of phi_k^T [v | 1]
  for (int l0 = 0; l0 < L; l0 += LC) {
    const int nl = min(LC, L - l0);
    __syncthreads();
    stage<float>(Xs, LDD, kb + (long long)l0 * DH, DH, LC, nl, DH);
    for (int e = tid; e < EP * LC; e += NTHREADS) {
      const int l = e % LC, c = e / LC;
      float val = 0.f;
      if (l < nl) val = c < DH ? vb[(long long)(l0 + l) * DH + c] : (c == DH ? 1.f : 0.f);
      Vt[c * LDL + l] = val;
    }
    __syncthreads();
    feature_map(Xs, proj, m, kernel_eps, [&](int l, int c, float val) {
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
    stage<float>(Xs, LDD, qb + (long long)l0 * DH, DH, LC, nl, DH);
    __syncthreads();
    feature_map(Xs, proj, m, kernel_eps,
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
      ob[(long long)(l0 + l) * DH + c] = NumS[l * LDN + c] / den;
    }
  }
}

cudaError_t launch(const float* q, const float* k, const float* v, const float* proj, float* out,
                   long long P, int L, int m, float kernel_eps, cudaStream_t st) {
  const size_t smem = smem_bytes(m);
  cudaError_t err = set_smem(la_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  la_f32_kernel<<<(unsigned)P, NTHREADS, smem, st>>>(q, k, v, proj, out, L, m, kernel_eps);
  return cudaGetLastError();
}

}  // namespace la_f32

// ------------------------------------------------- bfloat16 on wgmma
namespace la_wg {

using namespace rf::hopper;

constexpr int LC = 64;          // positions a chunk
constexpr int TILE = 64 * 128;  // 64 rows of 64 bf16, 128-byte swizzle
constexpr int KV_STAGES = 4;
// The K/V ring keeps KV_AHEAD chunks issued from the next one a thread takes
// on. Issuing chunk n waits for every warp to release chunk n - KV_STAGES, so
// a warpgroup may run KV_STAGES - KV_AHEAD chunks ahead of the slowest one
// (at KV_AHEAD = KV_STAGES every thread would wait, at each chunk, for all
// warps to release the chunk just taken)
constexpr int KV_AHEAD = KV_STAGES - 2;

// shared memory from a 1024-byte boundary, for NWG = m / 64 warpgroups
template <int NWG>
struct Cfg {
  static constexpr int NT = NWG * 128;
  static constexpr int P_OFF = 0;                          // NWG tiles [feature][dh]
  static constexpr int HI_OFF = P_OFF + NWG * TILE;        // NWG ctx hi tiles [dh][feature]
  static constexpr int LO_OFF = HI_OFF + NWG * TILE;       // NWG ctx lo tiles
  static constexpr int KV_OFF = LO_OFF + NWG * TILE;       // KV_STAGES x (K, V) [pos][dh]
  static constexpr int Q_OFF = KV_OFF + KV_STAGES * 2 * TILE;  // NWG Q tiles [pos][dh]
  static constexpr int KSUM_OFF = Q_OFF + NWG * TILE;      // 64 * NWG floats
  static constexpr int BAR_OFF = KSUM_OFF + NWG * 64 * 4;
  // p_full, kv_full[KV_STAGES], kv_empty[KV_STAGES], q_full[NWG]
  static constexpr int NBARS = 1 + 2 * KV_STAGES + NWG;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * NBARS;
  static_assert(SMEM <= 232448, "shared memory above the card's 227 KB a block");
};

template <int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
la_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap p_map, float kernel_eps,
                bf16* __restrict__ out, int L, long long P) {
  using C = Cfg<NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* ksum_s = reinterpret_cast<float*>(smem + C::KSUM_OFF);
  const uint32_t p_full = base + C::BAR_OFF, kv_full = p_full + 8,
                 kv_empty = kv_full + 8 * KV_STAGES, q_full = kv_empty + 8 * KV_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t leader = threadIdx.x == 0, wg_leader = (threadIdx.x & 127) == 0;
  if (leader) {
    mbar_init(p_full, 1);
    for (int st = 0; st < KV_STAGES; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, C::NT / 32);
    }
    for (int w = 0; w < NWG; ++w) mbar_init(q_full + 8 * w, 1);
    fence_mbar_init();
  }
  __syncthreads();
  mbar_arrive_expect_tx(p_full, NWG * TILE, leader);
  for (int s = 0; s < NWG; ++s)
    tma_load_2d(base + C::P_OFF + s * TILE, &p_map, p_full, 0, 64 * s, leader);

  const int nc = (L + LC - 1) / LC;
  // the K/V loads in the order phase 1 takes them over the block's problems;
  // every thread runs this in step, thread 0 alone issues
  long long kv_item = blockIdx.x;
  int kv_chunk = 0, kv_n = 0;
  auto issue_kv = [&](int released) {
    while (kv_item < P && kv_n < released + KV_AHEAD) {
      const int st = kv_n % KV_STAGES;
      mbar_wait(kv_empty + 8 * st, ((kv_n / KV_STAGES) & 1) ^ 1);
      const uint32_t dst = base + C::KV_OFF + st * 2 * TILE, full = kv_full + 8 * st;
      mbar_arrive_expect_tx(full, 2 * TILE, leader);
      tma_load_3d(dst, &k_map, full, 0, kv_chunk * LC, (int)kv_item, leader);
      tma_load_3d(dst + TILE, &v_map, full, 0, kv_chunk * LC, (int)kv_item, leader);
      ++kv_n;
      if (++kv_chunk == nc) {
        kv_chunk = 0;
        kv_item += gridDim.x;
      }
    }
  };
  int kv_used = 0;  // K/V stages this thread has taken
  int q_n = 0;      // Q tiles this warpgroup has taken
  issue_kv(0);
  mbar_wait(p_full, 0);

  const uint32_t p_tile = base + C::P_OFF + wg * TILE;
  const uint32_t q_tile = base + C::Q_OFF + wg * TILE, q_bar = q_full + 8 * wg;
  for (long long item = blockIdx.x; item < P; item += gridDim.x) {
    const int nq = wg < nc ? (nc - 1 - wg) / NWG + 1 : 0;  // this warpgroup's Q chunks
    // the warpgroup's k-th Q chunk of this problem into its tile, which the
    // warpgroup no longer reads
    auto issue_q = [&](int k) {
      const uint32_t pred = wg_leader && k < nq;
      mbar_arrive_expect_tx(q_bar, TILE, pred);
      tma_load_3d(q_tile, &q_map, q_bar, 0, (wg + k * NWG) * LC, (int)item, pred);
    };
    issue_q(0);

    // phase 1: ctx_s = phi_k,s^T . v, ksum_s, over the features of this warpgroup
    float ctx[32], ks[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) ctx[e] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int st = kv_used % KV_STAGES;
      mbar_wait(kv_full + 8 * st, (kv_used / KV_STAGES) & 1);
      const uint32_t kt = base + C::KV_OFF + st * 2 * TILE, vt = kt + TILE;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // positions 32 hf .. 32 hf + 31 of the chunk
        float d[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) d[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
          Wgmma<32>::ss(d, desc_sw128(p_tile + k4 * 32), desc_sw128(kt + hf * 4096 + k4 * 32), 1);
        wgmma_commit();
        wgmma_wait<0>();
        uint32_t hi[2][4], lo[2][4];
        const auto one = [](int) { return 1.f; };
        if (c + 1 < nc)  // only a problem's last chunk holds positions past L
          favor_features_split<2>(hi, lo, d, kernel_eps, LC, t, ks, one);
        else
          favor_features_split<2>(hi, lo, d, kernel_eps, L - c * LC - 32 * hf, t, ks, one);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t bv = desc_sw128_mn(vt + (2 * hf + kk) * 2048, TILE);
          Wgmma<64>::rs<1>(ctx, hi[kk], bv, 1);
          Wgmma<64>::rs<1>(ctx, lo[kk], bv, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * st);
      issue_kv(++kv_used);
    }

    __syncthreads();  // every warpgroup has left the last problem's phase 2
    // ctx_s -> bf16 hi and lo [dh][feature] tiles (the 128-byte swizzle),
    // ksum_s -> float32
    unsigned char* th = smem + C::HI_OFF + wg * TILE;
    unsigned char* tl = smem + C::LO_OFF + wg * TILE;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int f = 16 * wq + g + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + 2 * t + (e & 1);
      const int off = c * 128 + ((((f >> 3) ^ (c & 7)) << 4) | ((f & 7) << 1));
      const bf16 h = __float2bfloat16(ctx[e]);
      *reinterpret_cast<bf16*>(th + off) = h;
      *reinterpret_cast<bf16*>(tl + off) = __float2bfloat16(ctx[e] - __bfloat162float(h));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = ks[hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) ksum_s[64 * wg + 16 * wq + g + 8 * hh] = v;
    }
    fence_proxy_async();
    __syncthreads();

    // phase 2: out = num / max(den, 1e-12), num = phi_q . ctx, den = phi_q . ksum
    for (int k = 0; k < nq; ++k) {
      const int c = wg + k * NWG;
      mbar_wait(q_bar, (q_n + k) & 1);
      float num[32], dq[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) num[e] = 0.f;
#pragma unroll
      for (int s = 0; s < NWG; ++s) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // features 64 s + 32 hf .. + 31
          const uint32_t ps = base + C::P_OFF + s * TILE + hf * 4096;
          float d[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) d[e] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
            Wgmma<32>::ss(d, desc_sw128(q_tile + k4 * 32), desc_sw128(ps + k4 * 32), 1);
          wgmma_commit();
          wgmma_wait<0>();
          uint32_t hi[2][4], lo[2][4];
          const float* kw = ksum_s + 64 * s + 32 * hf;
          favor_features_split<2>(hi, lo, d, kernel_eps, LC, t, dq,
                                  [kw](int col) { return kw[col]; });
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint32_t koff = s * TILE + (2 * hf + kk) * 32;
            const uint64_t bh = desc_sw128(base + C::HI_OFF + koff);
            const uint64_t bl = desc_sw128(base + C::LO_OFF + koff);
            Wgmma<64>::rs<0>(num, hi[kk], bh, 1);
            Wgmma<64>::rs<0>(num, hi[kk], bl, 1);
            Wgmma<64>::rs<0>(num, lo[kk], bh, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = dq[hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const float den = fmaxf(v, 1e-12f);
        const int l = c * LC + 16 * wq + g + 8 * hh;
        if (l < L) {
          bf16* o = out + (item * L + l) * DH + 2 * t;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
                __floats2bfloat162_rn(num[4 * n + 2 * hh] / den, num[4 * n + 2 * hh + 1] / den);
        }
      }
      named_barrier(1 + wg, 128);  // the warpgroup is done with its Q tile
      issue_q(k + 1);
    }
    q_n += nq;
  }
}

template <int NWG>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* proj, bf16* out,
                   long long P, int L, float kernel_eps, cudaStream_t st) {
  using C = Cfg<NWG>;
  CUtensorMap q_map, k_map, v_map, p_map;
  const cuuint64_t dims[3] = {DH, (cuuint64_t)L, (cuuint64_t)P};
  const cuuint64_t strides[2] = {DH * 2, (cuuint64_t)L * DH * 2};
  const cuuint64_t pdims[2] = {DH, (cuuint64_t)(64 * NWG)}, pstrides[1] = {DH * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  cudaError_t err;
  if ((err = encode_bf16_sw128(&q_map, q, 3, dims, strides, box)) != cudaSuccess) return err;
  if ((err = encode_bf16_sw128(&k_map, k, 3, dims, strides, box)) != cudaSuccess) return err;
  if ((err = encode_bf16_sw128(&v_map, v, 3, dims, strides, box)) != cudaSuccess) return err;
  if ((err = encode_bf16_sw128(&p_map, proj, 2, pdims, pstrides, box)) != cudaSuccess) return err;
  if ((err = set_smem(la_wgmma_kernel<NWG>, C::SMEM)) != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, la_wgmma_kernel<NWG>, C::NT,
                                                           C::SMEM)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = (long long)sm_count() * per_sm;
  la_wgmma_kernel<NWG><<<(unsigned)(P < slots ? P : slots), C::NT, C::SMEM, st>>>(
      q_map, k_map, v_map, p_map, kernel_eps, out, L, P);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* proj, bf16* out,
                        long long P, int L, int m, float kernel_eps, cudaStream_t st) {
  switch (m / 64) {
    case 1: return launch<1>(q, k, v, proj, out, P, L, kernel_eps, st);
    case 2: return launch<2>(q, k, v, proj, out, P, L, kernel_eps, st);
    case 3: return launch<3>(q, k, v, proj, out, P, L, kernel_eps, st);
    case 4: return launch<4>(q, k, v, proj, out, P, L, kernel_eps, st);
    case 5: return launch<5>(q, k, v, proj, out, P, L, kernel_eps, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace la_wg

}  // namespace

extern "C" {

// q, k, v, out: (P, L, dh = 64) contiguous; proj (m, 64), m % 64 == 0 and
// m <= 320, all of one dtype: 0 float32, 1 bfloat16 (16-byte aligned).
// Returns the cudaError_t of the launch.
int linear_attention_fwd(const void* q, const void* k, const void* v, const void* proj,
                         void* out, long long P, int L, int dh, int m, float kernel_eps,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh != DH || m <= 0 || m % 64 || m > MAX_M || P <= 0 || P > 2147483647LL || L <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return la_f32::launch(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<const float*>(proj),
                          static_cast<float*>(out), P, L, m, kernel_eps, st);
  if (dtype == 1)
    return la_wg::launch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), static_cast<const bf16*>(proj),
                              static_cast<bf16*>(out), P, L, m, kernel_eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
