// Fused 3x3 dilated SAME convolution, NHWC (kernel F), for Hopper (sm_90a):
//
//   out[b, i, j, :] = sum_{ki, kj} a[b, i + (ki-1)d, j + (kj-1)d, :] . W[ki, kj]
//   a = elu(x * inv[b] + shift[b])   with the optional pre-op, else a = x
//
// Replaces rosettafold_tpu/ops/pallas/conv3x3.py `_forward` (the
// pl.pallas_call at :134, public entry `conv3x3_fused` :208). As there, the
// pre-op (InstanceNorm affine + ELU between a ResBlock's two convs) is applied
// in float32 and rounded to the compute dtype, and the out-of-image halo is
// zero AFTER it (SAME padding pads the activated tensor); products accumulate
// in float32. The output is written in the input dtype or, for the input
// gradient of the conv's backward (`_bwd_rule` :250: this kernel with
// flipped, transposed weights), in float32.
//
// What bounds it on this card: operations (2 * 9 * C * Co per pixel, 98 GFLOP
// at B=4, L=128, C = Co = 288). bfloat16 input, an implicit GEMM on wgmma fed
// by TMA (PERF.md has the alternatives measured against it):
//  * a block of 256 threads owns 128 output pixels of one image row and all
//    288 output channels; each of its two warpgroups holds 64 pixels x 288 in
//    float32 registers (two m64n144k16 per K step, both operands in shared
//    memory). 256 threads, not a producer warp besides: with 9 warps one SM
//    quarter holds 3 of them, ptxas caps a thread at 168 registers and spills
//    the 144 accumulators (setmaxnreg did not lift it);
//  * the weights (64 input channels x 288 of one tap, 36 KB) and the input
//    (per warpgroup a row segment of 64 + 2d pixels x 64 channels) arrive by
//    TMA in the 128-byte swizzle, through rings of four and three stages with
//    full / empty mbarriers. TMA zero-fills outside the image (SAME padding)
//    and beyond C (the last 64-channel box of C = 288 is half full; its empty
//    K steps are skipped);
//  * the segment of kernel row ki is loaded once per channel chunk and serves
//    its three taps as three shifted views (rows 0, d, 2d): a third of the
//    input reads of a per-tap form. Dilations above 8 load one 64-pixel
//    segment per tap instead (off the main path, whose dilations are 1-8);
//  * thread 0 issues the loads from inside the loop (every thread runs the
//    issue code in step, see Loads); the products of two taps run while the
//    next tap's are issued (wgmma.wait_group 2), a tap's stages are released
//    when its products are done;
//  * kernel rows outside the image are skipped by loads and products alike;
//  * the epilogue stages each warpgroup's tile in shared memory (the rings'
//    space) and writes whole 16-byte vectors of contiguous output rows.
// The pre-op is a first launch: elementwise, once per element, into scratch
// that the conv then reads; TMA's zero fill is then the zero halo after the
// pre-op. (Applied in the conv block, to each segment, it cost 2.3x the conv:
// three times the elements, latency-bound, in the products' way.) Weights
// are read from L2 once per block (1.49 MB; 0.76 GB per call at B=4, L=128).
// The float32 path (the float32 kernel envelope and tests) keeps the CUDA-core
// implicit GEMM: 64 pixels a block, 96-channel chunks, FMAs, the pre-op fused.

#include "common.cuh"
#include "hopper.cuh"

using namespace rf;

namespace {

constexpr int CO = 288;  // output channels; the wrapper checks it

// ---- bfloat16 input: TMA + wgmma ------------------------------------------

namespace tma {

constexpr int BM = 128;                 // output pixels per block
constexpr int WM = 64;                  // output pixels per warpgroup
constexpr int KC = 64;                  // input channels per chunk (128 bytes)
constexpr int IN_FLIGHT = 2;           // taps whose products run while the next is issued
constexpr int W_STAGES = 4, A_STAGES = 3;
// A stage is released IN_FLIGHT taps after its products were issued; an item
// has one tap in tap mode, so each ring needs more stages than that, or a
// load would wait for a stage that is never freed
static_assert(W_STAGES > IN_FLIGHT && A_STAGES > IN_FLIGHT, "ring too shallow");
constexpr int W_HALF = 144 * 128;       // bytes of one 144-row half of a weight stage
constexpr int W_STAGE = 2 * W_HALF;     // 288 rows x 128 bytes
constexpr int MAX_ROW_DIL = 8;          // row segments up to 64 + 2 * 8 pixels
constexpr int NTHREADS = 256;           // two warpgroups, up to 255 registers a thread
constexpr int LDO = CO + 8;             // epilogue row stride (elements), conflict-free

// pixels of one warpgroup's input segment, and its bytes in shared memory
__host__ __device__ constexpr int seg_pixels(int dil) {
  return dil <= MAX_ROW_DIL ? WM + 2 * dil : WM;
}
__host__ __device__ constexpr int seg_bytes(int dil) {
  return (seg_pixels(dil) * 128 + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int ring_bytes(int dil) {
  return W_STAGES * W_STAGE + A_STAGES * 2 * seg_bytes(dil);
}
constexpr int N_BARRIERS = 2 * W_STAGES + 2 * A_STAGES;
__host__ __device__ constexpr int smem_bytes(int dil) {
  return 1024 + ring_bytes(dil) + N_BARRIERS * 8;  // 1024: slack to align the base
}

// The block's work, walked alike by the loads and the products: items are
// the kernel rows inside the image (a row outside adds only zeros), then (tap
// mode: one group per tap) the channel chunks. An item's taps are a bit mask
// of kj; `seg` is the first pixel of warpgroup 0's segment (warpgroup 1's is
// WM further).
struct Items {
  int i, j0, H, C, dil, nch;
  bool row_mode;
  __device__ Items(int i_, int j0_, int H_, int C_, int dil_)
      : i(i_), j0(j0_), H(H_), C(C_), dil(dil_), nch((C_ + KC - 1) / KC),
        row_mode(dil_ <= MAX_ROW_DIL) {}
  __device__ bool row_in(int ki) const {
    const int ii = i + (ki - 1) * dil;
    return ii >= 0 && ii < H;
  }
  __device__ int groups() const { return row_mode ? 1 : 3; }
  __device__ unsigned taps(int grp) const { return row_mode ? 7u : 1u << grp; }
  __device__ int seg(int grp) const { return row_mode ? j0 - dil : j0 + (grp - 1) * dil; }
};

// A cursor over the items and their taps, in the order both walk them.
struct Cursor {
  int ki = 0, grp = 0, ch = 0, kj = -1;  // kj -1: at the item, before its taps
  bool done = false;
  __device__ explicit Cursor(const Items& it) { settle(it); }
  // (ki, grp, ch) to the first item at or after it
  __device__ void settle(const Items& it) {
    for (; ki < 3; ++ki, grp = 0, ch = 0) {
      if (!it.row_in(ki)) continue;
      for (; grp < it.groups(); ++grp, ch = 0)
        if (ch < it.nch) return;
    }
    done = true;
  }
  // to the next tap of the item; false (and to the next item) past its last
  __device__ bool next_tap(const Items& it) {
    const unsigned rest = it.taps(grp) >> (kj + 1);
    if (rest != 0) {
      kj += __ffs(rest);
      return true;
    }
    kj = -1;
    ++ch;
    settle(it);
    return false;
  }
};

// The block's TMA loads, in the order the products use them: per item its
// two input segments, then each tap's weights. Every thread runs this in
// step (no divergent path among the products); thread 0 alone issues. A load
// goes out once the calling warpgroup has released the stage it refills
// (`used_a`, `used_w` stages so far) and the other warpgroup has too.
struct Loads {
  Cursor cur;
  int na = 0, nw = 0;  // issued so far
  __device__ explicit Loads(const Items& it) : cur(it) {}

  __device__ void issue(const Items& it, const CUtensorMap* xmap, const CUtensorMap* wmap,
                        uint32_t a_tiles, uint32_t a_bars, uint32_t w_tiles, uint32_t w_bars,
                        int sbytes, int b, int used_a, int used_w) {
    using namespace rf::hopper;
    const uint32_t leader = threadIdx.x == 0;
    const int P = seg_pixels(it.dil);
    while (!cur.done) {
      if (cur.kj < 0) {
        if (na >= used_a + A_STAGES) return;
        const int s = na % A_STAGES;
        mbar_wait(a_bars + 8 * (A_STAGES + s), ((na / A_STAGES) & 1) ^ 1);
        const uint32_t full = a_bars + 8 * s, dst = a_tiles + s * 2 * sbytes;
        const int ii = it.i + (cur.ki - 1) * it.dil, seg = it.seg(cur.grp);
        mbar_arrive_expect_tx(full, 2 * P * 128, leader);
        tma_load_4d(dst, xmap, full, cur.ch * KC, seg, ii, b, leader);
        tma_load_4d(dst + sbytes, xmap, full, cur.ch * KC, seg + WM, ii, b, leader);
        ++na;
        cur.kj = __ffs(it.taps(cur.grp)) - 1;
      } else {
        if (nw >= used_w + W_STAGES) return;
        const int s = nw % W_STAGES;
        mbar_wait(w_bars + 8 * (W_STAGES + s), ((nw / W_STAGES) & 1) ^ 1);
        const uint32_t full = w_bars + 8 * s, dst = w_tiles + s * W_STAGE;
        const int row = (cur.ki * 3 + cur.kj) * CO;
        mbar_arrive_expect_tx(full, W_STAGE, leader);
        tma_load_2d(dst, wmap, full, cur.ch * KC, row, leader);
        tma_load_2d(dst + W_HALF, wmap, full, cur.ch * KC, row + CO / 2, leader);
        ++nw;
        cur.next_tap(it);
      }
    }
  }
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one 64 x 144 accumulator into the staging tile (row stride LDO); `p` is
// this thread's first element: row 16 * warp + lane / 4, column 2 * (lane % 4)
template <typename TO>
__device__ __forceinline__ void stage_acc(TO* p, const float (&d)[72]) {
#pragma unroll
  for (int n = 0; n < 18; ++n) {
    store2(p + n * 8, d[4 * n], d[4 * n + 1]);
    store2(p + 8 * LDO + n * 8, d[4 * n + 2], d[4 * n + 3]);
  }
}

template <typename TO>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, TO* __restrict__ out, int H, int W,
                   int C, int dil) {
  using namespace rf::hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int sbytes = seg_bytes(dil);
  const uint32_t w_tiles = base, a_tiles = base + W_STAGES * W_STAGE;
  // barriers: W full, W empty (W_STAGES each), A full, A empty (A_STAGES each)
  const uint32_t w_bars = base + ring_bytes(dil), a_bars = w_bars + 2 * W_STAGES * 8;

  const int b = blockIdx.z, i = blockIdx.y, j0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;
  const Items items(i, j0, H, C, dil);

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(w_bars + 8 * s, 1);
      mbar_init(w_bars + 8 * (W_STAGES + s), NTHREADS / 32);
    }
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(a_bars + 8 * s, 1);
      mbar_init(a_bars + 8 * (A_STAGES + s), NTHREADS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  Loads loads(items);
  int used_a = 0, used_w = 0;  // stages this warpgroup has released
  auto issue = [&] {
    loads.issue(items, &xmap, &wmap, a_tiles, a_bars, w_tiles, w_bars, sbytes, b, used_a,
                used_w);
  };
  issue();

  // Each warpgroup: 64 output pixels x 288 channels, two m64n144k16 per K
  // step, A (the pixels) and B (the tap's weights) from shared memory. The
  // products of IN_FLIGHT taps run while the next tap's are issued; a tap's
  // stages are released when its group is done (wgmma.wait_group IN_FLIGHT).
  float acc0[72], acc1[72];  // output channels 0-143 and 144-287
#pragma unroll
  for (int k = 0; k < 72; ++k) acc0[k] = acc1[k] = 0.f;
  int w_stage = 0, a_stage = 0;
  uint32_t w_phase = 0, a_phase = 0;
  // the stages of the last IN_FLIGHT taps, oldest first (-1: none)
  int held_w[IN_FLIGHT], held_a[IN_FLIGHT];
#pragma unroll
  for (int k = 0; k < IN_FLIGHT; ++k) held_w[k] = held_a[k] = -1;
  auto retire = [&](int w_now, int a_now) {  // the oldest tap's products are done
    __syncwarp();
    if (held_w[0] >= 0) {
      if (lane == 0) mbar_arrive(w_bars + 8 * (W_STAGES + held_w[0]));
      ++used_w;
    }
    const int a_next = IN_FLIGHT > 1 ? held_a[1] : a_now;
    if (held_a[0] >= 0 && held_a[0] != a_next) {  // it was its item's last tap
      if (lane == 0) mbar_arrive(a_bars + 8 * (A_STAGES + held_a[0]));
      ++used_a;
    }
#pragma unroll
    for (int k = 0; k + 1 < IN_FLIGHT; ++k) {
      held_w[k] = held_w[k + 1];
      held_a[k] = held_a[k + 1];
    }
    held_w[IN_FLIGHT - 1] = w_now;
    held_a[IN_FLIGHT - 1] = a_now;
    issue();
  };
  Cursor cur(items);
  while (!cur.done) {
    mbar_wait(a_bars + 8 * a_stage, a_phase);
    const uint32_t a_tile = a_tiles + (a_stage * 2 + wg) * sbytes;
    const int nks = min(KC, items.C - cur.ch * KC) / 16;
    cur.kj = __ffs(items.taps(cur.grp)) - 1;
    bool more;
    do {
      // the A rows of this tap: the warpgroup's 64 pixels shifted by kj * d
      const uint32_t a_row = a_tile + (items.row_mode ? cur.kj * dil : 0) * 128;
      const uint32_t w_tile = w_tiles + w_stage * W_STAGE;
      mbar_wait(w_bars + 8 * w_stage, w_phase);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks < nks) {
          Wgmma<144>::ss(acc0, desc_sw128(a_row + ks * 32), desc_sw128(w_tile + ks * 32), 1);
          Wgmma<144>::ss(acc1, desc_sw128(a_row + ks * 32),
                         desc_sw128(w_tile + W_HALF + ks * 32), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<IN_FLIGHT>();
      more = cur.next_tap(items);
      retire(w_stage, a_stage);
      if (++w_stage == W_STAGES) {
        w_stage = 0;
        w_phase ^= 1u;
      }
    } while (more);
    if (++a_stage == A_STAGES) {
      a_stage = 0;
      a_phase ^= 1u;
    }
  }
  wgmma_wait<0>();

  // epilogue: both warpgroups are done with the rings; stage, then store
  __syncthreads();
  TO* st = reinterpret_cast<TO*>(smem) + wg * WM * LDO;
  const int r = wq * 16 + (lane >> 2), c = 2 * (lane & 3);
  stage_acc(st + r * LDO + c, acc0);
  stage_acc(st + r * LDO + c + CO / 2, acc1);
  named_barrier(1 + wg, 128);
  const int jw = j0 + wg * WM, nv = min(WM, W - jw);
  constexpr int V = 16 / sizeof(TO), VPP = CO / V;  // elements a vector, vectors a pixel
  TO* ob = out + (((long long)b * H + i) * W + jw) * CO;
  for (int e = threadIdx.x & 127; e < nv * VPP; e += 128) {
    const int p = e / VPP, v = (e % VPP) * V;
    *reinterpret_cast<uint4*>(ob + (long long)p * CO + v) =
        *reinterpret_cast<const uint4*>(st + p * LDO + v);
  }
}

// The pre-op, once per element: act = elu(x * inv[b] + shift[b]) in float32,
// rounded to bf16, 8 channels a thread. The conv then reads act through TMA,
// whose zero fill outside the image is SAME padding of the activated tensor.
__global__ void __launch_bounds__(256)
pre_op_kernel(const bf16* __restrict__ x, const float* __restrict__ pre, bf16* __restrict__ act,
              long long vecs, long long hw, int C) {
  const int cv = C / 8;
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e < vecs) {
    const long long pix = e / cv;
    const int c = (int)(e - pix * cv) * 8;
    const float4* inv = reinterpret_cast<const float4*>(pre + (pix / hw) * 2 * C + c);
    const float4* shift = reinterpret_cast<const float4*>(pre + (pix / hw) * 2 * C + C + c);
    const float4 i0 = __ldg(inv), i1 = __ldg(inv + 1), s0 = __ldg(shift), s1 = __ldg(shift + 1);
    const float iv[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
    const float sh[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    uint4 u = __ldcs(reinterpret_cast<const uint4*>(x) + e);
    bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float a = __fadd_rn(__fmul_rn(__bfloat162float(h[k]), iv[k]), sh[k]);
      h[k] = __float2bfloat16(a > 0.f ? a : expm1f(a));
    }
    reinterpret_cast<uint4*>(act)[e] = u;
  }
}

template <typename TO>
cudaError_t launch(const void* x, const void* w, const float* pre, void* act, void* out, int B,
                   int H, int W, int C, int dil, cudaStream_t st) {
  using namespace rf::hopper;
  if (pre != nullptr) {
    if (act == nullptr) return cudaErrorInvalidValue;
    const long long vecs = (long long)B * H * W * (C / 8);
    pre_op_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(
        static_cast<const bf16*>(x), pre, static_cast<bf16*>(act), vecs, (long long)H * W, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    x = act;
  }
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                  (cuuint64_t)H * W * C * 2};
  const cuuint32_t xbox[4] = {KC, (cuuint32_t)seg_pixels(dil), 1, 1};
  cudaError_t err = encode_bf16_sw128(&xmap, x, 4, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {(cuuint64_t)C, 9 * CO};  // w (9, 288, C): [tap][co][ci]
  const cuuint64_t wstrides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t wbox[2] = {KC, CO / 2};
  err = encode_bf16_sw128(&wmap, w, 2, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(dil);
  err = set_smem(conv3x3_tma_kernel<TO>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((W + BM - 1) / BM, H, B);
  conv3x3_tma_kernel<TO><<<grid, NTHREADS, smem, st>>>(xmap, wmap, static_cast<TO*>(out), H, W,
                                                       C, dil);
  return cudaGetLastError();
}

}  // namespace tma

// ---- float32 input: CUDA cores ----------------------------------------------

namespace f32 {

constexpr int BP = 64;   // output pixels per block (one image row)
constexpr int KC = 96;   // input channels per K chunk
constexpr int LDK = KC + 8;
constexpr int NTHREADS = 256;
constexpr int WR = 4, WC = 2, NT = CO / (8 * WC);  // warp grid, 18 n8 tiles

constexpr size_t smem_bytes() { return sizeof(float) * (BP * LDK + CO * LDK); }

__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ pre, float* __restrict__ out, int H, int W, int C,
               int dil) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [BP][LDK] shifted input pixels
  float* Bs = As + BP * LDK;                        // [CO][LDK] weight slice [co][ci]

  const int b = blockIdx.z, i = blockIdx.y, j0 = blockIdx.x * BP;
  const int warp = threadIdx.x >> 5, rg = warp % WR, cg = warp / WR;
  const float* xb = x + (long long)b * H * W * C;
  const float* inv = pre ? pre + (long long)b * 2 * C : nullptr;
  const float* shift = pre ? inv + C : nullptr;

  float acc[NT][4];
  zero(acc);
  for (int tap = 0; tap < 9; ++tap) {
    const int ii = i + (tap / 3 - 1) * dil, dj = (tap % 3 - 1) * dil;
    const bool row_in = ii >= 0 && ii < H;
    for (int c0 = 0; c0 < C; c0 += KC) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < BP * (KC / 8); e += NTHREADS) {
        const int p = e / (KC / 8), c = (e % (KC / 8)) * 8;
        const int jj = j0 + p + dj;
        float v[8];
        if (row_in && jj >= 0 && jj < W) {
          load8(v, xb + ((long long)ii * W + jj) * C + c0 + c);
          if (pre) {
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float a = v[t] * inv[c0 + c + t] + shift[c0 + c + t];
              v[t] = a > 0.f ? a : expm1f(a);
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] = 0.f;
        }
        store8(As + p * LDK + c, v);
      }
      stage<float>(Bs, LDK, w + (long long)tap * CO * C + c0, C, CO, CO, KC);
      __syncthreads();
      warp_gemm<NT>(acc, As + rg * 16 * LDK, LDK, Bs + cg * NT * 8 * LDK, LDK, KC);
    }
  }
  float* ob = out + ((long long)b * H + i) * W * CO;
  for_each(acc, [&](int r, int c, float v) {
    const int j = j0 + rg * 16 + r;
    if (j < W) ob[(long long)j * CO + cg * NT * 8 + c] = v;
  });
}

cudaError_t launch(const void* x, const void* w, const float* pre, void* out, int B, int H, int W,
                   int C, int dil, cudaStream_t st) {
  constexpr size_t smem = smem_bytes();
  cudaError_t err = set_smem(conv3x3_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((W + BP - 1) / BP, H, B);
  conv3x3_kernel<<<grid, NTHREADS, smem, st>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w), pre,
                                               static_cast<float*>(out), H, W, C, dil);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// x (B, H, W, C) NHWC; w (9, 288, C): tap-major, [co][ci] per tap; pre null
// or (B, 2, C) float32 [inv; shift]; act: with pre and bfloat16, scratch of
// x's size for the activated input, else null; out (B, H, W, 288). C % 96
// == 0; x, w, act 16-byte aligned. dtype: 0 float32 (CUDA cores), 1
// bfloat16 (TMA + wgmma); out_f32: 1 writes a float32 out whatever the input
// dtype, 0 writes the input dtype.
int conv3x3_fwd(const void* x, const void* w, const float* pre, void* act, void* out, int B,
                int H, int W, int C, int Co, int dil, int dtype, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Co != CO || C % 96 != 0 || dil < 1 || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return f32::launch(x, w, pre, out, B, H, W, C, dil, st);
  if (dtype == 1 && out_f32)
    return tma::launch<float>(x, w, pre, act, out, B, H, W, C, dil, st);
  if (dtype == 1) return tma::launch<bf16>(x, w, pre, act, out, B, H, W, C, dil, st);
  return (int)cudaErrorInvalidValue;
}

const char* last_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
