// K5: the policy and value heads with the legal-masked softmax.
//
// Replaces: alphazero_risk_tpu/models/fast_infer.py, `_heads` (two 1x1
// convs with bias and ReLU, the (position, channel) flatten, dense 84->43,
// dense 42->V with ReLU, dense V->1, tanh) and the epilogue of the eval
// functions, softmax(where(legal, logits, -inf)).
//
// Bound on an H100: bytes.  At the main path's shape (B=64, C=256) the
// trunk output is 64*42*256*4 = 2.75 MB, 0.85 us at 3.35 TB/s with the
// head weights (64 KB at V=256) and the outputs; the arithmetic (under 3
// MFLOP) is small beside it.  So h is read once, the weights are read from
// L2 once per block (not once per cell or output), and the dependent steps
// of a game are few:
//
//   - the ten head tensors come packed at fold time (fast_infer.
//     pack_heads, heads_layout): the three 1x1-conv columns as one float4
//     per channel, pol_dense_w transposed to [43, 84] (a warp reduces one
//     logit over its lanes, coalesced), val_d1_w [42, Vp], the biases;
//   - a block stages the policy dense weights (14.6 KB) and its games' h
//     slabs in shared memory with bulk asynchronous copies (cp.async.bulk,
//     the TMA's 1-D form, completing on an mbarrier); each lane holds the
//     conv columns of its channels in registers for every cell, and each
//     pair of lanes the column of one value-hidden unit (21 rows each);
//     so no weight is read from L2 more than once per block;
//   - phase 1 (all 16 warps): a warp takes a cell, its lanes dot their
//     16-byte slices of h with the three columns, three warp sums;
//   - phase 2: the dense layers spread over the warps: each warp reduces
//     a few of the 43 logits over its lanes; each lane pair computes one
//     hidden unit of the value layer from its registers and its share of
//     the value dot; phase 3: one warp the masked softmax, one the value
//     (f32 throughout, expf and tanhf).
//
// The grid is one block per game up to one per SM; above that each block
// loops over games, its weights read once and the next game's h copied
// while the current one is computed (two h slabs).  (Two blocks per game
// as a thread-block cluster, each reading half of the cells and sending
// its activations to the other through distributed shared memory, timed
// the same at B = 64 on an H100: the kernel is bound by its dependent
// steps there, and the cluster barriers cost what the halved copy saved.)
//
// A row with no legal action gives NaN probabilities, as the plain
// version does (exp(-inf - -inf)).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCells = 42;
constexpr int kActions = 43;
constexpr int kPol = 2 * kCells;      // policy activations
constexpr int kAct = 128;             // activation row: 84 policy, 42 value
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPolPart = kActions * kPol + 44;  // pol_dense_w^T, its bias
constexpr int kBufs = 2;              // h slabs a looping block holds
constexpr int kBarBytes = 32;         // the mbarriers: weights, 2 slabs

// The offsets of heads_layout (fast_infer.py), in floats.
struct Layout {
  int vp, bias, pol, val, d1b, d2w;
  __device__ Layout(int C, int V) {
    vp = (V + 3) / 4 * 4;
    bias = 4 * C;
    pol = bias + 4;
    val = pol + kPolPart;
    d1b = val + kCells * vp;
    d2w = d1b + vp;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Expect `bytes` on `bar` and copy them from global `src` to shared `dst`
// (both 16-byte aligned, bytes % 16 == 0).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// NQ float4s of a cell's channels per lane (C <= 128 * NQ); P threads
// per value-hidden unit, each holding 42 / P rows of its val_d1_w column
// (V <= 512 / P).  Block b takes games b, b + gridDim.x, ...
template <int NQ, int P>
__global__ void __launch_bounds__(kThreads)
heads_eval_kernel(const float* __restrict__ h, const float* __restrict__ pack,
                  const uint8_t* __restrict__ legal, float* __restrict__ probs,
                  float* __restrict__ value, float* __restrict__ logits,
                  int B, int C, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(C, V);
  // shared memory: the mbarriers (policy weights, then one per h slab),
  // the policy dense weights, two h slabs, two activation rows, the
  // logits, the value partials
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* pw = reinterpret_cast<float*>(smem + kBarBytes);
  float* hbuf = pw + kPolPart;
  const int slab = kCells * C;                    // floats of one h slab
  float* act = hbuf + kBufs * slab;               // [2][kAct]
  float* lsm = act + 2 * kAct;                    // [44]
  float* psum = lsm + 44;                         // [kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t slab_bytes = static_cast<uint32_t>(slab) * 4;
  if (tid == 0) {
    for (int i = 0; i <= kBufs; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    bulk_copy(pw, pack + lay.pol, kPolPart * 4, &bars[0]);
    for (int i = 0; i < kBufs; ++i) {
      const int g = blockIdx.x + i * gridDim.x;
      if (g < B)
        bulk_copy(hbuf + i * slab, h + static_cast<int64_t>(g) * slab,
                  slab_bytes, &bars[1 + i]);
    }
  }
  // the lane's conv columns, for every cell: channels 4q' .. 4q' + 3 of
  // its float4 slices q' = lane + 32 q
  const int c4 = C / 4;
  float4 wc[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = lane + 32 * q;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wc[q][k] = i < c4 ? __ldg(reinterpret_cast<const float4*>(pack) +
                                4 * i + k)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float pb0 = __ldg(pack + lay.bias), pb1 = __ldg(pack + lay.bias + 1);
  const float vb = __ldg(pack + lay.bias + 2);
  const float d2b = __ldg(pack + lay.bias + 3);
  // the value layer's weights stay in registers for every game: hidden
  // unit j's rows row0 .. row0 + kRows - 1 of val_d1_w, its bias and its
  // val_d2_w entry (P = 2: the two lanes of a pair split the rows)
  constexpr int kRows = kCells / P;
  const int j = tid / P, row0 = (tid % P) * kRows;
  const bool unit = j < V;
  float wv[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    wv[k] = unit ? __ldg(pack + lay.val + (row0 + k) * lay.vp + j) : 0.f;
  const float b1 = unit ? __ldg(pack + lay.d1b + j) : 0.f;
  const float w2 = unit && tid % P == 0 ? __ldg(pack + lay.d2w + j) : 0.f;

  int it = 0;
  for (int g = blockIdx.x; g < B; g += gridDim.x, ++it) {
    const int buf = it & 1;
    float* a = act + buf * kAct;
    // the legal bytes, read now and first used in phase 3
    uint8_t lg0 = 0, lg1 = 0;
    if (warp == 0) {
      const uint8_t* lr = legal + static_cast<int64_t>(g) * kActions;
      lg0 = lr[lane];
      lg1 = lane + 32 < kActions ? lr[lane + 32] : 0;
    }
    mbar_wait(&bars[1 + buf], (it >> 1) & 1);

    // ---- phase 1: 1x1 convs 256->2 and 256->1 with bias and ReLU ----
    const float4* hs = reinterpret_cast<const float4*>(hbuf + buf * slab);
    for (int cell = warp; cell < kCells; cell += kWarps) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int i = lane + 32 * q;
        if (i < c4) {
          const float4 x = hs[cell * c4 + i];
          s0 = fmaf(x.x, wc[q][0].x, s0);
          s1 = fmaf(x.x, wc[q][0].y, s1);
          s2 = fmaf(x.x, wc[q][0].z, s2);
          s0 = fmaf(x.y, wc[q][1].x, s0);
          s1 = fmaf(x.y, wc[q][1].y, s1);
          s2 = fmaf(x.y, wc[q][1].z, s2);
          s0 = fmaf(x.z, wc[q][2].x, s0);
          s1 = fmaf(x.z, wc[q][2].y, s1);
          s2 = fmaf(x.z, wc[q][2].z, s2);
          s0 = fmaf(x.w, wc[q][3].x, s0);
          s1 = fmaf(x.w, wc[q][3].y, s1);
          s2 = fmaf(x.w, wc[q][3].z, s2);
        }
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane < 3)
        a[lane == 2 ? kPol + cell : 2 * cell + lane] =
            fmaxf(lane == 0 ? s0 + pb0 : (lane == 1 ? s1 + pb1 : s2 + vb),
                  0.f);
    }
    __syncthreads();
    // every thread has read its h slab: refill it with the game after next
    if (tid == 0 && g + kBufs * gridDim.x < B)
      bulk_copy(hbuf + buf * slab,
                h + static_cast<int64_t>(g + kBufs * gridDim.x) * slab,
                slab_bytes, &bars[1 + buf]);
    mbar_wait(&bars[0], 0);

    // ---- phase 2: dense 84->43; dense 42->V with ReLU, V->1 ----
    for (int o = warp; o < kActions; o += kWarps) {
      float s = 0.f;
      for (int i = lane; i < kPol; i += 32)
        s = fmaf(a[i], pw[o * kPol + i], s);
      s = warp_sum(s);
      if (lane == 0) lsm[o] = s + pw[kActions * kPol + o];
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) s = fmaf(a[kPol + row0 + k], wv[k], s);
    if constexpr (P == 2) s += __shfl_xor_sync(0xffffffffu, s, 1);
    // w2 is 0 off the unit's first lane and past V
    const float part = warp_sum(fmaxf(s + b1, 0.f) * w2);
    if (lane == 0) psum[warp] = part;
    __syncthreads();

    // ---- phase 3: the masked softmax; tanh of the value ----
    if (warp == 0) {
      const int a1 = lane + 32;
      const float l0 = lsm[lane];
      const float l1 = a1 < kActions ? lsm[a1] : 0.f;
      const float x0 = lg0 != 0 ? l0 : -CUDART_INF_F;
      const float x1 = lg1 != 0 ? l1 : -CUDART_INF_F;
      const float m = warp_max(fmaxf(x0, x1));
      const float e0 = expf(x0 - m);
      const float e1 = a1 < kActions ? expf(x1 - m) : 0.f;
      const float tot = warp_sum(e0 + e1);
      const int64_t r = static_cast<int64_t>(g) * kActions;
      probs[r + lane] = e0 / tot;
      logits[r + lane] = l0;
      if (a1 < kActions) {
        probs[r + a1] = e1 / tot;
        logits[r + a1] = l1;
      }
    } else if (warp == 1) {
      const float v = warp_sum(lane < kWarps ? psum[lane] : 0.f);
      if (lane == 0) value[g] = tanhf(v + d2b);
    }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

size_t smem_bytes(int C) {
  return kBarBytes +
         4 * (kPolPart + kBufs * kCells * C + 2 * kAct + 44 + kWarps);
}

template <int NQ, int P>
int launch(const float* h, const float* pack, const uint8_t* legal,
           float* probs, float* value, float* logits, int B, int C, int V,
           cudaStream_t stream) {
  const size_t shmem = smem_bytes(C);
  auto kern = heads_eval_kernel<NQ, P>;
  static size_t allowed = 0;    // the largest size set for this kernel
  if (shmem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = shmem;
  }
  const int grid = B < num_sms() ? B : num_sms();
  kern<<<grid, kThreads, shmem, stream>>>(h, pack, legal, probs, value,
                                          logits, B, C, V);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(const float* h, const float* pack, const uint8_t* legal,
             float* probs, float* value, float* logits, int B, int C, int V,
             cudaStream_t stream) {
  const int c4 = C / 4;
  if (c4 <= 32)
    return launch<1, P>(h, pack, legal, probs, value, logits, B, C, V,
                        stream);
  if (c4 <= 64)
    return launch<2, P>(h, pack, legal, probs, value, logits, B, C, V,
                        stream);
  return launch<4, P>(h, pack, legal, probs, value, logits, B, C, V, stream);
}

}  // namespace

// h [B, 42, C] f32 (C % 4 == 0, C <= 512, 16-byte aligned); pack: the head
// weights in heads_layout(C, V) (f32, 16-byte aligned, V <= 512);
// legal [B, 43] bool (one byte each).  Outputs probs [B, 43], value [B],
// logits [B, 43] f32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int az_heads_eval(const void* h, const void* pack,
                             const void* legal, void* probs, void* value,
                             void* logits, int B, int C, int V,
                             void* stream) {
  if (C % 4 != 0 || C > 512 || V < 1 || V > kThreads || B < 1 ||
      smem_bytes(C) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const auto* lg = static_cast<const uint8_t*>(legal);
  const auto st = static_cast<cudaStream_t>(stream);
  if (V <= kThreads / 2)
    return launch_p<2>(f(h), f(pack), lg, o(probs), o(value), o(logits), B,
                       C, V, st);
  return launch_p<1>(f(h), f(pack), lg, o(probs), o(value), o(logits), B, C,
                     V, st);
}
