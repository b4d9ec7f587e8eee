// K5: the policy and value heads with the legal-masked softmax.
//
// Replaces: alphazero_risk_tpu/models/fast_infer.py, `_heads` (two 1x1
// convs with bias and ReLU, the (position, channel) flatten, dense 84->43,
// dense 42->V with ReLU, dense V->1, tanh) and the epilogue of the eval
// functions, softmax(where(legal, logits, -inf)).
//
// Bound on an H100: bytes.  At the main path's shape (B=64, C=256) the
// trunk output slab is 64*42*256*4 = 2.75 MB, 0.8 us at 3.35 TB/s; the
// head weights (about 60 KB) and the arithmetic (under 3 MFLOP) are small
// beside it.
//
// Design: one 256-thread block per game reads its [42, C] slab once.  Each
// warp takes board cells in turn; its lanes stride over the channels
// (coalesced reads) and reduce three dot products per cell by shuffles:
// the two policy channels and the value channel.  The 84 + 42 head
// activations and the V hidden units stay in shared memory; one warp then
// reduces the value and another normalises the 43 logits.  Everything is
// float32.  A row with no legal action gives NaN probabilities, as the
// plain version does (exp(-inf - -inf)).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCells = 42;
constexpr int kActions = 43;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__global__ void __launch_bounds__(kThreads)
heads_eval_kernel(const float* __restrict__ h, const float* __restrict__ pol_w,
                  const float* __restrict__ pol_b,
                  const float* __restrict__ pol_dense_w,
                  const float* __restrict__ pol_dense_b,
                  const float* __restrict__ val_w,
                  const float* __restrict__ val_b,
                  const float* __restrict__ val_d1_w,
                  const float* __restrict__ val_d1_b,
                  const float* __restrict__ val_d2_w,
                  const float* __restrict__ val_d2_b,
                  const uint8_t* __restrict__ legal, float* __restrict__ probs,
                  float* __restrict__ value, float* __restrict__ logits,
                  int C, int V) {
  extern __shared__ float smem[];
  float* p_s = smem;                    // [84] policy head, (cell, channel)
  float* v_s = p_s + 2 * kCells;        // [42] value head
  float* l_s = v_s + kCells;            // [43] logits
  float* hid = l_s + kActions + 3;      // [V] value hidden layer

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* hb = h + static_cast<int64_t>(b) * kCells * C;

  // 1x1 convs 256->2 and 256->1 with bias and ReLU.
  for (int cell = warp; cell < kCells; cell += kWarps) {
    const float* row = hb + cell * C;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float x = row[c];
      s0 = fmaf(x, pol_w[2 * c], s0);
      s1 = fmaf(x, pol_w[2 * c + 1], s1);
      s2 = fmaf(x, val_w[c], s2);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      p_s[2 * cell] = fmaxf(s0 + pol_b[0], 0.0f);
      p_s[2 * cell + 1] = fmaxf(s1 + pol_b[1], 0.0f);
      v_s[cell] = fmaxf(s2 + val_b[0], 0.0f);
    }
  }
  __syncthreads();

  // dense 42->V with ReLU (all threads), dense 84->43 (threads 0..42).
  for (int j = tid; j < V; j += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < kCells; ++i) s = fmaf(v_s[i], val_d1_w[i * V + j], s);
    hid[j] = fmaxf(s + val_d1_b[j], 0.0f);
  }
  if (tid < kActions) {
    float s = 0.0f;
    for (int i = 0; i < 2 * kCells; ++i)
      s = fmaf(p_s[i], pol_dense_w[i * kActions + tid], s);
    s += pol_dense_b[tid];
    l_s[tid] = s;
    logits[static_cast<int64_t>(b) * kActions + tid] = s;
  }
  __syncthreads();

  if (warp == 0) {
    // dense V->1 and tanh
    float s = 0.0f;
    for (int j = lane; j < V; j += 32) s = fmaf(hid[j], val_d2_w[j], s);
    s = warp_sum(s);
    if (lane == 0) value[b] = tanhf(s + val_d2_b[0]);
  } else if (warp == 1) {
    // softmax over the legal actions: lanes hold actions lane and lane+32
    const uint8_t* lg = legal + static_cast<int64_t>(b) * kActions;
    const int a1 = lane + 32;
    const float x0 = lg[lane] ? l_s[lane] : -CUDART_INF_F;
    const float x1 =
        (a1 < kActions && lg[a1]) ? l_s[a1] : -CUDART_INF_F;
    const float m = warp_max(fmaxf(x0, x1));
    const float e0 = expf(x0 - m);
    const float e1 = (a1 < kActions) ? expf(x1 - m) : 0.0f;
    const float tot = warp_sum(e0 + e1);
    float* pb = probs + static_cast<int64_t>(b) * kActions;
    pb[lane] = e0 / tot;
    if (a1 < kActions) pb[a1] = e1 / tot;
  }
}

}  // namespace

// h [B, 42, C] f32; pol_w [C, 2], pol_b [2], pol_dense_w [84, 43],
// pol_dense_b [43], val_w [C, 1], val_b [1], val_d1_w [42, V], val_d1_b [V],
// val_d2_w [V, 1], val_d2_b [1], all f32; legal [B, 43] bool (one byte
// each).  Outputs probs [B, 43], value [B], logits [B, 43] f32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int az_heads_eval(const void* h, const void* pol_w,
                             const void* pol_b, const void* pol_dense_w,
                             const void* pol_dense_b, const void* val_w,
                             const void* val_b, const void* val_d1_w,
                             const void* val_d1_b, const void* val_d2_w,
                             const void* val_d2_b, const void* legal,
                             void* probs, void* value, void* logits, int B,
                             int C, int V, void* stream) {
  const size_t shmem = (2 * kCells + kCells + kActions + 3 + V) * sizeof(float);
  if (shmem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  heads_eval_kernel<<<B, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      f(h), f(pol_w), f(pol_b), f(pol_dense_w), f(pol_dense_b), f(val_w),
      f(val_b), f(val_d1_w), f(val_d1_b), f(val_d2_w), f(val_d2_b),
      static_cast<const uint8_t*>(legal), static_cast<float*>(probs),
      static_cast<float*>(value), static_cast<float*>(logits), C, V);
  return static_cast<int>(cudaGetLastError());
}
