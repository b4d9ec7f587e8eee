// K3: MCTS backup, one thread per game.
//
// Replaces: alphazero_risk_tpu/mcts/search.py, the backup of
// `simulate_once`: the sign of each path edge (-1 where the player changes
// below it), the suffix product of those signs times the leaf value, and
// the scatter-add of `visit` and `wsum` along the path.
//
// Bound on an H100: latency.  A game touches depth x (three path entries
// read, one visit and one wsum cell read and written), some 24 bytes per
// edge, and its walk up the path is sequential.  The closed form of the
// JAX code needs [B, max_depth] sign, suffix and value tensors and two
// scatters; here one thread walks its path from the leaf up, carrying the
// running sign product in a register.
//
// No atomics: each game owns its rows of the tree, and a path never holds
// the same (node, action) pair twice (every step goes to a node created
// later), so no two writes of one launch meet.  Each wsum cell gets one
// float add of leaf_v * (+-1), as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kActions = 43;

__global__ void mcts_backup_kernel(const int* __restrict__ pn,
                                   const int* __restrict__ pa,
                                   const int* __restrict__ pp,
                                   const int* __restrict__ depth,
                                   const float* __restrict__ leaf_v,
                                   const int* __restrict__ leaf_p,
                                   int* __restrict__ visit,
                                   float* __restrict__ wsum, int B, int N,
                                   int D) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int dep = depth[b];
  const float v = leaf_v[b];
  int child_p = leaf_p[b];
  float sign = 1.0f;
  for (int d = dep - 1; d >= 0; --d) {
    const int p = pp[b * D + d];
    if (p != child_p) sign = -sign;
    const int64_t cell =
        (static_cast<int64_t>(b) * N + pn[b * D + d]) * kActions + pa[b * D + d];
    visit[cell] += 1;
    wsum[cell] = wsum[cell] + v * sign;
    child_p = p;
  }
}

}  // namespace

// pn, pa, pp [B, D] and depth [B] int32 from the descent; leaf_v [B] f32 and
// leaf_p [B] int32 the leaf's value and mover; visit [B, N, 43] int32 and
// wsum [B, N, 43] f32 are updated in place.  Returns cudaGetLastError().
extern "C" int az_mcts_backup(const void* pn, const void* pa, const void* pp,
                              const void* depth, const void* leaf_v,
                              const void* leaf_p, void* visit, void* wsum,
                              int B, int N, int D, void* stream) {
  const int threads = 128;
  mcts_backup_kernel<<<(B + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pn), static_cast<const int*>(pa),
      static_cast<const int*>(pp), static_cast<const int*>(depth),
      static_cast<const float*>(leaf_v), static_cast<const int*>(leaf_p),
      static_cast<int*>(visit), static_cast<float*>(wsum), B, N, D);
  return static_cast<int>(cudaGetLastError());
}
