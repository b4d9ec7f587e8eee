// K3: MCTS backup, one warp per game.
//
// Replaces: alphazero_risk_tpu/mcts/search.py:264-285, the backup of
// `simulate_once`: the sign of each path edge (-1 where the mover changes
// below it), the suffix product of those signs times the leaf value, and
// the scatter-adds of `visit` and `wsum` along the path.
//
// Bound on an H100: latency.  A game reads three ints an edge of its path
// and its depth, leaf value and mover, and reads and writes one visit and
// one wsum cell an edge: some 28 bytes an edge, a few KB a launch.  What
// costs is the number of dependent round trips to memory, so the design
// spreads the path's edges over the lanes:
//
//   - one warp per game, four games per block; lane l holds edges l and
//     l + 32 (max_depth <= 64).  Every lane loads its edges' node, action
//     and mover, and the game's depth, leaf value and mover, in one round
//     (each field of the path is [B, D], so the loads coalesce; entries
//     past the depth are loaded and not used);
//   - the child mover of edge d is the mover of edge d + 1, one
//     __shfl_down_sync (lane 31 takes edge 32 from lane 0's second half),
//     or the leaf's mover at d = depth - 1.  Edge d flips when its mover
//     differs from its child's; two ballots give the 64-bit flip mask F,
//     and edge d's sign is (-1)^popc(F >> d): the suffix product of the
//     JAX code, as an integer parity;
//   - each live lane then updates its own visit and wsum cells in one
//     round (a read, an add, a write), so a path of depth d costs two
//     dependent round trips, not 2d.
//
// No atomics: each game owns its rows of the tree, and a path never holds
// the same (node, action) pair twice (every step goes to a node created
// later), so no two writes of one launch meet.  Each wsum cell gets one
// float add of +-leaf_v (a negation is exact), the single add of the plain
// version's scatter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kActions = 43;
constexpr int kWarps = 4;             // games per block
constexpr unsigned kFull = 0xffffffffu;
// Slots of the tree's pointer pack (mcts.search._k6_pack): K6's leaf
// outputs, then the tree's visit and wsum.
constexpr int kLeafV = 24, kLeafP = 25, kVisit = 26, kWsum = 27;

__device__ __forceinline__ void add_edge(int* __restrict__ visit,
                                         float* __restrict__ wsum,
                                         int64_t row, int node, int action,
                                         float v) {
  const int64_t cell = (row + node) * kActions + action;
  visit[cell] += 1;
  wsum[cell] = wsum[cell] + v;
}

__global__ void __launch_bounds__(kWarps * 32) mcts_backup_kernel(
    const int* __restrict__ paths, const int* __restrict__ depth,
    const float* __restrict__ leaf_v, const int* __restrict__ leaf_p,
    int* __restrict__ visit, float* __restrict__ wsum, int B, int N, int D) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;

  // ---- one round of loads ----
  const int64_t plane = static_cast<int64_t>(B) * D;
  const int* pn = paths + static_cast<int64_t>(b) * D;
  const int* pa = pn + plane;
  const int* pp = pa + plane;
  const int hi = lane + 32;
  const bool in0 = lane < D, in1 = hi < D;
  const int dep = depth[b];
  const float v = leaf_v[b];
  const int lp = leaf_p[b];
  const int n0 = in0 ? pn[lane] : 0, n1 = in1 ? pn[hi] : 0;
  const int a0 = in0 ? pa[lane] : 0, a1 = in1 ? pa[hi] : 0;
  const int p0 = in0 ? pp[lane] : 0, p1 = in1 ? pp[hi] : 0;

  // ---- signs: the child mover of each edge, one ballot per half ----
  const int next0 = __shfl_down_sync(kFull, p0, 1);   // edge lane + 1
  const int next1 = __shfl_down_sync(kFull, p1, 1);   // edge lane + 33
  const int seam = __shfl_sync(kFull, p1, 0);         // edge 32
  const bool live0 = in0 && lane < dep, live1 = in1 && hi < dep;
  // edge 63 is live only as the last edge of a 64-edge path
  const int c0 = lane == dep - 1 ? lp : (lane == 31 ? seam : next0);
  const int c1 = hi == dep - 1 ? lp : next1;
  const uint64_t flips =
      static_cast<uint64_t>(__ballot_sync(kFull, live0 && p0 != c0)) |
      (static_cast<uint64_t>(__ballot_sync(kFull, live1 && p1 != c1)) << 32);

  // ---- one round of updates ----
  const int64_t row = static_cast<int64_t>(b) * N;
  if (live0)
    add_edge(visit, wsum, row, n0, a0, (__popcll(flips >> lane) & 1) ? -v : v);
  if (live1)
    add_edge(visit, wsum, row, n1, a1, (__popcll(flips >> hi) & 1) ? -v : v);
}

}  // namespace

// tree: the tree's pointer pack (leaf_v [B] f32 and leaf_p [B] int32 at
// slots 24 and 25, visit [B, N, 43] int32 and wsum [B, N, 43] f32, updated
// in place, at 26 and 27); paths [3, B, D] int32: the descent's path
// nodes, actions and movers (D <= 64); depth [B] int32; leaf_v and leaf_p
// the leaf's value and mover, or null for the pack's.  Returns
// cudaGetLastError().
extern "C" int az_mcts_backup(void* const* tree, const void* paths,
                              const void* depth, const void* leaf_v,
                              const void* leaf_p, int B, int N, int D,
                              void* stream) {
  mcts_backup_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(paths), static_cast<const int*>(depth),
      static_cast<const float*>(leaf_v != nullptr ? leaf_v : tree[kLeafV]),
      static_cast<const int*>(leaf_p != nullptr ? leaf_p : tree[kLeafP]),
      static_cast<int*>(tree[kVisit]), static_cast<float*>(tree[kWsum]), B,
      N, D);
  return static_cast<int>(cudaGetLastError());
}
