// K2: MCTS descent, one warp per game.
//
// Replaces: alphazero_risk_tpu/mcts/search.py, the descent `while_loop` of
// `simulate_once` together with `_puct_select` (Q, the constant noise blend,
// U, the legal mask, first-index argmax) and `_sample_outcome` (the attack
// source of `rules.best_attack_from_army`, `rules.battle_comparisons`, the
// OUTCOME_PROBS row and a Gumbel-max draw), plus the path bookkeeping.
//
// Bound on an H100: latency, not bytes or operations.  A game reads about
// 1.5 KB per depth step (the 43-entry rows of one node, its children row
// and the board row of its state) and does a few hundred flops; the walk
// over depth is sequential inside each game.  So the design is about the
// dependent round trips to memory of one step:
//
//   - one warp walks one game, four games per block; lane k holds actions
//     k and k + 32 and lands k and k + 32;
//   - every load of a step depends only on the node `cur`, and they are
//     issued together: the node's legal, visit, wsum and prior rows, its
//     children row (all 129 links, so the child needs no second trip), its
//     phase, mover, army and owner rows, its terminal flag, and the step's
//     three Gumbel values.  A step is one round trip to L2, then register
//     and shuffle work.  The terminal flag of a child is read at the top of
//     the next step, with that node's rows (reading a terminal node's rows
//     is in bounds and harmless);
//   - sum_n is an integer __reduce_add_sync; the PUCT argmax and the
//     attack source are two warp reductions each, the largest key
//     (__reduce_max_sync; U as an int of the same order) and then the
//     lowest index holding it (__reduce_min_sync).  Illegal actions enter
//     as -inf (and so does a NaN, which the sequential strict `>` scan
//     skips), so index 0 stands when nothing is legal: exactly the
//     first-index argmax of the plain version and of `jnp.argmax`;
//   - NEIGHBOR_RANK (int8, 1,764 bytes) and the outcome logits sit in
//     shared memory, loaded once per block;
//   - lane 0 writes the step's path entries; after the walk the lanes zero
//     the rest of the game's path rows, coalesced.
//
// Exactness: each lane evaluates U for its actions with the plain
// expression in the plain order, and the file is compiled with
// --fmad=false, so each value rounds as in PyTorch's separate elementwise
// kernels.  log(p + 1e-30) of the outcome table comes precomputed from the
// caller, so both versions add the same logits to the same Gumbel noise.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kActions = 43;
constexpr int kLands = 42;
constexpr int kSkip = 42;
constexpr int kPhAttack = 3;
constexpr int kWarps = 4;             // games per block
constexpr unsigned kFull = 0xffffffffu;

// The index of the warp's largest key, the lowest index on a tie: two
// warp reductions.  Each lane offers its own best (key, index).
__device__ __forceinline__ int warp_argmax(int key, int index) {
  const int top = __reduce_max_sync(kFull, key);
  return static_cast<int>(__reduce_min_sync(
      kFull, key == top ? static_cast<unsigned>(index) : 64u));
}

// An int whose order is the float order of u (u not NaN; -0 as +0).
__device__ __forceinline__ int order_key(float u) {
  const int k = __float_as_int(u + 0.0f);
  return k ^ ((k >> 31) & 0x7fffffff);
}

// U of one action, in the order of the plain version; -inf when illegal
// or NaN.
__device__ __forceinline__ float puct(bool legal, int n, float w, float p,
                                      float sq, float c_keep, float c_add,
                                      float cpuct) {
  const float q = w / static_cast<float>(n > 1 ? n : 1);
  const float noised = c_keep * p + c_add;
  float t = noised * cpuct;
  t = t * sq;
  t = t / (1.0f + static_cast<float>(n));
  const float u = q + t;
  return (legal && u > -CUDART_INF_F) ? u : -CUDART_INF_F;
}

__global__ void __launch_bounds__(kWarps * 32) mcts_descend_kernel(
    const int* __restrict__ root, const uint8_t* __restrict__ terminal,
    const int* __restrict__ player, const uint8_t* __restrict__ legal,
    const float* __restrict__ prior, const int* __restrict__ visit,
    const float* __restrict__ wsum, const int* __restrict__ children,
    const int* __restrict__ phase, const int* __restrict__ army,
    const int* __restrict__ owner, const float* __restrict__ gumbel,
    const float* __restrict__ logp, const int8_t* __restrict__ nrank,
    float c_keep, float c_add, float cpuct, int B, int N, int D,
    int* __restrict__ paths, int* __restrict__ ends) {
  __shared__ __align__(16) int8_t s_nrank[kLands * kLands];
  __shared__ float s_logp[18];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int cur = b < B ? root[b] : 0;      // in flight across the table copy
  {
    const int* from = reinterpret_cast<const int*>(nrank);
    int* to = reinterpret_cast<int*>(s_nrank);
    for (int i = threadIdx.x; i < kLands * kLands / 4; i += blockDim.x)
      to[i] = from[i];
    if (threadIdx.x < 18) s_logp[threadIdx.x] = logp[threadIdx.x];
    __syncthreads();
  }
  if (b >= B) return;

  const bool act1 = lane + 32 < kActions;   // lane holds action lane + 32
  const bool land1 = lane + 32 < kLands;    // ... and land lane + 32
  int* pn = paths + static_cast<int64_t>(b) * D;
  int* pa = pn + static_cast<int64_t>(B) * D;
  int* pp = pa + static_cast<int64_t>(B) * D;

  int depth = 0;
  int en = -1, ea = 0, eo = 0;
  while (depth < D) {
    // ---- every load of the step, all depending on `cur` alone ----
    const int64_t node = static_cast<int64_t>(b) * N + cur;
    const int64_t row = node * kActions;
    const bool term = terminal[node] != 0;
    const int ph = phase[node];
    const int pl = player[node];
    const bool l0 = legal[row + lane] != 0;
    const bool l1 = act1 && legal[row + lane + 32] != 0;
    const int n0 = visit[row + lane];
    const int n1 = act1 ? visit[row + lane + 32] : 0;
    const float w0 = wsum[row + lane];
    const float w1 = act1 ? wsum[row + lane + 32] : 0.0f;
    const float p0 = prior[row + lane];
    const float p1 = act1 ? prior[row + lane + 32] : 0.0f;
    const int* ch = children + row * 3;
    const int c0 = ch[lane], c1 = ch[lane + 32], c2 = ch[lane + 64];
    const int c3 = ch[lane + 96];
    const int c4 = lane == 0 ? ch[128] : -1;
    const int64_t land = node * kLands;
    const int ar0 = army[land + lane];
    const int ar1 = land1 ? army[land + lane + 32] : 0;
    const int ow0 = owner[land + lane];
    const int ow1 = land1 ? owner[land + lane + 32] : -1;
    const float* g = gumbel + (static_cast<int64_t>(depth) * B + b) * 3;
    const float g0 = g[0], g1 = g[1], g2 = g[2];
    if (term) break;

    // ---- PUCT select (_puct_select) ----
    const int sum_n = __reduce_add_sync(kFull, n0 + n1);
    const float sq = sqrtf(1.0f + static_cast<float>(sum_n));
    float best = puct(l0, n0, w0, p0, sq, c_keep, c_add, cpuct);
    int a = lane;
    if (act1) {
      const float u1 = puct(l1, n1, w1, p1, sq, c_keep, c_add, cpuct);
      if (u1 > best) {
        best = u1;
        a = lane + 32;
      }
    }
    a = warp_argmax(order_key(best), a);

    // ---- chance outcome (_sample_outcome) ----
    int o = 0;
    if (ph == kPhAttack && a != kSkip) {
      // best_attack_from_army: first maximum of (army-1)*8 - rank over the
      // owned, armed neighbours of land a; -1 elsewhere.
      const int8_t* rk = s_nrank + a * kLands;
      const int r0 = rk[lane];
      int sc = (r0 < 6 && ow0 == pl && ar0 >= 2) ? (ar0 - 1) * 8 - r0 : -1;
      int frm = lane;
      if (land1) {
        const int r1 = rk[lane + 32];
        const int s1 =
            (r1 < 6 && ow1 == pl && ar1 >= 2) ? (ar1 - 1) * 8 - r1 : -1;
        if (s1 > sc) {
          sc = s1;
          frm = lane + 32;
        }
      }
      frm = warp_argmax(sc, frm);
      const int a0 = __shfl_sync(kFull, frm < 32 ? ar0 : ar1, frm & 31);
      const int d0 = __shfl_sync(kFull, a < 32 ? ar0 : ar1, a & 31);
      const int att_n = a0 >= 4 ? 3 : (a0 == 3 ? 2 : 1);
      const int def_n = d0 >= 2 ? 2 : 1;
      const float* lp = s_logp + ((att_n - 1) * 2 + (def_n - 1)) * 3;
      float bo = lp[0] + g0;
      const float v1 = lp[1] + g1;
      if (v1 > bo) {
        bo = v1;
        o = 1;
      }
      if (lp[2] + g2 > bo) o = 2;
    }

    // ---- record the edge, step down ----
    const int k = a * 3 + o;
    const int cv = k < 32 ? c0 : (k < 64 ? c1 : (k < 96 ? c2 : (k < 128 ? c3
                                                                        : c4)));
    const int child = __shfl_sync(kFull, cv, k & 31);
    if (lane == 0) {
      pn[depth] = cur;
      pa[depth] = a;
      pp[depth] = pl;
    }
    depth += 1;
    if (child < 0) {
      en = cur;
      ea = a;
      eo = o;
      break;
    }
    cur = child;
  }
  for (int d = depth + lane; d < D; d += 32) {
    pn[d] = 0;
    pa[d] = 0;
    pp[d] = 0;
  }
  if (lane < 5)
    ends[lane * B + b] =
        lane == 0 ? depth
                  : (lane == 1 ? cur : (lane == 2 ? en : (lane == 3 ? ea : eo)));
}

}  // namespace

// Tree arrays are the [B, N, ...] fields of search.Tree (bool as uint8),
// phase/army/owner the node states; gumbel [D, B, 3] f32 is this
// simulation's noise, logp [3, 2, 3] f32 = log(OUTCOME_PROBS + 1e-30),
// nrank [42, 42] int8 = NEIGHBOR_RANK (4-byte aligned).  Outputs, int32:
// paths [3, B, D] (pn, pa, pp) and ends [5, B] (depth, cur, exp_n, exp_a,
// exp_o).  Returns cudaGetLastError().
extern "C" int az_mcts_descend(
    const void* root, const void* terminal, const void* player,
    const void* legal, const void* prior, const void* visit, const void* wsum,
    const void* children, const void* phase, const void* army,
    const void* owner, const void* gumbel, const void* logp, const void* nrank,
    float c_keep, float c_add, float cpuct, int B, int N, int D, void* paths,
    void* ends, void* stream) {
  mcts_descend_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(root), static_cast<const uint8_t*>(terminal),
      static_cast<const int*>(player), static_cast<const uint8_t*>(legal),
      static_cast<const float*>(prior), static_cast<const int*>(visit),
      static_cast<const float*>(wsum), static_cast<const int*>(children),
      static_cast<const int*>(phase), static_cast<const int*>(army),
      static_cast<const int*>(owner), static_cast<const float*>(gumbel),
      static_cast<const float*>(logp), static_cast<const int8_t*>(nrank),
      c_keep, c_add, cpuct, B, N, D, static_cast<int*>(paths),
      static_cast<int*>(ends));
  return static_cast<int>(cudaGetLastError());
}
