// K2: MCTS descent, one thread per game.
//
// Replaces: alphazero_risk_tpu/mcts/search.py, the descent `while_loop` of
// `simulate_once` together with `_puct_select` (Q, the constant noise blend,
// U, the legal mask, first-index argmax) and `_sample_outcome` (the attack
// source of `rules.best_attack_from_army`, `rules.battle_comparisons`, the
// OUTCOME_PROBS row and a Gumbel-max draw), plus the path bookkeeping.
//
// Bound on an H100: latency, not bytes or operations.  A game reads a few
// hundred bytes per depth step (the 43-entry rows of one node and the
// board row of its state) and does a few hundred flops; the loop over depth
// is sequential inside each game.  In eager PyTorch the same loop costs a
// host round trip per depth step (the `.any()` that ends it).  This kernel
// runs the whole descent of every game in one launch: the depth loop lives
// inside the thread, and each game stops on its own.
//
// Exactness: the float expressions are evaluated in the order of the plain
// version, and the file is compiled with --fmad=false, so each value
// rounds as in PyTorch's separate elementwise kernels.  log(p + 1e-30) of
// the outcome table comes precomputed from the caller, so both versions
// add the same logits to the same Gumbel noise.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kActions = 43;
constexpr int kLands = 42;
constexpr int kSkip = 42;
constexpr int kPhAttack = 3;

__global__ void mcts_descend_kernel(
    const int* __restrict__ root, const uint8_t* __restrict__ terminal,
    const int* __restrict__ player, const uint8_t* __restrict__ legal,
    const float* __restrict__ prior, const int* __restrict__ visit,
    const float* __restrict__ wsum, const int* __restrict__ children,
    const int* __restrict__ phase, const int* __restrict__ army,
    const int* __restrict__ owner, const float* __restrict__ gumbel,
    const float* __restrict__ logp, const int* __restrict__ nrank,
    float c_keep, float c_add, float cpuct, int B, int N, int D,
    int* __restrict__ pn, int* __restrict__ pa, int* __restrict__ pp,
    int* __restrict__ depth_out, int* __restrict__ cur_out,
    int* __restrict__ exp_n, int* __restrict__ exp_a,
    int* __restrict__ exp_o) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  for (int d = 0; d < D; ++d) {
    pn[b * D + d] = 0;
    pa[b * D + d] = 0;
    pp[b * D + d] = 0;
  }
  int cur = root[b];
  bool done = terminal[static_cast<int64_t>(b) * N + cur] != 0;
  int depth = 0;
  int en = -1, ea = 0, eo = 0;

  while (!done) {
    const int64_t node = static_cast<int64_t>(b) * N + cur;
    const int64_t row = node * kActions;

    // ---- PUCT select (_puct_select) ----
    int sum_n = 0;
    for (int k = 0; k < kActions; ++k) sum_n += visit[row + k];
    const float sq = sqrtf(1.0f + static_cast<float>(sum_n));
    float best = -CUDART_INF_F;
    int a = 0;
    for (int k = 0; k < kActions; ++k) {
      if (!legal[row + k]) continue;
      const int n = visit[row + k];
      const float q = wsum[row + k] / static_cast<float>(n > 1 ? n : 1);
      const float noised = c_keep * prior[row + k] + c_add;
      float t = noised * cpuct;
      t = t * sq;
      t = t / (1.0f + static_cast<float>(n));
      const float u = q + t;
      if (u > best) {
        best = u;
        a = k;
      }
    }

    // ---- chance outcome (_sample_outcome) ----
    int o = 0;
    if (phase[node] == kPhAttack && a != kSkip) {
      const int* arm = army + node * kLands;
      const int* own = owner + node * kLands;
      const int pl = player[node];
      const int li = a;
      // best_attack_from_army: first maximum of (army-1)*8 - rank over the
      // owned, armed neighbours of li; -1 elsewhere.
      int frm = 0;
      int best_s = -2;
      for (int j = 0; j < kLands; ++j) {
        const int r = nrank[li * kLands + j];
        const bool cand = r < 6 && own[j] == pl && arm[j] >= 2;
        const int sc = cand ? (arm[j] - 1) * 8 - r : -1;
        if (sc > best_s) {
          best_s = sc;
          frm = j;
        }
      }
      const int a0 = arm[frm];
      const int d0 = arm[li];
      const int att_n = a0 >= 4 ? 3 : (a0 == 3 ? 2 : 1);
      const int def_n = d0 >= 2 ? 2 : 1;
      const float* lp = logp + ((att_n - 1) * 2 + (def_n - 1)) * 3;
      const float* g = gumbel + (static_cast<int64_t>(depth) * B + b) * 3;
      float bo = lp[0] + g[0];
      for (int k = 1; k < 3; ++k) {
        const float v = lp[k] + g[k];
        if (v > bo) {
          bo = v;
          o = k;
        }
      }
    }

    // ---- record the edge, step down ----
    const int child = children[(row + a) * 3 + o];
    pn[b * D + depth] = cur;
    pa[b * D + depth] = a;
    pp[b * D + depth] = player[node];
    depth += 1;
    if (child < 0) {
      en = cur;
      ea = a;
      eo = o;
      done = true;
    } else {
      cur = child;
      done = terminal[static_cast<int64_t>(b) * N + child] != 0;
    }
    if (depth >= D) done = true;
  }
  depth_out[b] = depth;
  cur_out[b] = cur;
  exp_n[b] = en;
  exp_a[b] = ea;
  exp_o[b] = eo;
}

}  // namespace

// Tree arrays are the [B, N, ...] fields of search.Tree (bool as uint8),
// phase/army/owner the node states; gumbel [D, B, 3] f32 is this
// simulation's noise, logp [3, 2, 3] f32 = log(OUTCOME_PROBS + 1e-30),
// nrank [42, 42] int32 = NEIGHBOR_RANK.  Outputs: pn, pa, pp [B, D] and
// depth, cur, exp_n, exp_a, exp_o [B], all int32.  Returns
// cudaGetLastError().
extern "C" int az_mcts_descend(
    const void* root, const void* terminal, const void* player,
    const void* legal, const void* prior, const void* visit, const void* wsum,
    const void* children, const void* phase, const void* army,
    const void* owner, const void* gumbel, const void* logp, const void* nrank,
    float c_keep, float c_add, float cpuct, int B, int N, int D, void* pn,
    void* pa, void* pp, void* depth, void* cur, void* exp_n, void* exp_a,
    void* exp_o, void* stream) {
  const int threads = 128;
  mcts_descend_kernel<<<(B + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(root), static_cast<const uint8_t*>(terminal),
      static_cast<const int*>(player), static_cast<const uint8_t*>(legal),
      static_cast<const float*>(prior), static_cast<const int*>(visit),
      static_cast<const float*>(wsum), static_cast<const int*>(children),
      static_cast<const int*>(phase), static_cast<const int*>(army),
      static_cast<const int*>(owner), static_cast<const float*>(gumbel),
      static_cast<const float*>(logp), static_cast<const int*>(nrank), c_keep,
      c_add, cpuct, B, N, D, static_cast<int*>(pn), static_cast<int*>(pa),
      static_cast<int*>(pp), static_cast<int*>(depth), static_cast<int*>(cur),
      static_cast<int*>(exp_n), static_cast<int*>(exp_a),
      static_cast<int*>(exp_o));
  return static_cast<int>(cudaGetLastError());
}
