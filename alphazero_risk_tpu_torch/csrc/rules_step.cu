// K7: the rules transition, one thread per game.
//
// Replaces: alphazero_risk_tpu/env/rules.py `step` (the phase machine over
// the 43-way action with dice) and `step_with_outcome` (the same with a
// forced battle outcome), with the graph walks they run (`connected_to`,
// `dfs_preorder_rank`); in the expand mode also the gather of the parent
// node out of the search tree and `game_status` / `legal_actions` of the
// child (mcts/search.py, the expansion of `simulate_once`).
//
// Bound on an H100: latency.  A game reads and writes about 1 KB of state
// (two [42] int32 rows and a few scalars) and does a few thousand integer
// operations, most of them serial inside the game (the BFS and the DFS of
// the fortify move).  The plain PyTorch version computes every phase
// branch for every game in some three hundred small launches, and its DFS
// asks the host whether to go on every four moves.  Here one thread runs
// the game's own branch to its end in registers and local memory, from one
// launch; the board tables sit in shared memory; blocks are one warp, so
// a batch of a few hundred games spreads over as many SMs as it can.
//
// Outputs go to fresh tensors (no in-place update): the caller keeps the
// input state (the actor records it).

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"

namespace {

__global__ void rules_step_kernel(rd::StateRef in, const int* __restrict__ node,
                                  int N, const int* __restrict__ action,
                                  const int* __restrict__ dice,
                                  const int* __restrict__ outcome,
                                  rd::StateRef out,
                                  const uint8_t* __restrict__ pc_in,
                                  const uint8_t* __restrict__ dc_in,
                                  uint8_t* __restrict__ pc_out,
                                  uint8_t* __restrict__ dc_out,
                                  int* __restrict__ status,
                                  uint8_t* __restrict__ legal,
                                  const rd::Tables* __restrict__ tables,
                                  int B, rd::Cfg cfg) {
  __shared__ rd::Tables t;
  rd::load_tables(t, tables);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  int n = 0;
  if (node != nullptr) n = node[b] < 0 ? 0 : node[b];
  const int64_t row = static_cast<int64_t>(b) * N + n;
  rd::St s;
  rd::load(s, in, row);
  rd::step(s, action[b], dice != nullptr ? dice + 5 * b : nullptr,
           outcome != nullptr ? outcome[b] : 0, outcome != nullptr, t, cfg);
  rd::store(s, out, b);
  if (pc_out != nullptr)
    for (int k = 0; k < 2 * rd::kLands; ++k)
      pc_out[b * 2 * rd::kLands + k] = pc_in[row * 2 * rd::kLands + k];
  if (dc_out != nullptr)
    for (int k = 0; k < rd::kLands; ++k)
      dc_out[b * rd::kLands + k] = dc_in[row * rd::kLands + k];
  if (status != nullptr) status[b] = rd::game_status(s, cfg);
  if (legal != nullptr) {
    const uint64_t m = rd::legal_actions(s, t, cfg);
    for (int k = 0; k < rd::kActions; ++k)
      legal[b * rd::kActions + k] = rd::has(m, k);
  }
}

}  // namespace

// in_*: the 12 first GameState fields of B games, or of a [B, N] tree's
// node states with node [B] int32 (node n = max(node[b], 0) of game b is
// read; null: N = 1, row b); pc_in/dc_in: their player_cards [.., 2, 42]
// and drawn_cards [.., 42] (bool).  Exactly one of dice [B, 5] and
// outcome [B] int32 is non-null: step or step_with_outcome.  out_*: the 12
// fields of the B results; pc_out/dc_out: their card masks, copied when
// non-null.  status [B] int32 and
// legal [B, 43] bool of the result, each when non-null.  tables: the packed
// rd::Tables.  flags: allow_yield | limit_reinf << 1 | limit_attack << 2 |
// fast_mob << 3 | exact_tb << 4.  Returns cudaGetLastError().
extern "C" int az_rules_step(
    void* in_owner, void* in_army, void* in_phase, void* in_round,
    void* in_cur, void* in_reinf, void* in_cards, void* in_sets,
    void* in_mob_from, void* in_mob_to, void* in_can_draw, void* in_attacks,
    const void* pc_in, const void* dc_in, const void* node, int N,
    const void* action, const void* dice, const void* outcome,
    void* out_owner, void* out_army, void* out_phase, void* out_round,
    void* out_cur, void* out_reinf, void* out_cards, void* out_sets,
    void* out_mob_from, void* out_mob_to, void* out_can_draw,
    void* out_attacks, void* pc_out, void* dc_out, void* status,
    void* legal, const void* tables, int B,
    int army_max, int min_move, int max_rounds, int flags, void* stream) {
  const int threads = 32;
  const rd::StateRef in = rd::state_ref(
      in_owner, in_army, in_phase, in_round, in_cur, in_reinf, in_cards,
      in_sets, in_mob_from, in_mob_to, in_can_draw, in_attacks);
  const rd::StateRef out = rd::state_ref(
      out_owner, out_army, out_phase, out_round, out_cur, out_reinf,
      out_cards, out_sets, out_mob_from, out_mob_to, out_can_draw,
      out_attacks);
  rules_step_kernel<<<(B + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int*>(node), N, static_cast<const int*>(action),
      static_cast<const int*>(dice), static_cast<const int*>(outcome), out,
      static_cast<const uint8_t*>(pc_in), static_cast<const uint8_t*>(dc_in),
      static_cast<uint8_t*>(pc_out), static_cast<uint8_t*>(dc_out),
      static_cast<int*>(status), static_cast<uint8_t*>(legal),
      static_cast<const rd::Tables*>(tables), B,
      rd::make_cfg(army_max, min_move, max_rounds, flags));
  return static_cast<int>(cudaGetLastError());
}
