// K7: the rules transition, one warp per game.
//
// Replaces: alphazero_risk_tpu/env/rules.py `step` (the phase machine over
// the 43-way action with dice) and `step_with_outcome` (the same with a
// forced battle outcome), with the graph walks they run (`connected_to`,
// `dfs_preorder_rank`); in the expand mode also the gather of the parent
// node out of the search tree and `game_status` / `legal_actions` of the
// child (mcts/search.py, the expansion of `simulate_once`).
//
// Bound on an H100: latency.  A game reads and writes about 380 bytes
// (two [42] int32 rows and a few scalars): 16 ns at B = 64 at 3.35 TB/s.
// What takes the time is the dependent chain of one game, so the design
// shortens it and spreads the game over a warp (rules_warp.cuh):
//
//   - one warp per game, four games per block; lane k holds lands k and
//     k + 32.  The action, the five dice, the battle outcome, the 12 state
//     fields, the card masks of expand and the lane's adjacency rows are
//     all loaded at once, coalesced: one round trip (two in expand, whose
//     tree row depends on the node index);
//   - land masks are ballots, neighbors_any an OR-reduction, the army of a
//     land known at run time a shuffle from its owner lane, an argmax two
//     reductions; the phase machine's scalars are warp-uniform;
//   - the fortify tie-break DFS stays serial (it is a walk), but stops at
//     the first tied land it visits (the source the ranks would pick),
//     with the parent pointers in the owner lanes' registers and the next
//     land picked by one reduction;
//   - no table copy into shared memory: each lane reads the rows it needs
//     (L1/L2-resident after the first warps); NEIGHBOR_RANK's row of the
//     action's land is read up front, with the state;
//   - the card masks (84 + 42 bytes) and the 43 legal bytes of expand are
//     written by the lanes, coalesced; the scalars by lane 0.
//
// Full cards (the step mode only: step_with_outcome and expand have no
// card uniform) are the kernel's kCards instantiation: the hands and the
// drawn pile load by ballots into warp-uniform masks beside the state, the
// trade and the draw (the card uniform u_card, one float a game) run on
// them, and the lanes write them back; the simple-cards instantiation
// keeps its code.  A game then reads and writes 126 bytes more and reads 4.
//
// Outputs go to fresh tensors (no in-place update): the caller keeps the
// input state (the actor records it).

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"
#include "rules_warp.cuh"

namespace {

constexpr int kWarps = 4;             // games per block
constexpr int kPc = 2 * rd::kLands;   // player_cards bytes per game

template <bool kCards>
__global__ void __launch_bounds__(kWarps * 32) rules_step_kernel(
    rd::StateRef in, const int* __restrict__ node, int N,
    const int* __restrict__ action, const int* __restrict__ dice,
    const int* __restrict__ outcome, const float* __restrict__ u_card,
    rd::StateRef out,
    const uint8_t* __restrict__ pc_in, const uint8_t* __restrict__ dc_in,
    uint8_t* __restrict__ pc_out, uint8_t* __restrict__ dc_out,
    int* __restrict__ status, uint8_t* __restrict__ legal,
    const rd::Tables* __restrict__ tables, int B, rd::Cfg cfg) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;

  // ---- every load, at once ----
  int n = 0;
  if (node != nullptr) n = rd::imax(node[b], 0);
  const int64_t row = static_cast<int64_t>(b) * N + n;
  const int act = action[b];
  const int die = (dice != nullptr && lane < 5) ? dice[5 * b + lane] : 0;
  const int oc = outcome != nullptr ? outcome[b] : 0;
  const float uc = kCards && u_card != nullptr ? u_card[b] : 0.f;
  const rw::Board d = rw::load_board(tables, lane);
  const int8_t* nr = tables->nrank + rd::clamp_land(act) * rd::kLands;
  const int nr0 = nr[lane];
  const int nr1 = rw::two(lane) ? nr[lane + 32] : 0;
  rw::WSt s;
  rw::load(s, in, row, lane);
  if (kCards) rw::load_cards(s, pc_in, dc_in, row, lane);
  uint8_t pc[3] = {0, 0, 0}, dc[2] = {0, 0};
  if (!kCards && pc_out != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (lane + 32 * k < kPc) pc[k] = pc_in[row * kPc + lane + 32 * k];
  }
  if (!kCards && dc_out != nullptr) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (lane + 32 * k < rd::kLands)
        dc[k] = dc_in[row * rd::kLands + lane + 32 * k];
  }

  rw::step<kCards>(s, act, die, oc, outcome != nullptr, uc, nr0, nr1, tables,
                   d, cfg, lane);
  rw::store(s, out, b, lane);

  if (kCards) rw::store_cards(s, pc_out, dc_out, b, lane);
  if (!kCards && pc_out != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (lane + 32 * k < kPc)
        pc_out[static_cast<int64_t>(b) * kPc + lane + 32 * k] = pc[k];
  }
  if (!kCards && dc_out != nullptr) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (lane + 32 * k < rd::kLands)
        dc_out[static_cast<int64_t>(b) * rd::kLands + lane + 32 * k] = dc[k];
  }
  if (status != nullptr && lane == 0) status[b] = rw::game_status(s, cfg);
  if (legal != nullptr) {
    const uint64_t m = rd::legal_from(rw::player_masks(s, d, cfg, lane),
                                      s.phase, s.mob_from, s.mob_to, cfg);
    uint8_t* o = legal + static_cast<int64_t>(b) * rd::kActions;
    o[lane] = rd::has(m, lane);
    if (lane + 32 < rd::kActions) o[lane + 32] = rd::has(m, lane + 32);
  }
}

}  // namespace

// in_*: the 12 first GameState fields of B games, or of a [B, N] tree's
// node states with node [B] int32 (node n = max(node[b], 0) of game b is
// read; null: N = 1, row b); pc_in/dc_in: their player_cards [.., 2, 42]
// and drawn_cards [.., 42] (bool).  Exactly one of dice [B, 5] and
// outcome [B] int32 is non-null: step or step_with_outcome.  u_card [B]
// f32: the card uniforms of a full-cards step (null otherwise).  out_*:
// the 12 fields of the B results; pc_out/dc_out: their card masks (copied
// when non-null; under full cards written, and required).  status [B]
// int32 and legal [B, 43] bool of the result, each when non-null.  tables:
// the packed rd::Tables.  flags: allow_yield | limit_reinf << 1 |
// limit_attack << 2 | fast_mob << 3 | exact_tb << 4 | full_cards << 5.
// Returns cudaGetLastError().
extern "C" int az_rules_step(
    void* in_owner, void* in_army, void* in_phase, void* in_round,
    void* in_cur, void* in_reinf, void* in_cards, void* in_sets,
    void* in_mob_from, void* in_mob_to, void* in_can_draw, void* in_attacks,
    const void* pc_in, const void* dc_in, const void* node, int N,
    const void* action, const void* dice, const void* outcome,
    const void* u_card, void* out_owner, void* out_army, void* out_phase,
    void* out_round, void* out_cur, void* out_reinf, void* out_cards,
    void* out_sets,
    void* out_mob_from, void* out_mob_to, void* out_can_draw,
    void* out_attacks, void* pc_out, void* dc_out, void* status,
    void* legal, const void* tables, int B,
    int army_max, int min_move, int max_rounds, int flags, void* stream) {
  const rd::StateRef in = rd::state_ref(
      in_owner, in_army, in_phase, in_round, in_cur, in_reinf, in_cards,
      in_sets, in_mob_from, in_mob_to, in_can_draw, in_attacks);
  const rd::StateRef out = rd::state_ref(
      out_owner, out_army, out_phase, out_round, out_cur, out_reinf,
      out_cards, out_sets, out_mob_from, out_mob_to, out_can_draw,
      out_attacks);
  const rd::Cfg cfg = rd::make_cfg(army_max, min_move, max_rounds, flags);
  const auto kernel = cfg.full_cards ? &rules_step_kernel<true>
                                     : &rules_step_kernel<false>;
  kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int*>(node), N, static_cast<const int*>(action),
      static_cast<const int*>(dice), static_cast<const int*>(outcome),
      static_cast<const float*>(u_card), out,
      static_cast<const uint8_t*>(pc_in), static_cast<const uint8_t*>(dc_in),
      static_cast<uint8_t*>(pc_out), static_cast<uint8_t*>(dc_out),
      static_cast<int*>(status), static_cast<uint8_t*>(legal),
      static_cast<const rd::Tables*>(tables), B, cfg);
  return static_cast<int>(cudaGetLastError());
}
