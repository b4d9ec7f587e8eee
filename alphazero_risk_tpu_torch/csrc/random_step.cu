// K10: one RandomPlayer micro-decision, one warp per game.
//
// Replaces: alphazero_risk_tpu/agents/random_agent.py
// `random_step_recorded`: uniform legal choices by `masked_choice` in
// every phase (u[0] the target, u[1] the attack or fortify source), 1-unit
// reinforcements, the mobilization coin and the random fortify amount
// (u[2]), the battle on the step's dice; the recorded 43-way action.
//
// Bound on an H100: latency.  A game reads and writes about 380 bytes of
// state and reads four uniforms and five dice; its work is a short chain
// of dependent choices.  The design (rules_warp.cuh, as K7 and K9):
//
//   - one warp per game, four games per block; lane k holds lands k and
//     k + 32, lanes 0-5 one continent each.  The state, the draws and the
//     lane's rows of the board load at once, coalesced; no table copy
//     into shared memory;
//   - every uniform choice is a collective (rw::masked_choice: a popcount
//     rank per lane and one min-reduction, not a walk over the set bits),
//     the attack source's candidates two ballots over the lanes' own
//     adjacency rows, the fortify's component one BFS whose frontier step
//     is one OR-reduction;
//   - the phase branch is warp-uniform, and only the game's own branch
//     runs (the plain version computes all six for every game).
//
// The float work is two float32 products (u * count, u * amount) truncated
// toward zero, as in PyTorch.  Full cards are the kernel's kCards
// instantiation: the hands and the drawn pile load by ballots into
// warp-uniform masks, the reinforcement's trade and the fortify's draw
// (u[3]) run on them, and the lanes write them back (126 bytes more read
// and written a game); the simple-cards instantiation keeps its code.
// Outputs go to fresh tensors (no in-place update).

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"
#include "rules_warp.cuh"

namespace {

constexpr int kWarps = 4;             // games per block

template <bool kCards>
__global__ void __launch_bounds__(kWarps * 32) random_step_kernel(
    rd::StateRef in, const float4* __restrict__ u,
    const int* __restrict__ dice, const uint8_t* __restrict__ pc_in,
    const uint8_t* __restrict__ dc_in, rd::StateRef out,
    int* __restrict__ action, uint8_t* __restrict__ record,
    uint8_t* __restrict__ pc_out, uint8_t* __restrict__ dc_out,
    const rd::Tables* __restrict__ tables, int B, rd::Cfg cfg) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;

  const float4 ub = u[b];
  const int die = lane < 5 ? dice[5 * b + lane] : 0;
  const rw::Board d = rw::load_board(tables, lane);
  rw::WSt s;
  rw::load(s, in, b, lane);
  if (kCards) rw::load_cards(s, pc_in, dc_in, b, lane);

  int a = 0;
  bool rec = false;
  rw::random_step<kCards>(s, ub.x, ub.y, ub.z, ub.w, die, a, rec, tables, d,
                          cfg, lane);
  rw::store(s, out, b, lane);
  if (kCards) rw::store_cards(s, pc_out, dc_out, b, lane);
  if (lane == 0) {
    action[b] = a;
    record[b] = rec ? 1 : 0;
  }
}

}  // namespace

// in_*/out_*: the 12 first GameState fields of B games; u [B, 4] f32 (16-
// byte aligned); dice [B, 5] int32; pc_in/dc_in and pc_out/dc_out:
// player_cards [B, 2, 42] and drawn_cards [B, 42] bool in and out (full
// cards; null under simple cards); action [B] int32 and record [B] bool
// out.  flags as in az_rules_step.  Returns cudaGetLastError().
extern "C" int az_random_step(
    void* in_owner, void* in_army, void* in_phase, void* in_round,
    void* in_cur, void* in_reinf, void* in_cards, void* in_sets,
    void* in_mob_from, void* in_mob_to, void* in_can_draw, void* in_attacks,
    const void* u, const void* dice, const void* pc_in, const void* dc_in,
    void* out_owner, void* out_army, void* out_phase, void* out_round,
    void* out_cur, void* out_reinf, void* out_cards, void* out_sets,
    void* out_mob_from, void* out_mob_to, void* out_can_draw,
    void* out_attacks, void* action, void* record, void* pc_out,
    void* dc_out, const void* tables, int B, int army_max, int min_move,
    int max_rounds, int flags, void* stream) {
  const rd::StateRef in = rd::state_ref(
      in_owner, in_army, in_phase, in_round, in_cur, in_reinf, in_cards,
      in_sets, in_mob_from, in_mob_to, in_can_draw, in_attacks);
  const rd::StateRef out = rd::state_ref(
      out_owner, out_army, out_phase, out_round, out_cur, out_reinf,
      out_cards, out_sets, out_mob_from, out_mob_to, out_can_draw,
      out_attacks);
  const rd::Cfg cfg = rd::make_cfg(army_max, min_move, max_rounds, flags);
  const auto kernel = cfg.full_cards ? &random_step_kernel<true>
                                     : &random_step_kernel<false>;
  kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float4*>(u), static_cast<const int*>(dice),
      static_cast<const uint8_t*>(pc_in), static_cast<const uint8_t*>(dc_in),
      out, static_cast<int*>(action), static_cast<uint8_t*>(record),
      static_cast<uint8_t*>(pc_out), static_cast<uint8_t*>(dc_out),
      static_cast<const rd::Tables*>(tables), B, cfg);
  return static_cast<int>(cudaGetLastError());
}
