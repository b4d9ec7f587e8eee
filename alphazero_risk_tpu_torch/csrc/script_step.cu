// K9: the ScriptPlayer's micro-decision with its carry, one warp per game.
//
// Replaces: alphazero_risk_tpu/agents/script_agent.py
// `script_step_recorded` (with `_select_target` and `_select_from`): the
// pin of the attack pair at turn start with the card trade, the
// reinforcement toward the pinned source, the attack with the pin kept or
// re-derived (mode_b), the mobilization, and the fortify from the largest
// interior stack of the best owned component toward the most exposed
// border land; the recorded 43-way action and its sample mask.  The loops
// around it (the opponent fast-forward, `play_match`) run in
// agent_steps.cu, k steps per launch.
//
// Bound on an H100: latency.  A game reads and writes about 380 bytes of
// state and one uniform and five dice; its work is a chain of dependent
// decisions.  The design (rules_warp.cuh, as K7):
//
//   - one warp per game, four games per block; lane k holds lands k and
//     k + 32, lanes 0-5 one continent each.  The state, the carry and the
//     lane's rows of the board and of SCRIPT_LAND_RANK load at once,
//     coalesced; no table copy into shared memory;
//   - every decision is a collective: the continent pick one
//     min-reduction over (score, continent), the target one over
//     (SCRIPT_LAND_RANK, land), the source an argmax (two reductions), the
//     setup-neutral pool a few ballots and OR-reductions, each fortify
//     component one BFS whose frontier step is one OR-reduction and its
//     interior stack one max-reduction.
//
// Full cards are the kernel's kCards instantiation: the hands and the
// drawn pile load by ballots into warp-uniform masks, the pin's trade and
// the fortify's draw (u[3]) run on them, and the lanes write them back
// (126 bytes more read and written a game); the simple-cards
// instantiation keeps its code.
//
// Outputs go to fresh tensors (no in-place update).

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"
#include "rules_warp.cuh"

namespace {

constexpr int kWarps = 4;             // games per block

template <bool kCards>
__global__ void __launch_bounds__(kWarps * 32) script_step_kernel(
    rd::StateRef in, rw::CarryRef cin, const uint8_t* __restrict__ reset,
    const float* __restrict__ u, const int* __restrict__ dice,
    const uint8_t* __restrict__ pc_in, const uint8_t* __restrict__ dc_in,
    rd::StateRef out, rw::CarryRef cout, int* __restrict__ action,
    uint8_t* __restrict__ record, uint8_t* __restrict__ pc_out,
    uint8_t* __restrict__ dc_out, const rd::Tables* __restrict__ tables,
    int B, rd::Cfg cfg) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;

  const bool rst = reset[b] != 0;
  const float u0 = u[4 * b];
  const float u3 = kCards ? u[4 * b + 3] : 0.f;
  const int die = lane < 5 ? dice[5 * b + lane] : 0;
  rw::Carry c = rw::load_carry(cin, b);
  const rw::Board d = rw::load_board(tables, lane);
  const rw::ScriptBoard sb = rw::load_script_board(tables, lane);
  rw::WSt s;
  rw::load(s, in, b, lane);
  if (kCards) rw::load_cards(s, pc_in, dc_in, b, lane);

  int a = 0;
  bool rec = false;
  rw::script_step<kCards>(s, c, rst, u0, u3, die, a, rec, tables, d, sb, cfg,
                          lane);
  rw::store(s, out, b, lane);
  if (kCards) rw::store_cards(s, pc_out, dc_out, b, lane);
  if (lane == 0) {
    rw::store_carry(c, cout, b);
    action[b] = a;
    record[b] = rec ? 1 : 0;
  }
}

}  // namespace

// in_*/out_*: the 12 first GameState fields of B games; carry (attack_to,
// attack_from int32, mode_b bool) in and out; reset [B] bool; u [B, 4]
// f32; dice [B, 5] int32; pc_in/dc_in and pc_out/dc_out: player_cards
// [B, 2, 42] and drawn_cards [B, 42] bool in and out (full cards; null
// under simple cards); action [B] int32 and record [B] bool out.  flags
// as in az_rules_step.  Returns cudaGetLastError().
extern "C" int az_script_step(
    void* in_owner, void* in_army, void* in_phase, void* in_round,
    void* in_cur, void* in_reinf, void* in_cards, void* in_sets,
    void* in_mob_from, void* in_mob_to, void* in_can_draw, void* in_attacks,
    void* c_to, void* c_from, void* c_mode, const void* reset, const void* u,
    const void* dice, const void* pc_in, const void* dc_in, void* out_owner,
    void* out_army, void* out_phase, void* out_round, void* out_cur,
    void* out_reinf, void* out_cards, void* out_sets, void* out_mob_from,
    void* out_mob_to, void* out_can_draw, void* out_attacks, void* o_to,
    void* o_from, void* o_mode, void* action, void* record, void* pc_out,
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
  const auto kernel = cfg.full_cards ? &script_step_kernel<true>
                                     : &script_step_kernel<false>;
  kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      in, rw::carry_ref(c_to, c_from, c_mode),
      static_cast<const uint8_t*>(reset), static_cast<const float*>(u),
      static_cast<const int*>(dice), static_cast<const uint8_t*>(pc_in),
      static_cast<const uint8_t*>(dc_in), out,
      rw::carry_ref(o_to, o_from, o_mode), static_cast<int*>(action),
      static_cast<uint8_t*>(record), static_cast<uint8_t*>(pc_out),
      static_cast<uint8_t*>(dc_out), static_cast<const rd::Tables*>(tables),
      B, cfg);
  return static_cast<int>(cudaGetLastError());
}
