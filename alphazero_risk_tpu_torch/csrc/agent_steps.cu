// The multi-step entry of K9 and K10: up to k ScriptPlayer or RandomPlayer
// micro-decisions per game in one launch, the kind of the seat to move
// picking the agent.
//
// Replaces: the loops of the JAX package around the agents' steps, for
// any pair of ScriptPlayer, RandomPlayer and AlphaZero seats: the opponent
// fast-forward of alphazero_risk_tpu/training/actor.py:203-222 (`ff_cond`
// / `ff_body`, a `lax.while_loop`) and the `while_loop` of `play_match`
// in alphazero_risk_tpu/agents/driver.py:56-88.
//
// Bound on an H100: latency.  A game reads and writes its state (about
// 380 bytes) and carry once, and per step one row of draws (16 bytes of
// uniforms, 20 of dice); its steps are a chain of dependent decisions.
// The design:
//
//   - one warp per game, four games per block, on rules_warp.cuh (as K7,
//     K9 and K10); the game and the ScriptPlayer's carry stay in
//     registers across its steps and are written back once, with the
//     step count;
//   - game b steps from iteration j with row j of the draws while its
//     stop predicate (the game ended, or an AlphaZero seat is to move) is
//     false on the state before the step, as the JAX loops test it.  The
//     mover's seat kind picks rw::script_step or rw::random_step; `reset`
//     (mover != previous mover) and the previous mover follow every step,
//     and the carry changes only on a ScriptPlayer step, as the JAX body's
//     select of the mover's carry leaves it;
//   - the draws of iteration j (one 16-byte load of the four uniforms,
//     lanes 0-4 one die each) are loaded while iteration j - 1 runs;
//   - the kernel is instantiated for the set of agent kinds the seats
//     hold, so a launch carries the code of the agents it runs only (on
//     an H100 the one body for both agents runs two ScriptPlayers 11%
//     slower);
//   - the draws, the previous movers and the tables come in as
//     `__restrict__` kernel parameters, which take the read-only load
//     path (without it two ScriptPlayers run 10% slower on an H100);
//   - full cards are a third template switch: the hands and the drawn
//     pile stay in registers as three warp-uniform masks across the
//     steps, loaded by ballots and written back once (126 bytes more a
//     game), the trades and draws (u[3] of the float4) run on them; the
//     simple-cards instantiations keep their code.
//
// The host then syncs once per block of k iterations, not once per
// iteration.  Outputs go to fresh tensors (no in-place update).

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"
#include "rules_warp.cuh"

namespace {

constexpr int kWarps = 4;             // games per block
// Seat kinds, two bits a seat: the JAX package's opponent codes.
constexpr int kAlphaZero = 0, kScript = 1, kRandom = 2;

template <bool kHasScript, bool kHasRandom, bool kCards>
__global__ void __launch_bounds__(kWarps * 32) agent_steps_kernel(
    rd::StateRef in, rw::CarryRef cin, const int* __restrict__ prev_in,
    const float4* __restrict__ u, const int* __restrict__ dice,
    const uint8_t* __restrict__ pc_in, const uint8_t* __restrict__ dc_in,
    int k, int kinds, rd::StateRef out, rw::CarryRef cout,
    int* __restrict__ prev_out, int* __restrict__ n_out,
    uint8_t* __restrict__ pc_out, uint8_t* __restrict__ dc_out,
    const rd::Tables* __restrict__ tables, int B, rd::Cfg cfg) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;

  int prev = prev_in[b];
  rw::Carry c = rw::load_carry(cin, b);
  const rw::Board d = rw::load_board(tables, lane);
  rw::ScriptBoard sb{};
  if (kHasScript) sb = rw::load_script_board(tables, lane);
  rw::WSt s;
  rw::load(s, in, b, lane);
  if (kCards) rw::load_cards(s, pc_in, dc_in, b, lane);

  const int64_t stride = B;
  float4 ur = k > 0 ? u[b] : make_float4(0.f, 0.f, 0.f, 0.f);
  int die = k > 0 && lane < 5 ? dice[5 * b + lane] : 0;
  int j = 0;
  for (; j < k; ++j) {
    const int kind = (kinds >> (2 * s.cur)) & 3;
    if (rw::game_status(s, cfg) != rd::kNotEnded || kind == kAlphaZero)
      break;
    float4 u_next = make_float4(0.f, 0.f, 0.f, 0.f);
    int die_next = 0;
    if (j + 1 < k) {
      const int64_t row = (j + 1) * stride + b;
      u_next = u[row];
      if (lane < 5) die_next = dice[5 * row + lane];
    }
    const bool rst = s.cur != prev;
    prev = s.cur;
    int act;
    bool rec;
    if (kHasScript && (!kHasRandom || kind == kScript))
      rw::script_step<kCards>(s, c, rst, ur.x, ur.w, die, act, rec, tables,
                              d, sb, cfg, lane);
    else if (kHasRandom)
      rw::random_step<kCards>(s, ur.x, ur.y, ur.z, ur.w, die, act, rec,
                              tables, d, cfg, lane);
    ur = u_next;
    die = die_next;
  }
  rw::store(s, out, b, lane);
  if (kCards) rw::store_cards(s, pc_out, dc_out, b, lane);
  if (lane == 0) {
    rw::store_carry(c, cout, b);
    prev_out[b] = prev;
    n_out[b] = j;
  }
}

}  // namespace

// in_*/out_*: the 12 first GameState fields of B games; the ScriptPlayer's
// carry (attack_to, attack_from int32, mode_b bool) in and out; prev [B]
// int32: the mover of each game's last step (in and out); u [k, B, 4] f32
// (16-byte aligned) and dice [k, B, 5] int32: row j is iteration j's
// draws; pc_in/dc_in and pc_out/dc_out: player_cards [B, 2, 42] and
// drawn_cards [B, 42] bool in and out (full cards; null under simple
// cards); kinds: bits 2p and 2p + 1 the kind of seat p (0 AlphaZero: the
// game stops when it is to move; 1 ScriptPlayer; 2 RandomPlayer).  n [B]
// int32 out: the steps game b took.  flags as in az_rules_step.  Returns
// cudaGetLastError().
extern "C" int az_agent_steps(
    void* in_owner, void* in_army, void* in_phase, void* in_round,
    void* in_cur, void* in_reinf, void* in_cards, void* in_sets,
    void* in_mob_from, void* in_mob_to, void* in_can_draw, void* in_attacks,
    void* c_to, void* c_from, void* c_mode, const void* prev_in,
    const void* u, const void* dice, const void* pc_in, const void* dc_in,
    int k, int kinds, void* out_owner, void* out_army, void* out_phase,
    void* out_round, void* out_cur, void* out_reinf, void* out_cards,
    void* out_sets, void* out_mob_from, void* out_mob_to, void* out_can_draw,
    void* out_attacks, void* o_to, void* o_from, void* o_mode,
    void* prev_out, void* n_out, void* pc_out, void* dc_out,
    const void* tables, int B, int army_max, int min_move, int max_rounds,
    int flags, void* stream) {
  const int k0 = kinds & 3, k1 = (kinds >> 2) & 3;
  const bool has_script = k0 == kScript || k1 == kScript;
  const bool has_random = k0 == kRandom || k1 == kRandom;
  const rd::Cfg cfg = rd::make_cfg(army_max, min_move, max_rounds, flags);
  const auto kernel =
      cfg.full_cards
          ? (has_script && has_random ? &agent_steps_kernel<true, true, true>
             : has_random             ? &agent_steps_kernel<false, true, true>
                                      : &agent_steps_kernel<true, false, true>)
          : (has_script && has_random
                 ? &agent_steps_kernel<true, true, false>
             : has_random ? &agent_steps_kernel<false, true, false>
                          : &agent_steps_kernel<true, false, false>);
  kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      rd::state_ref(in_owner, in_army, in_phase, in_round, in_cur, in_reinf,
                    in_cards, in_sets, in_mob_from, in_mob_to, in_can_draw,
                    in_attacks),
      rw::carry_ref(c_to, c_from, c_mode), static_cast<const int*>(prev_in),
      static_cast<const float4*>(u), static_cast<const int*>(dice),
      static_cast<const uint8_t*>(pc_in), static_cast<const uint8_t*>(dc_in),
      k, kinds,
      rd::state_ref(out_owner, out_army, out_phase, out_round, out_cur,
                    out_reinf, out_cards, out_sets, out_mob_from, out_mob_to,
                    out_can_draw, out_attacks),
      rw::carry_ref(o_to, o_from, o_mode), static_cast<int*>(prev_out),
      static_cast<int*>(n_out), static_cast<uint8_t*>(pc_out),
      static_cast<uint8_t*>(dc_out), static_cast<const rd::Tables*>(tables),
      B, cfg);
  return static_cast<int>(cudaGetLastError());
}
