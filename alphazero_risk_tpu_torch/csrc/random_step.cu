// K10: one RandomPlayer micro-decision, one thread per game.
//
// Replaces: alphazero_risk_tpu/agents/random_agent.py
// `random_step_recorded`: uniform legal choices by `masked_choice` in
// every phase (u[0] the target, u[1] the attack or fortify source), 1-unit
// reinforcements, the mobilization coin and the random fortify amount
// (u[2]), the battle on the step's dice; the recorded 43-way action.
//
// Bound on an H100: latency.  A game reads and writes about 1 KB (state,
// four uniforms, five dice) and walks its masks serially (one BFS for the
// fortify component).  The plain version computes all six phase branches
// for every game in some two hundred small launches; this kernel runs the
// game's own branch in one launch.  The float work is two float32 products
// (u * count, u * amount) truncated toward zero, as in PyTorch.

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"

namespace {

__global__ void random_step_kernel(rd::StateRef in,
                                   const float* __restrict__ u,
                                   const int* __restrict__ dice,
                                   rd::StateRef out, int* __restrict__ action,
                                   uint8_t* __restrict__ record,
                                   const rd::Tables* __restrict__ tables,
                                   int B, rd::Cfg cfg) {
  __shared__ rd::Tables t;
  rd::load_tables(t, tables);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  rd::St s;
  rd::load(s, in, b);
  int a = 0;
  bool rec = false;
  rd::random_step(s, u + 4 * b, dice + 5 * b, a, rec, t, cfg);
  rd::store(s, out, b);
  action[b] = a;
  record[b] = rec ? 1 : 0;
}

}  // namespace

// in_*/out_*: the 12 first GameState fields of B games; u [B, 4] f32;
// dice [B, 5] int32; action [B] int32 and record [B] bool out.  flags as
// in az_rules_step.  Returns cudaGetLastError().
extern "C" int az_random_step(
    void* in_owner, void* in_army, void* in_phase, void* in_round,
    void* in_cur, void* in_reinf, void* in_cards, void* in_sets,
    void* in_mob_from, void* in_mob_to, void* in_can_draw, void* in_attacks,
    const void* u, const void* dice, void* out_owner, void* out_army,
    void* out_phase, void* out_round, void* out_cur, void* out_reinf,
    void* out_cards, void* out_sets, void* out_mob_from, void* out_mob_to,
    void* out_can_draw, void* out_attacks, void* action, void* record,
    const void* tables, int B, int army_max, int min_move, int max_rounds,
    int flags, void* stream) {
  const int threads = 32;
  const rd::StateRef in = rd::state_ref(
      in_owner, in_army, in_phase, in_round, in_cur, in_reinf, in_cards,
      in_sets, in_mob_from, in_mob_to, in_can_draw, in_attacks);
  const rd::StateRef out = rd::state_ref(
      out_owner, out_army, out_phase, out_round, out_cur, out_reinf,
      out_cards, out_sets, out_mob_from, out_mob_to, out_can_draw,
      out_attacks);
  random_step_kernel<<<(B + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(u), static_cast<const int*>(dice), out,
      static_cast<int*>(action), static_cast<uint8_t*>(record),
      static_cast<const rd::Tables*>(tables), B,
      rd::make_cfg(army_max, min_move, max_rounds, flags));
  return static_cast<int>(cudaGetLastError());
}
