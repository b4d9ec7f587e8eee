// K9: one ScriptPlayer micro-decision with its carry, one thread per game.
//
// Replaces: alphazero_risk_tpu/agents/script_agent.py
// `script_step_recorded` (with `_select_target` and `_select_from`): the
// pin of the attack pair at turn start with the card trade, the
// reinforcement toward the pinned source, the attack with the pin kept or
// re-derived (mode_b), the mobilization, and the fortify from the largest
// interior stack of the best owned component (a per-component max over
// `component_labels`) toward the most exposed border land; the recorded
// 43-way action and its sample mask.
//
// Bound on an H100: latency.  A game reads and writes about 1 KB (state,
// carry, four uniforms and five dice) and its work is serial: continent
// scans, neighbour scans and one BFS per owned component.  The plain
// version computes all six phase branches for every game in some four
// hundred small launches (its component labels by six [42, 42] matrix
// squarings); this kernel runs only the game's own branch, on masks, in
// one launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"

namespace {

__global__ void script_step_kernel(
    rd::StateRef in, const int* __restrict__ c_to,
    const int* __restrict__ c_from, const uint8_t* __restrict__ c_mode,
    const uint8_t* __restrict__ reset, const float* __restrict__ u,
    const int* __restrict__ dice, rd::StateRef out, int* __restrict__ o_to,
    int* __restrict__ o_from, uint8_t* __restrict__ o_mode,
    int* __restrict__ action, uint8_t* __restrict__ record,
    const rd::Tables* __restrict__ tables, int B, rd::Cfg cfg) {
  __shared__ rd::Tables t;
  rd::load_tables(t, tables);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  rd::St s;
  rd::load(s, in, b);
  rd::Carry carry{c_to[b], c_from[b], c_mode[b] != 0};
  int a = 0;
  bool rec = false;
  rd::script_step(s, carry, reset[b] != 0, u + 4 * b, dice + 5 * b, a, rec,
                  t, cfg);
  rd::store(s, out, b);
  o_to[b] = carry.to;
  o_from[b] = carry.from;
  o_mode[b] = carry.mode_b ? 1 : 0;
  action[b] = a;
  record[b] = rec ? 1 : 0;
}

}  // namespace

// in_*/out_*: the 12 first GameState fields of B games; carry (attack_to,
// attack_from int32, mode_b bool) in and out; reset [B] bool; u [B, 4]
// f32; dice [B, 5] int32; action [B] int32 and record [B] bool out.
// flags as in az_rules_step.  Returns cudaGetLastError().
extern "C" int az_script_step(
    void* in_owner, void* in_army, void* in_phase, void* in_round,
    void* in_cur, void* in_reinf, void* in_cards, void* in_sets,
    void* in_mob_from, void* in_mob_to, void* in_can_draw, void* in_attacks,
    const void* c_to, const void* c_from, const void* c_mode,
    const void* reset, const void* u, const void* dice, void* out_owner,
    void* out_army, void* out_phase, void* out_round, void* out_cur,
    void* out_reinf, void* out_cards, void* out_sets, void* out_mob_from,
    void* out_mob_to, void* out_can_draw, void* out_attacks, void* o_to,
    void* o_from, void* o_mode, void* action, void* record,
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
  script_step_kernel<<<(B + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int*>(c_to), static_cast<const int*>(c_from),
      static_cast<const uint8_t*>(c_mode), static_cast<const uint8_t*>(reset),
      static_cast<const float*>(u), static_cast<const int*>(dice), out,
      static_cast<int*>(o_to), static_cast<int*>(o_from),
      static_cast<uint8_t*>(o_mode), static_cast<int*>(action),
      static_cast<uint8_t*>(record), static_cast<const rd::Tables*>(tables), B,
      rd::make_cfg(army_max, min_move, max_rounds, flags));
  return static_cast<int>(cudaGetLastError());
}
