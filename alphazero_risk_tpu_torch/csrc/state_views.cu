// K8: the state views, one thread per game.
//
// Replaces: alphazero_risk_tpu/env/rules.py `legal_actions` and
// `game_status`, and alphazero_risk_tpu/env/featurize.py `featurize` (the
// prologue of every network evaluation).  One read of each game's state
// gives any of the three outputs; a null pointer skips one.
//
// Bound on an H100: latency at the main path's batches.  A game reads
// about 400 bytes of state and writes 43 bytes of legality, 4 of status
// and 42 x F x 4 bytes of features (2.2 KB at F = 13): the features are
// the bytes, and at B = 64 they take under 0.05 us at 3.35 TB/s.  The
// plain version runs some forty small PyTorch launches for the features
// and twenty more for the legality; here the masks of the player are
// built once in registers and every output comes from them.
//
// Exactness: the float outputs are army / land_army_max, the two shares
// and the attack frequency, IEEE-rounded divisions as in PyTorch
// (__fdiv_rn); a 0 / 0 share is NaN, as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"

namespace {

__global__ void state_views_kernel(rd::StateRef in,
                                   const rd::Tables* __restrict__ tables,
                                   uint8_t* __restrict__ legal,
                                   int* __restrict__ status,
                                   float* __restrict__ feats, int B,
                                   rd::Cfg cfg, int version) {
  __shared__ rd::Tables t;
  rd::load_tables(t, tables);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  rd::St s;
  rd::load(s, in, b);
  if (legal != nullptr) {
    const uint64_t m = rd::legal_actions(s, t, cfg);
    for (int k = 0; k < rd::kActions; ++k)
      legal[b * rd::kActions + k] = rd::has(m, k);
  }
  if (status != nullptr) status[b] = rd::game_status(s, cfg);
  if (feats != nullptr) {
    const int F = version == 1 ? 12 : (version == 2 ? 13 : 14);
    rd::features(s, version, cfg, t,
                 feats + static_cast<int64_t>(b) * rd::kLands * F);
  }
}

}  // namespace

// The 12 first GameState fields of B games (reinf, cards and sets are not
// read and may be null); legal [B, 43] bool, status [B] int32 and feats
// [B, 42, F] f32 (F = 12, 13, 14 for feature version 1, 2, 3), each
// written when non-null.  flags as in az_rules_step.  Returns
// cudaGetLastError().
extern "C" int az_state_views(
    void* owner, void* army, void* phase, void* round, void* cur,
    void* mob_from, void* mob_to, void* can_draw, void* attacks,
    const void* tables, void* legal, void* status, void* feats, int B,
    int army_max, int max_rounds, int flags, int version, void* stream) {
  const int threads = 32;
  const rd::StateRef in = rd::state_ref(owner, army, phase, round, cur,
                                        nullptr, nullptr, nullptr, mob_from,
                                        mob_to, can_draw, attacks);
  state_views_kernel<<<(B + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const rd::Tables*>(tables),
      static_cast<uint8_t*>(legal), static_cast<int*>(status),
      static_cast<float*>(feats), B,
      rd::make_cfg(army_max, 0, max_rounds, flags), version);
  return static_cast<int>(cudaGetLastError());
}
