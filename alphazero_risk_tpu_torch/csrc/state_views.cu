// K8: the state views, one warp per game.
//
// Replaces: alphazero_risk_tpu/env/rules.py `legal_actions` and
// `game_status`, and alphazero_risk_tpu/env/featurize.py `featurize` (the
// prologue of every network evaluation).  One read of each game's state
// gives any of the three outputs; a null pointer skips one.
//
// Bound on an H100: latency at the main path's batches.  A game reads
// about 400 bytes of state and writes 43 bytes of legality, 4 of status
// and 42 x F x 4 bytes of features (2.2 KB at F = 13): the features are
// the bytes, and at B = 64 they take under 0.05 us at 3.35 TB/s.  So the
// design cuts the dependent steps of one game and spreads its work:
//
//   - one warp per game, four games per block; lane k holds lands k and
//     k + 32.  The board rows, the state's scalars and the table rows a
//     lane needs (its lands' adjacency masks; lanes 0-5 one continent
//     each) are all loaded at once, coalesced, in one round trip;
//   - the ownership and army masks are two __ballot_sync each;
//     neighbors_any is an OR of the adjacency rows of the set lands, one
//     or two per lane, reduced by __reduce_or_sync; the army sums and the
//     continent bonuses are __reduce_add_sync;
//   - each lane puts its lands' F features into the warp's row in shared
//     memory (a stride of F words: no bank conflict for F = 13), and the
//     game's contiguous 42 x F floats go out from there, consecutive lanes
//     on consecutive addresses (computing each output float from its flat
//     index, land i / F and plane i % F, on the way out was the slower
//     design on an H100, 16-byte stores or not); the legality bytes are
//     written by lanes, the status by lane 0.
//
// Exactness: the mask logic is integer; the float outputs are army /
// land_army_max, the two shares and the attack frequency, IEEE-rounded
// divisions as in PyTorch (__fdiv_rn) of the same operands as the plain
// version, so the features agree bit for bit, a 0 / 0 share (NaN)
// included.  The warp helpers (ballots, neighbors_any, the
// reinforcement) are rules_warp.cuh's, shared with K7; legality and status
// are rules_dev.cuh's `legal_from` and `game_status` on the masks.

#include <cstdint>
#include <cuda_runtime.h>

#include "rules_dev.cuh"
#include "rules_warp.cuh"

namespace {

constexpr int kWarps = 4;             // games per block
constexpr int kMaxF = 14;

template <int V>
__global__ void __launch_bounds__(kWarps * 32) state_views_kernel(
    rd::StateRef in, const rd::Tables* __restrict__ tables,
    uint8_t* __restrict__ legal, int* __restrict__ status,
    float* __restrict__ feats, int B, rd::Cfg cfg) {
  constexpr int F = V == 1 ? 12 : (V == 2 ? 13 : 14);
  constexpr int kScalars = V + 2;     // broadcast planes before the phase
  __shared__ float s_feat[kWarps][rd::kLands * kMaxF];  // each game's row
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= B) return;

  // ---- every load, at once ----
  const bool two = lane + 32 < rd::kLands;
  const int64_t land = static_cast<int64_t>(b) * rd::kLands;
  const int ow0 = in.owner[land + lane];
  const int ow1 = two ? in.owner[land + lane + 32] : -1;
  const int ar0 = in.army[land + lane];
  const int ar1 = two ? in.army[land + lane + 32] : 0;
  const int phase = in.phase[b];
  const int cur = in.cur[b];
  const rw::Board d = rw::load_board(tables, lane);
  int round = 0, mob_from = -1, mob_to = -1, attacks = 0;
  bool can_draw = false;
  if (status != nullptr || V == 3) round = in.round[b];
  if (legal != nullptr) {
    mob_from = in.mob_from[b];
    mob_to = in.mob_to[b];
  }
  if (feats != nullptr) {
    attacks = in.attacks[b];
    can_draw = in.can_draw[b] != 0;
  }

  const uint64_t owned = rw::ballot(ow0 == cur, ow1 == cur);
  const uint64_t enemy = rw::ballot(ow0 == 1 - cur, ow1 == 1 - cur);

  if (status != nullptr && lane == 0)
    status[b] = rd::game_status(cur == 0 ? owned : enemy,
                                cur == 0 ? enemy : owned, round, cfg);

  if (legal != nullptr) {
    rd::Masks m;
    m.owned = owned;
    m.enemy = enemy;
    m.neutral = rw::ballot(ow0 == rd::kNeutral, ow1 == rd::kNeutral);
    m.owa = owned & rw::ballot(ar0 >= 2, two && ar1 >= 2);
    m.full =
        owned & rw::ballot(ar0 >= cfg.army_max, two && ar1 >= cfg.army_max);
    m.attack = 0;
    m.attack_wa = ~owned & rw::nb_any(m.owa, d, lane);
    m.enemy_attack = ~enemy & rw::nb_any(enemy, d, lane);
    m.neutral_attack = rw::nb_any(m.neutral, d, lane) & ~m.neutral;
    const uint64_t mask = rd::legal_from(m, phase, mob_from, mob_to, cfg);
    uint8_t* out = legal + static_cast<int64_t>(b) * rd::kActions;
    out[lane] = rd::has(mask, lane);
    if (lane + 32 < rd::kActions) out[lane + 32] = rd::has(mask, lane + 32);
  }

  if (feats == nullptr) return;
  // ---- features (rd::features, cell-major, planes in the JAX order) ----
  const float ref = static_cast<float>(rw::reinforcement(owned, d));
  const float eref = static_cast<float>(rw::reinforcement(enemy, d));
  const int ta = __reduce_add_sync(
      rw::kFull, (rd::has(owned, lane) ? ar0 : 0) +
                 (rd::has(owned, lane + 32) ? ar1 : 0));
  const int eta = __reduce_add_sync(
      rw::kFull, (rd::has(enemy, lane) ? ar0 : 0) +
                 (rd::has(enemy, lane + 32) ? ar1 : 0));
  // the broadcast planes: (round share V3, army share V2+) reinforcement
  // share, attack frequency, can-draw; then the phase one-hot
  const float fa = static_cast<float>(ta), fe = static_cast<float>(eta);
  const float af = rd::fdiv(static_cast<float>(attacks), 8.0f);
  const float all5[5] = {
      V == 3 ? rd::fdiv(static_cast<float>(round),
                        static_cast<float>(cfg.max_rounds))
             : 0.0f,
      V >= 2 ? rd::fdiv(fa, fa + fe) : 0.0f, rd::fdiv(ref, ref + eref),
      af > 1.0f ? 1.0f : af, can_draw ? 1.0f : 0.0f};
  const float army_max = static_cast<float>(cfg.army_max);
  float* row = s_feat[w];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j >= rd::kLands) break;
    const float a = rd::fdiv(static_cast<float>(h ? ar1 : ar0), army_max);
    const bool mine = rd::has(owned, j), theirs = rd::has(enemy, j);
    float* o = row + j * F;
    o[0] = mine ? a : 0.0f;
    o[1] = theirs ? a : 0.0f;
    o[2] = (!mine && !theirs) ? a : 0.0f;
#pragma unroll
    for (int k = 0; k < kScalars; ++k) o[3 + k] = all5[k + 3 - V];
#pragma unroll
    for (int k = 0; k < 6; ++k) o[3 + kScalars + k] = phase == k ? 1.0f : 0.0f;
  }
  __syncwarp();
  constexpr int kTotal = rd::kLands * F;
  float* out = feats + static_cast<int64_t>(b) * kTotal;
  for (int i = lane; i < kTotal; i += 32) out[i] = row[i];
}

}  // namespace

// The 12 first GameState fields of B games (reinf, cards and sets are not
// read and may be null); legal [B, 43] bool, status [B] int32 and feats
// [B, 42, F] f32 (F = 12, 13, 14 for feature version 1, 2, 3), each
// written when non-null.  flags as in az_rules_step.
// Returns cudaGetLastError().
extern "C" int az_state_views(
    void* owner, void* army, void* phase, void* round, void* cur,
    void* mob_from, void* mob_to, void* can_draw, void* attacks,
    const void* tables, void* legal, void* status, void* feats, int B,
    int army_max, int max_rounds, int flags, int version, void* stream) {
  const rd::StateRef in = rd::state_ref(owner, army, phase, round, cur,
                                        nullptr, nullptr, nullptr, mob_from,
                                        mob_to, can_draw, attacks);
  const rd::Cfg cfg = rd::make_cfg(army_max, 0, max_rounds, flags);
  const dim3 grid((B + kWarps - 1) / kWarps), block(kWarps * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const rd::Tables*>(tables);
  auto* l = static_cast<uint8_t*>(legal);
  auto* st = static_cast<int*>(status);
  auto* f = static_cast<float*>(feats);
  if (version == 1)
    state_views_kernel<1><<<grid, block, 0, s>>>(in, t, l, st, f, B, cfg);
  else if (version == 2)
    state_views_kernel<2><<<grid, block, 0, s>>>(in, t, l, st, f, B, cfg);
  else
    state_views_kernel<3><<<grid, block, 0, s>>>(in, t, l, st, f, B, cfg);
  return static_cast<int>(cudaGetLastError());
}
