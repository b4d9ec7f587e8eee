// The Risk rules' shared layouts and per-game helpers of the rules kernels
// K7 (rules_step.cu), K8 (state_views.cu), K9 (script_step.cu), K10
// (random_step.cu) and their multi-step entry (agent_steps.cu), which run
// one game per warp (rules_warp.cuh) and call the helpers here that take
// masks and scalars.
//
// The 42-land sets are uint64_t masks (bit j = land j), the scalars plain
// ints.  The functions are the per-game form of the plain PyTorch code in
// env/rules.py.  Every output is an integer, a bool or a float32 computed
// in the order of the plain version, so each agrees with it bit for bit
// (the sources are built with --fmad=false).
//
// The board tables come from env/topology.py: the wrapper packs them into
// one device buffer (rules.kernel_tables) laid out as `Tables`, which the
// lanes read in place.
//
// The same text compiles as host C++ (RD_FN is then `static inline`), so
// the per-game functions can be exercised without a card.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define RD_FN __device__ __forceinline__
#define RD_HD __host__ __device__ inline
#else
#define RD_FN static inline
#define RD_HD static inline
#endif

namespace rd {

constexpr int kLands = 42;
constexpr int kActions = 43;
constexpr int kSkip = 42;
constexpr int kNeutral = 2;
constexpr int kConts = 6;
constexpr int kNotEnded = -1;
constexpr int kDraw = -2;
constexpr uint64_t kAll = (1ull << kLands) - 1;
constexpr uint64_t kSkipBit = 1ull << kSkip;

enum Phase {
  kSetup = 0,
  kSetupNeutral = 1,
  kReinforcement = 2,
  kAttack = 3,
  kMobilization = 4,
  kFortify = 5,
};

// Board tables, packed by rules.kernel_tables (little-endian, no padding).
struct Tables {
  uint64_t adj[kLands];             // adjacency rows as masks
  uint64_t cont[kConts];            // continent membership masks
  uint64_t card_type[3];            // infantry, horse, siege card masks
  int32_t cont_size[kConts];
  int32_t cont_bonus[kConts];
  int32_t card_gain[64];            // CARD_SET_GAIN
  int32_t cont_tie_rank[kConts];    // CONTINENT_TIE_RANK
  int8_t nrank[kLands * kLands];    // NEIGHBOR_RANK
  int8_t land_rank[kConts * kLands];  // SCRIPT_LAND_RANK
};
static_assert(sizeof(Tables) == 2752, "Tables must match kernel_tables()");

// The rule switches of Config that the kernels read.
struct Cfg {
  int army_max;       // land_army_max
  int min_move;       // min_unit_move
  int max_rounds;     // max_game_rounds
  bool allow_yield;
  bool limit_reinf;   // limit_reinforcement_moves
  bool limit_attack;  // limit_attack_moves
  bool fast_mob;      // fast_attack_mobilization
  bool exact_tb;      // exact_fortify_tiebreak
  bool full_cards;    // not simple_cards
};

// Called by the host launchers: the flags of rules.kernel_flags.
RD_HD Cfg make_cfg(int army_max, int min_move, int max_rounds, int flags) {
  Cfg c;
  c.army_max = army_max;
  c.min_move = min_move;
  c.max_rounds = max_rounds;
  c.allow_yield = flags & 1;
  c.limit_reinf = flags & 2;
  c.limit_attack = flags & 4;
  c.fast_mob = flags & 8;
  c.exact_tb = flags & 16;
  c.full_cards = flags & 32;
  return c;
}

// Pointers to the first 12 fields of a GameState (bool fields as uint8).
struct StateRef {
  int* owner;      // [.., 42]
  int* army;       // [.., 42]
  int* phase;
  int* round;
  int* cur;
  int* reinf;
  int* cards;      // [.., 2]
  int* sets;
  int* mob_from;
  int* mob_to;
  uint8_t* can_draw;
  int* attacks;
};

// The launchers' StateRef from the 12 field pointers, in GameState order.
RD_HD StateRef state_ref(void* owner, void* army, void* phase, void* round,
                         void* cur, void* reinf, void* cards, void* sets,
                         void* mob_from, void* mob_to, void* can_draw,
                         void* attacks) {
  return {static_cast<int*>(owner),    static_cast<int*>(army),
          static_cast<int*>(phase),    static_cast<int*>(round),
          static_cast<int*>(cur),      static_cast<int*>(reinf),
          static_cast<int*>(cards),    static_cast<int*>(sets),
          static_cast<int*>(mob_from), static_cast<int*>(mob_to),
          static_cast<uint8_t*>(can_draw), static_cast<int*>(attacks)};
}

// ---------------------------------------------------------------- bits

RD_FN int popc(uint64_t m) {
#ifdef __CUDA_ARCH__
  return __popcll(m);
#else
  return __builtin_popcountll(m);
#endif
}

// Index of the lowest set bit of a nonzero mask.
RD_FN int low(uint64_t m) {
#ifdef __CUDA_ARCH__
  return __ffsll(static_cast<long long>(m)) - 1;
#else
  return __builtin_ctzll(m);
#endif
}

RD_FN bool has(uint64_t m, int i) { return (m >> i) & 1ull; }
RD_FN uint64_t bit(int i) { return 1ull << i; }

// rules.first_set_bit: lowest set index, 0 for an empty mask.
RD_FN int first_set_bit(uint64_t m) { return m ? low(m) : 0; }

RD_FN int clamp_land(int x) {
  return x < 0 ? 0 : (x > kLands - 1 ? kLands - 1 : x);
}
RD_FN int imin(int a, int b) { return a < b ? a : b; }
RD_FN int imax(int a, int b) { return a > b ? a : b; }

// Python's a // 2 (floor) for any int.
RD_FN int floordiv2(int a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }

RD_FN float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

RD_FN float fdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// rules.PlayerMasks.
struct Masks {
  uint64_t owned, enemy, neutral, owa, full, attack, attack_wa, enemy_attack,
      neutral_attack;
};

// rules.game_status from the two players' lands and the round: -1
// running, -2 draw, else the winner.
RD_FN int game_status(uint64_t own0, uint64_t own1, int round,
                      const Cfg& c) {
  const int p0 = popc(own0);
  const int p1 = popc(own1);
  int st = kNotEnded;
  if (round > c.max_rounds) st = p0 > p1 ? 0 : (p0 < p1 ? 1 : kDraw);
  if (c.allow_yield) {
    if (p1 >= 30) st = 1;
    if (p0 >= 30) st = 0;
  }
  if (p1 == 0) st = 0;
  if (p0 == 0) st = 1;
  return st;
}

// rules.legal_actions as a 43-bit mask (bit 42 = skip), from the mover's
// masks (PlayerMasks.attack is not read).
RD_FN uint64_t legal_from(const Masks& m, int phase, int mob_from,
                          int mob_to, const Cfg& c) {
  switch (phase) {
    case kSetup:
    case kReinforcement: {
      const uint64_t base = m.owned & ~m.full;
      uint64_t lands = base;
      if (c.limit_reinf) {
        const uint64_t border = base & (m.enemy_attack | m.neutral_attack);
        lands = border ? border : base;
      }
      return base ? lands : kSkipBit;
    }
    case kSetupNeutral:
      return m.neutral;
    case kAttack:
      if (c.limit_attack) return m.attack_wa ? m.attack_wa : kSkipBit;
      return m.attack_wa | kSkipBit;
    case kMobilization: {
      uint64_t r = 0;
      if (mob_from >= 0 && mob_from < kLands) r |= bit(mob_from);
      if (mob_to >= 0 && mob_to < kLands) r |= bit(mob_to);
      return r;
    }
    default:
      return (c.limit_reinf ? m.owned & m.enemy_attack : m.owned) | kSkipBit;
  }
}

// ---------------------------------------------------------------- engine

// rules._move_amount.
RD_FN int move_amount(int budget, const Cfg& c) {
  if (c.fast_mob) {
    const int half = floordiv2(budget);
    return half < c.min_move ? imin(budget, c.min_move) : half;
  }
  return imin(budget, c.min_move);
}

// rules.battle: dice[0..2] attack, dice[3..4] defend, each sorted
// descending with zeros for the unused dice.
RD_FN void battle(int af, int at, const int* dice, int& a_new, int& d_new,
                  int& units) {
  const int att_n = af >= 4 ? 3 : (af == 3 ? 2 : 1);
  const int def_n = at >= 2 ? 2 : 1;
  int a0 = dice[0], a1 = att_n >= 2 ? dice[1] : 0;
  int a2 = att_n >= 3 ? dice[2] : 0;
  int tmp;
  if (a1 > a0) { tmp = a0; a0 = a1; a1 = tmp; }
  if (a2 > a1) { tmp = a1; a1 = a2; a2 = tmp; }
  if (a1 > a0) { tmp = a0; a0 = a1; a1 = tmp; }
  int d0 = dice[3], d1 = def_n >= 2 ? dice[4] : 0;
  if (d1 > d0) { tmp = d0; d0 = d1; d1 = tmp; }
  const bool win1 = a0 > d0;
  const bool second = att_n >= 2 && def_n == 2;
  const bool win2 = second && a1 > d1;
  const bool lose2 = second && !(a1 > d1);
  d_new = at - (win1 ? 1 : 0) - (win2 ? 1 : 0);
  a_new = af - (win1 ? 0 : 1) - (lose2 ? 1 : 0);
  units = att_n - (win1 ? 0 : 1) - (lose2 ? 1 : 0);
}

// rules.battle_with_outcome: outcome = attacker losses in [0, ncomp].
RD_FN void battle_with_outcome(int af, int at, int outcome, int& a_new,
                               int& d_new, int& units) {
  const int att_n = af >= 4 ? 3 : (af == 3 ? 2 : 1);
  const int def_n = at >= 2 ? 2 : 1;
  const bool two = att_n >= 2 && def_n == 2;
  const bool w1 = outcome == 0 || (outcome == 1 && two);
  const bool w2 = outcome == 0;
  const int d_loss = (w1 ? 1 : 0) + (w2 && two ? 1 : 0);
  const int a_loss = (w1 ? 0 : 1) + (!w2 && two ? 1 : 0);
  a_new = af - a_loss;
  d_new = at - d_loss;
  units = att_n - a_loss;
}

}  // namespace rd
