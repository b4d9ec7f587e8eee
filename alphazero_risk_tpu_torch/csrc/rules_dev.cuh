// The Risk rules for one game held by one thread, run by K10
// (random_step.cu); K7 (rules_step.cu), K8 (state_views.cu) and K9
// (script_step.cu) run one game per warp (rules_warp.cuh) and reuse the
// helpers here that take masks and scalars.
//
// The 42-land sets are uint64_t masks (bit j = land j), the armies an
// int[42] array, the scalars plain ints.  The functions are the per-game
// form of the plain PyTorch code in env/rules.py and
// agents/random_agent.py, which compute every phase branch for every
// game and blend: here only the branch of the game's phase runs.  Every
// output is an integer, a bool or a float32 computed in the order of the
// plain version, so each agrees with it bit for bit (the sources are built
// with --fmad=false).
//
// The graph walks of rules.py are mask walks: `connected_to` is a BFS over
// the owned lands, `component_labels` one BFS from each lowest unlabelled
// owned land.
//
// The board tables come from env/topology.py: the wrapper packs them into
// one device buffer (rules.kernel_tables) laid out as `Tables`, and each
// block of K10 copies it into shared memory.
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
constexpr int kMaxDegree = 6;
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
  int32_t cont_size[kConts];
  int32_t cont_bonus[kConts];
  int32_t card_gain[64];            // CARD_SET_GAIN
  int32_t cont_tie_rank[kConts];    // CONTINENT_TIE_RANK
  int8_t nrank[kLands * kLands];    // NEIGHBOR_RANK
  int8_t land_rank[kConts * kLands];  // SCRIPT_LAND_RANK
};
static_assert(sizeof(Tables) == 2728, "Tables must match kernel_tables()");

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

#ifdef __CUDACC__
// Every thread of the block copies its share of the tables into shared
// memory `t`; returns after the block's barrier.
__device__ __forceinline__ void load_tables(Tables& t, const Tables* src) {
  const int* from = reinterpret_cast<const int*>(src);
  int* to = reinterpret_cast<int*>(&t);
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(Tables) / 4);
       i += blockDim.x)
    to[i] = from[i];
  __syncthreads();
}
#endif

// One game.
struct St {
  int army[kLands];
  uint64_t own[3];  // owner == 0, 1, 2
  int phase, round, cur, reinf, cards[2], sets, mob_from, mob_to, attacks;
  bool can_draw;
};

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

// rules.masked_choice over a mask of up to 43 bits: the (n+1)-th set bit
// for n = clip(trunc(u * count), 0, count - 1), 0 for an empty mask.  The
// product is one float32 multiply, as PyTorch's u * count.
RD_FN int masked_choice(uint64_t mask, float u) {
  const int cnt = popc(mask);
  if (cnt == 0) return 0;
  int n = static_cast<int>(fmul(u, static_cast<float>(cnt)));
  n = imin(imax(n, 0), cnt - 1);
  for (int k = 0; k < n; ++k) mask &= mask - 1;
  return low(mask);
}

// ---------------------------------------------------------------- state

// Reads row `row` of every field; reinf, cards and sets may be null (the
// views read none of them) and then read as 0.
RD_FN void load(St& s, const StateRef& r, int64_t row) {
  const int* ow = r.owner + row * kLands;
  const int* ar = r.army + row * kLands;
  s.own[0] = s.own[1] = s.own[2] = 0;
  for (int j = 0; j < kLands; ++j) {
    const int o = ow[j];
    if (o >= 0 && o < 3) s.own[o] |= bit(j);
    s.army[j] = ar[j];
  }
  s.phase = r.phase[row];
  s.round = r.round[row];
  s.cur = r.cur[row];
  s.reinf = r.reinf != nullptr ? r.reinf[row] : 0;
  s.cards[0] = r.cards != nullptr ? r.cards[row * 2] : 0;
  s.cards[1] = r.cards != nullptr ? r.cards[row * 2 + 1] : 0;
  s.sets = r.sets != nullptr ? r.sets[row] : 0;
  s.mob_from = r.mob_from[row];
  s.mob_to = r.mob_to[row];
  s.can_draw = r.can_draw[row] != 0;
  s.attacks = r.attacks[row];
}

RD_FN void store(const St& s, const StateRef& r, int64_t row) {
  int* ow = r.owner + row * kLands;
  int* ar = r.army + row * kLands;
  for (int j = 0; j < kLands; ++j) {
    ow[j] = has(s.own[1], j) ? 1 : (has(s.own[2], j) ? 2 : 0);
    ar[j] = s.army[j];
  }
  r.phase[row] = s.phase;
  r.round[row] = s.round;
  r.cur[row] = s.cur;
  r.reinf[row] = s.reinf;
  r.cards[row * 2] = s.cards[0];
  r.cards[row * 2 + 1] = s.cards[1];
  r.sets[row] = s.sets;
  r.mob_from[row] = s.mob_from;
  r.mob_to[row] = s.mob_to;
  r.can_draw[row] = s.can_draw ? 1 : 0;
  r.attacks[row] = s.attacks;
}

RD_FN void set_owner(St& s, int li, int p) {
  const uint64_t m = ~bit(li);
  s.own[0] &= m;
  s.own[1] &= m;
  s.own[2] &= m;
  s.own[p] |= bit(li);
}

// Lands whose army is at least `thr`.
RD_FN uint64_t army_at_least(const St& s, int thr) {
  uint64_t m = 0;
  for (int j = 0; j < kLands; ++j)
    if (s.army[j] >= thr) m |= bit(j);
  return m;
}

// rules.neighbors_any: lands adjacent to any land of x.
RD_FN uint64_t nb_any(uint64_t x, const Tables& t) {
  uint64_t r = 0;
  while (x) {
    r |= t.adj[low(x)];
    x &= x - 1;
  }
  return r;
}

// rules.PlayerMasks.
struct Masks {
  uint64_t owned, enemy, neutral, owa, full, attack, attack_wa, enemy_attack,
      neutral_attack;
};

RD_FN Masks player_masks(const St& s, const Tables& t, const Cfg& c) {
  Masks m;
  m.owned = s.own[s.cur];
  m.enemy = s.own[1 - s.cur];
  m.neutral = s.own[kNeutral];
  m.owa = m.owned & army_at_least(s, 2);
  m.full = m.owned & army_at_least(s, c.army_max);
  m.attack = ~m.owned & nb_any(m.owned, t);
  m.attack_wa = ~m.owned & nb_any(m.owa, t);
  m.enemy_attack = ~m.enemy & nb_any(m.enemy, t);
  m.neutral_attack = nb_any(m.neutral, t) & ~m.neutral;
  return m;
}

// attack_lands_with_army alone.
RD_FN uint64_t attack_wa(const St& s, const Tables& t) {
  const uint64_t owned = s.own[s.cur];
  return ~owned & nb_any(owned & army_at_least(s, 2), t);
}

// rules.calc_reinforcement.
RD_FN int calc_reinforcement(uint64_t owned, const Tables& t) {
  int bonus = 0;
  for (int c = 0; c < kConts; ++c)
    if (popc(owned & t.cont[c]) == t.cont_size[c]) bonus += t.cont_bonus[c];
  return imax(popc(owned) / 3 + bonus, 3);
}

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

RD_FN int game_status(const St& s, const Cfg& c) {
  return game_status(s.own[0], s.own[1], s.round, c);
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

// ---------------------------------------------------------------- graph

// rules.connected_to: owned lands in the component of src (empty when src
// is not owned).  A BFS over masks.
RD_FN uint64_t connected_to(uint64_t owned, int src, const Tables& t) {
  if (!has(owned, src)) return 0;
  uint64_t comp = bit(src), frontier = comp;
  while (frontier) {
    const uint64_t next = nb_any(frontier, t) & owned & ~comp;
    comp |= next;
    frontier = next;
  }
  return comp;
}

// ---------------------------------------------------------------- engine

// rules.goto_attack.
RD_FN void goto_attack(St& s, const Tables& t) {
  s.reinf = 0;
  s.mob_from = -1;
  s.mob_to = -1;
  s.phase = attack_wa(s, t) ? kAttack : kFortify;
}

// rules.end_turn (with the simple-cards draw_card).
RD_FN void end_turn(St& s, const Tables& t) {
  s.cards[s.cur] += s.can_draw ? 1 : 0;
  const int nxt = 1 - s.cur;
  s.can_draw = false;
  s.round += 1;
  s.cur = nxt;
  s.attacks = 0;
  s.phase = kReinforcement;
  s.reinf = calc_reinforcement(s.own[nxt], t);
}

// rules.play_cards, simple cards.
RD_FN void play_cards(St& s, const Tables& t) {
  if (s.cards[s.cur] >= 3) {
    s.cards[s.cur] -= 3;
    s.sets += 1;
    s.reinf += t.card_gain[s.sets < 0 ? 0 : (s.sets > 63 ? 63 : s.sets)];
  }
}

// rules._move_amount.
RD_FN int move_amount(int budget, const Cfg& c) {
  if (c.fast_mob) {
    const int half = floordiv2(budget);
    return half < c.min_move ? imin(budget, c.min_move) : half;
  }
  return imin(budget, c.min_move);
}

// rules.apply_reinforcement.
RD_FN void apply_reinforcement(St& s, int li, int amount, const Tables& t) {
  s.reinf -= amount;
  s.army[li] += amount;
  if (s.reinf == 0) goto_attack(s, t);
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

// rules._apply_battle.
RD_FN void apply_battle(St& s, int frm, int li, int a1, int d1, int units,
                        const Tables& t) {
  const bool conquest = d1 == 0;
  const int a2 = conquest ? a1 - units : a1;
  const bool mob = conquest && a2 > 1;
  s.army[frm] = a2;
  s.army[li] = conquest ? units : d1;
  if (conquest) set_owner(s, li, s.cur);
  s.attacks += 1;
  s.can_draw = s.can_draw || conquest;
  if (mob) {
    s.phase = kMobilization;
    s.mob_from = frm;
    s.mob_to = li;
  }
  if (s.phase == kAttack && !attack_wa(s, t)) s.phase = kFortify;
}

// rules.apply_attack.
RD_FN void apply_attack(St& s, int frm, int li, const int* dice,
                        const Tables& t) {
  int a1, d1, units;
  battle(s.army[frm], s.army[li], dice, a1, d1, units);
  apply_battle(s, frm, li, a1, d1, units, t);
}

// rules.apply_mobilization.
RD_FN void apply_mobilization(St& s, int amount, const Tables& t) {
  const int mf = clamp_land(s.mob_from), mt = clamp_land(s.mob_to);
  s.army[mf] -= amount;
  s.army[mt] += amount;
  if (s.army[mf] == 1) goto_attack(s, t);
}

// rules.apply_fortify.
RD_FN void apply_fortify(St& s, int frm, int li, int amount) {
  s.army[frm] -= amount;
  s.army[li] += amount;
}

// The SETUP_NEUTRAL move of the RandomPlayer: +1 on land li, next setup
// turn.
RD_FN void setup_neutral_move(St& s, int li, const Tables& t) {
  s.army[li] += 1;
  s.round += 1;
  s.cur = 1 - s.cur;
  if (s.reinf == 0) {
    s.phase = kReinforcement;
    s.reinf = calc_reinforcement(s.own[s.cur], t);
  } else {
    s.phase = kSetup;
  }
}

// ---------------------------------------------------------------- random

// random_agent.random_step_recorded for one game (u[0] primary choice,
// u[1] secondary, u[2] amount or coin).
RD_FN void random_step(St& s, const float* u, const int* dice, int& action,
                       bool& record, const Tables& t, const Cfg& c) {
  const bool live = game_status(s, c) == kNotEnded;
  const Masks m = player_masks(s, t, c);
  St o = s;
  switch (s.phase) {
    case kSetup: {
      const int li = masked_choice(m.owned, u[0]);
      o.reinf -= 2;
      o.army[li] += 2;
      o.phase = kSetupNeutral;
      action = li;
      break;
    }
    case kSetupNeutral: {
      const int li = masked_choice(m.neutral, u[0]);
      setup_neutral_move(o, li, t);
      action = li;
      break;
    }
    case kReinforcement: {
      play_cards(o, t);
      const int li = masked_choice(m.owned & ~m.full, u[0]);
      apply_reinforcement(o, li, 1, t);
      action = li;
      break;
    }
    case kAttack: {
      const int choice = masked_choice(m.attack_wa | kSkipBit, u[0]);
      if (choice == kSkip) {
        o.phase = kFortify;
        action = kSkip;
      } else {
        const int frm = masked_choice(t.adj[choice] & m.owa, u[1]);
        apply_attack(o, frm, choice, dice, t);
        action = choice;
      }
      break;
    }
    case kMobilization: {
      const int mf = clamp_land(s.mob_from);
      if (u[2] > 0.5f) {
        apply_mobilization(o, imin(s.army[mf] - 1, c.min_move), t);
        action = clamp_land(s.mob_to);
      } else {
        goto_attack(o, t);
        action = mf;
      }
      break;
    }
    default: {
      const int fchoice = masked_choice((m.owned & ~m.full) | kSkipBit, u[0]);
      const bool f_skip = fchoice == kSkip;
      const int fto = clamp_land(fchoice);
      const uint64_t cand =
          connected_to(m.owned, fto, t) & ~bit(fto) & m.owa;
      const int ffrom = masked_choice(cand, u[1]);
      const int max_amt =
          imin(s.army[ffrom] - 1, c.army_max - s.army[fto]);
      const bool can = !f_skip && cand;
      const int ramt =
          can ? static_cast<int>(fmul(u[2], static_cast<float>(max_amt))) : 0;
      apply_fortify(o, can ? ffrom : 0, can ? fto : 0, ramt);
      end_turn(o, t);
      action = f_skip ? kSkip : fto;
      break;
    }
  }
  record = live;
  if (live) s = o;
}

}  // namespace rd
