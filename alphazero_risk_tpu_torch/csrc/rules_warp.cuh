// The Risk rules for one game held by one warp, shared by K7
// (rules_step.cu), K8 (state_views.cu), K9 (script_step.cu) and K10
// (random_step.cu), and by their multi-step entry (agent_steps.cu), which
// run the ScriptPlayer's and the RandomPlayer's decisions at the end of
// this file.
//
// Lane k owns lands k and k + 32 (the second only for k < 10): it holds
// their armies in registers and reads their adjacency rows; lanes 0-5 also
// hold one continent each.  Land sets are warp-uniform uint64_t masks
// (bit j = land j): a predicate on the lanes' lands becomes a mask by two
// __ballot_sync, and rules.neighbors_any is the OR of the adjacency rows of
// the set lands, reduced over the lanes by __reduce_or_sync on the two
// 32-bit halves.  So player_masks costs one reduction per mask, and a BFS
// step of connected_to one reduction, not a walk over the set bits.  The
// army of a land known only at run time comes from its owner lane by
// __shfl_sync; a first argmax over the lands is two reductions (the largest
// key, then the lowest land holding it), which keeps jnp.argmax's
// first-index rule.
//
// Every function here is called by all 32 lanes of the warp with the same
// (warp-uniform) arguments; the scalars of the game and the phase machine's
// branches are warp-uniform, so no lane diverges on the game's phase.  The
// per-game logic is that of the plain PyTorch version (env/rules.py), each
// side effect in its order, so every output agrees with it bit for bit.
//
// The board adjacency is symmetric (rules.kernel_tables checks it): land j
// neighbours land i iff bit i of j's own row is set, so a lane tests its
// lands against a land known at run time with the rows it already holds.
//
// The functions that reach a card rule (the trade, the draw at a turn's
// end) are templates on kCards, the full-cards rules: the hands and the
// drawn pile are warp-uniform masks of WSt, read and written only by the
// kCards instantiations, so the simple-cards ones keep their code.

#pragma once

#include <climits>
#include <cstdint>

#include "rules_dev.cuh"

namespace rw {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoLand = INT_MIN;      // argmax key of a land past the 42nd

// Whether the lane owns a second land (lane + 32 < 42).
__device__ __forceinline__ bool two(int lane) {
  return lane + 32 < rd::kLands;
}

// A 42-land mask from the lanes' predicates on land lane (p0) and land
// lane + 32 (p1, false where there is none).
__device__ __forceinline__ uint64_t ballot(bool p0, bool p1) {
  return static_cast<uint64_t>(__ballot_sync(kFull, p0)) |
         (static_cast<uint64_t>(__ballot_sync(kFull, p1)) << 32);
}

__device__ __forceinline__ uint64_t reduce_or(uint64_t r) {
  return static_cast<uint64_t>(
             __reduce_or_sync(kFull, static_cast<unsigned>(r))) |
         (static_cast<uint64_t>(
              __reduce_or_sync(kFull, static_cast<unsigned>(r >> 32)))
          << 32);
}

// What a lane holds of the board tables.
struct Board {
  uint64_t adj0, adj1;   // adjacency rows of lands lane, lane + 32 (or 0)
  uint64_t cont;         // continent `lane`'s mask (lanes 0-5, else 0)
  int csize, cbonus;     // its size and bonus (else 0)
};

__device__ __forceinline__ Board load_board(const rd::Tables* __restrict__ t,
                                            int lane) {
  Board d;
  d.adj0 = t->adj[lane];
  d.adj1 = two(lane) ? t->adj[lane + 32] : 0;
  const bool cl = lane < rd::kConts;
  d.cont = cl ? t->cont[lane] : 0;
  d.csize = cl ? t->cont_size[lane] : 0;
  d.cbonus = cl ? t->cont_bonus[lane] : 0;
  return d;
}

// rules.neighbors_any: lands adjacent to any land of x.
__device__ __forceinline__ uint64_t nb_any(uint64_t x, const Board& d,
                                           int lane) {
  return reduce_or((rd::has(x, lane) ? d.adj0 : 0) |
                   (rd::has(x, lane + 32) ? d.adj1 : 0));
}

// rules.calc_reinforcement.
__device__ __forceinline__ int reinforcement(uint64_t owned, const Board& d) {
  const int b = __reduce_add_sync(
      kFull, rd::popc(owned & d.cont) == d.csize ? d.cbonus : 0);
  return rd::imax(rd::popc(owned) / 3 + b, 3);
}

// The first land of the largest key (jnp.argmax over the 42 lands): k0 is
// the key of land lane, k1 that of land lane + 32 (kNoLand where there is
// none).
__device__ __forceinline__ int argmax_lands(int k0, int k1, int lane) {
  const bool hi = k1 > k0;
  const int key = hi ? k1 : k0;
  const int top = __reduce_max_sync(kFull, key);
  return static_cast<int>(__reduce_min_sync(
      kFull, key == top ? static_cast<unsigned>(hi ? lane + 32 : lane)
                        : 64u));
}

// One game: the lane's two armies, the rest warp-uniform.
struct WSt {
  int ar0, ar1;          // armies of lands lane and lane + 32 (0 if none)
  uint64_t own[3];       // owner == 0, 1, 2
  int phase, round, cur, reinf, cards[2], sets, mob_from, mob_to, attacks;
  bool can_draw;
  uint64_t hand[2], drawn;  // full cards: player_cards, drawn_cards
};

// own[p] with p known at run time, without indexing a register array
// (which would put it in local memory; cards[cur] is selected the same
// way where it is used).
__device__ __forceinline__ uint64_t own_of(const WSt& s, int p) {
  return p == 0 ? s.own[0] : (p == 1 ? s.own[1] : s.own[2]);
}

__device__ __forceinline__ int army(const WSt& s, int li) {
  return __shfl_sync(kFull, li < 32 ? s.ar0 : s.ar1, li & 31);
}

__device__ __forceinline__ void set_army(WSt& s, int li, int v, int lane) {
  if (lane == (li & 31)) {
    if (li < 32) s.ar0 = v;
    else s.ar1 = v;
  }
}

__device__ __forceinline__ void add_army(WSt& s, int li, int v, int lane) {
  if (lane == (li & 31)) {
    if (li < 32) s.ar0 += v;
    else s.ar1 += v;
  }
}

// Lands whose army is at least `thr`.
__device__ __forceinline__ uint64_t at_least(const WSt& s, int thr,
                                             int lane) {
  return ballot(s.ar0 >= thr, two(lane) && s.ar1 >= thr);
}

__device__ __forceinline__ void set_owner(WSt& s, int li, int p) {
  const uint64_t m = ~rd::bit(li);
  s.own[0] &= m;
  s.own[1] &= m;
  s.own[2] &= m;
  if (p == 0) s.own[0] |= rd::bit(li);
  else if (p == 1) s.own[1] |= rd::bit(li);
  else s.own[2] |= rd::bit(li);
}

// Reads row `row` of the 12 fields (all non-null): one round trip.
__device__ __forceinline__ void load(WSt& s, const rd::StateRef& r,
                                     int64_t row, int lane) {
  const int* ow = r.owner + row * rd::kLands;
  const int* ar = r.army + row * rd::kLands;
  const bool t2 = two(lane);
  const int o0 = ow[lane];
  const int o1 = t2 ? ow[lane + 32] : -1;
  s.ar0 = ar[lane];
  s.ar1 = t2 ? ar[lane + 32] : 0;
  s.phase = r.phase[row];
  s.round = r.round[row];
  s.cur = r.cur[row];
  s.reinf = r.reinf[row];
  s.cards[0] = r.cards[row * 2];
  s.cards[1] = r.cards[row * 2 + 1];
  s.sets = r.sets[row];
  s.mob_from = r.mob_from[row];
  s.mob_to = r.mob_to[row];
  s.can_draw = r.can_draw[row] != 0;
  s.attacks = r.attacks[row];
  s.own[0] = ballot(o0 == 0, o1 == 0);
  s.own[1] = ballot(o0 == 1, o1 == 1);
  s.own[2] = ballot(o0 == 2, o1 == 2);
}

__device__ __forceinline__ void store(const WSt& s, const rd::StateRef& r,
                                      int64_t row, int lane) {
  int* ow = r.owner + row * rd::kLands;
  int* ar = r.army + row * rd::kLands;
  auto owner = [&](int j) {
    return rd::has(s.own[1], j) ? 1 : (rd::has(s.own[2], j) ? 2 : 0);
  };
  ow[lane] = owner(lane);
  ar[lane] = s.ar0;
  if (two(lane)) {
    ow[lane + 32] = owner(lane + 32);
    ar[lane + 32] = s.ar1;
  }
  if (lane == 0) {
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
}

// Full cards: reads the card masks of row `row` (player_cards [.., 2, 42]
// and drawn_cards [.., 42] bool) by ballots over the lanes' lands.
__device__ __forceinline__ void load_cards(WSt& s,
                                           const uint8_t* __restrict__ pc,
                                           const uint8_t* __restrict__ dc,
                                           int64_t row, int lane) {
  const uint8_t* p = pc + row * 2 * rd::kLands;
  const uint8_t* q = dc + row * rd::kLands;
  const bool t2 = two(lane);
  const uint8_t h00 = p[lane], h01 = t2 ? p[lane + 32] : 0;
  const uint8_t h10 = p[rd::kLands + lane];
  const uint8_t h11 = t2 ? p[rd::kLands + lane + 32] : 0;
  const uint8_t d0 = q[lane], d1 = t2 ? q[lane + 32] : 0;
  s.hand[0] = ballot(h00 != 0, h01 != 0);
  s.hand[1] = ballot(h10 != 0, h11 != 0);
  s.drawn = ballot(d0 != 0, d1 != 0);
}

// Full cards: each lane writes its lands' bytes of the card masks.
__device__ __forceinline__ void store_cards(const WSt& s,
                                            uint8_t* __restrict__ pc,
                                            uint8_t* __restrict__ dc,
                                            int64_t row, int lane) {
  uint8_t* p = pc + row * 2 * rd::kLands;
  uint8_t* q = dc + row * rd::kLands;
  p[lane] = rd::has(s.hand[0], lane);
  p[rd::kLands + lane] = rd::has(s.hand[1], lane);
  q[lane] = rd::has(s.drawn, lane);
  if (two(lane)) {
    p[lane + 32] = rd::has(s.hand[0], lane + 32);
    p[rd::kLands + lane + 32] = rd::has(s.hand[1], lane + 32);
    q[lane + 32] = rd::has(s.drawn, lane + 32);
  }
}

__device__ __forceinline__ int game_status(const WSt& s, const rd::Cfg& c) {
  return rd::game_status(s.own[0], s.own[1], s.round, c);
}

// rules.PlayerMasks but `attack`, which no warp caller reads.
__device__ __forceinline__ rd::Masks player_masks(const WSt& s,
                                                  const Board& d,
                                                  const rd::Cfg& c,
                                                  int lane) {
  rd::Masks m;
  m.owned = own_of(s, s.cur);
  m.enemy = own_of(s, 1 - s.cur);
  m.neutral = s.own[rd::kNeutral];
  m.owa = m.owned & at_least(s, 2, lane);
  m.full = m.owned & at_least(s, c.army_max, lane);
  m.attack = 0;
  m.attack_wa = ~m.owned & nb_any(m.owa, d, lane);
  m.enemy_attack = ~m.enemy & nb_any(m.enemy, d, lane);
  m.neutral_attack = nb_any(m.neutral, d, lane) & ~m.neutral;
  return m;
}

// attack_lands_with_army alone.
__device__ __forceinline__ uint64_t attack_wa(const WSt& s, const Board& d,
                                              int lane) {
  const uint64_t owned = own_of(s, s.cur);
  return ~owned & nb_any(owned & at_least(s, 2, lane), d, lane);
}

// rules.connected_to: a BFS whose frontier step is one OR-reduction.
__device__ __forceinline__ uint64_t connected_to(uint64_t owned, int src,
                                                 const Board& d, int lane) {
  if (!rd::has(owned, src)) return 0;
  uint64_t comp = rd::bit(src), frontier = comp;
  while (frontier) {
    const uint64_t next = nb_any(frontier, d, lane) & owned & ~comp;
    comp |= next;
    frontier = next;
  }
  return comp;
}

// rules.masked_choice over a warp-uniform mask of up to 43 bits (bit 42
// the skip): the (n+1)-th set bit for n = clip(trunc(u * count), 0,
// count - 1), 0 for an empty mask.  The product is one float32 multiply,
// as PyTorch's u * count.  Lane l tests bits l and l + 32: the one whose
// rank among the set bits (the popcount of the bits below it) is n is the
// pick, found by one min-reduction.
__device__ __forceinline__ int masked_choice(uint64_t mask, float u,
                                             int lane) {
  const int cnt = rd::popc(mask);
  if (cnt == 0) return 0;
  int n = static_cast<int>(rd::fmul(u, static_cast<float>(cnt)));
  n = rd::imin(rd::imax(n, 0), cnt - 1);
  const int hi = lane + 32;
  const bool h0 =
      rd::has(mask, lane) && rd::popc(mask & (rd::bit(lane) - 1)) == n;
  const bool h1 =
      rd::has(mask, hi) && rd::popc(mask & (rd::bit(hi) - 1)) == n;
  return static_cast<int>(__reduce_min_sync(
      kFull, h0 ? static_cast<unsigned>(lane)
                : (h1 ? static_cast<unsigned>(hi) : 64u)));
}

// The fortify tie-break of rules.step: the land of `tied` that comes first
// in rules.dfs_preorder_rank's pre-order of the owned component from
// `root` (root owned, tied in its component).  The source argmax keys a
// land by army * 64 + (42 - rank), and the tied lands share the top army,
// so the source is the tied land of least rank: the walk stops at the
// first one it visits instead of ranking every land until all of them are
// visited.  The next land, the unvisited owned neighbour first in the
// current land's neighbour list, is one __reduce_min_sync over
// (NEIGHBOR_RANK, land) keys; the parent pointers sit in the owner lanes'
// registers, and a step back reads one by a shuffle.
__device__ __forceinline__ int dfs_first_tied(
    uint64_t owned, int root, uint64_t tied, const Board& d,
    const int8_t* __restrict__ nrank, int lane) {
  if (rd::has(tied, root)) return root;
  int par0 = -1, par1 = -1;
  uint64_t visited = rd::bit(root);
  int cur = root;
  const bool t2 = two(lane);
  while (cur >= 0) {
    const uint64_t open = owned & ~visited;
    const int8_t* nr = nrank + cur * rd::kLands;
    const int c0 = rd::has(open, lane) && rd::has(d.adj0, cur)
                       ? nr[lane] * 64 + lane
                       : INT_MAX;
    const int c1 = t2 && rd::has(open, lane + 32) && rd::has(d.adj1, cur)
                       ? nr[lane + 32] * 64 + lane + 32
                       : INT_MAX;
    const int best = __reduce_min_sync(kFull, rd::imin(c0, c1));
    if (best != INT_MAX) {
      const int nxt = best & 63;
      if (rd::has(tied, nxt)) return nxt;
      visited |= rd::bit(nxt);
      if (lane == (nxt & 31)) {
        if (nxt < 32) par0 = cur;
        else par1 = cur;
      }
      cur = nxt;
    } else {
      cur = __shfl_sync(kFull, cur < 32 ? par0 : par1, cur & 31);
    }
  }
  return -1;  // not reached: the component holds the tied lands
}

// ---------------------------------------------------------------- engine

__device__ __forceinline__ void goto_attack(WSt& s, const Board& d,
                                            int lane) {
  s.reinf = 0;
  s.mob_from = -1;
  s.mob_to = -1;
  s.phase = attack_wa(s, d, lane) ? rd::kAttack : rd::kFortify;
}

// rules.draw_card under full cards: a game that earned a card draws
// masked_choice(pile, u_card) from the undrawn pile; an empty pile is first
// reshuffled (the cards in no hand come back, the drawn pile becomes the
// hands).  A game that earned none keeps its pile as it is.
__device__ __forceinline__ void draw_card_full(WSt& s, float u_card,
                                               int lane) {
  if (!s.can_draw) return;
  uint64_t drawn = s.drawn;
  uint64_t pile = rd::kAll & ~drawn;
  if (!pile) {
    drawn = s.hand[0] | s.hand[1];
    pile = rd::kAll & ~drawn;
  }
  const uint64_t card = rd::bit(masked_choice(pile, u_card, lane));
  s.drawn = drawn | card;
  if (s.cur == 0) s.hand[0] |= card;
  else s.hand[1] |= card;
}

// rules.end_turn; u_card is read under full cards only.
template <bool kCards>
__device__ __forceinline__ void end_turn(WSt& s, const Board& d,
                                         float u_card, int lane) {
  if (kCards) {
    draw_card_full(s, u_card, lane);
  } else {
    const int drawn = s.can_draw ? 1 : 0;
    if (s.cur == 0) s.cards[0] += drawn;
    else s.cards[1] += drawn;
  }
  const int nxt = 1 - s.cur;
  s.can_draw = false;
  s.round += 1;
  s.cur = nxt;
  s.attacks = 0;
  s.phase = rd::kReinforcement;
  s.reinf = reinforcement(own_of(s, nxt), d);
}

// The lowest k set bits of m (k <= 3).
__device__ __forceinline__ uint64_t lowest(uint64_t m, int k) {
  uint64_t r = 0;
  for (int i = 0; i < k && m; ++i) {
    r |= m & (~m + 1);
    m &= m - 1;
  }
  return r;
}

// rules._play_cards_full: with more than three cards, the best combo of
// rules._best_combo on masks.  A type's combo is the lowest three of its
// owned cards, topped up by the lowest of its others, and scores its owned
// count; one-of-each takes each type's first owned card, else its first
// card, and scores the types with an owned card.  The key score * 8 +
// (3 - kind) keeps the tie order infantry, horse, siege, one-of-each.  The
// +2 goes on the first owned combo land with army + 2 <= land_army_max (a
// ballot), if any.
__device__ __forceinline__ void play_cards_full(
    WSt& s, const rd::Tables* __restrict__ t, const rd::Cfg& c, int lane) {
  const uint64_t hand = s.cur == 0 ? s.hand[0] : s.hand[1];
  if (rd::popc(hand) <= 3) return;
  const uint64_t owned = own_of(s, s.cur);
  int best = -1;
  uint64_t combo = 0, each = 0;
  int each_owned = 0;
  bool each_ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint64_t ht = hand & t->card_type[k];
    const uint64_t ho = ht & owned;
    if (rd::popc(ht) >= 3) {
      const int n = rd::imin(rd::popc(ho), 3);
      const int key = n * 8 + (3 - k);
      if (key > best) {
        best = key;
        combo = lowest(ho, 3) | lowest(ht & ~owned, 3 - n);
      }
    }
    each_ok = each_ok && ht != 0;
    each |= lowest(ho ? ho : ht, 1);
    each_owned += ho ? 1 : 0;
  }
  if (each_ok && each_owned * 8 > best) {
    best = each_owned * 8;
    combo = each;
  }
  if (best < 0) return;
  const uint64_t room = ballot(s.ar0 + 2 <= c.army_max,
                               two(lane) && s.ar1 + 2 <= c.army_max);
  const uint64_t bonus = combo & owned & room;
  if (bonus) add_army(s, rd::low(bonus), 2, lane);
  if (s.cur == 0) s.hand[0] = hand & ~combo;
  else s.hand[1] = hand & ~combo;
  s.sets += 1;
  s.reinf += t->card_gain[s.sets < 0 ? 0 : (s.sets > 63 ? 63 : s.sets)];
}

template <bool kCards>
__device__ __forceinline__ void play_cards(WSt& s,
                                           const rd::Tables* __restrict__ t,
                                           const rd::Cfg& c, int lane) {
  if (kCards) {
    play_cards_full(s, t, c, lane);
    return;
  }
  const int have = s.cur == 0 ? s.cards[0] : s.cards[1];
  if (have >= 3) {
    if (s.cur == 0) s.cards[0] -= 3;
    else s.cards[1] -= 3;
    s.sets += 1;
    s.reinf += t->card_gain[s.sets < 0 ? 0 : (s.sets > 63 ? 63 : s.sets)];
  }
}

__device__ __forceinline__ void apply_reinforcement(WSt& s, int li,
                                                    int amount,
                                                    const Board& d,
                                                    int lane) {
  s.reinf -= amount;
  add_army(s, li, amount, lane);
  if (s.reinf == 0) goto_attack(s, d, lane);
}

__device__ __forceinline__ void apply_battle(WSt& s, int frm, int li, int a1,
                                             int d1, int units,
                                             const Board& d, int lane) {
  const bool conquest = d1 == 0;
  const int a2 = conquest ? a1 - units : a1;
  const bool mob = conquest && a2 > 1;
  set_army(s, frm, a2, lane);
  set_army(s, li, conquest ? units : d1, lane);
  if (conquest) set_owner(s, li, s.cur);
  s.attacks += 1;
  s.can_draw = s.can_draw || conquest;
  if (mob) {
    s.phase = rd::kMobilization;
    s.mob_from = frm;
    s.mob_to = li;
  }
  if (s.phase == rd::kAttack && !attack_wa(s, d, lane)) s.phase = rd::kFortify;
}

__device__ __forceinline__ void apply_mobilization(WSt& s, int amount,
                                                   const Board& d,
                                                   int lane) {
  const int mf = rd::clamp_land(s.mob_from), mt = rd::clamp_land(s.mob_to);
  add_army(s, mf, -amount, lane);
  add_army(s, mt, amount, lane);
  if (army(s, mf) == 1) goto_attack(s, d, lane);
}

// rules.best_attack_from_army: the owned, armed neighbour of target with
// the largest army, first in target's neighbour list on ties.  nr0/nr1:
// NEIGHBOR_RANK[target] of the lane's lands.
__device__ __forceinline__ int best_attack_from(const WSt& s, int target,
                                                uint64_t owa, int nr0,
                                                int nr1, const Board& d,
                                                int lane) {
  const int k0 = rd::has(owa, lane) && rd::has(d.adj0, target)
                     ? (s.ar0 - 1) * 8 - nr0
                     : -1;
  const int k1 = !two(lane) ? kNoLand
                 : (rd::has(owa, lane + 32) && rd::has(d.adj1, target)
                        ? (s.ar1 - 1) * 8 - nr1
                        : -1);
  return argmax_lands(k0, k1, lane);
}

// The fortify move of rules.step, then the turn's end.
template <bool kCards>
__device__ __forceinline__ void fortify_step(WSt& s, int li, bool is_skip,
                                             float u_card,
                                             const int8_t* __restrict__ nrank,
                                             const Board& d,
                                             const rd::Cfg& c, int lane) {
  const uint64_t owned = own_of(s, s.cur);
  const int a_li = army(s, li);
  const bool target_full = a_li >= c.army_max;
  const uint64_t comp = connected_to(owned, li, d, lane);
  const uint64_t cand = comp & ~rd::bit(li) & at_least(s, 2, lane);
  const uint64_t hen = nb_any(rd::kAll & ~owned, d, lane);
  const uint64_t interior = cand & ~hen, border = cand & hen;
  const uint64_t pick = interior ? interior : border;
  const bool p0 = rd::has(pick, lane), p1 = rd::has(pick, lane + 32);
  // the first land of the most armies (unranked lands all rank 42 in the
  // plain version's key army * 64 + (42 - rank), so this is its argmax
  // wherever no DFS runs)
  int f_from = argmax_lands(p0 ? s.ar0 : -1,
                            !two(lane) ? kNoLand : (p1 ? s.ar1 : -1), lane);
  if (c.exact_tb) {
    const int top = army(s, f_from);
    const uint64_t tied = ballot(p0 && s.ar0 == top, p1 && s.ar1 == top);
    if (s.phase == rd::kFortify && !is_skip && !target_full &&
        rd::popc(tied) >= 2)
      f_from = dfs_first_tied(owned, rd::first_set_bit(comp), tied, d,
                              nrank, lane);
  }
  const bool can_move = pick && !target_full && !is_skip;
  const int famount =
      can_move ? rd::imin(army(s, f_from) - 1, c.army_max - a_li) : 0;
  add_army(s, f_from, -famount, lane);
  add_army(s, li, famount, lane);
  end_turn<kCards>(s, d, u_card, lane);
}

// rules.step (the five dice held by lanes 0-4 in `die`; u_card the card
// uniform under full cards) or, with use_outcome, rules.step_with_outcome
// (simple cards only).  nr0/nr1: NEIGHBOR_RANK[clamp_land(action)] of the
// lane's lands (read only in the attack phase).  Terminal games are left
// unchanged.
template <bool kCards>
__device__ __forceinline__ void step(WSt& s, int action, int die,
                                     int outcome, bool use_outcome,
                                     float u_card, int nr0, int nr1,
                                     const rd::Tables* __restrict__ t,
                                     const Board& d, const rd::Cfg& c,
                                     int lane) {
  if (game_status(s, c) != rd::kNotEnded) return;
  const int li = rd::clamp_land(action);
  const bool is_skip = action == rd::kSkip;
  switch (s.phase) {
    case rd::kSetup:
      s.reinf -= 2;
      add_army(s, li, 2, lane);
      s.phase = rd::kSetupNeutral;
      break;
    case rd::kSetupNeutral:
      add_army(s, li, 1, lane);
      s.round += 1;
      s.cur = 1 - s.cur;
      if (s.reinf == 0) {
        s.phase = rd::kReinforcement;
        s.reinf = reinforcement(own_of(s, s.cur), d);
      } else {
        s.phase = rd::kSetup;
      }
      break;
    case rd::kReinforcement:
      if (is_skip) {
        goto_attack(s, d, lane);
      } else {
        play_cards<kCards>(s, t, c, lane);
        const int amount =
            rd::imin(rd::move_amount(s.reinf, c), c.army_max - army(s, li));
        apply_reinforcement(s, li, amount, d, lane);
      }
      break;
    case rd::kAttack:
      if (is_skip) {
        s.phase = rd::kFortify;
      } else {
        const int frm = best_attack_from(
            s, li, own_of(s, s.cur) & at_least(s, 2, lane), nr0, nr1, d,
            lane);
        const int af = army(s, frm), at = army(s, li);
        int a1, d1, units;
        if (use_outcome) {
          rd::battle_with_outcome(af, at, outcome, a1, d1, units);
        } else {
          int dice[5];
#pragma unroll
          for (int k = 0; k < 5; ++k) dice[k] = __shfl_sync(kFull, die, k);
          rd::battle(af, at, dice, a1, d1, units);
        }
        apply_battle(s, frm, li, a1, d1, units, d, lane);
      }
      break;
    case rd::kMobilization:
      if (action == s.mob_from) {
        goto_attack(s, d, lane);
      } else {
        const int mf = rd::clamp_land(s.mob_from);
        apply_mobilization(s, rd::move_amount(army(s, mf) - 1, c), d, lane);
      }
      break;
    default:
      fortify_step<kCards>(s, li, is_skip, u_card, t->nrank, d, c, lane);
      break;
  }
}

// ---------------------------------------------------------- ScriptPlayer

// What a lane holds of the ScriptPlayer's tables: SCRIPT_LAND_RANK of its
// two lands for each continent, one byte per continent (the ranks are
// 0..42), and CONTINENT_TIE_RANK of continent `lane` (lanes 0-5).
struct ScriptBoard {
  uint64_t rank0, rank1;
  int tie;
};

__device__ __forceinline__ ScriptBoard load_script_board(
    const rd::Tables* __restrict__ t, int lane) {
  ScriptBoard sb{0, 0, lane < rd::kConts ? t->cont_tie_rank[lane] : 0};
  const bool t2 = two(lane);
#pragma unroll
  for (int c = 0; c < rd::kConts; ++c) {
    const int8_t* r = t->land_rank + c * rd::kLands;
    sb.rank0 |= static_cast<uint64_t>(static_cast<uint8_t>(r[lane])) << (8 * c);
    if (t2)
      sb.rank1 |= static_cast<uint64_t>(static_cast<uint8_t>(r[lane + 32]))
                  << (8 * c);
  }
  return sb;
}

__device__ __forceinline__ int land_rank(uint64_t ranks, int cont) {
  return static_cast<int>((ranks >> (8 * cont)) & 0xffu);
}

// script_agent._select_target: lanes 0-5 score one continent each, the
// first of the least score by one min-reduction over (score, continent);
// then the first attackable land in that continent's declared order, one
// min-reduction over (SCRIPT_LAND_RANK, land).
__device__ __forceinline__ int select_target(uint64_t owned, uint64_t attack,
                                             const Board& d,
                                             const ScriptBoard& sb,
                                             int lane) {
  int key = INT_MAX;
  if (lane < rd::kConts) {
    const int unowned = rd::popc(~owned & d.cont);
    const int att = rd::popc(~owned & attack & d.cont);
    const int score =
        att > 0 ? unowned * 1000 - att * 10 + sb.tie : 100000000;
    key = score * 8 + lane;
  }
  const int cont = __reduce_min_sync(kFull, key) & 7;
  const int none = rd::kLands + 1;
  const int k0 = (rd::has(attack, lane) ? land_rank(sb.rank0, cont) : none) *
                     64 + lane;
  const int k1 = !two(lane) ? INT_MAX
                 : (rd::has(attack, lane + 32) ? land_rank(sb.rank1, cont)
                                               : none) * 64 + lane + 32;
  return __reduce_min_sync(kFull, rd::imin(k0, k1)) & 63;
}

// script_agent._select_from: the land of `mask` next to the target with
// the most armies, first in the target's neighbour list on ties (keys
// army * 8 - NEIGHBOR_RANK[target]).
__device__ __forceinline__ int select_from(const WSt& s, int target,
                                           uint64_t mask,
                                           const rd::Tables* __restrict__ t,
                                           const Board& d, int lane) {
  const int8_t* nr = t->nrank + target * rd::kLands;
  const int k0 = rd::has(mask, lane) && rd::has(d.adj0, target)
                     ? s.ar0 * 8 - nr[lane]
                     : -1;
  const int k1 = !two(lane) ? kNoLand
                 : (rd::has(mask, lane + 32) && rd::has(d.adj1, target)
                        ? s.ar1 * 8 - nr[lane + 32]
                        : -1);
  return argmax_lands(k0, k1, lane);
}

// The ScriptPlayer's carry.
struct Carry {
  int to, from;
  bool mode_b;
};

// Its fields in memory: attack_to, attack_from int32, mode_b bool, [B].
struct CarryRef {
  int* to;
  int* from;
  uint8_t* mode_b;
};

inline CarryRef carry_ref(void* to, void* from, void* mode_b) {
  return {static_cast<int*>(to), static_cast<int*>(from),
          static_cast<uint8_t*>(mode_b)};
}

__device__ __forceinline__ Carry load_carry(const CarryRef& r, int b) {
  return Carry{r.to[b], r.from[b], r.mode_b[b] != 0};
}

__device__ __forceinline__ void store_carry(const Carry& c,
                                            const CarryRef& r, int b) {
  r.to[b] = c.to;
  r.from[b] = c.from;
  r.mode_b[b] = c.mode_b ? 1 : 0;
}

// script_agent.script_step_recorded for one game: the state and carry
// advance only while the game runs (the carry's reset applies either way);
// action and record are the recorded 43-way action and its sample mask.
// u0 is the step's first uniform, u3 its card uniform (full cards), `die`
// the lane's die (lanes 0-4).  Every branch is that of the plain version,
// each side effect in its order; the masks it reads are computed in the
// branch that reads them.
template <bool kCards>
__device__ __forceinline__ void script_step(
    WSt& s, Carry& carry, bool reset, float u0, float u3, int die,
    int& action,
    bool& record, const rd::Tables* __restrict__ t, const Board& d,
    const ScriptBoard& sb, const rd::Cfg& c, int lane) {
  if (reset) carry = Carry{-1, -1, false};
  const bool live = game_status(s, c) == rd::kNotEnded;
  const uint64_t owned = own_of(s, s.cur);
  WSt o = s;
  Carry nc = carry;
  bool rec = true;
  switch (s.phase) {
    case rd::kSetup: {
      const uint64_t attack = ~owned & nb_any(owned, d, lane);
      const int to = select_target(owned, attack, d, sb, lane);
      const int frm = select_from(s, to, owned, t, d, lane);
      o.reinf -= 2;
      add_army(o, frm, 2, lane);
      o.phase = rd::kSetupNeutral;
      action = frm;
      break;
    }
    case rd::kSetupNeutral: {
      const uint64_t enemy = own_of(s, 1 - s.cur);
      const uint64_t neutral = s.own[rd::kNeutral];
      const uint64_t attack = ~owned & nb_any(owned, d, lane);
      const uint64_t enemy_attack = ~enemy & nb_any(enemy, d, lane);
      const uint64_t pref1 = neutral & enemy_attack & ~attack;
      const uint64_t pref2 = neutral & enemy_attack;
      const int li = masked_choice(
          pref1 ? pref1 : (pref2 ? pref2 : neutral), u0, lane);
      add_army(o, li, 1, lane);
      o.round += 1;
      o.cur = 1 - o.cur;
      if (o.reinf == 0) {
        o.phase = rd::kReinforcement;
        o.reinf = reinforcement(own_of(o, o.cur), d);
      } else {
        o.phase = rd::kSetup;
      }
      action = li;
      break;
    }
    case rd::kReinforcement: {
      const bool need_pin = carry.to < 0;
      int r_to = carry.to, r_from = carry.from;
      if (need_pin) {
        play_cards<kCards>(o, t, c, lane);  // traded once, at the pin
        const uint64_t attack = ~owned & nb_any(owned, d, lane);
        r_to = select_target(owned, attack, d, sb, lane);
        r_from = select_from(o, r_to, owned, t, d, lane);
      }
      nc.to = r_to;
      nc.from = r_from;
      // the lands not full after the trade (a full-cards bonus may fill
      // one; a simple trade moves no army)
      const uint64_t onf =
          owned & ~at_least(kCards ? o : s, c.army_max, lane);
      int to_r;
      if (r_from >= 0 && r_from < rd::kLands && rd::has(onf, r_from)) {
        to_r = r_from;
      } else {
        const uint64_t near_to =
            ballot(rd::has(onf, lane) && rd::has(d.adj0, r_to),
                   rd::has(onf, lane + 32) && rd::has(d.adj1, r_to));
        if (near_to) {
          to_r = rd::low(near_to);
        } else {
          const uint64_t enemy = own_of(s, 1 - s.cur);
          const uint64_t neutral = s.own[rd::kNeutral];
          const uint64_t near_enemy =
              onf & ((~enemy & nb_any(enemy, d, lane)) |
                     (nb_any(neutral, d, lane) & ~neutral));
          to_r = near_enemy ? rd::low(near_enemy) : rd::first_set_bit(onf);
        }
      }
      if (onf) {
        const int amt = rd::imin(rd::imin(o.reinf, c.min_move),
                                 c.army_max - army(o, to_r));
        apply_reinforcement(o, to_r, amt, d, lane);
      } else {
        goto_attack(o, d, lane);
      }
      action = to_r;
      break;
    }
    case rd::kAttack: {
      const int at = rd::clamp_land(carry.to);
      const int af = rd::clamp_land(carry.from);
      const bool to_valid = carry.to >= 0 && !rd::has(owned, at);
      const bool from_valid =
          carry.from >= 0 && army(s, af) >= 2 && rd::has(owned, af);
      const bool pinned_ok = to_valid && from_valid;
      int a_to = carry.to, a_from = carry.from;
      if (!pinned_ok) {
        const uint64_t owa = owned & at_least(s, 2, lane);
        const uint64_t attack_wa = ~owned & nb_any(owa, d, lane);
        a_to = select_target(owned, attack_wa, d, sb, lane);
        a_from = select_from(s, a_to, owa, t, d, lane);
      }
      nc.to = a_to;
      nc.from = a_from;
      nc.mode_b = carry.mode_b || !pinned_ok;
      int dice[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) dice[k] = __shfl_sync(kFull, die, k);
      int a1, d1, units;
      rd::battle(army(o, a_from), army(o, a_to), dice, a1, d1, units);
      apply_battle(o, a_from, a_to, a1, d1, units, d, lane);
      action = a_to;
      break;
    }
    case rd::kMobilization: {
      const int mf = rd::clamp_land(s.mob_from);
      apply_mobilization(o, rd::imin(army(s, mf) - 1, c.min_move), d, lane);
      action = rd::clamp_land(s.mob_to);
      break;
    }
    default: {
      // components of the owned lands in the order of their lowest land;
      // the best holds the largest interior stack (landFortifyFromAmount)
      const uint64_t outside = rd::kAll & ~owned;
      const uint64_t hout = ballot(
          rd::has(owned, lane) && (d.adj0 & outside) != 0,
          rd::has(owned, lane + 32) && (d.adj1 & outside) != 0);
      const uint64_t interior = owned & ~hout;
      int best_score = -1000000, best_c = 0;
      uint64_t best_comp = 0, rem = owned;
      bool any_amt = false;
      while (rem) {
        const int r = rd::low(rem);
        const uint64_t comp = connected_to(owned, r, d, lane);
        rem &= ~comp;
        const uint64_t in_c = comp & interior;
        const int amt = __reduce_max_sync(
            kFull, rd::imax(rd::has(in_c, lane) ? s.ar0 : 0,
                            rd::has(in_c, lane + 32) ? s.ar1 : 0));
        if (amt > 0) {
          any_amt = true;
          const int sc = amt * 64 - r;
          if (sc > best_score || (sc == best_score && r < best_c)) {
            best_score = sc;
            best_c = r;
            best_comp = comp;
          }
        }
      }
      // with no interior stack (any_amt false) nothing moves and the
      // action is the skip, whichever lands these pick
      const uint64_t src = interior & best_comp;
      const uint64_t dst = owned & best_comp & hout;
      const bool t2 = two(lane);
      const int f_from = argmax_lands(
          rd::has(src, lane) ? s.ar0 : -1,
          !t2 ? kNoLand : (rd::has(src, lane + 32) ? s.ar1 : -1), lane);
      const int f_to = argmax_lands(
          rd::has(dst, lane) ? rd::popc(d.adj0 & outside) : 0,
          !t2 ? kNoLand
              : (rd::has(dst, lane + 32) ? rd::popc(d.adj1 & outside) : 0),
          lane);
      const uint64_t owa = owned & at_least(s, 2, lane);
      const bool do_fortify = owa && any_amt && dst;
      if (do_fortify) {
        const int famt = rd::imax(
            rd::imin(army(s, f_from) - 1, c.army_max - army(s, f_to)), 0);
        add_army(o, f_from, -famt, lane);
        add_army(o, f_to, famt, lane);
      }
      end_turn<kCards>(o, d, u3, lane);
      action = do_fortify ? f_to : rd::kSkip;
      rec = s.phase != rd::kFortify || owa != 0;
      break;
    }
  }
  record = live && rec;
  if (live) {
    s = o;
    carry = nc;
  }
}

// ---------------------------------------------------------- RandomPlayer

// random_agent.random_step_recorded for one game: u0 the primary choice,
// u1 the secondary (attack or fortify source), u2 the amount or the
// mobilization coin, u3 the card draw (full cards), `die` the lane's die
// (lanes 0-4).  Uniform choices are masked_choice collectives, the
// fortify's component one BFS of OR-reductions.  The state advances only
// while the game runs; a finished game still yields its branch's action,
// with record = live.  Every branch is that of the plain version, each
// side effect in its order.
template <bool kCards>
__device__ __forceinline__ void random_step(
    WSt& s, float u0, float u1, float u2, float u3, int die, int& action,
    bool& record, const rd::Tables* __restrict__ t, const Board& d,
    const rd::Cfg& c, int lane) {
  const bool live = game_status(s, c) == rd::kNotEnded;
  const uint64_t owned = own_of(s, s.cur);
  WSt o = s;
  switch (s.phase) {
    case rd::kSetup: {
      const int li = masked_choice(owned, u0, lane);
      o.reinf -= 2;
      add_army(o, li, 2, lane);
      o.phase = rd::kSetupNeutral;
      action = li;
      break;
    }
    case rd::kSetupNeutral: {
      const int li = masked_choice(s.own[rd::kNeutral], u0, lane);
      add_army(o, li, 1, lane);
      o.round += 1;
      o.cur = 1 - o.cur;
      if (o.reinf == 0) {
        o.phase = rd::kReinforcement;
        o.reinf = reinforcement(own_of(o, o.cur), d);
      } else {
        o.phase = rd::kSetup;
      }
      action = li;
      break;
    }
    case rd::kReinforcement: {
      play_cards<kCards>(o, t, c, lane);
      // the choice reads the lands full before the trade, as the plain
      // version does
      const uint64_t full = owned & at_least(s, c.army_max, lane);
      const int li = masked_choice(owned & ~full, u0, lane);
      apply_reinforcement(o, li, 1, d, lane);
      action = li;
      break;
    }
    case rd::kAttack: {
      const uint64_t owa = owned & at_least(s, 2, lane);
      const int choice =
          masked_choice((~owned & nb_any(owa, d, lane)) | rd::kSkipBit, u0,
                        lane);
      if (choice == rd::kSkip) {
        o.phase = rd::kFortify;
      } else {
        // the armed owned neighbours of the target, from the lanes' own
        // adjacency rows (the board is symmetric)
        const uint64_t near =
            ballot(rd::has(d.adj0, choice),
                   two(lane) && rd::has(d.adj1, choice));
        const int frm = masked_choice(near & owa, u1, lane);
        int dice[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) dice[k] = __shfl_sync(kFull, die, k);
        int a1, d1, units;
        rd::battle(army(o, frm), army(o, choice), dice, a1, d1, units);
        apply_battle(o, frm, choice, a1, d1, units, d, lane);
      }
      action = choice;
      break;
    }
    case rd::kMobilization: {
      const int mf = rd::clamp_land(s.mob_from);
      if (u2 > 0.5f) {
        apply_mobilization(o, rd::imin(army(s, mf) - 1, c.min_move), d,
                           lane);
        action = rd::clamp_land(s.mob_to);
      } else {
        goto_attack(o, d, lane);
        action = mf;
      }
      break;
    }
    default: {
      const uint64_t full = owned & at_least(s, c.army_max, lane);
      const int fchoice =
          masked_choice((owned & ~full) | rd::kSkipBit, u0, lane);
      const bool f_skip = fchoice == rd::kSkip;
      const int fto = rd::clamp_land(fchoice);
      const uint64_t cand = connected_to(owned, fto, d, lane) &
                            ~rd::bit(fto) & owned & at_least(s, 2, lane);
      const int ffrom = masked_choice(cand, u1, lane);
      const int max_amt =
          rd::imin(army(s, ffrom) - 1, c.army_max - army(s, fto));
      const bool can = !f_skip && cand;
      const int ramt =
          can ? static_cast<int>(rd::fmul(u2, static_cast<float>(max_amt)))
              : 0;
      add_army(o, can ? ffrom : 0, -ramt, lane);
      add_army(o, can ? fto : 0, ramt, lane);
      end_turn<kCards>(o, d, u3, lane);
      action = f_skip ? rd::kSkip : fto;
      break;
    }
  }
  record = live;
  if (live) s = o;
}

}  // namespace rw
