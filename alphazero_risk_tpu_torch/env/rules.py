"""Vectorized Risk rules engine: legality, transition, termination.

Port of ``alphazero_risk_tpu/env/rules.py`` to PyTorch.  The canonical
transition is ``step(state, action, dice)`` over the 43-way action space,
applied to a whole batch of games in lockstep: every phase branch is
computed for every game and the results are blended per game with
``tree_select``, as in the JAX engine.  Randomness is explicit (``dice`` is
a ``[B, 5]`` tensor), so ``step`` is a pure function of its inputs and
bit-exact against the JAX ``step`` on the same inputs.

Tie-breaks are kept exactly: ``argmax``/``argmin`` return the first index
of the extreme value (as ``jnp.argmax`` does), and ``masked_choice``
truncates ``u * count`` toward zero.

The JAX engine has three fixpoint ``while_loop``s.  Here:

- ``connected_to`` and ``component_labels`` read the transitive closure of
  the owned-land subgraph, built by six squarings of its adjacency matrix
  (a fixed trip count: 2^6 = 64 hops >= 41, the longest possible path).
  The closure is the fixpoint both loops converge to, so the results are
  identical, and no iteration asks the host whether to go on.
- ``dfs_preorder_rank`` keeps its loop, with one host check per four DFS
  moves as the JAX body unrolls them.  A fixed bound (two moves per land,
  84) would cost some two thousand launches in every ``step``; the loop
  runs only for the few games that meet a fortify tie.

Both card modes run.  Under ``simple_cards`` a hand is a count; under
full cards (``simple_cards=False``) hands are per-territory masks, a turn's
earned card is drawn uniformly from the undrawn pile with the uniform
``u_card`` (the pile reshuffled from the cards in no hand when it is
empty), and a hand of more than three cards trades its best combo.  A
full-cards ``step`` needs ``u_card``; ``step_with_outcome`` and ``expand``
have none to give (as in the JAX engine, whose trace refuses there), so
they raise under full cards, and so does the search built on them.

On the card two kernels carry the engine (the game's own phase branch
only, the graph walks as mask walks):

- K7 (``csrc/rules_step.cu``, one warp per game): ``step``,
  ``step_with_outcome`` and ``expand`` (the child of a search tree's node,
  with its status and legality);
- K8 (``csrc/state_views.cu``, ``state_views``, one warp per game):
  ``legal_actions``, ``game_status`` and ``featurize``, any of them from
  one read.

CPU tensors take the plain versions (``_step_plain``,
``_step_with_outcome_plain``, ``_expand_plain``, ``_legal_actions_plain``,
``_game_status_plain``), which follow the JAX code; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import (
    Config,
    MAP_X,
    MAP_Y,
    NUM_ACTIONS,
    NUM_LANDS,
    PH_ATTACK,
    PH_ATTACK_MOBILIZATION,
    PH_FORTIFY,
    PH_REINFORCEMENT,
    PH_SETUP,
    PH_SETUP_NEUTRAL,
    SKIP_ACTION,
    STATUS_DRAW,
    STATUS_NOT_ENDED,
    NEUTRAL_PLAYER,
)
from . import topology
from .state import GameState, tree_map, tree_select

I32 = torch.int32

# Card-set reinforcement schedule (reference: state.cpp:1102-1111).
_GAIN = np.zeros(64, np.int32)
_GAIN[1:7] = [4, 6, 8, 10, 12, 15]
for _k in range(7, 64):
    _GAIN[_k] = 15 + (_k - 6) * 5
CARD_SET_GAIN = _GAIN


class Tables(NamedTuple):
    """The board tables as tensors on one device."""

    adj: torch.Tensor            # [42, 42] bool
    adj_f32: torch.Tensor        # [42, 42] f32
    neighbor_rank: torch.Tensor  # [42, 42] int32
    continent_mask_f32: torch.Tensor  # [6, 42] f32
    continent_size: torch.Tensor      # [6] int32
    continent_bonus: torch.Tensor     # [6] int32
    card_set_gain: torch.Tensor       # [64] int32
    land_idx: torch.Tensor            # [42] int32
    card_types: torch.Tensor          # [3, 42] bool: infantry, horse, siege


@functools.lru_cache(maxsize=None)
def tables(device: torch.device) -> Tables:
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return Tables(
        adj=t(topology.ADJACENCY, torch.bool),
        adj_f32=t(topology.ADJ_F32, torch.float32),
        neighbor_rank=t(topology.NEIGHBOR_RANK, I32),
        continent_mask_f32=t(topology.CONTINENT_MASK, torch.float32),
        continent_size=t(topology.CONTINENT_SIZE, I32),
        continent_bonus=t(topology.CONTINENT_BONUS, I32),
        card_set_gain=t(CARD_SET_GAIN, I32),
        land_idx=torch.arange(NUM_LANDS, dtype=I32, device=device),
        card_types=t(np.stack(CARD_TYPES), torch.bool),
    )


CARD_TYPES = (topology.CARD_INFANTRY, topology.CARD_HORSE,
              topology.CARD_SIEGE)

# What the JAX engine asserts when a full-cards turn ends without a card
# uniform (``rules.draw_card``).
NEEDS_UNIFORM = "full-cards draw needs a uniform"


def require_uniform(cfg: Config, u_card) -> None:
    """Raise unless ``u_card`` is given or the cards are simple."""
    if u_card is None and not cfg.simple_cards:
        raise ValueError(f"{NEEDS_UNIFORM}: a full-cards step takes u_card "
                         f"[B] (step_with_outcome, expand and the search "
                         f"have none, as in the JAX engine)")


# ---------------------------------------------------------------------------
# small tensor helpers: per-game gather / scatter on dim 1
# ---------------------------------------------------------------------------

def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[rows, idx] for x [B, K], idx [B]."""
    return x.gather(1, idx.long()[:, None]).squeeze(1)


def put(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Copy of x with x[rows, idx] = val."""
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    val = val.expand(idx.shape)[:, None]
    return x.scatter(1, idx.long()[:, None], val)


def add_at(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Copy of x with x[rows, idx] += val."""
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    val = val.expand(idx.shape)[:, None]
    return x.scatter_add(1, idx.long()[:, None], val)


def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum (``jnp.argmax``), as int32."""
    if x.dtype == torch.bool:
        x = x.to(I32)
    return torch.argmax(x, dim=dim).to(I32)


def masked_choice(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Uniform choice among set bits in ascending-index order (reference
    ``Utility::randomMask``, land.cpp:100-112).  Returns 0 on empty mask."""
    cnt = mask.sum(-1)
    n = (u * cnt).to(I32)
    n = torch.minimum(n.clamp(min=0), (cnt - 1).clamp(min=0))
    csum = torch.cumsum(mask.to(I32), dim=-1)
    hit = mask & (csum == (n + 1)[..., None])
    return argmax_first(hit)


def first_set_bit(mask: torch.Tensor) -> torch.Tensor:
    """Lowest set index (reference ``Utility::getFirstBitMask``)."""
    return argmax_first(mask)


def neighbors_any(x: torch.Tensor) -> torch.Tensor:
    """[B,42] bool -> [B,42] bool: lands adjacent to any set land."""
    return (x.to(torch.float32) @ tables(x.device).adj_f32) > 0.5


def neighbor_count(x: torch.Tensor) -> torch.Tensor:
    """[B,42] bool -> [B,42] int32: number of set neighbours per land."""
    return (x.to(torch.float32) @ tables(x.device).adj_f32).to(I32)


class PlayerMasks(NamedTuple):
    """Derived per-current-player masks (reference ``PlayerStatus``,
    state.h:59-84)."""

    owned: torch.Tensor
    enemy: torch.Tensor
    neutral: torch.Tensor
    owned_with_army: torch.Tensor
    owned_full: torch.Tensor
    attack_lands: torch.Tensor
    attack_lands_with_army: torch.Tensor
    enemy_attack_lands: torch.Tensor
    neutral_attack_lands: torch.Tensor


def player_masks(state: GameState, cfg: Config) -> PlayerMasks:
    p = state.cur_player[:, None]
    owned = state.owner == p
    enemy = state.owner == (1 - p)
    neutral = state.owner == NEUTRAL_PLAYER
    owned_with_army = owned & (state.army >= 2)
    owned_full = owned & (state.army >= cfg.land_army_max)
    attack_lands = ~owned & neighbors_any(owned)
    attack_lands_with_army = ~owned & neighbors_any(owned_with_army)
    enemy_attack = ~enemy & neighbors_any(enemy)
    neutral_attack = neighbors_any(neutral) & ~neutral
    return PlayerMasks(owned, enemy, neutral, owned_with_army, owned_full,
                       attack_lands, attack_lands_with_army, enemy_attack,
                       neutral_attack)


def calc_reinforcement(owned: torch.Tensor) -> torch.Tensor:
    """Turn-start reinforcement count (reference
    ``State::calculateReinforcementValue``, state.cpp:457-491)."""
    t = tables(owned.device)
    cnt = owned.sum(-1).to(I32)
    per_cont = (owned.to(torch.float32) @ t.continent_mask_f32.T).to(I32)
    bonus = torch.where(per_cont == t.continent_size, t.continent_bonus,
                        0).sum(-1).to(I32)
    return torch.clamp(cnt // 3 + bonus, min=3).to(I32)


def _game_status_plain(state: GameState, cfg: Config) -> torch.Tensor:
    """``game_status`` in plain PyTorch."""
    p0 = (state.owner == 0).sum(-1)
    p1 = (state.owner == 1).sum(-1)
    over = state.round > cfg.max_game_rounds
    by_count = torch.where(p0 > p1, 0, torch.where(p0 < p1, 1, STATUS_DRAW))
    status = torch.where(over, by_count, STATUS_NOT_ENDED)
    if cfg.allow_yield:
        status = torch.where(p1 >= 30, 1, status)
        status = torch.where(p0 >= 30, 0, status)
    status = torch.where(p1 == 0, 0, status)
    status = torch.where(p0 == 0, 1, status)
    return status.to(I32)


def _legal_actions_plain(state: GameState, cfg: Config) -> torch.Tensor:
    """``legal_actions`` in plain PyTorch."""
    m = player_masks(state, cfg)
    b = state.batch_size
    dev = state.device
    skip_only = torch.zeros((b, NUM_ACTIONS), dtype=torch.bool, device=dev)
    skip_only[:, SKIP_ACTION] = True
    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)

    def with_skip(lands):
        return torch.cat([lands, ones], dim=-1)

    def no_skip(lands):
        return torch.cat([lands, ~ones], dim=-1)

    base = m.owned & ~m.owned_full
    if cfg.limit_reinforcement_moves:
        border = base & (m.enemy_attack_lands | m.neutral_attack_lands)
        lands = torch.where(border.any(-1, keepdim=True), border, base)
    else:
        lands = base
    reinf_mask = torch.where(base.any(-1, keepdim=True), no_skip(lands),
                             skip_only)

    setup_neutral_mask = no_skip(m.neutral)

    if cfg.limit_attack_moves:
        attack_mask = torch.where(
            m.attack_lands_with_army.any(-1, keepdim=True),
            no_skip(m.attack_lands_with_army), skip_only)
    else:
        attack_mask = with_skip(m.attack_lands_with_army)

    idx = tables(dev).land_idx[None, :]
    mob_lands = (idx == state.mob_from[:, None]) | (
        idx == state.mob_to[:, None])
    mob_mask = no_skip(mob_lands)

    if cfg.limit_reinforcement_moves:
        fortify_mask = with_skip(m.owned & m.enemy_attack_lands)
    else:
        fortify_mask = with_skip(m.owned)

    ph = state.phase[:, None]
    return torch.where(
        (ph == PH_SETUP) | (ph == PH_REINFORCEMENT), reinf_mask,
        torch.where(ph == PH_SETUP_NEUTRAL, setup_neutral_mask,
                    torch.where(ph == PH_ATTACK, attack_mask,
                                torch.where(ph == PH_ATTACK_MOBILIZATION,
                                            mob_mask, fortify_mask))))


# ---------------------------------------------------------------------------
# Engine primitives (shared by the AZ action abstraction and the scripted
# opponent)
# ---------------------------------------------------------------------------

def goto_attack(state: GameState, cfg: Config) -> GameState:
    """Reference ``State::gotoAttack`` (state.cpp:20-40)."""
    s = state.replace(
        reinforcements=torch.zeros_like(state.reinforcements),
        mob_from=torch.full_like(state.mob_from, -1),
        mob_to=torch.full_like(state.mob_to, -1))
    m = player_masks(s, cfg)
    can_attack = m.attack_lands_with_army.any(-1)
    phase = torch.where(can_attack, PH_ATTACK, PH_FORTIFY).to(I32)
    return s.replace(phase=phase)


def draw_card(state: GameState, cfg: Config, u_card=None) -> GameState:
    """Reference ``State::drawCard`` (state.cpp:618-643).  Simple mode: the
    hand is a count.  Full mode: a uniform card (``u_card`` [B]) from the
    undrawn pile; an empty pile is reshuffled from the cards in no hand
    (the reference's duplicate-dealing reshuffle, state.cpp:627-632, is
    not reproduced, as in the JAX engine).  Games that earned no card keep
    their hands and pile."""
    if cfg.simple_cards:
        cards = add_at(state.cards, state.cur_player,
                       state.can_draw_card.to(I32))
        return state.replace(cards=cards)
    require_uniform(cfg, u_card)
    available = ~state.drawn_cards
    empty = ~available.any(-1, keepdim=True)
    in_hands = state.player_cards.any(1)
    avail = torch.where(empty, ~in_hands, available)
    drawn = torch.where(empty, in_hands, state.drawn_cards)
    card = masked_choice(avail, u_card)
    card_oh = tables(state.device).land_idx[None, :] == card[:, None]
    do = state.can_draw_card[:, None]
    hand = _hand(state)
    return state.replace(
        drawn_cards=torch.where(do, drawn | card_oh, state.drawn_cards),
        player_cards=_set_hand(state, torch.where(do, hand | card_oh, hand)))


def _hand(state: GameState) -> torch.Tensor:
    """[B, 42] bool: the current player's hand."""
    rows = torch.arange(state.batch_size, device=state.device)
    return state.player_cards[rows, state.cur_player.long()]


def _set_hand(state: GameState, hand: torch.Tensor) -> torch.Tensor:
    """Copy of ``player_cards`` with the current player's hand ``hand``."""
    mine = (torch.arange(2, device=state.device)[None, :]
            == state.cur_player[:, None])[..., None]
    return torch.where(mine, hand[:, None, :], state.player_cards)


def end_turn(state: GameState, cfg: Config, u_card=None) -> GameState:
    """Reference ``State::nextPlayerGameTurn`` (state.cpp:748-766): draw the
    earned card (full cards: with ``u_card``), advance the round, hand the
    turn and a fresh reinforcement budget to the opponent."""
    s = draw_card(state, cfg, u_card)
    nxt = (1 - s.cur_player).to(I32)
    s = s.replace(
        can_draw_card=torch.zeros_like(s.can_draw_card),
        round=s.round + 1,
        cur_player=nxt,
        attacks_during_turn=torch.zeros_like(s.attacks_during_turn),
        phase=torch.full_like(s.phase, PH_REINFORCEMENT),
    )
    owned_next = s.owner == nxt[:, None]
    return s.replace(reinforcements=calc_reinforcement(owned_next))


def play_cards(state: GameState, cfg: Config) -> GameState:
    """Card set trade-in (reference ``GameHelper::playCards`` dispatch,
    game_helper.cpp:3-17).

    Simple mode (state.cpp:1090-1117): trade 3 counted cards whenever >= 3
    are held.  Full mode: the best 3-card combo (``_best_combo``) when
    *more than* 3 are held, +2 armies on its first owned land with room
    (game_helper.cpp:111-208, state.cpp:1119-1177)."""
    if not cfg.simple_cards:
        return _play_cards_full(state, cfg)
    p = state.cur_player
    held = take(state.cards, p)
    play = held >= 3
    cards = add_at(state.cards, p, torch.where(play, -3, 0).to(I32))
    sets = state.card_sets_played + play.to(I32)
    gain = tables(state.device).card_set_gain[sets.clamp(0, 63).long()]
    gained = torch.where(play, gain, 0).to(I32)
    return state.replace(cards=cards, card_sets_played=sets,
                         reinforcements=state.reinforcements + gained)


def _lowest(mask: torch.Tensor, k) -> torch.Tensor:
    """The lowest ``k`` ([B] or int) set lands of each row of ``mask``."""
    k = torch.as_tensor(k, device=mask.device)
    return mask & (torch.cumsum(mask.to(I32), -1) <= k[..., None])


def _best_combo(hand: torch.Tensor, owned: torch.Tensor):
    """``GameHelper::getBestCombo`` (game_helper.cpp:145-208): ([B, 42]
    combo mask, [B] valid).  A same-type combo takes three cards of one
    type, the owned ones first, each group in ascending land order; the
    one-of-each combo the first owned card of each type, else its first
    card.  The most owned cards win, ties in the order infantry, horse,
    siege, one-of-each (the JAX engine's order: the reference's std::sort
    leaves equal keys unordered).  Only a hand of more than three cards
    trades."""
    types = tables(hand.device).card_types
    masks, scores = [], []
    each = torch.zeros_like(hand)
    each_valid = torch.ones(hand.shape[0], dtype=torch.bool,
                            device=hand.device)
    each_owned = torch.zeros(hand.shape[0], dtype=I32, device=hand.device)
    for t in range(3):
        ht = hand & types[t]
        ho = ht & owned
        n_own = ho.sum(-1).clamp(max=3)
        mask = _lowest(ho, 3) | _lowest(ht & ~owned, 3 - n_own)
        masks.append(mask)
        scores.append(torch.where(ht.sum(-1) >= 3, n_own, -1))
        each_valid = each_valid & ht.any(-1)
        has_o = ho.any(-1)
        each = each | _lowest(torch.where(has_o[:, None], ho, ht), 1)
        each_owned = each_owned + has_o.to(I32)
    masks.append(each)
    scores.append(torch.where(each_valid, each_owned, -1))
    scores = torch.stack(scores, -1)
    pos = torch.arange(4, device=hand.device)
    keyed = torch.where(scores >= 0, scores * 8 + (3 - pos), -1)
    best = argmax_first(keyed)
    combo = torch.stack(masks, 1).gather(
        1, best.long()[:, None, None].expand(-1, 1, NUM_LANDS))[:, 0]
    valid = (hand.sum(-1) > 3) & (keyed.amax(-1) >= 0)
    return combo & hand, valid


def _play_cards_full(state: GameState, cfg: Config) -> GameState:
    """``play_cards`` under full cards."""
    hand = _hand(state)
    owned = state.owner == state.cur_player[:, None]
    combo, play = _best_combo(hand, owned)
    # +2 on the first owned combo land with room (state.cpp:1145-1158)
    bonus_cand = combo & owned & (state.army + 2 <= cfg.land_army_max)
    do_bonus = play & bonus_cand.any(-1)
    army = add_at(state.army, first_set_bit(bonus_cand),
                  torch.where(do_bonus, 2, 0).to(I32))
    sets = state.card_sets_played + play.to(I32)
    gain = tables(state.device).card_set_gain[sets.clamp(0, 63).long()]
    return state.replace(
        army=army,
        player_cards=_set_hand(state, torch.where(play[:, None],
                                                  hand & ~combo, hand)),
        card_sets_played=sets,
        reinforcements=state.reinforcements
        + torch.where(play, gain, 0).to(I32))


def _move_amount(budget: torch.Tensor, cfg: Config) -> torch.Tensor:
    """FAST_ATTACK_MOBILIZATION half-stack sizing
    (reference alphazero_moves.cpp:108-118,153-164)."""
    if cfg.fast_attack_mobilization:
        half = budget // 2
        return torch.where(half < cfg.min_unit_move,
                           budget.clamp(max=cfg.min_unit_move), half)
    return budget.clamp(max=cfg.min_unit_move)


def battle(army_from: torch.Tensor, army_to: torch.Tensor,
           dice: torch.Tensor):
    """One max-dice battle round (reference ``State::attackMove`` core,
    state.cpp:822-857).  Returns (new_from, new_to, occupying_units)."""
    dev = army_from.device
    att_n = torch.where(army_from >= 4, 3, torch.where(army_from == 3, 2, 1))
    def_n = torch.where(army_to >= 2, 2, 1)
    lane3 = torch.arange(3, device=dev)[None, :]
    lane2 = torch.arange(2, device=dev)[None, :]
    att = torch.where(lane3 < att_n[:, None], dice[:, :3], 0)
    att = torch.sort(att, dim=-1, descending=True).values
    dfn = torch.where(lane2 < def_n[:, None], dice[:, 3:], 0)
    dfn = torch.sort(dfn, dim=-1, descending=True).values

    win1 = att[:, 0] > dfn[:, 0]
    second = (att_n >= 2) & (def_n == 2)
    win2 = second & (att[:, 1] > dfn[:, 1])
    lose2 = second & ~(att[:, 1] > dfn[:, 1])

    d_new = army_to - win1.to(I32) - win2.to(I32)
    a_new = army_from - (~win1).to(I32) - lose2.to(I32)
    units = att_n - (~win1).to(I32) - lose2.to(I32)
    return a_new.to(I32), d_new.to(I32), units.to(I32)


def apply_reinforcement(state: GameState, li: torch.Tensor,
                        amount: torch.Tensor, cfg: Config) -> GameState:
    """Reference ``State::reinforcementMove`` (state.cpp:976-998)."""
    s = state.replace(reinforcements=state.reinforcements - amount,
                      army=add_at(state.army, li, amount))
    return tree_select(s.reinforcements == 0, goto_attack(s, cfg), s)


def _apply_battle(state: GameState, frm, li, a1, d1, units,
                  cfg: Config) -> GameState:
    """Casualties, conquest / mobilization entry, card-draw flag and
    auto-FORTIFY after one resolved battle (state.cpp:769-918)."""
    p = state.cur_player
    conquest = d1 == 0
    a2 = torch.where(conquest, a1 - units, a1)
    mob = conquest & (a2 > 1)
    army = put(state.army, frm, a2)
    army = put(army, li, torch.where(conquest, units, d1))
    s = state.replace(
        attacks_during_turn=state.attacks_during_turn + 1,
        army=army,
        owner=put(state.owner, li,
                  torch.where(conquest, p, take(state.owner, li))),
        can_draw_card=state.can_draw_card | conquest,
        phase=torch.where(mob, PH_ATTACK_MOBILIZATION, state.phase).to(I32),
        mob_from=torch.where(mob, frm, state.mob_from).to(I32),
        mob_to=torch.where(mob, li, state.mob_to).to(I32),
    )
    m = player_masks(s, cfg)
    stuck = (s.phase == PH_ATTACK) & ~m.attack_lands_with_army.any(-1)
    return s.replace(phase=torch.where(stuck, PH_FORTIFY, s.phase).to(I32))


def apply_attack(state: GameState, frm: torch.Tensor, li: torch.Tensor,
                 dice: torch.Tensor, cfg: Config) -> GameState:
    """Resolve one battle from ``frm`` onto ``li`` (reference
    ``State::attackMove``, state.cpp:769-918)."""
    a1, d1, units = battle(take(state.army, frm), take(state.army, li), dice)
    return _apply_battle(state, frm, li, a1, d1, units, cfg)


def apply_mobilization(state: GameState, amount: torch.Tensor,
                       cfg: Config) -> GameState:
    """Reference ``State::attackReinforcementMove`` (state.cpp:920-947)."""
    mf = state.mob_from.clamp(0, NUM_LANDS - 1)
    mt = state.mob_to.clamp(0, NUM_LANDS - 1)
    army = add_at(add_at(state.army, mf, -amount), mt, amount)
    s = state.replace(army=army)
    return tree_select(take(army, mf) == 1, goto_attack(s, cfg), s)


def apply_fortify(state: GameState, frm: torch.Tensor, li: torch.Tensor,
                  amount: torch.Tensor) -> GameState:
    """Reference ``State::fortifyMove`` (state.cpp:949-974)."""
    return state.replace(
        army=add_at(add_at(state.army, frm, -amount), li, amount))


def battle_comparisons(army_from: torch.Tensor, army_to: torch.Tensor):
    """(att_n, def_n, ncomp) for a battle."""
    att_n = torch.where(army_from >= 4, 3, torch.where(army_from == 3, 2, 1))
    def_n = torch.where(army_to >= 2, 2, 1)
    ncomp = torch.where((att_n >= 2) & (def_n == 2), 2, 1)
    return att_n.to(I32), def_n.to(I32), ncomp.to(I32)


def battle_with_outcome(army_from: torch.Tensor, army_to: torch.Tensor,
                        outcome: torch.Tensor):
    """Deterministic battle resolution given the outcome index (= number
    of attacker losses, in [0, ncomp])."""
    att_n, def_n, ncomp = battle_comparisons(army_from, army_to)
    two = ncomp == 2
    w1 = (outcome == 0) | ((outcome == 1) & two)
    w2 = outcome == 0
    d_loss = w1.to(I32) + (w2 & two).to(I32)
    a_loss = (~w1).to(I32) + (~w2 & two).to(I32)
    return ((army_from - a_loss).to(I32), (army_to - d_loss).to(I32),
            (att_n - a_loss).to(I32))


def apply_attack_outcome(state: GameState, frm: torch.Tensor,
                         li: torch.Tensor, outcome: torch.Tensor,
                         cfg: Config) -> GameState:
    """``apply_attack`` with a forced outcome instead of dice."""
    a1, d1, units = battle_with_outcome(take(state.army, frm),
                                        take(state.army, li), outcome)
    return _apply_battle(state, frm, li, a1, d1, units, cfg)


def _step_with_outcome_plain(state: GameState, action: torch.Tensor,
                             outcome: torch.Tensor, cfg: Config) -> GameState:
    """``step_with_outcome`` in plain PyTorch."""
    dummy_dice = torch.ones((state.batch_size, 5), dtype=I32,
                            device=state.device)
    out = _step_plain(state, action, dummy_dice, cfg)
    masks = player_masks(state, cfg)
    li = action.clamp(0, NUM_LANDS - 1)
    frm = best_attack_from(state, li, masks.owned_with_army)
    s_attack = apply_attack_outcome(state, frm, li, outcome, cfg)
    use_attack = (state.phase == PH_ATTACK) & (action != SKIP_ACTION) & (
        _game_status_plain(state, cfg) == STATUS_NOT_ENDED)
    return tree_select(use_attack, s_attack, out)


def best_attack_from_army(army: torch.Tensor, target: torch.Tensor,
                          owned_with_army: torch.Tensor) -> torch.Tensor:
    """Source-land selection for an attack action (reference
    alphazero_moves.cpp:122-144): the owned neighbour of ``target`` with the
    largest army, first-in-neighbour-list on ties."""
    t = tables(army.device)
    tl = target.long()
    cand = t.adj[tl] & owned_with_army
    score = torch.where(cand, (army - 1) * 8 - t.neighbor_rank[tl], -1)
    return argmax_first(score)


def best_attack_from(state: GameState, target: torch.Tensor,
                     owned_with_army: torch.Tensor) -> torch.Tensor:
    return best_attack_from_army(state.army, target, owned_with_army)


def _owned_reach(owned: torch.Tensor) -> torch.Tensor:
    """[B,42,42] bool: j reachable from i inside the owned subgraph (i
    reaches itself when owned).  Six squarings cover 64 >= 41 hops."""
    t = tables(owned.device)
    o = owned.to(torch.float32)
    m = t.adj_f32 * o[:, :, None] * o[:, None, :]
    m = m + torch.diag_embed(o)
    for _ in range(6):
        m = (torch.bmm(m, m) > 0.5).to(torch.float32)
    return m > 0.5


def connected_to(owned: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """[B,42] bool: owned lands in the same component as land ``src``
    (empty when ``src`` is not owned)."""
    reach = _owned_reach(owned)
    rows = torch.arange(owned.shape[0], device=owned.device)
    return reach[rows, src.long()] & owned


def component_labels(owned: torch.Tensor) -> torch.Tensor:
    """[B,42] int32: per-land component label = lowest reachable land index
    within the owned subgraph (self-label for unowned lands)."""
    idx = tables(owned.device).land_idx[None, :]
    return torch.where(owned, first_set_bit(_owned_reach(owned)),
                       idx).to(I32)


def dfs_preorder_rank(owned: torch.Tensor, root: torch.Tensor,
                      active: torch.Tensor | None = None,
                      until: torch.Tensor | None = None) -> torch.Tensor:
    """[B,42] DFS pre-order rank within the flood-fill component of
    ``root`` (reference ``GameHelper::LandSetMovement::add``,
    game_helper.cpp:51-82).  Rank 0 = root; NUM_LANDS outside the
    component.

    Stackless DFS: advance to the first unvisited owned neighbour (by
    NEIGHBOR_RANK), else backtrack via parent pointers.  ``active`` [B]
    admits games; ``until`` [B,42] stops a game once every target has a
    rank (ranks beyond are unspecified), as in the JAX engine.
    """
    t = tables(owned.device)
    b = owned.shape[0]
    idx = t.land_idx[None, :]
    at_root = take(owned, root)
    if active is not None:
        at_root = at_root & active
    visited = (idx == root[:, None]) & owned
    rank = torch.where(visited & at_root[:, None], 0, NUM_LANDS).to(I32)
    parent = torch.full((b, NUM_LANDS), -1, dtype=I32, device=owned.device)
    cur = torch.where(at_root, root, -1).to(I32)
    if until is not None:
        cur = torch.where((until & ~visited).any(-1), cur, -1).to(I32)
    count = at_root.to(I32)

    def advance(cur, visited, rank, parent, count):
        run = cur >= 0
        cs = cur.clamp(min=0).long()
        nbr = t.adj[cs] & owned & ~visited
        has = nbr.any(-1) & run
        r = torch.where(nbr, t.neighbor_rank[cs], topology.MAX_DEGREE)
        nxt = torch.argmin(r, dim=-1).to(I32)
        new_cur = torch.where(has, nxt,
                              torch.where(run, take(parent, cs), -1))
        hit = has[:, None] & (idx == nxt[:, None])
        visited = visited | hit
        if until is not None:
            new_cur = torch.where((until & ~visited).any(-1), new_cur, -1)
        return (new_cur.to(I32), visited,
                torch.where(hit, count[:, None], rank),
                torch.where(hit, cs.to(I32)[:, None], parent),
                count + has.to(I32))

    c = (cur, visited, rank, parent, count)
    while bool((c[0] >= 0).any()):
        for _ in range(4):
            c = advance(*c)
    return c[2]


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------

def _fortify_sources(state: GameState, li: torch.Tensor,
                     owned: torch.Tensor):
    """(the owned component of the fortify target ``li``, the source
    candidates: its other lands with 2+ armies and no enemy neighbour, or
    failing those its border ones)."""
    comp = connected_to(owned, li)
    idx = tables(state.device).land_idx[None, :]
    cand = comp & (idx != li[:, None]) & (state.army >= 2)
    has_enemy_neighbor = neighbor_count(~owned) > 0
    interior = cand & ~has_enemy_neighbor
    border = cand & has_enemy_neighbor
    return comp, torch.where(interior.any(-1)[:, None], interior, border)


def _fortify_ties(state: GameState, is_skip, target_full, pick, running):
    """(the candidates holding the most armies, [B] bool: the games whose
    fortify move needs the DFS tie-break)."""
    top = torch.where(pick, state.army, -1).amax(-1)
    tied = pick & (state.army == top[:, None])
    return tied, ((state.phase == PH_FORTIFY) & running & ~is_skip
                  & ~target_full & (tied.sum(-1) >= 2))


def fortify_needs_rank(state: GameState, action: torch.Tensor,
                       cfg: Config) -> torch.Tensor:
    """[B] bool: the games where ``step`` with ``action`` is a fortify move
    whose most-armed source candidates tie, so that only the reference's
    DFS order picks the source (plain PyTorch on any device)."""
    li = action.clamp(0, NUM_LANDS - 1)
    _, pick = _fortify_sources(state, li, player_masks(state, cfg).owned)
    running = _game_status_plain(state, cfg) == STATUS_NOT_ENDED
    return _fortify_ties(state, action == SKIP_ACTION,
                         take(state.army, li) >= cfg.land_army_max, pick,
                         running)[1]


def _step_plain(state: GameState, action: torch.Tensor, dice: torch.Tensor,
                cfg: Config, u_card=None) -> GameState:
    """``step`` in plain PyTorch: every phase branch for every game,
    blended by phase."""
    action = action.to(I32)
    li = action.clamp(0, NUM_LANDS - 1)
    is_skip = action == SKIP_ACTION
    masks = player_masks(state, cfg)
    p = state.cur_player

    # ---- SETUP: place 2 on own land, to SETUP_NEUTRAL ----
    s_setup = state.replace(
        reinforcements=state.reinforcements - 2,
        army=add_at(state.army, li, 2),
        phase=torch.full_like(state.phase, PH_SETUP_NEUTRAL),
    )

    # ---- SETUP_NEUTRAL: +1 on a neutral land, next setup turn ----
    sn = state.replace(
        army=add_at(state.army, li, 1),
        round=state.round + 1,
        cur_player=(1 - p).to(I32),
    )
    setup_done = sn.reinforcements == 0
    owned_next = sn.owner == sn.cur_player[:, None]
    s_setup_neutral = sn.replace(
        phase=torch.where(setup_done, PH_REINFORCEMENT, PH_SETUP).to(I32),
        reinforcements=torch.where(setup_done,
                                   calc_reinforcement(owned_next),
                                   sn.reinforcements).to(I32),
    )

    # ---- REINFORCEMENT (alphazero_moves.cpp:104-121) ----
    sr = play_cards(state, cfg)
    amount = _move_amount(sr.reinforcements, cfg)
    amount = torch.minimum(amount, cfg.land_army_max - take(sr.army, li))
    sr = apply_reinforcement(sr, li, amount, cfg)
    s_reinf = tree_select(is_skip, goto_attack(state, cfg), sr)

    # ---- ATTACK (alphazero_moves.cpp:122-145, state.cpp:769-918) ----
    frm = best_attack_from(state, li, masks.owned_with_army)
    sa = apply_attack(state, frm, li, dice, cfg)
    s_attack = tree_select(
        is_skip, state.replace(phase=torch.full_like(state.phase,
                                                     PH_FORTIFY)), sa)

    # ---- ATTACK_MOBILIZATION (alphazero_moves.cpp:146-171) ----
    mf = state.mob_from.clamp(0, NUM_LANDS - 1)
    mamount = _move_amount(take(state.army, mf) - 1, cfg)
    s_mob = tree_select(action == state.mob_from,
                        goto_attack(state, cfg),
                        apply_mobilization(state, mamount, cfg))

    # ---- FORTIFY (alphazero_moves.cpp:172-231) ----
    target_full = take(state.army, li) >= cfg.land_army_max
    comp, pick_from_mask = _fortify_sources(state, li, masks.owned)
    # First-strict-max over the reference's DFS pre-order (see the JAX
    # engine): the DFS runs only for games really in this decision that
    # have an army tie among the max candidates.
    running = _game_status_plain(state, cfg) == STATUS_NOT_ENDED
    if cfg.exact_fortify_tiebreak:
        tied, need_rank = _fortify_ties(state, is_skip, target_full,
                                        pick_from_mask, running)
        pre_rank = dfs_preorder_rank(masks.owned, first_set_bit(comp),
                                     active=need_rank, until=tied)
        score = torch.where(pick_from_mask,
                            state.army * 64 + (NUM_LANDS - pre_rank), -1)
    else:
        score = torch.where(pick_from_mask, state.army, -1)
    f_from = argmax_first(score)
    can_move = pick_from_mask.any(-1) & ~target_full & ~is_skip
    famount = torch.minimum(take(state.army, f_from) - 1,
                            cfg.land_army_max - take(state.army, li))
    famount = torch.where(can_move, famount, 0).to(I32)
    sf = state.replace(
        army=add_at(add_at(state.army, f_from, -famount), li, famount))
    s_fortify = end_turn(sf, cfg, u_card)

    # ---- blend by phase ----
    ph = state.phase
    out = tree_select(ph == PH_SETUP, s_setup, s_fortify)
    out = tree_select(ph == PH_SETUP_NEUTRAL, s_setup_neutral, out)
    out = tree_select(ph == PH_REINFORCEMENT, s_reinf, out)
    out = tree_select(ph == PH_ATTACK, s_attack, out)
    out = tree_select(ph == PH_ATTACK_MOBILIZATION, s_mob, out)

    # Terminal games are frozen.
    return tree_select(~running, state, out)


def roll_dice(generator: torch.Generator, batch_size: int) -> torch.Tensor:
    """[B, 5] dice in [1, 6] for one step, on the generator's device."""
    return torch.randint(1, 7, (batch_size, 5), generator=generator,
                         device=generator.device, dtype=I32)


def step_key(state: GameState, action: torch.Tensor,
             generator: torch.Generator, cfg: Config) -> GameState:
    """``step`` with its randomness drawn from ``generator``: the dice
    ([B, 5], ``roll_dice``), then under full cards ``u_card`` ([B]
    uniforms)."""
    b = state.batch_size
    dice = roll_dice(generator, b).to(state.device)
    u_card = None if cfg.simple_cards else torch.rand(
        (b,), generator=generator, device=generator.device).to(state.device)
    return step(state, action, dice, cfg, u_card)


# ---------------------------------------------------------------------------
# The public engine: K7 and K8 on the card, the plain versions on the CPU
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_tables(device: torch.device) -> torch.Tensor:
    """The board tables of the rules kernels, packed as ``rd::Tables`` of
    ``csrc/rules_dev.cuh`` (2,752 bytes, uint8) on ``device``."""
    bits = np.uint64(1) << np.arange(NUM_LANDS, dtype=np.uint64)

    def masks(rows):
        return (np.asarray(rows, bool) * bits).sum(-1, dtype=np.uint64)

    parts = [masks(topology.ADJACENCY).astype("<u8"),
             masks(topology.CONTINENT_MASK).astype("<u8"),
             masks(CARD_TYPES).astype("<u8"),
             topology.CONTINENT_SIZE.astype("<i4"),
             topology.CONTINENT_BONUS.astype("<i4"),
             CARD_SET_GAIN.astype("<i4"),
             topology.CONTINENT_TIE_RANK.astype("<i4"),
             topology.NEIGHBOR_RANK.astype("<i1"),
             topology.SCRIPT_LAND_RANK.astype("<i1")]
    buf = np.concatenate([p.ravel().view(np.uint8) for p in parts])
    if buf.size != 2752:
        raise AssertionError("kernel_tables no longer matches rd::Tables")
    adj = np.asarray(topology.ADJACENCY, bool)
    if not (adj == adj.T).all():
        # csrc/rules_warp.cuh tests "j neighbours i" on j's own row
        raise AssertionError("the rules kernels need a symmetric adjacency")
    return torch.from_numpy(buf).to(device)


# kernel_tables' device pointer by device index: a dict lookup on an int
# costs less than hashing a torch.device on every launch.
_TABLES_PTR: dict = {}


def tables_ptr(device: torch.device) -> int:
    """The device pointer of ``kernel_tables(device)``."""
    p = _TABLES_PTR.get(device.index)
    if p is None:
        p = _TABLES_PTR[device.index] = kernel_tables(device).data_ptr()
    return p


# kernel_flags by Config object: (the Config, its flags).  The identity
# check rules out an id reused by another object; a Config is frozen, so a
# cached entry never goes stale.
_FLAGS: dict = {}


def kernel_flags(cfg: Config) -> tuple:
    """The trailing ints of the rules kernels: land_army_max,
    min_unit_move, max_game_rounds and the switch bits (bit 5: full
    cards)."""
    hit = _FLAGS.get(id(cfg))
    if hit is not None and hit[0] is cfg:
        return hit[1]
    flags = (int(cfg.allow_yield) | int(cfg.limit_reinforcement_moves) << 1
             | int(cfg.limit_attack_moves) << 2
             | int(cfg.fast_attack_mobilization) << 3
             | int(cfg.exact_fortify_tiebreak) << 4
             | int(not cfg.simple_cards) << 5)
    out = (cfg.land_army_max, cfg.min_unit_move, cfg.max_game_rounds, flags)
    if len(_FLAGS) > 64:
        _FLAGS.clear()
    _FLAGS[id(cfg)] = (cfg, out)
    return out


B8 = torch.bool
# The first 12 fields of GameState, as the kernels read them: name, type,
# shape after the game (and node) axes.
STATE_SPEC = (("owner", I32, (NUM_LANDS,)), ("army", I32, (NUM_LANDS,)),
              ("phase", I32, ()), ("round", I32, ()),
              ("cur_player", I32, ()), ("reinforcements", I32, ()),
              ("cards", I32, (2,)), ("card_sets_played", I32, ()),
              ("mob_from", I32, ()), ("mob_to", I32, ()),
              ("can_draw_card", B8, ()), ("attacks_during_turn", I32, ()))
CARDS_SPEC = (("player_cards", B8, (2, NUM_LANDS)),
              ("drawn_cards", B8, (NUM_LANDS,)))
# What K8 reads.
VIEW_FIELDS = ("owner", "army", "phase", "round", "cur_player", "mob_from",
               "mob_to", "can_draw_card", "attacks_during_turn")
VIEW_SPEC = tuple(f for f in STATE_SPEC if f[0] in VIEW_FIELDS)


def checked(t: torch.Tensor, dtype, shape, what: str) -> torch.Tensor:
    """``t`` if it is a contiguous CUDA tensor of ``dtype`` and ``shape``;
    else raise (what a kernel takes)."""
    if (not t.is_cuda or t.dtype != dtype or t.shape != shape
            or not t.is_contiguous()):
        raise ValueError(f"{what}: a contiguous CUDA {dtype} tensor of shape "
                         f"{tuple(shape)} is needed, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def state_fields(state: GameState, lead: tuple, spec=STATE_SPEC):
    """The tensors of ``spec``'s fields of ``state``, each checked against
    its type and the shape ``lead`` + its own."""
    return [checked(getattr(state, name), dtype, lead + tail, name)
            for name, dtype, tail in spec]


@functools.lru_cache(maxsize=None)
def _layout(spec) -> tuple:
    """``spec``'s fields grouped by type: (type, names, shapes after the
    game axis, elements per game, their sum)."""
    groups = {}
    for name, dtype, tail in spec:
        groups.setdefault(dtype, []).append((name, tail, math.prod(tail)))
    return tuple((dtype, *zip(*fields), sum(f[2] for f in fields))
                 for dtype, fields in groups.items())


def empty_fields(b: int, device, spec=STATE_SPEC) -> dict:
    """Fresh contiguous [b, *shape] tensors of ``spec``'s fields by name,
    cut from one allocation per type by one ``split_with_sizes``: a
    wrapper's allocations and views cost more than the rules kernels
    run."""
    out = {}
    for dtype, names, tails, sizes, total in _layout(spec):
        parts = torch.split_with_sizes(
            torch.empty(b * total, dtype=dtype, device=device),
            [b * n for n in sizes])
        for name, tail, t in zip(names, tails, parts):
            out[name] = t.view((b,) + tail) if tail else t
    return out


def launch_rules(kernel, states: GameState, lead: tuple, pre: tuple,
                 outs: tuple, cfg: Config):
    """Launch a rules kernel (K7, K9, K10) whose C arguments are: the 12
    state fields of ``states`` (each of shape ``lead`` + its own), ``pre``
    (pointers and ints), the 12 state fields of the B results, the
    outputs that ``outs`` describes ((name, type, shape after B), or None
    for a null pointer), the packed tables, B and ``kernel_flags(cfg)``.  Returns the
    resulting GameState (with the card masks of ``outs``, else those of
    ``states``) and every fresh output by name."""
    flags = kernel_flags(cfg)
    b, dev = lead[0], states.phase.device
    ins = state_fields(states, lead)
    new = empty_fields(b, dev, STATE_SPEC + tuple(o for o in outs if o))
    if b:
        kernel.launch(
            *(t.data_ptr() for t in ins), *pre,
            *(new[name].data_ptr() for name, _, _ in STATE_SPEC),
            *(new[o[0]].data_ptr() if o else None for o in outs),
            tables_ptr(dev), b, *flags)
    result = GameState(
        **{name: new[name] for name, _, _ in STATE_SPEC},
        player_cards=new.get("player_cards", states.player_cards),
        drawn_cards=new.get("drawn_cards", states.drawn_cards))
    return result, new


def card_io(states: GameState, lead: tuple, cfg: Config):
    """The card masks' part of a rules kernel's arguments: (the pointers of
    ``states``' player_cards and drawn_cards, the outputs for
    ``launch_rules``) under full cards; nulls under simple cards, whose
    masks never change (the result keeps ``states``')."""
    if cfg.simple_cards:
        return (None, None), (None, None)
    return (tuple(t.data_ptr()
                  for t in state_fields(states, lead, CARDS_SPEC)),
            CARDS_SPEC)


# K7's extra outputs in expand mode: the child's card masks (copied from
# its node), its status and its legal mask.  In step mode the card masks
# are written under full cards only (``card_io``).
EXPAND_OUTS = CARDS_SPEC + (("status", I32, ()),
                            ("legal", B8, (NUM_ACTIONS,)))


def _launch_step(states: GameState, action: torch.Tensor, cfg: Config, *,
                 dice=None, outcome=None, node=None, u_card=None):
    """K7.  ``states`` holds B games; or, with ``node`` [B], the [B, N]
    node states of a tree (game b steps node ``max(node[b], 0)``), and
    then the result comes with its status and legal mask."""
    if node is None:
        b, n = states.batch_size, 1
        lead = (b,)
    else:
        b, n = node.shape[0], states.phase.shape[1]
        lead = (b, n)
        checked(node, I32, (b,), "node")
    cards = state_fields(states, lead, CARDS_SPEC)
    if action.dtype != I32:
        action = action.to(I32)
    checked(action, I32, (b,), "action")
    if dice is not None:
        checked(dice, I32, (b, 5), "dice")
    if outcome is not None:
        if outcome.dtype != I32:
            outcome = outcome.to(I32)
        checked(outcome, I32, (b,), "outcome")
    if u_card is not None:
        checked(u_card, torch.float32, (b,), "u_card")
    outs = (EXPAND_OUTS if node is not None
            else card_io(states, lead, cfg)[1] + (None, None))
    P = kernels.ptr
    result, new = launch_rules(
        kernels.RULES_STEP, states, lead,
        (*(t.data_ptr() for t in cards), P(node), n, action.data_ptr(),
         P(dice), P(outcome), P(u_card)), outs, cfg)
    return result if node is None else (result, new["status"], new["legal"])


def step(state: GameState, action: torch.Tensor, dice: torch.Tensor,
         cfg: Config, u_card: torch.Tensor | None = None) -> GameState:
    """Apply one 43-way action per game (reference ``UtilityNN::makeMove``,
    alphazero_moves.cpp:72-233).

    ``action`` in [0, 43); 42 is skip/end-phase.  ``dice`` is [B, 5] in
    [1, 6], consumed only by attack resolutions; ``u_card`` [B] float32
    draws the card a fortify move's turn end earns (full cards only, where
    it is required; ignored under simple cards).  Terminal games are left
    unchanged.  CUDA tensors launch K7; CPU tensors take ``_step_plain``.
    """
    if cfg.simple_cards:
        u_card = None
    require_uniform(cfg, u_card)
    if state.device.type == "cpu":
        return _step_plain(state, action, dice, cfg, u_card)
    return _launch_step(state, action, cfg, dice=dice, u_card=u_card)


def step_with_outcome(state: GameState, action: torch.Tensor,
                      outcome: torch.Tensor, cfg: Config) -> GameState:
    """``step`` with battle randomness replaced by an explicit outcome
    index.  Non-attack phases ignore ``outcome``.  Used inside MCTS; simple
    cards only (``require_uniform``).  CUDA tensors launch K7; CPU tensors
    take ``_step_with_outcome_plain``."""
    require_uniform(cfg, None)
    if state.device.type == "cpu":
        return _step_with_outcome_plain(state, action, outcome, cfg)
    return _launch_step(state, action, cfg, outcome=outcome)


def _expand_plain(states: GameState, node: torch.Tensor,
                  action: torch.Tensor, outcome: torch.Tensor, cfg: Config):
    """``expand`` in plain PyTorch: gather, step, status, legality."""
    rows = torch.arange(node.shape[0], device=node.device)
    n = node.clamp(min=0).long()
    parent = tree_map(lambda x: x[rows, n], states)
    child = _step_with_outcome_plain(parent, action, outcome, cfg)
    return (child, _game_status_plain(child, cfg),
            _legal_actions_plain(child, cfg))


def expand(states: GameState, node: torch.Tensor, action: torch.Tensor,
           outcome: torch.Tensor, cfg: Config):
    """The children of one node per game of a search tree: ``states`` are
    the tree's [B, N] node states, game b steps node ``max(node[b], 0)``
    with ``action[b]`` and battle outcome ``outcome[b]``.  Returns
    ``(child GameState, status [B] int32, legal [B, 43] bool)``.  Simple
    cards only, as ``step_with_outcome``.  CUDA tensors launch K7 once;
    CPU tensors take ``_expand_plain``."""
    require_uniform(cfg, None)
    if states.device.type == "cpu":
        return _expand_plain(states, node, action, outcome, cfg)
    return _launch_step(states, action, cfg, outcome=outcome, node=node)


def _state_views_plain(state: GameState, cfg: Config, legal: bool,
                       status: bool, features: bool) -> tuple:
    # featurize imports this module, so its plain version is fetched here
    from .featurize import _featurize_plain
    return tuple(fn(state, cfg) for want, fn in (
        (legal, _legal_actions_plain), (status, _game_status_plain),
        (features, _featurize_plain)) if want)


def state_views(state: GameState, cfg: Config, *, legal: bool = False,
                status: bool = False, features: bool = False) -> tuple:
    """Any of ``legal_actions`` [B, 43] bool, ``game_status`` [B] int32 and
    ``featurize`` [B, 7, 6, F] f32 of ``state``, in that order, from one
    read of each game (kernel K8).  CPU tensors take the plain versions."""
    if state.device.type == "cpu":
        return _state_views_plain(state, cfg, legal, status, features)
    b, dev = state.batch_size, state.phase.device
    ins = state_fields(state, (b,), VIEW_SPEC)
    outs = (torch.empty((b, NUM_ACTIONS), dtype=B8, device=dev)
            if legal else None,
            torch.empty((b,), dtype=I32, device=dev) if status else None,
            torch.empty((b, MAP_Y, MAP_X, cfg.num_features),
                        dtype=torch.float32, device=dev)
            if features else None)
    if b:
        army_max, _, max_rounds, flags = kernel_flags(cfg)
        P = kernels.ptr
        kernels.STATE_VIEWS.launch(
            *(t.data_ptr() for t in ins), tables_ptr(dev),
            *(P(t) for t in outs), b, army_max, max_rounds, flags,
            cfg.feature_version)
    return tuple(t for t in outs if t is not None)


def legal_actions(state: GameState, cfg: Config) -> torch.Tensor:
    """[B, 43] bool legality mask (reference ``UtilityNN::getValidMoves``,
    alphazero_moves.cpp:3-70).  K8 on the card."""
    return state_views(state, cfg, legal=True)[0]


def game_status(state: GameState, cfg: Config) -> torch.Tensor:
    """[B] int32: -1 running, -2 draw, else winner index
    (reference ``State::gameStatus``, state.cpp:518-565).  K8 on the
    card."""
    return state_views(state, cfg, status=True)[0]
