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

Only the simple-cards rules are ported: ``simple_cards=False`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import (
    Config,
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
from .state import GameState, tree_select

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
    )


def _check_cfg(cfg: Config) -> None:
    if not cfg.simple_cards:
        raise NotImplementedError(
            "the port runs the simple-cards rules only (simple_cards=True)")


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


def game_status(state: GameState, cfg: Config) -> torch.Tensor:
    """[B] int32: -1 running, -2 draw, else winner index
    (reference ``State::gameStatus``, state.cpp:518-565)."""
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


def legal_actions(state: GameState, cfg: Config) -> torch.Tensor:
    """[B, 43] bool legality mask (reference ``UtilityNN::getValidMoves``,
    alphazero_moves.cpp:3-70)."""
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


def draw_card(state: GameState, cfg: Config) -> GameState:
    """Reference ``State::drawCard`` (state.cpp:618-643), simple mode: the
    hand is a count."""
    _check_cfg(cfg)
    cards = add_at(state.cards, state.cur_player,
                   state.can_draw_card.to(I32))
    return state.replace(cards=cards)


def end_turn(state: GameState, cfg: Config) -> GameState:
    """Reference ``State::nextPlayerGameTurn`` (state.cpp:748-766)."""
    s = draw_card(state, cfg)
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
    """Card set trade-in, simple mode (state.cpp:1090-1117): trade 3
    counted cards whenever >= 3 are held."""
    _check_cfg(cfg)
    p = state.cur_player
    held = take(state.cards, p)
    play = held >= 3
    cards = add_at(state.cards, p, torch.where(play, -3, 0).to(I32))
    sets = state.card_sets_played + play.to(I32)
    gain = tables(state.device).card_set_gain[sets.clamp(0, 63).long()]
    gained = torch.where(play, gain, 0).to(I32)
    return state.replace(cards=cards, card_sets_played=sets,
                         reinforcements=state.reinforcements + gained)


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


def step_with_outcome(state: GameState, action: torch.Tensor,
                      outcome: torch.Tensor, cfg: Config) -> GameState:
    """``step`` with battle randomness replaced by an explicit outcome
    index.  Non-attack phases ignore ``outcome``.  Used inside MCTS."""
    dummy_dice = torch.ones((state.batch_size, 5), dtype=I32,
                            device=state.device)
    out = step(state, action, dummy_dice, cfg)
    masks = player_masks(state, cfg)
    li = action.clamp(0, NUM_LANDS - 1)
    frm = best_attack_from(state, li, masks.owned_with_army)
    s_attack = apply_attack_outcome(state, frm, li, outcome, cfg)
    use_attack = (state.phase == PH_ATTACK) & (action != SKIP_ACTION) & (
        game_status(state, cfg) == STATUS_NOT_ENDED)
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

def step(state: GameState, action: torch.Tensor, dice: torch.Tensor,
         cfg: Config) -> GameState:
    """Apply one 43-way action per game (reference ``UtilityNN::makeMove``,
    alphazero_moves.cpp:72-233).

    ``action`` in [0, 43); 42 is skip/end-phase.  ``dice`` is [B, 5] in
    [1, 6], consumed only by attack resolutions.  Terminal games are left
    unchanged.
    """
    _check_cfg(cfg)
    t = tables(state.device)
    idx = t.land_idx[None, :]
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
    comp = connected_to(masks.owned, li)
    cand = comp & (idx != li[:, None]) & (state.army >= 2)
    has_enemy_neighbor = neighbor_count(~masks.owned) > 0
    interior = cand & ~has_enemy_neighbor
    border = cand & has_enemy_neighbor
    use_interior = interior.any(-1)
    pick_from_mask = torch.where(use_interior[:, None], interior, border)
    # First-strict-max over the reference's DFS pre-order (see the JAX
    # engine): the DFS runs only for games really in this decision that
    # have an army tie among the max candidates.
    running = game_status(state, cfg) == STATUS_NOT_ENDED
    if cfg.exact_fortify_tiebreak:
        top = torch.where(pick_from_mask, state.army, -1).amax(-1)
        tied = pick_from_mask & (state.army == top[:, None])
        need_rank = ((state.phase == PH_FORTIFY) & running & ~is_skip
                     & ~target_full & (tied.sum(-1) >= 2))
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
    s_fortify = end_turn(sf, cfg)

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
    """``step`` with dice drawn from ``generator``."""
    dice = roll_dice(generator, state.batch_size).to(state.device)
    return step(state, action, dice, cfg)
