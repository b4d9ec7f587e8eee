"""Scalar rules oracle for golden-trajectory testing.

A deliberately simple, dict-and-int Python implementation of the Risk rules
engine + 43-way action semantics, transcribed *directly from the reference
C++* (``state.cpp``, ``alphazero_moves.cpp``) rather than from the
vectorized engine, so that agreement between the two is meaningful.  It
consumes the same explicit dice tensor as ``rules.step``, making trajectories
bit-exact reproducible under a shared RNG discipline (the reference's
``std::default_random_engine`` consumption order is implementation-defined,
so the shared discipline is: 5 dice per step, 3 attacker then 2 defender —
see SURVEY.md section 7 hard part #1).

This module is NOT compiled and NOT fast; it is the spec.

The port's own copy of ``alphazero_risk_tpu/env/oracle.py`` (the port
imports nothing of the JAX package): the same state, the same functions,
the same dice rule, and under full cards the same card uniform
(``step(..., u_card)``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..config import (
    Config,
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
from .topology import CONTINENTS, NEIGHBORS


@dataclasses.dataclass
class OracleState:
    owner: List[int]
    army: List[int]
    phase: int = PH_SETUP
    round: int = 1
    cur_player: int = 0
    reinforcements: int = 52
    cards: List[int] = dataclasses.field(default_factory=lambda: [0, 0])
    card_sets_played: int = 0
    mob_from: int = -1
    mob_to: int = -1
    can_draw_card: bool = False
    attacks_during_turn: int = 0
    # full-cards mode (STATE_SIMPLE_CARDS off)
    player_cards: List[List[bool]] = dataclasses.field(
        default_factory=lambda: [[False] * NUM_LANDS,
                                 [False] * NUM_LANDS])
    drawn_cards: List[bool] = dataclasses.field(
        default_factory=lambda: [False] * NUM_LANDS)


def new_game(permutation: List[int]) -> OracleState:
    """Deal per reference State::newGame (state.cpp:137-167): lands assigned
    to the cycle [P0, P1, neutral] over the given permutation."""
    owner = [0] * NUM_LANDS
    pattern = [0, 1, NEUTRAL_PLAYER]
    for i, land in enumerate(permutation):
        owner[land] = pattern[i % 3]
    return OracleState(owner=owner, army=[1] * NUM_LANDS)


def _owned(s: OracleState, p: int) -> List[int]:
    return [l for l in range(NUM_LANDS) if s.owner[l] == p]


def calc_reinforcement(s: OracleState, p: int) -> int:
    owned = set(_owned(s, p))
    r = len(owned) // 3
    for lands, bonus in CONTINENTS.values():
        if set(lands) <= owned:
            r += bonus
    return max(r, 3)


def game_status(s: OracleState, cfg: Config) -> int:
    p0 = len(_owned(s, 0))
    if p0 == 0:
        return 1
    p1 = len(_owned(s, 1))
    if p1 == 0:
        return 0
    if cfg.allow_yield:
        if p0 >= 30:
            return 0
        if p1 >= 30:
            return 1
    if s.round > cfg.max_game_rounds:
        if p0 > p1:
            return 0
        if p0 < p1:
            return 1
        return STATUS_DRAW
    return STATUS_NOT_ENDED


def _attack_lands_with_army(s: OracleState, p: int) -> List[int]:
    out = []
    for l in range(NUM_LANDS):
        if s.owner[l] == p:
            continue
        if any(s.owner[n] == p and s.army[n] >= 2 for n in NEIGHBORS[l]):
            out.append(l)
    return out


def _enemy_attack_lands(s: OracleState, p: int) -> List[int]:
    e = 1 - p
    out = []
    for l in range(NUM_LANDS):
        if s.owner[l] == e:
            continue
        if any(s.owner[n] == e for n in NEIGHBORS[l]):
            out.append(l)
    return out


def _neutral_attack_lands(s: OracleState) -> List[int]:
    out = set()
    for l in range(NUM_LANDS):
        if s.owner[l] == NEUTRAL_PLAYER:
            out.update(NEIGHBORS[l])
    return [l for l in sorted(out) if s.owner[l] != NEUTRAL_PLAYER]


def legal_actions(s: OracleState, cfg: Config) -> List[bool]:
    p = s.cur_player
    mask = [False] * (NUM_LANDS + 1)
    if s.phase in (PH_SETUP, PH_REINFORCEMENT):
        base = [l for l in _owned(s, p) if s.army[l] < cfg.land_army_max]
        if not base:
            mask[SKIP_ACTION] = True
            return mask
        if cfg.limit_reinforcement_moves:
            borders = set(_enemy_attack_lands(s, p)) | set(
                _neutral_attack_lands(s))
            border = [l for l in base if l in borders]
            lands = border if border else base
        else:
            lands = base
        for l in lands:
            mask[l] = True
    elif s.phase == PH_SETUP_NEUTRAL:
        for l in range(NUM_LANDS):
            if s.owner[l] == NEUTRAL_PLAYER:
                mask[l] = True
    elif s.phase == PH_ATTACK:
        targets = _attack_lands_with_army(s, p)
        if cfg.limit_attack_moves:
            if targets:
                for l in targets:
                    mask[l] = True
            else:
                mask[SKIP_ACTION] = True
        else:
            for l in targets:
                mask[l] = True
            mask[SKIP_ACTION] = True
    elif s.phase == PH_ATTACK_MOBILIZATION:
        mask[s.mob_from] = True
        mask[s.mob_to] = True
    elif s.phase == PH_FORTIFY:
        if cfg.limit_reinforcement_moves:
            borders = set(_enemy_attack_lands(s, p))
            for l in _owned(s, p):
                if l in borders:
                    mask[l] = True
        else:
            for l in _owned(s, p):
                mask[l] = True
        mask[SKIP_ACTION] = True
    return mask


def _goto_attack(s: OracleState, cfg: Config) -> None:
    s.reinforcements = 0
    s.mob_from = -1
    s.mob_to = -1
    s.phase = PH_ATTACK
    if not _attack_lands_with_army(s, s.cur_player):
        s.phase = PH_FORTIFY


def _draw_card(s: OracleState, cfg: Config, u_card: float) -> None:
    """Reference State::drawCard (state.cpp:618-643), full-cards mode."""
    if not s.can_draw_card:
        return
    available = [not d for d in s.drawn_cards]
    if not any(available):
        # sane reshuffle: hands stay out of the deck (see rules.draw_card
        # for the documented deviation from the reference's literal code)
        available = [not (s.player_cards[0][l] or s.player_cards[1][l])
                     for l in range(NUM_LANDS)]
        s.drawn_cards = [not a for a in available]
    idx = [l for l, a in enumerate(available) if a]
    card = idx[min(int(u_card * len(idx)), len(idx) - 1)]
    s.drawn_cards[card] = True
    s.player_cards[s.cur_player][card] = True


def _next_player_game_turn(s: OracleState, cfg: Config,
                           u_card: float = 0.0) -> None:
    if s.can_draw_card:
        if cfg.simple_cards:
            s.cards[s.cur_player] += 1
        else:
            _draw_card(s, cfg, u_card)
        s.can_draw_card = False
    s.round += 1
    s.cur_player = 1 - s.cur_player
    s.attacks_during_turn = 0
    s.phase = PH_REINFORCEMENT
    s.reinforcements = calc_reinforcement(s, s.cur_player)


def _gain(k: int) -> int:
    return [0, 4, 6, 8, 10, 12, 15][k] if k <= 6 else 15 + (k - 6) * 5


def _best_combo(s: OracleState, cfg: Config) -> List[int]:
    """GameHelper::getBestCombo (game_helper.cpp:145-208): best 3-card
    combo when more than 3 cards are held, [] otherwise.  Tie order:
    infantry/horse/siege/one-of-each (documented deviation — the reference
    sorts with an unspecified equal-key order)."""
    from .topology import CARD_HORSE, CARD_INFANTRY, CARD_SIEGE

    p = s.cur_player
    hand = [l for l in range(NUM_LANDS) if s.player_cards[p][l]]
    if len(hand) <= 3:
        return []
    types = [CARD_INFANTRY, CARD_HORSE, CARD_SIEGE]
    owned = [s.owner[l] == p for l in range(NUM_LANDS)]
    combos = []  # (owned_count, order, cards)
    for ti, t in enumerate(types):
        cards_t = [l for l in hand if t[l]]
        if len(cards_t) >= 3:
            ordered = sorted(cards_t, key=lambda l: (not owned[l], l))[:3]
            combos.append((sum(owned[l] for l in ordered), ti, ordered))
    per_type = [[l for l in hand if t[l]] for t in types]
    if all(per_type):
        pick = []
        oc = 0
        for cards_t in per_type:
            o = [l for l in cards_t if owned[l]]
            if o:
                pick.append(o[0])
                oc += 1
            else:
                pick.append(cards_t[0])
        combos.append((oc, 3, pick))
    if not combos:
        return []
    combos.sort(key=lambda c: (-c[0], c[1]))
    return combos[0][2]


def _play_cards(s: OracleState, cfg: Config) -> None:
    if cfg.simple_cards:
        if s.cards[s.cur_player] >= 3:
            s.cards[s.cur_player] -= 3
            s.card_sets_played += 1
            s.reinforcements += _gain(s.card_sets_played)
        return
    combo = _best_combo(s, cfg)
    if not combo:
        return
    p = s.cur_player
    # +2 on the first owned combo land with space (state.cpp:1145-1158)
    for l in sorted(combo):
        if s.owner[l] == p and s.army[l] + 2 <= cfg.land_army_max:
            s.army[l] += 2
            break
    for l in combo:
        s.player_cards[p][l] = False
    s.card_sets_played += 1
    s.reinforcements += _gain(s.card_sets_played)


def _move_amount(budget: int, cfg: Config) -> int:
    if cfg.fast_attack_mobilization:
        half = budget // 2
        if half < cfg.min_unit_move:
            return min(cfg.min_unit_move, budget)
        return half
    return min(cfg.min_unit_move, budget)


def step(s: OracleState, action: int, dice: List[int],
         cfg: Config, u_card: float = 0.0) -> OracleState:
    """Scalar mirror of ``rules.step`` (reference UtilityNN::makeMove).

    Mutates and returns ``s``.  ``dice`` is 5 ints in [1,6]; only attack
    resolutions consume them.
    """
    if game_status(s, cfg) != STATUS_NOT_ENDED:
        return s
    p = s.cur_player

    if s.phase == PH_SETUP:
        assert action != SKIP_ACTION
        s.reinforcements -= 2
        s.army[action] += 2
        s.phase = PH_SETUP_NEUTRAL
    elif s.phase == PH_SETUP_NEUTRAL:
        assert s.owner[action] == NEUTRAL_PLAYER
        s.army[action] += 1
        # nextPlayerSetupTurn (state.cpp:725-746)
        s.round += 1
        s.cur_player = 1 - p
        s.phase = PH_SETUP
        if s.reinforcements == 0:
            s.phase = PH_REINFORCEMENT
            s.reinforcements = calc_reinforcement(s, s.cur_player)
    elif s.phase == PH_REINFORCEMENT:
        if action == SKIP_ACTION:
            _goto_attack(s, cfg)
        else:
            _play_cards(s, cfg)
            amount = _move_amount(s.reinforcements, cfg)
            amount = min(amount, cfg.land_army_max - s.army[action])
            s.reinforcements -= amount
            s.army[action] += amount
            if s.reinforcements == 0:
                _goto_attack(s, cfg)
    elif s.phase == PH_ATTACK:
        if action == SKIP_ACTION:
            s.phase = PH_FORTIFY
        else:
            s.attacks_during_turn += 1
            # best attack-from: first strict max over neighbour list order
            best_army, frm = 0, -1
            for n in NEIGHBORS[action]:
                if s.owner[n] == p and s.army[n] >= 2:
                    if s.army[n] - 1 > best_army:
                        best_army, frm = s.army[n] - 1, n
            assert frm >= 0, "attack with no valid source"
            a, d = s.army[frm], s.army[action]
            att_n = 3 if a >= 4 else (2 if a == 3 else 1)
            def_n = 2 if d >= 2 else 1
            att = sorted(dice[:att_n], reverse=True)
            dfn = sorted(dice[3:3 + def_n], reverse=True)
            units = att_n
            if att[0] > dfn[0]:
                d -= 1
            else:
                a -= 1
                units -= 1
            if att_n >= 2 and def_n == 2:
                if att[1] > dfn[1]:
                    d -= 1
                else:
                    a -= 1
                    units -= 1
            if d == 0:
                a -= units
                if a > 1:
                    s.phase = PH_ATTACK_MOBILIZATION
                    s.mob_from = frm
                    s.mob_to = action
                s.can_draw_card = True
                s.army[frm] = a
                s.army[action] = units
                s.owner[action] = p
            else:
                s.army[frm] = a
                s.army[action] = d
            if s.phase == PH_ATTACK and not _attack_lands_with_army(s, p):
                s.phase = PH_FORTIFY
    elif s.phase == PH_ATTACK_MOBILIZATION:
        if action == s.mob_from:
            _goto_attack(s, cfg)
        else:
            assert action == s.mob_to
            value = s.army[s.mob_from] - 1
            amount = _move_amount(value, cfg)
            s.army[s.mob_from] -= amount
            s.army[action] += amount
            if s.army[s.mob_from] == 1:
                _goto_attack(s, cfg)
    elif s.phase == PH_FORTIFY:
        if action != SKIP_ACTION:
            if s.army[action] < cfg.land_army_max:
                comp = _component(s, p, action)
                best_int, from_int = 0, -1
                best_ext, from_ext = 0, -1
                # Reference iterates the flood fill's DFS PRE-ORDER rooted
                # at the lowest-index land of the component and keeps the
                # first strict max (game_helper.cpp:51-105,
                # alphazero_moves.cpp:188-221).
                for l in _dfs_preorder(s, p, min(comp)):
                    if l == action:
                        continue
                    value = s.army[l] - 1
                    interior = all(s.owner[n] == p for n in NEIGHBORS[l])
                    if interior:
                        if value > best_int:
                            best_int, from_int = value, l
                    else:
                        if value > best_ext:
                            best_ext, from_ext = value, l
                frm, val = (from_int, best_int) if from_int >= 0 else (
                    from_ext, best_ext)
                if frm >= 0:
                    amount = min(val, cfg.land_army_max - s.army[action])
                    s.army[frm] -= amount
                    s.army[action] += amount
        _next_player_game_turn(s, cfg, u_card)
    return s


def _component(s: OracleState, p: int, src: int) -> set:
    seen = {src}
    stack = [src]
    while stack:
        l = stack.pop()
        for n in NEIGHBORS[l]:
            if s.owner[n] == p and n not in seen:
                seen.add(n)
                stack.append(n)
    return seen


def _dfs_preorder(s: OracleState, p: int, root: int) -> list:
    """Recursive flood-fill visit order (reference
    GameHelper::LandSetMovement::add, game_helper.cpp:51-82)."""
    order, seen = [], set()

    def visit(l):
        if s.owner[l] != p or l in seen:
            return
        seen.add(l)
        order.append(l)
        for n in NEIGHBORS[l]:
            visit(n)

    visit(root)
    return order
