"""Scalar micro-step mirrors of the script/random agents, for parity tests.

These operate on ``env.oracle.OracleState`` with plain Python control flow
transcribed from ``script_player.cpp`` / ``random_player.cpp``, consuming
the same per-step randomness (u[4], dice[5]) as the vectorized agents so
trajectories must match bit-exactly.

The port's own copy of ``alphazero_risk_tpu/agents/oracle_agents.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..config import (
    Config,
    NUM_LANDS,
    PH_ATTACK,
    PH_ATTACK_MOBILIZATION,
    PH_FORTIFY,
    PH_REINFORCEMENT,
    PH_SETUP,
    PH_SETUP_NEUTRAL,
    STATUS_NOT_ENDED,
    NEUTRAL_PLAYER,
)
from ..env import oracle
from ..env.oracle import OracleState
from ..env.topology import (
    CONTINENT_MASK,
    CONTINENT_TIE_RANK,
    NEIGHBORS,
    SCRIPT_LAND_RANK,
)


def _choice(mask: List[bool], u: float) -> int:
    idx = [i for i, v in enumerate(mask) if v]
    assert idx, "choice over empty mask"
    return idx[min(int(u * len(idx)), len(idx) - 1)]


def _first(mask: List[bool]) -> int:
    for i, v in enumerate(mask):
        if v:
            return i
    return -1


# ---------------------------------------------------------------------------
# shared oracle engine primitives
# ---------------------------------------------------------------------------

def _masks(s: OracleState, cfg: Config):
    p = s.cur_player
    owned = [s.owner[l] == p for l in range(NUM_LANDS)]
    enemy = [s.owner[l] == 1 - p for l in range(NUM_LANDS)]
    neutral = [s.owner[l] == NEUTRAL_PLAYER for l in range(NUM_LANDS)]
    owned_wa = [owned[l] and s.army[l] >= 2 for l in range(NUM_LANDS)]
    owned_full = [owned[l] and s.army[l] >= cfg.land_army_max
                  for l in range(NUM_LANDS)]
    attack = [not owned[l] and any(owned[n] for n in NEIGHBORS[l])
              for l in range(NUM_LANDS)]
    attack_wa = [not owned[l] and any(owned_wa[n] for n in NEIGHBORS[l])
                 for l in range(NUM_LANDS)]
    enemy_attack = [not enemy[l] and any(enemy[n] for n in NEIGHBORS[l])
                    for l in range(NUM_LANDS)]
    neutral_attack = [not neutral[l] and any(neutral[n]
                                             for n in NEIGHBORS[l])
                      for l in range(NUM_LANDS)]
    return (owned, enemy, neutral, owned_wa, owned_full, attack, attack_wa,
            enemy_attack, neutral_attack)


def _goto_attack(s: OracleState, cfg: Config) -> None:
    oracle._goto_attack(s, cfg)


def _apply_reinforcement(s: OracleState, li: int, amount: int,
                         cfg: Config) -> None:
    s.reinforcements -= amount
    s.army[li] += amount
    if s.reinforcements == 0:
        _goto_attack(s, cfg)


def _apply_attack(s: OracleState, frm: int, li: int, dice: List[int],
                  cfg: Config) -> None:
    p = s.cur_player
    s.attacks_during_turn += 1
    a, d = s.army[frm], s.army[li]
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
            s.mob_from, s.mob_to = frm, li
        s.can_draw_card = True
        s.army[frm], s.army[li] = a, units
        s.owner[li] = p
    else:
        s.army[frm], s.army[li] = a, d
    if s.phase == PH_ATTACK and not oracle._attack_lands_with_army(s, p):
        s.phase = PH_FORTIFY


def _apply_mobilization(s: OracleState, amount: int, cfg: Config) -> None:
    s.army[s.mob_from] -= amount
    s.army[s.mob_to] += amount
    if s.army[s.mob_from] == 1:
        _goto_attack(s, cfg)


def _end_turn(s: OracleState, cfg: Config, u_card: float = 0.0) -> None:
    oracle._next_player_game_turn(s, cfg, u_card)


# ---------------------------------------------------------------------------
# random agent (random_player.cpp:22-111)
# ---------------------------------------------------------------------------

def random_step(s: OracleState, u: List[float], dice: List[int],
                cfg: Config) -> None:
    if oracle.game_status(s, cfg) != STATUS_NOT_ENDED:
        return
    (owned, enemy, neutral, owned_wa, owned_full, attack, attack_wa,
     enemy_attack, neutral_attack) = _masks(s, cfg)
    if s.phase == PH_SETUP:
        li = _choice(owned, u[0])
        s.reinforcements -= 2
        s.army[li] += 2
        s.phase = PH_SETUP_NEUTRAL
    elif s.phase == PH_SETUP_NEUTRAL:
        li = _choice(neutral, u[0])
        oracle.step(s, li, dice, cfg)
    elif s.phase == PH_REINFORCEMENT:
        oracle._play_cards(s, cfg)
        li = _choice([owned[l] and not owned_full[l]
                      for l in range(NUM_LANDS)], u[0])
        _apply_reinforcement(s, li, 1, cfg)
    elif s.phase == PH_ATTACK:
        mask = attack_wa + [True]
        c = _choice(mask, u[0])
        if c == NUM_LANDS:
            s.phase = PH_FORTIFY
        else:
            frm = _choice([owned_wa[n] if n in NEIGHBORS[c] else False
                           for n in range(NUM_LANDS)], u[1])
            _apply_attack(s, frm, c, dice, cfg)
    elif s.phase == PH_ATTACK_MOBILIZATION:
        if u[2] > 0.5:
            amt = min(s.army[s.mob_from] - 1, cfg.min_unit_move)
            _apply_mobilization(s, amt, cfg)
        else:
            _goto_attack(s, cfg)
    elif s.phase == PH_FORTIFY:
        mask = [owned[l] and not owned_full[l]
                for l in range(NUM_LANDS)] + [True]
        c = _choice(mask, u[0])
        if c != NUM_LANDS:
            comp = oracle._component(s, s.cur_player, c)
            cand = [l in comp and l != c and owned_wa[l]
                    for l in range(NUM_LANDS)]
            if any(cand):
                frm = _choice(cand, u[1])
                max_amt = min(s.army[frm] - 1,
                              cfg.land_army_max - s.army[c])
                amt = int(u[2] * max_amt)
                s.army[frm] -= amt
                s.army[c] += amt
        _end_turn(s, cfg, u[3])


# ---------------------------------------------------------------------------
# script agent (script_player.cpp)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OracleScriptCarry:
    attack_to: int = -1
    attack_from: int = -1
    mode_b: bool = False


def _select_target(owned: List[bool], attack_mask: List[bool]
                   ) -> int:
    best_key, best_c = None, -1
    for c in range(6):
        unowned = sum(1 for l in range(NUM_LANDS)
                      if CONTINENT_MASK[c][l] and not owned[l])
        attackable = sum(1 for l in range(NUM_LANDS)
                         if CONTINENT_MASK[c][l] and not owned[l]
                         and attack_mask[l])
        if attackable == 0:
            continue
        key = (unowned, -attackable, int(CONTINENT_TIE_RANK[c]))
        if best_key is None or key < best_key:
            best_key, best_c = key, c
    if best_c < 0:
        return -1
    best_rank, best_l = None, -1
    for l in range(NUM_LANDS):
        if attack_mask[l] and SCRIPT_LAND_RANK[best_c][l] < NUM_LANDS:
            if best_rank is None or SCRIPT_LAND_RANK[best_c][l] < best_rank:
                best_rank, best_l = SCRIPT_LAND_RANK[best_c][l], l
    return best_l


def _select_from(s: OracleState, target: int, owned_mask: List[bool]) -> int:
    best_army, best = 0, -1
    for n in NEIGHBORS[target]:
        if owned_mask[n] and s.army[n] > best_army:
            best_army, best = s.army[n], n
    return best


def script_step(s: OracleState, carry: OracleScriptCarry, reset: bool,
                u: List[float], dice: List[int], cfg: Config
                ) -> OracleScriptCarry:
    if oracle.game_status(s, cfg) != STATUS_NOT_ENDED:
        return carry
    if reset:
        carry = OracleScriptCarry()
    (owned, enemy, neutral, owned_wa, owned_full, attack, attack_wa,
     enemy_attack, neutral_attack) = _masks(s, cfg)

    if s.phase == PH_SETUP:
        t = _select_target(owned, attack)
        f = _select_from(s, t, owned)
        s.reinforcements -= 2
        s.army[f] += 2
        s.phase = PH_SETUP_NEUTRAL
    elif s.phase == PH_SETUP_NEUTRAL:
        pref1 = [neutral[l] and enemy_attack[l] and not attack[l]
                 for l in range(NUM_LANDS)]
        pref2 = [neutral[l] and enemy_attack[l] for l in range(NUM_LANDS)]
        pool = pref1 if any(pref1) else (pref2 if any(pref2) else neutral)
        li = _choice(pool, u[0])
        oracle.step(s, li, dice, cfg)
    elif s.phase == PH_REINFORCEMENT:
        if carry.attack_to < 0:
            oracle._play_cards(s, cfg)
            carry.attack_to = _select_target(owned, attack)
            carry.attack_from = _select_from(s, carry.attack_to, owned)
        owned_not_full = [owned[l] and s.army[l] < cfg.land_army_max
                          for l in range(NUM_LANDS)]
        if not any(owned_not_full):
            _goto_attack(s, cfg)
            return carry
        if owned_not_full[carry.attack_from]:
            to_r = carry.attack_from
        else:
            near_to = [owned_not_full[l] and l in NEIGHBORS[carry.attack_to]
                       for l in range(NUM_LANDS)]
            near_enemy = [owned_not_full[l] and (enemy_attack[l] or
                                                 neutral_attack[l])
                          for l in range(NUM_LANDS)]
            if any(near_to):
                to_r = _first(near_to)
            elif any(near_enemy):
                to_r = _first(near_enemy)
            else:
                to_r = _first(owned_not_full)
        amt = min(cfg.min_unit_move, s.reinforcements,
                  cfg.land_army_max - s.army[to_r])
        _apply_reinforcement(s, to_r, amt, cfg)
    elif s.phase == PH_ATTACK:
        p = s.cur_player
        to_ok = carry.attack_to >= 0 and s.owner[carry.attack_to] != p
        from_ok = (carry.attack_from >= 0
                   and s.owner[carry.attack_from] == p
                   and s.army[carry.attack_from] >= 2)
        if not (to_ok and from_ok):
            carry.attack_to = _select_target(owned, attack_wa)
            carry.attack_from = _select_from(s, carry.attack_to, owned_wa)
            carry.mode_b = True
        _apply_attack(s, carry.attack_from, carry.attack_to, dice, cfg)
    elif s.phase == PH_ATTACK_MOBILIZATION:
        amt = min(s.army[s.mob_from] - 1, cfg.min_unit_move)
        _apply_mobilization(s, amt, cfg)
    elif s.phase == PH_FORTIFY:
        if any(owned_wa):
            p = s.cur_player
            # components with interior stacks
            seen = set()
            best = None  # (from_amt, -lowest_label) maximized
            for l in range(NUM_LANDS):
                if owned[l] and l not in seen:
                    comp = oracle._component(s, p, l)
                    seen |= comp
                    from_amt, from_l = 0, -1
                    to_cnt, to_l = 0, -1
                    for c in sorted(comp):
                        outside = sum(1 for n in NEIGHBORS[c]
                                      if not owned[n])
                        if outside == 0:
                            if s.army[c] > from_amt:
                                from_amt, from_l = s.army[c], c
                        else:
                            if outside > to_cnt:
                                to_cnt, to_l = outside, c
                    label = min(comp)
                    key = (from_amt, -label)
                    if best is None or key > best[0]:
                        best = (key, from_l, to_l, from_amt)
            _, from_l, to_l, from_amt = best
            if from_amt > 0 and to_l >= 0:
                amt = min(s.army[from_l] - 1,
                          cfg.land_army_max - s.army[to_l])
                s.army[from_l] -= amt
                s.army[to_l] += amt
        _end_turn(s, cfg, u[3])
    return carry
