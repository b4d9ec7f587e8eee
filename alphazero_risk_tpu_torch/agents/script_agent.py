"""Vectorized ScriptPlayer: the heuristic benchmark opponent.

Port of ``alphazero_risk_tpu/agents/script_agent.py``, a micro-decision
reformulation of reference ``ScriptPlayer`` (``script_player.cpp``):
prioritize attacking the continent with fewest unowned lands, pour
reinforcements toward the chosen attack source, attack until exhausted,
move captured stacks forward, then fortify the largest interior stack
toward the most exposed border land.

The state of a turn lives in a small carry: the (attack_to, attack_from)
pair pinned at each outer-loop boundary, and a flag for which ownership
masks to use when re-deriving it (script_player.cpp:204-222).  With the
same ``u`` and ``dice`` it steps bit-exactly as the JAX agent, including
its documented tie-break deviations from the reference.

On the card ``script_step_recorded`` launches kernel K9
(``csrc/script_step.cu``); CPU tensors take
``_script_step_recorded_plain``.  ``agents.blocks`` runs it k steps per
game in one launch, beside the RandomPlayer.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import kernels
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
)
from ..env import rules, topology
from ..env.rules import argmax_first, take
from ..env.state import GameState, tree_select
from .common import first_set_bit, masked_choice

I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _script_tables(device: torch.device):
    return (torch.tensor(topology.SCRIPT_LAND_RANK, device=device),
            torch.tensor(topology.CONTINENT_TIE_RANK, device=device))


@dataclasses.dataclass
class ScriptCarry:
    """Within-turn pinned choices (reference member fields
    ``landAttackTo/landAttackFrom`` + the mask-mode of the outer loop)."""

    attack_to: torch.Tensor    # [B] int32, -1 = not pinned
    attack_from: torch.Tensor  # [B] int32
    mode_b: torch.Tensor       # [B] bool: use with-army masks on re-derivation


def init_carry(batch_size: int, device) -> ScriptCarry:
    return ScriptCarry(
        attack_to=torch.full((batch_size,), -1, dtype=I32, device=device),
        attack_from=torch.full((batch_size,), -1, dtype=I32, device=device),
        mode_b=torch.zeros((batch_size,), dtype=torch.bool, device=device),
    )


def _select_target(owned: torch.Tensor,
                   attack_mask: torch.Tensor) -> torch.Tensor:
    """Continent priority + first attackable land in declared order
    (script_player.cpp:17-50, game_helper.cpp:19-36)."""
    land_rank, tie_rank = _script_tables(owned.device)
    cm = rules.tables(owned.device).continent_mask_f32
    per_cont_unowned = ((~owned).to(torch.float32) @ cm.T).to(I32)
    per_cont_attack = ((~owned & attack_mask).to(torch.float32)
                       @ cm.T).to(I32)
    score = per_cont_unowned * 1000 - per_cont_attack * 10 + tie_rank
    score = torch.where(per_cont_attack > 0, score, 10 ** 8)
    cont = torch.argmin(score, dim=-1)
    rank = torch.where(attack_mask, land_rank[cont], NUM_LANDS + 1)
    return torch.argmin(rank, dim=-1).to(I32)


def _select_from(state: GameState, target: torch.Tensor,
                 owned_mask: torch.Tensor) -> torch.Tensor:
    """Max-army owned neighbour of the target, first-in-list on ties
    (script_player.cpp:52-69)."""
    t = rules.tables(state.device)
    tl = target.long()
    cand = t.adj[tl] & owned_mask
    score = torch.where(cand, state.army * 8 - t.neighbor_rank[tl], -1)
    return argmax_first(score)


def script_step_recorded(state: GameState, carry: ScriptCarry,
                         reset: torch.Tensor, u: torch.Tensor,
                         dice: torch.Tensor, cfg: Config):
    """Advance every game one script micro-decision.

    ``reset`` marks games whose mover just became this agent (turn start).
    Returns (new_state, new_carry, (action43, record_mask)).  CUDA tensors
    launch K9; CPU tensors take ``_script_step_recorded_plain``.
    """
    if state.device.type == "cpu":
        return _script_step_recorded_plain(state, carry, reset, u, dice, cfg)
    b, ck = state.batch_size, rules.checked
    ins = (*_carry_fields(carry, b), ck(reset, torch.bool, (b,), "reset"),
           ck(u, torch.float32, (b, 4), "u"), ck(dice, I32, (b, 5), "dice"))
    cards_in, cards_out = rules.card_io(state, (b,), cfg)
    nstate, new = rules.launch_rules(
        kernels.SCRIPT_STEP, state, (b,),
        (*(t.data_ptr() for t in ins), *cards_in), _K9_OUTS + cards_out,
        cfg)
    return (nstate, ScriptCarry(new["attack_to"], new["attack_from"],
                                new["mode_b"]),
            (new["action"], new["record"]))


def _carry_fields(carry: ScriptCarry, b: int) -> tuple:
    ck = rules.checked
    return (ck(carry.attack_to, I32, (b,), "attack_to"),
            ck(carry.attack_from, I32, (b,), "attack_from"),
            ck(carry.mode_b, torch.bool, (b,), "mode_b"))


# K9's outputs after the state: the carry, then the action and its record
# mask.
_CARRY_OUTS = (("attack_to", I32, ()), ("attack_from", I32, ()),
               ("mode_b", torch.bool, ()))
_K9_OUTS = _CARRY_OUTS + (("action", I32, ()), ("record", torch.bool, ()))


def _script_step_recorded_plain(state: GameState, carry: ScriptCarry,
                                reset: torch.Tensor, u: torch.Tensor,
                                dice: torch.Tensor, cfg: Config):
    """``script_step_recorded`` in plain PyTorch: every phase branch for
    every game, blended by phase."""
    b = state.batch_size
    dev = state.device
    idx = rules.tables(dev).land_idx[None, :]
    carry = tree_select(reset, init_carry(b, dev), carry)
    m = rules.player_masks(state, cfg)

    # ---- SETUP: reinforce the best attack source (:164-178) ----
    t_setup = _select_target(m.owned, m.attack_lands)
    f_setup = _select_from(state, t_setup, m.owned)
    s_setup = state.replace(
        reinforcements=state.reinforcements - 2,
        army=rules.add_at(state.army, f_setup, 2),
        phase=torch.full_like(state.phase, PH_SETUP_NEUTRAL))

    # ---- SETUP_NEUTRAL: random neutral next to the enemy (:180-200) ----
    pref1 = m.neutral & m.enemy_attack_lands & ~m.attack_lands
    pref2 = m.neutral & m.enemy_attack_lands
    pool = torch.where(pref1.any(-1, keepdim=True), pref1,
                       torch.where(pref2.any(-1, keepdim=True), pref2,
                                   m.neutral))
    li_n = masked_choice(pool, u[:, 0])
    sn = state.replace(army=rules.add_at(state.army, li_n, 1),
                       round=state.round + 1,
                       cur_player=(1 - state.cur_player).to(I32))
    done_setup = sn.reinforcements == 0
    owned_next = sn.owner == sn.cur_player[:, None]
    s_neutral = sn.replace(
        phase=torch.where(done_setup, PH_REINFORCEMENT, PH_SETUP).to(I32),
        reinforcements=torch.where(done_setup,
                                   rules.calc_reinforcement(owned_next),
                                   sn.reinforcements).to(I32))

    # ---- REINFORCEMENT (:71-110, 204-218) ----
    need_pin = carry.attack_to < 0
    # cards are traded once, at the pin (turn start)
    sr = tree_select(need_pin, rules.play_cards(state, cfg), state)
    pin_to = _select_target(m.owned, m.attack_lands)
    pin_from = _select_from(sr, pin_to, m.owned)
    r_to = torch.where(need_pin, pin_to, carry.attack_to)
    r_from = torch.where(need_pin, pin_from, carry.attack_from)
    carry_r = ScriptCarry(attack_to=r_to, attack_from=r_from,
                          mode_b=carry.mode_b)

    owned_not_full = (sr.owner == sr.cur_player[:, None]) & (
        sr.army < cfg.land_army_max)
    from_ok = take(owned_not_full, r_from)
    near_to = rules.tables(dev).adj[r_to.long()] & owned_not_full
    near_enemy = owned_not_full & (m.enemy_attack_lands |
                                   m.neutral_attack_lands)
    to_r = torch.where(
        from_ok, r_from,
        torch.where(near_to.any(-1), first_set_bit(near_to),
                    torch.where(near_enemy.any(-1), first_set_bit(near_enemy),
                                first_set_bit(owned_not_full)))).to(I32)
    amt = torch.minimum(sr.reinforcements.clamp(max=cfg.min_unit_move),
                        cfg.land_army_max - take(sr.army, to_r))
    s_reinf = rules.apply_reinforcement(sr, to_r, amt, cfg)
    # Pathological guard: all owned lands full -> drop the budget.
    s_reinf = tree_select(owned_not_full.any(-1), s_reinf,
                          rules.goto_attack(sr, cfg))

    # ---- ATTACK (:113-135, 211-222) ----
    at = carry.attack_to.clamp(0, NUM_LANDS - 1)
    af = carry.attack_from.clamp(0, NUM_LANDS - 1)
    to_valid = (carry.attack_to >= 0) & (take(state.owner, at)
                                         != state.cur_player)
    from_valid = ((carry.attack_from >= 0) & (take(state.army, af) >= 2)
                  & (take(state.owner, af) == state.cur_player))
    pinned_ok = to_valid & from_valid
    re_to = _select_target(m.owned, m.attack_lands_with_army)
    re_from = _select_from(state, re_to, m.owned_with_army)
    a_to = torch.where(pinned_ok, carry.attack_to, re_to)
    a_from = torch.where(pinned_ok, carry.attack_from, re_from)
    carry_a = ScriptCarry(attack_to=a_to, attack_from=a_from,
                          mode_b=carry.mode_b | ~pinned_ok)
    s_attack = rules.apply_attack(state, a_from, a_to, dice, cfg)

    # ---- ATTACK_MOBILIZATION: move everything, 3 at a time ----
    mf = state.mob_from.clamp(0, NUM_LANDS - 1)
    mamt = (take(state.army, mf) - 1).clamp(max=cfg.min_unit_move)
    s_mob = rules.apply_mobilization(state, mamt, cfg)

    # ---- FORTIFY (:138-160, game_helper.cpp:40-109) ----
    label = rules.component_labels(m.owned)
    outside_cnt = rules.neighbor_count(~m.owned)
    has_outside = outside_cnt > 0
    interior = m.owned & ~has_outside
    # per-component max interior stack (landFortifyFromAmount)
    from_amt = torch.zeros((b, NUM_LANDS), dtype=I32, device=dev)
    from_amt = from_amt.scatter_reduce(
        1, label.long(), torch.where(interior, state.army, 0).to(I32),
        reduce="amax", include_self=True)
    comp_score = from_amt * 64 - idx
    comp_score = torch.where(from_amt > 0, comp_score, -10 ** 6)
    best_c = argmax_first(comp_score)
    in_best = label == best_c[:, None]
    f_from = argmax_first(torch.where(interior & in_best, state.army, -1))
    f_to_score = torch.where(m.owned & in_best & has_outside, outside_cnt, 0)
    f_to = argmax_first(f_to_score)
    do_fortify = (m.owned_with_army.any(-1) & (from_amt.amax(-1) > 0)
                  & (f_to_score.amax(-1) > 0))
    famt = torch.minimum(take(state.army, f_from) - 1,
                         cfg.land_army_max - take(state.army, f_to))
    famt = torch.where(do_fortify, famt.clamp(min=0), 0).to(I32)
    zero = torch.zeros_like(f_from)
    sf = rules.apply_fortify(state, torch.where(do_fortify, f_from, zero),
                             torch.where(do_fortify, f_to, zero), famt)
    s_fortify = rules.end_turn(sf, cfg, u[:, 3])

    # ---- blend ----
    ph = state.phase
    out = tree_select(ph == PH_SETUP, s_setup, s_fortify)
    out = tree_select(ph == PH_SETUP_NEUTRAL, s_neutral, out)
    out = tree_select(ph == PH_REINFORCEMENT, s_reinf, out)
    out = tree_select(ph == PH_ATTACK, s_attack, out)
    out = tree_select(ph == PH_ATTACK_MOBILIZATION, s_mob, out)

    new_carry = tree_select(ph == PH_REINFORCEMENT, carry_r, carry)
    new_carry = tree_select(ph == PH_ATTACK, carry_a, new_carry)

    # recorded action per phase (script_player.cpp addTrainingSample calls)
    skip = torch.full((b,), NUM_LANDS, dtype=I32, device=dev)
    action = torch.where(
        ph == PH_SETUP, f_setup,
        torch.where(ph == PH_SETUP_NEUTRAL, li_n,
        torch.where(ph == PH_REINFORCEMENT, to_r,
        torch.where(ph == PH_ATTACK, a_to,
        torch.where(ph == PH_ATTACK_MOBILIZATION,
                    state.mob_to.clamp(0, NUM_LANDS - 1),
                    torch.where(do_fortify, f_to, skip)))))).to(I32)
    live = rules._game_status_plain(state, cfg) == STATUS_NOT_ENDED
    # fortify emits a sample only when the player has any armed land
    record = live & torch.where(ph == PH_FORTIFY, m.owned_with_army.any(-1),
                                True)

    return (tree_select(live, out, state),
            tree_select(live, new_carry, carry),
            (action, record))
