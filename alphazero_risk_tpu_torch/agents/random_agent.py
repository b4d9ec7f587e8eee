"""Vectorized RandomPlayer: one micro-decision per call.

Port of ``alphazero_risk_tpu/agents/random_agent.py``, which mirrors
reference ``RandomPlayer::takeTurn`` (random_player.cpp:22-111) at
micro-decision granularity: uniform legal choices in every phase, 1-unit
reinforcements, 50/50 mobilization, random fortify amount.  Engine effects
go through the shared primitives in ``env.rules``.

Randomness is explicit: ``u[B,4]`` uniforms + ``dice[B,5]`` per step (see
``agents.common``).  u[0] = primary target choice, u[1] = secondary
(attack-from / fortify-from), u[2] = amount or mobilization coin.  With the
same ``u`` and ``dice`` it steps bit-exactly as the JAX agent.

On the card ``random_step_recorded`` launches kernel K10
(``csrc/random_step.cu``); CPU tensors take
``_random_step_recorded_plain``.  ``agents.blocks`` runs it k steps per
game in one launch, beside the ScriptPlayer.
"""

from __future__ import annotations

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
from ..env import rules
from ..env.rules import take
from ..env.state import GameState, tree_select
from .common import masked_choice

I32 = torch.int32


def random_step_recorded(state: GameState, u: torch.Tensor,
                         dice: torch.Tensor, cfg: Config):
    """Advance every game one random micro-decision.  Returns
    ``(new_state, (action43, record_mask))``: the 43-way action the player
    "chose", which reference ``addTrainingSample`` records as a one-hot
    policy target (random_player.cpp:29-82).  CUDA tensors launch K10; CPU
    tensors take ``_random_step_recorded_plain``."""
    if state.device.type == "cpu":
        return _random_step_recorded_plain(state, u, dice, cfg)
    b = state.batch_size
    rules.checked(u, torch.float32, (b, 4), "u")
    rules.checked(dice, I32, (b, 5), "dice")
    kernels.require_aligned(u)
    cards_in, cards_out = rules.card_io(state, (b,), cfg)
    nstate, new = rules.launch_rules(
        kernels.RANDOM_STEP, state, (b,),
        (u.data_ptr(), dice.data_ptr(), *cards_in), _K10_OUTS + cards_out,
        cfg)
    return nstate, (new["action"], new["record"])


# K10's outputs after the state: the action and its record mask.
_K10_OUTS = (("action", I32, ()), ("record", torch.bool, ()))


def _random_step_recorded_plain(state: GameState, u: torch.Tensor,
                                dice: torch.Tensor, cfg: Config):
    """``random_step_recorded`` in plain PyTorch: every phase branch for
    every game, blended by phase."""
    b, dev = state.batch_size, state.device
    t = rules.tables(dev)
    m = rules.player_masks(state, cfg)
    land_idx = t.land_idx[None, :]
    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)

    # SETUP: uniform owned land, +2 (random_player.cpp:26-31)
    li_setup = masked_choice(m.owned, u[:, 0])
    s_setup = state.replace(
        reinforcements=state.reinforcements - 2,
        army=rules.add_at(state.army, li_setup, 2),
        phase=torch.full_like(state.phase, PH_SETUP_NEUTRAL))

    # SETUP_NEUTRAL: uniform neutral land (random_player.cpp:32-37)
    li_n = masked_choice(m.neutral, u[:, 0])
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

    # REINFORCEMENT: play cards, then 1 unit on a uniform non-full owned
    # land (random_player.cpp:38-45)
    sr = rules.play_cards(state, cfg)
    li_r = masked_choice(m.owned & ~m.owned_full, u[:, 0])
    s_reinf = rules.apply_reinforcement(sr, li_r, torch.ones_like(li_r), cfg)

    # ATTACK: uniform over attackable | skip; source = uniform armed owned
    # neighbour (random_player.cpp:46-62)
    atk_mask = torch.cat([m.attack_lands_with_army, ones], dim=-1)
    choice = masked_choice(atk_mask, u[:, 0])
    atk_skip = choice == NUM_LANDS
    tgt = choice.clamp(0, NUM_LANDS - 1)
    frm_mask = t.adj[tgt.long()] & m.owned_with_army
    frm = masked_choice(frm_mask, u[:, 1])
    s_attack = tree_select(
        atk_skip,
        state.replace(phase=torch.full_like(state.phase, PH_FORTIFY)),
        rules.apply_attack(state, frm, tgt, dice, cfg))

    # ATTACK_MOBILIZATION: coin flip between moving min(3, n-1) and stopping
    # (random_player.cpp:63-76)
    mf = state.mob_from.clamp(0, NUM_LANDS - 1)
    amt = (take(state.army, mf) - 1).clamp(max=cfg.min_unit_move)
    s_mob = tree_select(u[:, 2] > 0.5,
                        rules.apply_mobilization(state, amt, cfg),
                        rules.goto_attack(state, cfg))

    # FORTIFY: uniform target (non-full owned | skip); source = uniform armed
    # land in target's component; amount = rand % max
    # (random_player.cpp:77-109)
    f_mask = torch.cat([m.owned & ~m.owned_full, ones], dim=-1)
    fchoice = masked_choice(f_mask, u[:, 0])
    f_skip = fchoice == NUM_LANDS
    fto = fchoice.clamp(0, NUM_LANDS - 1)
    comp = rules.connected_to(m.owned, fto)
    cand = comp & (land_idx != fto[:, None]) & m.owned_with_army
    ffrom = masked_choice(cand, u[:, 1])
    max_amt = torch.minimum(take(state.army, ffrom) - 1,
                            cfg.land_army_max - take(state.army, fto))
    ramt = (u[:, 2] * max_amt).to(I32)     # rInt() % amount semantics
    can = ~f_skip & cand.any(-1)
    ramt = torch.where(can, ramt, 0).to(I32)
    zero = torch.zeros_like(ffrom)
    sf = rules.apply_fortify(state, torch.where(can, ffrom, zero),
                             torch.where(can, fto, zero), ramt)
    s_fortify = rules.end_turn(sf, cfg, u[:, 3])

    ph = state.phase
    out = tree_select(ph == PH_SETUP, s_setup, s_fortify)
    out = tree_select(ph == PH_SETUP_NEUTRAL, s_neutral, out)
    out = tree_select(ph == PH_REINFORCEMENT, s_reinf, out)
    out = tree_select(ph == PH_ATTACK, s_attack, out)
    out = tree_select(ph == PH_ATTACK_MOBILIZATION, s_mob, out)

    # recorded action per phase (random_player.cpp addTrainingSample calls)
    skip = torch.full_like(li_setup, NUM_LANDS)
    action = torch.where(
        ph == PH_SETUP, li_setup,
        torch.where(ph == PH_SETUP_NEUTRAL, li_n,
        torch.where(ph == PH_REINFORCEMENT, li_r,
        torch.where(ph == PH_ATTACK, torch.where(atk_skip, skip, tgt),
        torch.where(ph == PH_ATTACK_MOBILIZATION,
                    torch.where(u[:, 2] > 0.5,
                                state.mob_to.clamp(0, NUM_LANDS - 1),
                                state.mob_from.clamp(0, NUM_LANDS - 1)),
                    torch.where(f_skip, skip, fto)))))).to(I32)

    live = rules._game_status_plain(state, cfg) == STATUS_NOT_ENDED
    return tree_select(live, out, state), (action, live)
