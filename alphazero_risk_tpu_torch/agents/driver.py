"""Mirrored deals, agent-vs-agent matches and match tallies.

Port of ``alphazero_risk_tpu/agents/driver.py``: mirrored pairs share one
initial deal with ownership inverted and the starting player swapped
(game.cpp:170-191), ``play_match`` drives two scripted or random agents in
lockstep until every game ends, and ``summarize`` tallies results like the
reference's ``GameResults`` (game.cpp:193-235).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Config, STATUS_NOT_ENDED
from ..env import rules
from ..env.state import (GameState, invert_players, new_game, tree_map,
                         tree_select)
from . import random_agent, script_agent
from .common import draw_step_randoms

AGENT_SCRIPT = 0
AGENT_RANDOM = 1


class MatchResult(NamedTuple):
    status: torch.Tensor      # [B] final status
    rounds: torch.Tensor      # [B] final round
    steps: int                # iterations used
    started_by: torch.Tensor  # [B] starting player


def mirrored_initial_states(batch: int, *,
                            generator: torch.Generator | None = None,
                            perm: torch.Tensor | None = None,
                            device="cuda") -> GameState:
    """B games = B/2 independent deals, each played from both sides.
    ``perm`` [B/2, 42] gives the deals explicitly."""
    if batch % 2:
        raise ValueError("mirrored games come in pairs: batch must be even")
    half = new_game(batch // 2, generator=generator, perm=perm,
                    device=device)
    mirrored = invert_players(half).replace(
        cur_player=torch.ones_like(half.cur_player))
    return tree_map(lambda a, b: torch.cat([a, b]), half, mirrored)


def _agent_step(agent_kind: int, state, carry, reset, u, dice, cfg):
    if agent_kind == AGENT_SCRIPT:
        return script_agent.script_step(state, carry, reset, u, dice, cfg)
    return random_agent.random_step(state, u, dice, cfg), carry


def play_match(generator: torch.Generator, state: GameState, agent0: int,
               agent1: int, cfg: Config, max_steps: int) -> MatchResult:
    """Play until every game ends (or ``max_steps``); ``agent0`` sits in
    seat 0.  The step's ``u`` and dice come from ``generator``."""
    b, dev = state.batch_size, state.device
    started_by = state.cur_player
    carry = script_agent.init_carry(b, dev)
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)
    t = 0
    while t < max_steps and bool(
            (rules.game_status(state, cfg) == STATUS_NOT_ENDED).any()):
        u, dice = draw_step_randoms(generator, b, dev)
        reset = state.cur_player != prev
        s0, c0 = _agent_step(agent0, state, carry, reset, u, dice, cfg)
        if agent1 == agent0:
            s1, c1 = s0, c0
        else:
            s1, c1 = _agent_step(agent1, state, carry, reset, u, dice, cfg)
        mover0 = state.cur_player == 0
        prev = state.cur_player
        state = tree_select(mover0, s0, s1)
        carry = tree_select(mover0, c0, c1)
        t += 1
    return MatchResult(status=rules.game_status(state, cfg),
                       rounds=state.round, steps=t, started_by=started_by)


def summarize(result: MatchResult):
    """Win/draw tallies matching reference ``GameResults``."""
    status = np.asarray(result.status.cpu())
    started = np.asarray(result.started_by.cpu())
    return {
        "games": int(status.shape[0]),
        "p0_wins": int((status == 0).sum()),
        "p1_wins": int((status == 1).sum()),
        "draws": int((status == -2).sum()),
        "unfinished": int((status == -1).sum()),
        "p0_win_started": int(((status == 0) & (started == 0)).sum()),
        "p1_win_started": int(((status == 1) & (started == 1)).sum()),
    }
