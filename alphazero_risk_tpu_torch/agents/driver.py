"""Mirrored deals and match tallies.

Port of the parts of ``alphazero_risk_tpu/agents/driver.py`` that the
AlphaZero-vs-ScriptPlayer evaluation uses: mirrored pairs share one
initial deal with ownership inverted and the starting player swapped
(game.cpp:170-191), and ``summarize`` tallies results like the reference's
``GameResults`` (game.cpp:193-235).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..env.state import GameState, invert_players, new_game, tree_map


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
