"""Mirrored deals, agent-vs-agent matches and match tallies.

Port of ``alphazero_risk_tpu/agents/driver.py``: mirrored pairs share one
initial deal with ownership inverted and the starting player swapped
(game.cpp:170-191), ``play_match`` drives two scripted or random agents in
lockstep until every game ends, and ``summarize`` tallies results like the
reference's ``GameResults`` (game.cpp:193-235).  ``mixed_play`` gives
states of every phase for holding the rules kernels against their plain
versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import NUM_LANDS, Config
from ..env import rules
from ..env.state import (GameState, invert_players, new_game, tree_map,
                         tree_select)
from . import blocks, random_agent, script_agent
from .common import BlockDraws, draw_step_randoms

AGENT_SCRIPT = 0
AGENT_RANDOM = 1
# the seat kinds of the multi-step path
_KINDS = {AGENT_SCRIPT: blocks.OPP_SCRIPT, AGENT_RANDOM: blocks.OPP_RANDOM}


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


# The match's blocks of draws, MATCH_BLOCK steps each.  Data (b)'s 1,024
# Script-vs-Script games end in 1,118 steps: three blocks (a launch and a
# sync each), the unused draws of the last put back.  Blocks of 64 or 128
# doubling to 512 timed within the runs' spread on an H100
# (``tools/time_kernels.py --parts match_blocks``).
MATCH_BLOCK = 512


def play_match(generator: torch.Generator, state: GameState, agent0: int,
               agent1: int, cfg: Config, max_steps: int) -> MatchResult:
    """Play until every game ends (or ``max_steps``); ``agent0`` sits in
    seat 0.  The step's ``u`` and dice come from ``generator``.

    Any pair of ScriptPlayer and RandomPlayer seats runs in blocks of
    ``MATCH_BLOCK`` steps (``blocks.run_agent_blocks``: on the card one
    launch of the multi-step entry and one host sync per block); the
    draws consumed, and so the result, are those of one step per
    iteration."""
    b, dev = state.batch_size, state.device
    started_by = state.cur_player
    draws = BlockDraws(generator, b, dev)
    state, _, _, t, _ = blocks.run_agent_blocks(
        state, script_agent.init_carry(b, dev),
        torch.full((b,), -1, dtype=torch.int32, device=dev), cfg,
        draws.block, draws.rewind, kinds=(_KINDS[agent0], _KINDS[agent1]),
        k=MATCH_BLOCK, k_max=MATCH_BLOCK, limit=max_steps)
    return MatchResult(status=rules.game_status(state, cfg),
                       rounds=state.round, steps=t, started_by=started_by)


class MixedPlay(NamedTuple):
    """States of mixed play, each with what its step drew."""

    state: GameState
    carry: script_agent.ScriptCarry   # the script carry the step starts from
    prev: torch.Tensor                # [B] the previous step's mover
    u: torch.Tensor                   # [B, 4] the step's uniforms
    dice: torch.Tensor                # [B, 5] the step's dice
    action: torch.Tensor              # [B] a random legal action

    @property
    def reset(self) -> torch.Tensor:
        return self.state.cur_player != self.prev

    def apply(self, fn) -> "MixedPlay":
        """``fn`` applied to every tensor (e.g. a slice of the games)."""
        return MixedPlay(*(fn(x) if isinstance(x, torch.Tensor)
                           else tree_map(fn, x) for x in self))


def mixed_play(batch: int, steps: int, cfg: Config,
               generator: torch.Generator, every: int = 1) -> MixedPlay:
    """``steps`` lockstep steps of ``batch`` mirrored games on the
    generator's device: seat 0 the ScriptPlayer, seat 1 the RandomPlayer,
    and on every third step a random legal move for about 30% of the
    games, as an AlphaZero seat would make (its card uniform ``u[:, 3]``).  Returns every ``every``-th
    step's states with what that step drew, concatenated along the game
    axis: every phase, fortify ties, full lands and finished games occur
    within a few hundred steps."""
    dev = generator.device
    st = mirrored_initial_states(batch, generator=generator, device=dev)
    carry = script_agent.init_carry(batch, dev)
    prev = torch.full((batch,), -1, dtype=torch.int32, device=dev)
    snaps = []
    for t in range(steps):
        u, dice = draw_step_randoms(generator, batch, dev)
        legal = rules.legal_actions(st, cfg)
        g = torch.rand(legal.shape, generator=generator, device=dev)
        a = torch.argmax(torch.where(legal, g, -1.0), -1).to(torch.int32)
        if t % every == 0:
            snaps.append(MixedPlay(st, carry, prev, u, dice, a))
        s0, c0, _ = script_agent.script_step_recorded(
            st, carry, st.cur_player != prev, u, dice, cfg)
        s1, _ = random_agent.random_step_recorded(st, u, dice, cfg)
        mover0 = st.cur_player == 0
        nst = tree_select(mover0, s0, s1)
        if t % 3 == 0:
            az = torch.rand(batch, generator=generator, device=dev) < 0.3
            nst = tree_select(az, rules.step(st, a, dice, cfg,
                                             u[:, 3].contiguous()), nst)
        carry = tree_select(mover0, c0, carry)
        prev, st = st.cur_player, nst

    def cat(*xs):
        return torch.cat(xs)
    return MixedPlay(*(cat(*xs) if isinstance(xs[0], torch.Tensor)
                       else tree_map(cat, *xs) for xs in zip(*snaps)))


def force_card_cases(state: GameState, rng: np.random.Generator,
                     cfg: Config) -> GameState:
    """``state`` with the full-cards fields dealt anew from the numpy
    ``rng``, for holding the card rules: each player a hand of 0-12
    distinct cards (disjoint), the pile consistent with them (every card
    in a hand drawn) and in one of four conditions (a quarter each):
    drawn further at random, all but one or two cards drawn, empty (every
    card drawn), or only the hands drawn.  In half the games each land of
    the mover's hand it owns gets land_army_max - 2 or - 1 armies (a +2
    bonus fits on the first, not the second); ``can_draw_card`` is set in
    three games of four."""
    b, dev = state.batch_size, state.device
    rank = np.argsort(rng.random((b, NUM_LANDS)), axis=1).argsort(axis=1)
    n = rng.integers(0, 13, (b, 2))
    hands = np.stack([rank < n[:, :1], (rank >= n[:, :1])
                      & (rank < n[:, :1] + n[:, 1:])], axis=1)
    in_hands = hands.any(1)
    mode = rng.integers(0, 4, b)[:, None]
    spare = np.where(in_hands, NUM_LANDS, rank)       # the pile's order
    left = np.sort(spare, axis=1)[:, :2]
    keep = rng.integers(1, 3, b)[:, None]             # left in the pile
    nearly = spare > left[np.arange(b), keep[:, 0] - 1][:, None]
    drawn = in_hands | np.select(
        [mode == 0, mode == 1, mode == 2],
        [rng.random((b, NUM_LANDS)) < 0.5, nearly,
         np.ones((b, NUM_LANDS), bool)], np.zeros((b, NUM_LANDS), bool))
    owner = state.owner.cpu().numpy()
    cur = state.cur_player.cpu().numpy()
    mine = hands[np.arange(b), cur] & (owner == cur[:, None]) & (
        rng.random(b) < 0.5)[:, None]
    army = np.where(mine, cfg.land_army_max - rng.integers(1, 3, (b, 42)),
                    state.army.cpu().numpy()).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return state.replace(player_cards=t(hands), drawn_cards=t(drawn),
                         army=t(army),
                         can_draw_card=t(rng.random(b) < 0.75))


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
