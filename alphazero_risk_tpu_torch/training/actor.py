"""Evaluation actor: batched MCTS against the ScriptPlayer.

Port of the versus path of ``alphazero_risk_tpu/training/actor.py``
(``run_episodes`` with ``az_seats=(True, False)``, ``opponent=OPP_SCRIPT``,
argmax moves, no sample records): every micro-step, opponent movers are
fast-forwarded to their next AlphaZero turn, then one batched MCTS over
all B games picks each AlphaZero move.

Randomness is explicit.  ``run_episodes`` takes a ``draws`` object that
hands out, per step, the search's Gumbel noise, the dice of the AlphaZero
move and the opponent's ``u``/dice of each fast-forward iteration.
``GeneratorDraws`` draws them from a ``torch.Generator``; a test can hand in
the numbers another implementation drew.

Self-play, sampled moves, the random opponent and sample records come with
the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..agents import script_agent
from ..agents.common import draw_step_randoms
from ..config import Config, STATUS_NOT_ENDED
from ..env import rules
from ..env.featurize import featurize
from ..env.state import GameState, tree_select
from ..mcts import search as mcts
from ..models.resnet import AZNet

OPP_SCRIPT = 1          # the JAX package's opponent code


def make_eval_fn(net: AZNet, cfg: Config):
    """eval_fn(state, legal) -> (probs, value) over the plain network."""

    @torch.no_grad()
    def eval_fn(state: GameState, legal: torch.Tensor):
        logits, value = net(featurize(state, cfg))
        neg_inf = torch.tensor(float("-inf"), device=logits.device)
        probs = torch.softmax(torch.where(legal, logits, neg_inf), dim=-1)
        return probs, value

    return eval_fn


class GeneratorDraws:
    """The random draws of ``run_episodes``, from one generator."""

    def __init__(self, generator: torch.Generator, cfg: Config,
                 batch: int, device):
        self.gen, self.cfg, self.batch, self.device = (generator, cfg, batch,
                                                       device)

    def begin_step(self) -> None:
        """Called once at the start of every micro-step."""

    def ff(self):
        """(u [B,4], dice [B,5]) of one opponent fast-forward iteration."""
        return draw_step_randoms(self.gen, self.batch, self.device)

    def gumbel(self) -> torch.Tensor:
        """[S, max_depth, B, 3] chance noise of the step's search."""
        return mcts.draw_gumbel(self.gen, self.cfg, self.batch, self.device)

    def az_dice(self) -> torch.Tensor:
        """[B, 5] dice of the AlphaZero move."""
        return rules.roll_dice(self.gen, self.batch).to(self.device)


class ActorOutput(NamedTuple):
    state: GameState
    status: torch.Tensor            # [B]
    carry: script_agent.ScriptCarry  # opponent carry (chunking)
    prev_player: torch.Tensor       # mover of last step
    az_decisions: torch.Tensor      # 0-d: searches made for live games


def run_episodes(eval_fn, state0: GameState, draws, cfg: Config,
                 num_steps: int, opponent: int = OPP_SCRIPT,
                 az_seats: Tuple[bool, bool] = (True, False),
                 sample_moves: bool = False, record_all: bool = False,
                 carry_in=None, prev_in=None) -> ActorOutput:
    """Advance B games ``num_steps`` AlphaZero micro-decisions.

    ``eval_fn(state, legal) -> (probs, value)`` is closed over the weights;
    ``carry_in``/``prev_in`` resume a chunked run.  Only the evaluation
    path is ported: AlphaZero in seat 0 against the ScriptPlayer, argmax
    moves, no records, so opponent movers are always fast-forwarded.
    """
    if (opponent != OPP_SCRIPT or tuple(az_seats) != (True, False)
            or sample_moves or record_all):
        raise NotImplementedError(
            "only the AlphaZero-vs-ScriptPlayer evaluation path is ported")
    b, dev = state0.batch_size, state0.device
    state = state0
    carry = script_agent.init_carry(b, dev) if carry_in is None else carry_in
    prev = (torch.full((b,), -1, dtype=torch.int32, device=dev)
            if prev_in is None else prev_in)
    decisions = torch.zeros((), dtype=torch.int64, device=dev)

    def az_turn_or_done(st):
        az = torch.where(st.cur_player == 0, az_seats[0], az_seats[1])
        return az | (rules.game_status(st, cfg) != STATUS_NOT_ENDED)

    for _ in range(num_steps):
        draws.begin_step()
        # fast-forward opponent movers to their next AlphaZero turn
        while True:
            waiting = az_turn_or_done(state)
            if bool(waiting.all()):
                break
            u, dice = draws.ff()
            reset = state.cur_player != prev
            s2, c2, _ = script_agent.script_step_recorded(
                state, carry, reset, u, dice, cfg)
            moving = ~waiting
            prev = torch.where(moving, state.cur_player, prev)
            state = tree_select(moving, s2, state)
            carry = tree_select(moving, c2, carry)

        live = rules.game_status(state, cfg) == STATUS_NOT_ENDED
        mover = state.cur_player
        res = mcts.search(state, draws.gumbel(), cfg, eval_fn)
        action = mcts.pick_move(res, state, cfg, sample=False)
        s_az = rules.step(state, action, draws.az_dice(), cfg)
        # After the fast-forward every live game is at an AlphaZero turn,
        # so the opponent branch of the JAX step body is never selected.
        state = tree_select(live, s_az, state)
        prev = mover
        decisions += live.sum()
    return ActorOutput(state=state, status=rules.game_status(state, cfg),
                       carry=carry, prev_player=prev, az_decisions=decisions)
