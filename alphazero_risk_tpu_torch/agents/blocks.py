"""The agents' multi-step path: k ScriptPlayer or RandomPlayer steps per
game in one launch, in blocks of draws with one host sync per block.

Seats have kinds, the JAX package's opponent codes: ``OPP_AZ`` (the game
stops when this seat is to move), ``OPP_SCRIPT`` and ``OPP_RANDOM``.
``agent_steps`` steps each game up to k times while its stop predicate
is false (the game ended, or an AlphaZero seat is to move), the kind of
the seat to move picking the agent: one launch of the multi-step entry
(``csrc/agent_steps.cu``) on the card, ``_agent_steps_plain`` on CPU
tensors.  ``run_agent_blocks`` drives it in blocks of draws.  Together
they replace the per-iteration loops of the JAX package: the opponent
fast-forward of ``training/actor.py`` (``ff_cond`` / ``ff_body``) and
``play_match``'s ``while_loop`` in ``agents/driver.py``.

Under the profiler (``utils.profiling``) each ``run_agent_blocks`` call is
an ``actor.ff`` span, and each block's read of its step counts is a
``host.sync`` span.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import Config, STATUS_NOT_ENDED
from ..env import rules
from ..env.state import GameState, tree_select
from ..utils import profiling
from . import random_agent, script_agent
from .script_agent import ScriptCarry

I32 = torch.int32

OPP_AZ = 0              # the JAX package's opponent codes
OPP_SCRIPT = 1
OPP_RANDOM = 2

# K9's outputs after the state: the carry, the last mover, the step count.
_STEPS_OUTS = script_agent._CARRY_OUTS + (("prev", I32, ()), ("n", I32, ()))


def _kinds_code(kinds) -> int:
    """The kernel's seat kinds: bits 2p and 2p + 1 the kind of seat p."""
    if len(kinds) != 2 or any(k not in (OPP_AZ, OPP_SCRIPT, OPP_RANDOM)
                              for k in kinds):
        raise ValueError(f"seat kinds must be two of OPP_AZ, OPP_SCRIPT "
                         f"and OPP_RANDOM, got {kinds}")
    return int(kinds[0]) | int(kinds[1]) << 2


def agent_steps(state: GameState, carry: ScriptCarry, prev: torch.Tensor,
                u: torch.Tensor, dice: torch.Tensor, cfg: Config, kinds):
    """Up to k agent steps per game, game b stepping from iteration j with
    ``u[j]`` [B, 4] and ``dice[j]`` [B, 5] while its stop predicate,
    tested on the state before the step, is false: the game has ended, or
    the seat to move is an AlphaZero seat (``kinds[p] == OPP_AZ``).  The
    mover's kind picks the ScriptPlayer or the RandomPlayer; ``reset`` is
    ``cur_player != prev`` at each step, ``prev`` follows the mover of
    each step taken, and the carry changes on ScriptPlayer steps only.  A
    game that stops stays stopped, so game b's j-th step uses row j.
    Returns ``(state, carry, prev, n [B] int32)``, n the steps each game
    took.  CUDA tensors launch the multi-step entry once; CPU tensors take
    ``_agent_steps_plain``."""
    code = _kinds_code(kinds)
    if state.device.type == "cpu":
        return _agent_steps_plain(state, carry, prev, u, dice, cfg, kinds)
    b, k, ck = state.batch_size, u.shape[0], rules.checked
    ins = (*script_agent._carry_fields(carry, b),
           ck(prev, I32, (b,), "prev"), ck(u, torch.float32, (k, b, 4), "u"),
           ck(dice, I32, (k, b, 5), "dice"))
    kernels.require_aligned(u)
    cards_in, cards_out = rules.card_io(state, (b,), cfg)
    nstate, new = rules.launch_rules(
        kernels.AGENT_STEPS, state, (b,),
        (*(t.data_ptr() for t in ins), *cards_in, k, code),
        _STEPS_OUTS + cards_out, cfg)
    return (nstate, ScriptCarry(new["attack_to"], new["attack_from"],
                                new["mode_b"]), new["prev"], new["n"])


def _agent_steps_plain(state: GameState, carry: ScriptCarry,
                       prev: torch.Tensor, u: torch.Tensor,
                       dice: torch.Tensor, cfg: Config, kinds):
    """``agent_steps`` in plain PyTorch, iteration by iteration as JAX's
    ``ff_cond``/``ff_body``: each seat's agent steps every game
    (``_script_step_recorded_plain`` or ``_random_step_recorded_plain``),
    and a game takes its mover's result while its stop predicate is
    false."""
    n = torch.zeros_like(prev)
    for j in range(u.shape[0]):
        kind = torch.where(state.cur_player == 0, kinds[0], kinds[1])
        moving = ((rules._game_status_plain(state, cfg) == STATUS_NOT_ENDED)
                  & (kind != OPP_AZ) & (n == j))
        if not bool(moving.any()):
            break
        if OPP_SCRIPT in kinds:
            s_s, c_s, _ = script_agent._script_step_recorded_plain(
                state, carry, state.cur_player != prev, u[j], dice[j], cfg)
        if OPP_RANDOM in kinds:
            s_r, _ = random_agent._random_step_recorded_plain(
                state, u[j], dice[j], cfg)
        if OPP_SCRIPT not in kinds:
            s2 = s_r
        elif OPP_RANDOM not in kinds:
            s2 = s_s
        else:
            s2 = tree_select(kind == OPP_SCRIPT, s_s, s_r)
        if OPP_SCRIPT in kinds:
            carry = tree_select(moving & (kind == OPP_SCRIPT), c_s, carry)
        prev = torch.where(moving, state.cur_player, prev)
        state = tree_select(moving, s2, state)
        n = n + moving.to(I32)
    return state, carry, prev, n


def run_agent_blocks(state: GameState, carry: ScriptCarry,
                     prev: torch.Tensor, cfg: Config, block, rewind, *,
                     kinds, k: int, k_max: int, limit: int | None = None):
    """Step the games until every game's stop predicate holds
    (``agent_steps`` with the seats' ``kinds``), or ``limit`` iterations:
    the host loop of one ``(u, dice)`` draw and one sync per iteration,
    run in blocks.

    ``block(k)`` draws the next k iterations' ``(u [k, B, 4], dice
    [k, B, 5])`` as k sequential draws; ``rewind(m)`` puts the source
    back to where it stood after the block's first m of them.  After each
    block the host syncs once on ``m = max(n)``: the iterations the
    per-iteration loop would have run (it runs while some game moves), so
    it rewinds to m and, when m fills the block, goes on with a block of
    twice the size, at most ``k_max``.  The draws consumed are those of
    the per-iteration loop, so the results are too.  Returns ``(state,
    carry, prev, iterations, blocks)``."""
    total = blocks = 0
    with profiling.span("actor.ff"):
        while limit is None or total < limit:
            kk = k if limit is None else min(k, limit - total)
            u, dice = block(kk)
            state, carry, prev, n = agent_steps(state, carry, prev, u, dice,
                                                cfg, kinds)
            blocks += 1
            with profiling.span("host.sync"):
                m = int(n.max()) if n.numel() else 0
            rewind(m)
            total += m
            if m < kk:
                break
            k = min(2 * k, k_max)
    return state, carry, prev, total, blocks
