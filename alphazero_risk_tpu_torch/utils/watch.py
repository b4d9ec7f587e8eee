"""Interactive game viewer: step through a live match in the terminal.

Replacement for the reference's ImGui board GUI with its "Next turn" button
(``src/risk_game/board/board_gui.cpp:5-125``): renders the ASCII board
after every turn (or every micro-decision with ``--micro``) and waits for
Enter (``--no-pause``, or stdin at its end, runs it headless).

- ``watch_game``: two heuristic seats on the scalar oracle engine
  (``env/oracle.py``), with Python ``random.Random(seed)`` draws; no
  device.  It prints what ``alphazero_risk_tpu.utils.watch.watch_game``
  prints for the same arguments, character for character.
- ``watch_game_az``: at least one AlphaZero seat.  The port's batched
  engine and search step one game (a lockstep batch of one) with the plain
  network restored from a checkpoint role, one micro-decision per call of
  ``run_episodes``.  It runs on the card unless the caller passes
  ``device="cpu"`` (``--cpu``); with no card and no ``--cpu`` it raises.
  (The JAX viewer always runs on the CPU.)

Usage: python -m alphazero_risk_tpu_torch.cli -m watch --p1 az --p2 sp
"""

from __future__ import annotations

import itertools
import random
from typing import Iterable, Iterator, Optional, Tuple

from ..agents import oracle_agents
from ..config import Config, STATUS_DRAW, STATUS_NOT_ENDED
from ..env import oracle
from .board import render_state, render_text


def _randoms(rng: random.Random):
    u = [rng.random() for _ in range(4)]
    dice = [rng.randint(1, 6) for _ in range(5)]
    return u, dice


def _pause(micro: bool) -> None:
    try:
        input("-- Enter for next "
              f"{'micro-step' if micro else 'turn'} "
              "(Ctrl-C to stop) --")
    except EOFError:
        pass


def watch_game(p1: str = "sp", p2: str = "rp", seed: int = 0,
               cfg: Optional[Config] = None, micro: bool = False,
               pause: bool = True, max_steps: int = 5000) -> int:
    """Play one scripted/random game, rendering each turn.  Returns the
    final status (0/1 winner, -2 draw)."""
    cfg = cfg or Config()
    rng = random.Random(seed)
    perm = list(range(42))
    rng.shuffle(perm)
    s = oracle.new_game(perm)
    carries = {0: oracle_agents.OracleScriptCarry(),
               1: oracle_agents.OracleScriptCarry()}
    kinds = {0: p1, 1: p2}
    fresh = {0: True, 1: True}

    def show(step, last):
        print(render_text(s.owner, s.army, s.phase, s.cur_player, s.round,
                          s.reinforcements))
        print(f"[micro-step {step}] last mover: {last}")
        if pause:
            _pause(micro)

    step = 0
    while oracle.game_status(s, cfg) == STATUS_NOT_ENDED \
            and step < max_steps:
        p = s.cur_player
        u, dice = _randoms(rng)
        if kinds[p] == "sp":
            carries[p] = oracle_agents.script_step(
                s, carries[p], fresh[p], u, dice, cfg)
            fresh[p] = False
        else:
            oracle_agents.random_step(s, u, dice, cfg)
        step += 1
        moved_on = s.cur_player != p
        if moved_on:
            fresh[s.cur_player] = True
        if micro or moved_on:
            show(step, f"player {p} ({kinds[p]})")

    status = oracle.game_status(s, cfg)
    if status == STATUS_DRAW:
        print(f"=== draw after {s.round} rounds ===")
    elif status == STATUS_NOT_ENDED:
        print(f"=== stopped at step cap {max_steps} ===")
    else:
        print(f"=== player {status} ({kinds[int(status)]}) wins in "
              f"round {s.round} ===")
    return int(status)


def az_steps(eval_fn, state, cfg: Config, draws: Iterable,
             max_steps: int, opponent: Optional[int] = None,
             az_seats: Tuple[bool, bool] = (True, True),
             paired: bool = False) -> Iterator:
    """The AlphaZero viewer's step loop over the one game of ``state``
    (a batch of one): each step is one call of ``run_episodes`` with
    ``num_steps=1`` and argmax moves, resumed through ``carry_in`` and
    ``prev_in``; it records every mover (``record_all``), or with
    ``paired`` runs the two-net arena eval (``eval_fn(state, legal,
    use_a)``).  ``draws`` gives one draws object (``actor.GeneratorDraws``
    or anything with its methods) per step.

    Yields ``(state, pi, mover)`` after each step: the new state, the
    recorded policy [43] (float16, on the state's device) and the seat that
    moved.  Stops after the step that ends the game, or after
    ``max_steps``."""
    import torch

    from ..agents.script_agent import init_carry
    from ..training import actor as A

    dev = state.device
    carry = init_carry(1, dev)
    prev = torch.full((1,), -1, dtype=torch.int32, device=dev)
    if paired:
        kw = dict(sample_moves=False, paired_eval=True)
    else:
        kw = dict(opponent=opponent, az_seats=az_seats, sample_moves=False,
                  record_all=True)
    for _, step_draws in zip(range(max_steps), draws):
        mover = int(state.cur_player[0])
        out = A.run_episodes(eval_fn, state, step_draws, cfg, 1,
                             carry_in=carry, prev_in=prev, **kw)
        state, carry, prev = out.state, out.carry, out.prev_player
        yield state, out.samples.policy[0, 0], mover
        if int(out.status[0]) != STATUS_NOT_ENDED:
            return


def pi_line(step: int, last: str, pi) -> str:
    """The viewer's line under each board: the step, the last mover and
    the top three moves of ``pi`` (a numpy array) with their shares."""
    import numpy as np
    top = np.argsort(pi)[::-1][:3]
    moves = ", ".join(f"{'skip' if a == 42 else a}:{pi[a]:.2f}"
                      for a in top if pi[a] > 0)
    return f"[micro-step {step}] last mover: {last}  pi: {moves}"


def _restore(mgr, role: str, target, cfg: Config):
    """The train state of a checkpoint role, or of a params npz."""
    if role.endswith(".npz"):
        from ..training.checkpoints import load_params_npz
        from ..training.learner import train_state_of
        dev = next(target.net.parameters()).device
        return train_state_of(load_params_npz(role, cfg, device=dev), cfg)
    return mgr.restore(role, target)


def watch_game_az(p1: str, p2: str, seed: int = 0,
                  cfg: Optional[Config] = None,
                  ckpt_dir: str = "checkpoints", roles=("latest", "best"),
                  micro: bool = False, pause: bool = True,
                  max_steps: int = 3000, device="cuda") -> int:
    """Step through a game with at least one AlphaZero seat (B=1 engine
    and search, plain network), rendering after every turn or, with
    ``micro``, every decision.  Seat 0's weights come from ``roles[0]``
    and, for az vs az, seat 1's from ``roles[1]`` (checkpoint roles under
    ``ckpt_dir``, or params npz files).  One generator seeded with
    ``seed`` deals the game and then draws every step's randomness.
    Returns the final status."""
    import torch

    from ..agents.blocks import OPP_RANDOM, OPP_SCRIPT
    from ..device import resolve_device
    from ..env import rules
    from ..env.state import new_game
    from ..training import actor as A
    from ..training.checkpoints import CheckpointManager
    from ..training.learner import create_train_state

    cfg = cfg or Config()
    dev = resolve_device(device)
    kinds = {0: p1, 1: p2}
    az_seats = (p1 == "az", p2 == "az")
    paired = az_seats[0] and az_seats[1]
    opp = {"sp": OPP_SCRIPT, "rp": OPP_RANDOM}.get(
        p1 if p1 != "az" else p2, OPP_SCRIPT)

    ts = create_train_state(cfg, seed, dev)
    mgr = CheckpointManager(cfg, ckpt_dir)
    ts = _restore(mgr, roles[0], ts, cfg)
    if paired:
        other = _restore(mgr, roles[1], ts, cfg)
        efn = A.make_paired_eval_fn(ts.net.eval(), other.net.eval(), cfg)
    else:
        efn = A.make_eval_fn(ts.net.eval(), cfg)

    gen = torch.Generator(device=dev).manual_seed(seed)
    state = new_game(1, generator=gen, device=dev)
    draws = itertools.repeat(A.GeneratorDraws(gen, cfg, 1, dev))

    for step, (state, pi, mover) in enumerate(
            az_steps(efn, state, cfg, draws, max_steps, opponent=opp,
                     az_seats=az_seats, paired=paired), 1):
        if micro or int(state.cur_player[0]) != mover:
            print(render_state(state, 0))
            print(pi_line(step, f"player {mover} ({kinds[mover]})",
                          pi.cpu().numpy()))
            if pause:
                _pause(micro)

    status = int(rules.game_status(state, cfg)[0])
    rnd = int(state.round[0])
    if status == STATUS_DRAW:
        print(f"=== draw after {rnd} rounds ===")
    elif status == STATUS_NOT_ENDED:
        print(f"=== stopped at step cap {max_steps} ===")
    else:
        print(f"=== player {status} ({kinds[status]}) wins in round "
              f"{rnd} ===")
    return status
