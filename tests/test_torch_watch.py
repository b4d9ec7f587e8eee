"""Port parity of the board renderers, the game viewer and the profiling and
logging utilities.

- ``render_text`` and ``render_state`` give JAX's strings, character for
  character; ``render_png`` writes an image.
- ``watch_game`` (the oracle viewer) prints what JAX's prints for the same
  seat kinds, seed and ``micro``.
- ``az_steps`` (the AlphaZero viewer's step loop) against JAX's
  ``run_episodes`` chain as ``alphazero_risk_tpu.utils.watch.watch_game_az``
  builds it: the same initial state, the JAX key chain replayed
  (``JaxChainDraws``), weights carried across by ``train_state_from_jax``;
  states, rendered boards and ``pi`` equal at every micro-step, exactly.
  Both networks run in float32 here: bf16 rounds differently in XLA and
  PyTorch, and a search's visit counts follow every bit of its priors.
- ``-m watch --cpu --no-pause`` through ``cli.main``.
- ``PhaseTimer``, the ``Logs`` files and ``print_progress`` equal to JAX's
  for the same calls (apart from the ``ts`` field); ``trace`` writes a
  Chrome trace on the CPU.
"""

import builtins
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu import cli as jcli
from alphazero_risk_tpu.agents.script_agent import init_carry as j_init_carry
from alphazero_risk_tpu.env.state import new_game as j_new_game
from alphazero_risk_tpu.models.resnet import AZNet as JAZNet
from alphazero_risk_tpu.training import actor as JA
from alphazero_risk_tpu.utils import board as JB
from alphazero_risk_tpu.utils import logging as JLG
from alphazero_risk_tpu.utils import profiling as JP
from alphazero_risk_tpu.utils import watch as JW

from alphazero_risk_tpu_torch import cli
from alphazero_risk_tpu_torch.config import (PH_ATTACK, PH_REINFORCEMENT,
                                             Config)
from alphazero_risk_tpu_torch.env import oracle as TO
from alphazero_risk_tpu_torch.models import resnet as TRN
from alphazero_risk_tpu_torch.training import actor as TA
from alphazero_risk_tpu_torch.training.checkpoints import train_state_from_jax
from alphazero_risk_tpu_torch.utils import board as TB
from alphazero_risk_tpu_torch.utils import logging as TLG
from alphazero_risk_tpu_torch.utils import profiling as TP
from alphazero_risk_tpu_torch.utils import watch as TW

from test_torch_model import _flat, _randomized_variables
from test_torch_slice import JaxChainDraws, _assert_states_equal, _port_state

torch.set_num_threads(1)


# ---------------------------------------------------------------- board

def _oracle_boards(seed, every=37):
    """Boards of a random legal game on the port's oracle, every
    ``every``-th step: (owner, army, phase, cur_player, round,
    reinforcements)."""
    cfg = Config()
    rng = np.random.default_rng(seed)
    g = TO.new_game([int(x) for x in rng.permutation(42)])
    out = []
    for t in range(2000):
        if TO.game_status(g, cfg) != -1:
            break
        if t % every == 0:
            out.append((list(g.owner), list(g.army), g.phase, g.cur_player,
                        g.round, g.reinforcements))
        mask = TO.legal_actions(g, cfg)
        TO.step(g, int(rng.choice(np.nonzero(mask)[0])),
                [int(d) for d in rng.integers(1, 7, 5)], cfg)
    return out


def test_render_text_and_state_match_jax():
    """Exact string equality: ``render_text`` with and without the header,
    ``render_state`` on a port ``GameState`` against JAX's on the same
    game; the tables of phase names and owner glyphs are JAX's."""
    assert TB.PHASE_NAMES == JB.PHASE_NAMES
    assert TB.OWNER_GLYPH == JB.OWNER_GLYPH
    boards = _oracle_boards(3)
    assert len(boards) > 10
    for owner, army, *head in boards:
        assert TB.render_text(owner, army, *head) == \
            JB.render_text(owner, army, *head)
        assert TB.render_text(owner, army) == JB.render_text(owner, army)
    js = j_new_game(jax.random.PRNGKey(4), 3)
    js = js.replace(army=js.army + jnp.arange(42)[None] % 7,
                    round=js.round + 3, phase=js.phase + 2)
    ts = _port_state(js)
    for b in range(3):
        assert TB.render_state(ts, b) == JB.render_state(js, b)


def test_render_png_writes_an_image(tmp_path):
    pytest.importorskip("matplotlib")
    owner, army, *_ = _oracle_boards(5)[-1]
    path = tmp_path / "board.png"
    TB.render_png(owner, army, str(path), title="round 9")
    data = path.read_bytes()
    assert len(data) > 1000 and data[:8] == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------- viewer

@pytest.mark.parametrize("seed,micro,kinds", [(5, False, ("sp", "rp")),
                                              (8, True, ("sp", "sp")),
                                              (8, False, ("rp", "sp")),
                                              (5, True, ("rp", "rp"))])
def test_watch_game_prints_what_jax_prints(seed, micro, kinds, capsys):
    """Headless (``pause=False``): stdout equal to JAX's, character for
    character, and the same final status."""
    got = TW.watch_game(*kinds, seed=seed, micro=micro, pause=False)
    out = capsys.readouterr().out
    want = JW.watch_game(*kinds, seed=seed, micro=micro, pause=False)
    assert got == want and out == capsys.readouterr().out
    assert "NORTH_AMERICA" in out
    assert "wins in round" in out or "draw" in out


def test_watch_game_pauses_until_stdin_ends(monkeypatch, capsys):
    """With ``pause`` the viewer waits on ``input`` after every turn; at
    the end of stdin (``EOFError``) it goes on, as JAX's does."""
    prompts = []

    def no_input(prompt=""):
        prompts.append(prompt)
        raise EOFError

    monkeypatch.setattr(builtins, "input", no_input)
    TW.watch_game("sp", "rp", seed=2, micro=False, pause=True,
                  max_steps=300)
    out = capsys.readouterr().out
    assert prompts and prompts[0] == \
        "-- Enter for next turn (Ctrl-C to stop) --"
    assert len(prompts) == out.count("[micro-step")
    assert "stopped at step cap 300" in out or "wins" in out


AZ_CFG = Config(blocks=2, filters=32, value_hidden=16, mcts_simulations=8,
                max_depth=16)
# past the setup (about 50 micro-steps) into the battle phases
AZ_STEPS = 80


@functools.lru_cache(maxsize=None)
def _nets(seed):
    """A JAX float32 net with randomized weights and statistics, its
    variables, and the port's net with the same weights (built once per
    seed; no test changes them)."""
    _, variables = _randomized_variables(AZ_CFG, seed=seed)
    jnet = JAZNet(blocks=AZ_CFG.blocks, filters=AZ_CFG.filters,
                  value_hidden=AZ_CFG.value_hidden, dtype=jnp.float32)
    zeros = {k: np.zeros_like(v) for k, v in _flat(variables).items()
             if k.startswith("p/")}
    tnet = train_state_from_jax(AZ_CFG, _flat(variables), zeros, zeros, 0,
                                device="cpu").net.eval()
    return jnet, variables, tnet


@pytest.mark.parametrize("p2", ["sp", "az"])
def test_az_steps_match_jax_watch_chain(p2, monkeypatch):
    """The AlphaZero viewer's loop, az vs sp (``record_all`` with the
    ScriptPlayer's single steps) and az vs az (the paired eval), against
    the jitted one-step ``run_episodes`` that JAX's ``watch_game_az``
    calls with the same carries, on JAX's initial state and key chain:
    state, rendered board, ``pi`` (float16) and mover equal at every
    micro-step, through the setup and into the attack phase."""
    monkeypatch.setattr(TRN, "_bf16", lambda x: x)
    jc = jconfig.Config(**dataclasses.asdict(AZ_CFG))
    jnet, va, tnet = _nets(0)
    az_seats = (True, p2 == "az")
    if p2 == "az":
        _, vb, tnet_b = _nets(5)
        paired = JA.make_paired_eval_fn(jnet, jc)
        jefn = lambda s, m, use_a: paired(  # noqa: E731
            va["params"], va["batch_stats"], vb["params"],
            vb["batch_stats"], use_a, s, m)
        step1 = jax.jit(lambda s0, c, pr, k: JA.run_episodes(
            jefn, s0, k, jc, 1, sample_moves=False, paired_eval=True,
            carry_in=c, prev_in=pr))
        tefn = TA.make_paired_eval_fn(tnet, tnet_b, AZ_CFG)
        kw = dict(paired=True)
    else:
        ev = JA.make_eval_fn(jnet, jc)
        jefn = lambda s, m: ev(  # noqa: E731
            va["params"], va["batch_stats"], s, m)
        step1 = jax.jit(lambda s0, c, pr, k: JA.run_episodes(
            jefn, s0, k, jc, 1, opponent=JA.OPP_SCRIPT, az_seats=az_seats,
            sample_moves=False, record_all=True, carry_in=c, prev_in=pr))
        tefn = TA.make_eval_fn(tnet, AZ_CFG)
        kw = dict(opponent=TA.OPP_SCRIPT, az_seats=az_seats)

    key = jax.random.PRNGKey(7)
    key, k0 = jax.random.split(key)
    js = j_new_game(k0, 1)
    carry, prev = j_init_carry(1), jnp.full((1,), -1, jnp.int32)
    subs = []
    for _ in range(AZ_STEPS):
        key, sub = jax.random.split(key)
        subs.append(sub)
    draws = (JaxChainDraws(sub, AZ_CFG, 1, fast_forward=False)
             for sub in subs)
    steps = TW.az_steps(tefn, _port_state(js), AZ_CFG, draws, AZ_STEPS, **kw)
    movers, phases, n = set(), set(), 0
    for (ts, pi, mover), sub in zip(steps, subs):
        jmover = int(js.cur_player[0])
        out = step1(js, carry, prev, sub)
        js, carry, prev = out.state, out.carry, out.prev_player
        n += 1
        _assert_states_equal(ts, js, f"micro-step {n}")
        assert mover == jmover
        jpi = np.asarray(out.samples.policy)[0, 0]
        assert pi.dtype == torch.float16
        np.testing.assert_array_equal(pi.numpy(), jpi,
                                      err_msg=f"micro-step {n}")
        assert TB.render_state(ts, 0) == JB.render_state(js, 0)
        assert TW.pi_line(n, "x", pi.numpy()) == \
            TW.pi_line(n, "x", jpi)
        movers.add(mover)
        phases.add(int(ts.phase[0]))
    assert n == AZ_STEPS and movers == {0, 1}
    assert PH_ATTACK in phases and PH_REINFORCEMENT in phases


def test_watch_game_az_headless_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``watch_game_az`` restores its roles through the port's
    ``CheckpointManager``: a saved ``latest`` is played (not fresh
    weights), the board and ``pi`` line are printed per turn, and the
    run stops at its cap."""
    from alphazero_risk_tpu_torch.training.checkpoints import (
        CheckpointManager)
    from alphazero_risk_tpu_torch.training.learner import create_train_state
    cfg = Config(blocks=1, filters=16, value_hidden=8, mcts_simulations=2,
                 max_depth=8)
    ts = create_train_state(cfg, seed=11, device="cpu")
    CheckpointManager(cfg, str(tmp_path)).save("latest", ts)
    restored = []
    restore = CheckpointManager.restore

    def watched(self, role, target):
        out = restore(self, role, target)
        restored.append((role, out is not target))
        return out

    monkeypatch.setattr(CheckpointManager, "restore", watched)
    status = TW.watch_game_az("az", "rp", seed=1, cfg=cfg,
                              ckpt_dir=str(tmp_path), micro=True,
                              pause=False, max_steps=12, device="cpu")
    out = capsys.readouterr().out
    assert restored == [("latest", True)]
    assert status == -1 and "stopped at step cap 12" in out
    assert out.count("[micro-step") == 12 and "pi: " in out
    assert "player 1 (rp)" in out or "player 0 (az)" in out
    # a role may also be a params npz, as --c1 is for -m play
    from alphazero_risk_tpu_torch.training import checkpoints
    loaded = []
    load = checkpoints.load_params_npz
    monkeypatch.setattr(checkpoints, "load_params_npz", lambda *a, **kw: (
        loaded.append(a[0]) or load(*a, **kw)))
    npz = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "artifacts", "params-5block-scratch-r5-iter37.npz")
    TW.watch_game_az("sp", "az", cfg=Config(blocks=5, mcts_simulations=2,
                                            max_depth=8),
                     ckpt_dir=str(tmp_path), roles=(npz, "best"),
                     pause=False, max_steps=4, device="cpu")
    assert loaded == [npz] and restored == [("latest", True)]
    assert "stopped at step cap 4" in capsys.readouterr().out


def test_cli_watch_heuristic_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """``-m watch --p1 sp --p2 rp --cpu --no-pause`` prints what the JAX
    CLI prints, and writes no settings file."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("AZR_COMPILE_CACHE", "")
    args = ["-m", "watch", "--p1", "sp", "--p2", "rp", "--seed", "4",
            "--no-pause", "--cpu"]
    cli.main(args)
    out = capsys.readouterr().out
    jcli.main(args)
    assert out == capsys.readouterr().out
    assert "wins in round" in out or "draw" in out
    assert not os.path.exists("log/settings.txt")


def test_cli_watch_az_seat(tmp_path, monkeypatch, capsys):
    """``-m watch --p1 az --p2 sp --cpu --no-pause --micro``: the CLI hands
    the AlphaZero viewer the seats, seed, config, roles and the CPU (the
    cap is cut to keep the test short)."""
    monkeypatch.chdir(tmp_path)
    calls = []
    real = TW.watch_game_az

    def capped(*a, **kw):
        calls.append(kw)
        return real(*a, **dict(kw, max_steps=6))

    monkeypatch.setattr(TW, "watch_game_az", capped)
    cli.main(["-m", "watch", "--p1", "az", "--p2", "sp", "--cpu",
              "--no-pause", "--micro", "--blocks", "1", "--filters", "16",
              "--value-hidden", "8", "--mcts", "2", "--seed", "3"])
    out = capsys.readouterr().out
    (kw,) = calls
    assert kw["device"] == "cpu" and kw["roles"] == ("latest", "best")
    assert kw["micro"] and not kw["pause"] and kw["seed"] == 3
    assert kw["cfg"].mcts_simulations == 2 and kw["cfg"].blocks == 1
    assert out.count("[micro-step") == 6 and "stopped at step cap 6" in out
    assert not os.path.exists("log/settings.txt")


# ---------------------------------------------------------- logs, timing

def _fake_clock(monkeypatch):
    """``time.perf_counter`` as a fixed-step clock, so two runs of the same
    calls measure the same seconds."""
    import time
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 0.25)


def _read_dir(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            text = f.read()
        if name.endswith(".jsonl"):
            rows = [json.loads(line) for line in text.splitlines()]
            assert all(isinstance(r.pop("ts"), float) for r in rows)
            text = rows
        out[name] = text
    return out


def test_logs_and_phase_timer_match_jax(tmp_path, monkeypatch, capsys):
    """The same calls on the port's ``Logs`` and ``PhaseTimer`` and on
    JAX's write the same files, line for line (the events apart from
    their ``ts``), and keep the same totals; ``print_progress`` prints the
    same bar."""
    _fake_clock(monkeypatch)
    summary = {"draws": 1, "p0_wins": 5, "p0_win_started": 3, "p1_wins": 2,
               "p1_win_started": 1}
    results = {}
    for name, LG, P in (("port", TLG, TP), ("jax", JLG, JP)):
        logs = LG.Logs(str(tmp_path / name))
        timer = P.PhaseTimer(logs)
        with timer.phase("selfplay"):
            logs.log_improvement(3, 2, 10, 6, 8, 5)
        with timer.phase("train"):
            logs.log_nn_epoch(3, 1, 1.2345678, 0.5)
        with timer.phase("selfplay"):
            logs.log_benchmark(3, summary, dict(summary, draws=4))
        logs.nn_performance.write("3,512,0.125")
        logs.mcts_performance.write("3,32,0.5")
        logs.event("note", text="x", n=1)
        for i in (0, 3, 7, 10):
            LG.print_progress(i, 10, width=20)
        results[name] = (_read_dir(tmp_path / name), timer.totals,
                         capsys.readouterr().out)
    assert results["port"] == results["jax"]
    files, totals, bar = results["port"]
    assert set(files) == {"azr-improvement-log.txt", "azr-benchmark-log.txt",
                          "azr-nn-log.txt", "nn-performance-log.txt",
                          "mcts-performance-log.txt", "events.jsonl"}
    assert totals == {"selfplay": 0.5, "train": 0.25}
    assert bar.endswith("[####################] 10/10\n")


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` profiles the block with torch.profiler (CPU activity
    here) and writes a Chrome trace into its directory."""
    with TP.trace(str(tmp_path / "traces")) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    files = os.listdir(tmp_path / "traces")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "traces" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
