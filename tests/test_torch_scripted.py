"""Port parity of the supervised-bootstrap path: the scripted episodes,
``Trainer.train_on_data``, ``train_on_script``, ``play_az_vs_az`` and the
CLI modes that reach them.

``run_scripted_episodes`` in both packages from the same mirrored deals,
with the port handed the numbers of the JAX key chain (``key, k =
split(key)``; ``draw_step_randoms(k, b)`` per step): states, carry,
``prev_player``, status and every ``SampleBatch`` field bit-equal, in one
call and resumed in two chunks, for Script-vs-Script and Script-vs-Random
under five rule configurations (one with full cards).  Then the trainer paths on the CPU at a
tiny width with the real folded network on the plain kernels.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.agents.common import draw_step_randoms
from alphazero_risk_tpu.agents.driver import mirrored_initial_states
from alphazero_risk_tpu.training import actor as JA

from alphazero_risk_tpu_torch import cli
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.training import actor as TA
from alphazero_risk_tpu_torch.training.trainer import Trainer

from test_torch_slice import (_assert_carry_equal, _assert_states_equal,
                              _port_state, _t)

torch.set_num_threads(1)


class JaxScriptedDraws:
    """The draws of one JAX ``run_scripted_episodes`` call, from its key."""

    def __init__(self, key, batch):
        self.key, self.b = key, batch

    def begin_step(self):
        self.key, self.k = jax.random.split(self.key)

    def opp(self):
        u, dice = draw_step_randoms(self.k, self.b)
        return _t(u), _t(dice)


def _assert_samples_equal(ts, js, msg):
    for f in TA.SampleBatch._fields:
        a, r = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == r.dtype, f"{msg} {f}: {a.dtype} vs {r.dtype}"
        np.testing.assert_array_equal(a, r, err_msg=f"{msg} samples {f}")


@pytest.mark.parametrize("kinds", [(TA.OPP_SCRIPT, TA.OPP_SCRIPT),
                                   (TA.OPP_SCRIPT, TA.OPP_RANDOM)],
                         ids=["script-script", "script-random"])
@pytest.mark.parametrize("cfg", [
    Config(),
    Config(limit_attack_moves=True),
    Config(limit_reinforcement_moves=False),
    Config(exact_fortify_tiebreak=False),
    Config(simple_cards=False),
], ids=["default", "limit-attack", "free-reinforcement", "lowest-index",
        "full-cards"])
def test_run_scripted_episodes_matches_jax(cfg, kinds):
    b, steps = 8, 160
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    js0 = mirrored_initial_states(jax.random.PRNGKey(sum(kinds)), b)
    if not cfg.simple_cards:
        # hands dealt up front: the first trade of fresh deals comes after
        # 200-300 steps
        js0 = _dealt(js0, cfg)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda s, k: JA.run_scripted_episodes(
        s, k, jc, steps, kinds))(js0, key)

    ts0 = _port_state(js0)
    one = TA.run_scripted_episodes(ts0, JaxScriptedDraws(key, b), cfg, steps,
                                   kinds)
    draws = JaxScriptedDraws(key, b)
    first = TA.run_scripted_episodes(ts0, draws, cfg, steps // 2, kinds)
    second = TA.run_scripted_episodes(first.state, draws, cfg, steps // 2,
                                      kinds, carry_in=first.carry,
                                      prev_in=first.prev_player)
    chunked = TA.SampleBatch(*(torch.cat(x) for x in zip(first.samples,
                                                         second.samples)))
    for name, out, samples in (("one call", one, one.samples),
                               ("two chunks", second, chunked)):
        _assert_states_equal(out.state, ref.state, name)
        _assert_carry_equal(out.carry, ref.carry, name)
        np.testing.assert_array_equal(out.prev_player.numpy(),
                                      np.asarray(ref.prev_player))
        np.testing.assert_array_equal(out.status.numpy(),
                                      np.asarray(ref.status))
        _assert_samples_equal(samples, ref.samples, name)
        assert int(out.az_decisions) == 0
    phases = set(np.asarray(ref.samples.phase).ravel().tolist())
    assert phases == set(range(6)), phases
    # every record is a one-hot policy; the scripted fortify without an
    # armed land is the only unrecorded live decision
    pol = np.asarray(ref.samples.policy, np.float32)
    assert (pol.sum(-1) == 1).all() and (pol.max(-1) == 1).all()
    assert np.asarray(ref.samples.valid).mean() > 0.9
    if not cfg.simple_cards:         # a full trade happened
        assert (one.state.card_sets_played > 0).any()


def _dealt(js, cfg):
    """The JAX states ``js`` with their card fields dealt by the port's
    ``driver.force_card_cases`` (numpy seed 3)."""
    from alphazero_risk_tpu.env.state import GameState as JState
    from alphazero_risk_tpu_torch.agents.driver import force_card_cases
    ts = force_card_cases(_port_state(js), np.random.default_rng(3), cfg)
    return JState(**{f.name: jax.numpy.asarray(getattr(ts, f.name).numpy())
                     for f in dataclasses.fields(JState)})


TINY = Config(blocks=2, filters=32, value_hidden=16, mcts_simulations=2,
              max_depth=6, batch_size=32, env_batch_per_device=4,
              train_iteration_games=2, compare_games=4, epochs=1,
              benchmark_games_random=2, benchmark_games_script=2,
              data_games_ss=4, data_games_sr=4, max_game_steps=128,
              actor_chunk_steps=64, samples_storage_min_batches=2,
              samples_storage_max_batches=64, fast_infer=True,
              fast_infer_int8=True, arena_early_stop_min_games=2)


def test_train_on_data_iteration(tmp_path, monkeypatch):
    """One loop of ``train_on_data`` on the CPU: the fresh buffer holds
    exactly the scripted games' valid records, the learner takes 3 epochs
    of ``n // batch_size`` steps, the arena never reverts the candidate,
    and ``temp``, ``latest`` and the meta are written."""
    monkeypatch.chdir(tmp_path)
    cfg = TINY
    t = Trainer(cfg, seed=0, device="cpu")
    actor0 = {k: v.clone() for k, v in t.net.state_dict().items()}
    valid, seen, reverts = [0], {}, []

    real_call = t._scripted_call

    def scripted_call(kinds):
        call = real_call(kinds)

        def counted(state, carry, prev):
            out = call(state, carry, prev)
            valid[0] += int(out.samples.valid.sum())
            return out
        return counted

    real_epochs = t.train_epochs

    def epochs(epochs=None):
        seen["n"], seen["step0"] = len(t.replay), t.train_state.step
        seen["lockstep"] = t.play_stats["steps"]
        out = real_epochs(epochs)
        seen["epochs"] = epochs
        seen["trained"] = {k: v.clone() for k, v in
                           t.train_state.net.state_dict().items()}
        return out

    real_gate = t.gate

    def gate(revert_on_fail=None):
        seen["accepted"] = real_gate(revert_on_fail)
        return seen["accepted"]

    monkeypatch.setattr(t, "_scripted_call", scripted_call)
    monkeypatch.setattr(t, "train_epochs", epochs)
    monkeypatch.setattr(t, "gate", gate)
    monkeypatch.setattr(t, "_revert", lambda: reverts.append(1))
    t.train_on_data(loops=1)
    n = seen["n"]
    assert n == valid[0] > 0
    # the two scripted waves ran every chunk before the learner started
    assert seen["lockstep"] == 2 * cfg.max_game_steps
    assert seen["epochs"] == 3
    assert t.train_state.step - seen["step0"] == 3 * (n // cfg.batch_size)
    # the learner keeps the trained weights whatever the arena said; the
    # actor takes them only on acceptance
    assert not reverts
    for k, v in t.train_state.net.state_dict().items():
        assert torch.equal(v, seen["trained"][k]), k
    assert any(not torch.equal(v, actor0[k])
               for k, v in seen["trained"].items())
    want = seen["trained"] if seen["accepted"] else actor0
    for k, v in t.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert t.ckpt.exists("best") == seen["accepted"]
    assert t.ckpt.exists("temp") and t.ckpt.exists("latest")
    assert t.ckpt.load_meta()["iteration"] == 1
    assert len(t.replay) > n                   # + the arena's records


def test_train_on_script_and_play_az_vs_az(tmp_path, monkeypatch):
    """``train_on_script`` for one iteration (games against the
    ScriptPlayer with every decision recorded, epochs, gate, latest, meta,
    replay npz), then ``play_az_vs_az`` of the learner against ``latest``
    and against a missing role (the learner itself)."""
    monkeypatch.chdir(tmp_path)
    t = Trainer(TINY, seed=1, device="cpu")
    t.train_on_script(iterations=1)
    assert len(t.replay) > 0 and len(t.epoch_log) == 1
    assert np.isfinite(t.epoch_log[0]["pi_loss"])
    assert t.ckpt.exists("latest") and t.ckpt.load_meta()["iteration"] == 1
    assert os.path.exists(t._replay_path())
    steps0 = t.play_stats["paired_steps"]
    res = t.play_az_vs_az("latest", 4)
    assert res["games"] == 4
    assert res["p0_wins"] + res["p1_wins"] + res["draws"] + \
        res["unfinished"] == 4
    assert t.play_stats["paired_steps"] > steps0
    assert t.play_az_vs_az("no-such-role", 2)["games"] == 2


TINY_ARGS = ["--cpu", "--blocks", "1", "--filters", "16", "--value-hidden",
             "8", "--mcts", "2", "--env-batch", "4", "--max-steps", "128",
             "--bench-random", "2", "--bench-script", "2", "--fast",
             "--int8", "--bs", "32", "--e", "1"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_data_train_script_and_play_az(tmp_path, monkeypatch,
                                                 capsys):
    """``-m train-data`` and ``-m train-script`` on the CPU write their
    settings, checkpoints and meta; ``-m play --p2 az`` then plays
    ``latest`` against ``temp``."""
    monkeypatch.chdir(tmp_path)
    cli.main(["-m", "train-data", "--dtl", "1", "--dgss", "2", "--dgsr", "2",
              "--games", "2", *TINY_ARGS])
    out = _last_json(capsys)
    assert out["mode"] == "train-data" and out["samples"] > 0
    assert np.isfinite(out["pi_loss"])
    for rel in ("log/settings.txt", "checkpoints/temp.pt",
                "checkpoints/latest.pt", "checkpoints/meta.json"):
        assert os.path.exists(rel), rel
    with open("log/settings.txt") as f:
        assert "data_games_ss=2\n" in f.read()
    cli.main(["-m", "play", "--p1", "az", "--p2", "az", "--c1", "latest",
              "--c2", "temp", "--games", "2", *TINY_ARGS])
    res = _last_json(capsys)
    assert res["p2"] == "az" and res["games"] == 2
    cli.main(["-m", "train-script", "--ti", "1", "--tg", "1", "--games", "2",
              *TINY_ARGS])
    out = _last_json(capsys)
    assert out["mode"] == "train-script" and out["samples"] > 0
    assert os.path.exists("data/training_samples.npz")


@pytest.mark.parametrize("p1,p2", [("sp", "rp"), ("sp", "sp")])
def test_cli_play_heuristic_players(p1, p2, tmp_path, monkeypatch, capsys):
    """``-m play --p1 sp|rp --p2 sp|rp --cpu`` runs ``play_match`` to the
    end with no network when the native engine does not load, and the
    native engine's matches when it does; an az player only sits in
    --p1."""
    from alphazero_risk_tpu_torch import native
    monkeypatch.chdir(tmp_path)
    args = ["-m", "play", "--p1", p1, "--p2", p2, "--games", "4", "--cpu"]
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        cli.main(args)
    res = _last_json(capsys)
    assert (res["p1"], res["p2"], res["engine"]) == (p1, p2, "torch")
    assert res["games"] == 4 and res["unfinished"] == 0
    assert res["p0_wins"] + res["p1_wins"] + res["draws"] == 4
    assert 0 < res["micro_steps"] < Config().max_game_steps
    cli.main(args)
    res = _last_json(capsys)
    assert (res["p1"], res["p2"], res["engine"]) == (p1, p2, "native")
    assert res["games"] == 4
    assert res["p0_wins"] + res["p1_wins"] + res["draws"] == 4
    assert res["micro_steps"] > 0
    with pytest.raises(SystemExit, match="--p1"):
        cli.main(["-m", "play", "--p1", p1, "--p2", "az", "--cpu"])
