"""Port parity of the slice: the actor loop and one trainer iteration.

``run_episodes`` in both packages with the same fake network and every
random draw injected: the harness replays the JAX key chain of
``actor.run_episodes`` (a 5-way split per step: ``k_mcts`` for the search
and its root noise, ``k_pick`` for the sampled move, ``k_dice`` for the
move's dice, ``k_opp`` for the opponent's step; ``kff`` for the
fast-forward) and hands the port the same numbers.  Covered: the versus
path with opponent fast-forward and chunked ``carry_in``/``prev_in``,
self-play with sampled moves and root Dirichlet noise, ``record_all``
versus runs against the ScriptPlayer and the RandomPlayer, and the paired
arena; states and ``SampleBatch`` fields are bit-equal, ``backfill_values``
too.  Then ``sequential_verdict`` on a grid, and the port's
``Trainer.play`` / ``Trainer.train`` / CLI at a tiny config on the CPU with
the real folded network on the plain kernels.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.agents import script_agent as JSA
from alphazero_risk_tpu.agents.common import draw_step_randoms
from alphazero_risk_tpu.agents.driver import mirrored_initial_states
from alphazero_risk_tpu.training import actor as JA
from alphazero_risk_tpu.training import trainer as JT

from alphazero_risk_tpu_torch import cli
from alphazero_risk_tpu_torch.agents import script_agent as TSA
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env import state as TS
from alphazero_risk_tpu_torch.training import actor as TA
from alphazero_risk_tpu_torch.training import trainer as TT
from alphazero_risk_tpu_torch.training.replay import ReplayBuffer
from alphazero_risk_tpu_torch.training.trainer import Trainer

from test_torch_mcts import jax_eval, port_eval, search_gumbel

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


class JaxChainDraws:
    """The draws of one JAX ``run_episodes`` call, from its key.
    ``fast_forward``: the call fast-forwards its opponent (one more split
    per step, ``actor.py:220``)."""

    def __init__(self, key, cfg, batch, fast_forward=True):
        self.key, self.cfg, self.b = key, cfg, batch
        self.fast_forward = fast_forward

    def begin_step(self):
        (self.key, self.k_mcts, self.k_pick, self.k_dice,
         self.k_opp) = jax.random.split(self.key, 5)
        if self.fast_forward:
            self.key, self.kff = jax.random.split(self.key)
        # search(): the root noise takes one split off the search's key
        self.k_sims = self.k_mcts
        if self.cfg.use_dirichlet_noise:
            self.k_sims, self.k_noise = jax.random.split(self.k_mcts)

    def ff(self):
        self.kff, ko = jax.random.split(self.kff)
        u, dice = draw_step_randoms(ko, self.b)
        return _t(u), _t(dice)

    def ff_block(self, k):
        """k ``ff()`` draws, stacked; ``ff_rewind(m)`` puts the chain back
        to after the first m of them."""
        self.kff_before = []
        us, dice = [], []
        for _ in range(k):
            self.kff_before.append(self.kff)
            u, d = self.ff()
            us.append(u)
            dice.append(d)
        return torch.stack(us), torch.stack(dice)

    def ff_rewind(self, m):
        if m < len(self.kff_before):
            self.kff = self.kff_before[m]

    def gumbel(self):
        return search_gumbel(self.k_sims, self.cfg.mcts_simulations,
                             self.cfg.max_depth, self.b)

    def root_noise(self):
        return _t(jax.random.uniform(self.k_noise, (self.b, 43), jnp.float32,
                                     minval=1e-7, maxval=1.0 - 1e-4))

    def pick(self):
        return _t(jax.random.gumbel(self.k_pick, (self.b, 43), jnp.float32))

    def az_dice(self):
        kd, _ = jax.random.split(self.k_dice)
        return _t(jax.random.randint(kd, (self.b, 5), 1, 7,
                                     dtype=jnp.int32))

    def opp(self):
        u, dice = draw_step_randoms(self.k_opp, self.b)
        return _t(u), _t(dice)


def _port_state(js):
    return TS.GameState(**{f.name: _t(getattr(js, f.name))
                           for f in dataclasses.fields(TS.GameState)})


def _assert_states_equal(ts, js, msg):
    for f in dataclasses.fields(TS.GameState):
        np.testing.assert_array_equal(
            getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
            err_msg=f"{msg} field {f.name}")


def _assert_carry_equal(tcar, jcar, msg):
    for f in dataclasses.fields(TSA.ScriptCarry):
        np.testing.assert_array_equal(
            getattr(tcar, f.name).numpy(), np.asarray(getattr(jcar, f.name)),
            err_msg=f"{msg} carry {f.name}")


def test_run_episodes_matches_jax():
    cfg = Config(mcts_simulations=4, max_depth=8)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    b, chunk = 4, 30
    js = mirrored_initial_states(jax.random.PRNGKey(3), b)
    ts = _port_state(js)
    kw = dict(az_seats=(True, False), sample_moves=False, record_all=False)
    run = jax.jit(lambda s, k, c, p: JA.run_episodes(
        jax_eval, s, k, jc, chunk, opponent=JA.OPP_SCRIPT, carry_in=c,
        prev_in=p, **kw))
    jcar, jprev = JSA.init_carry(b), jnp.full((b,), -1, jnp.int32)
    tcar, tprev = None, None
    for c, key in enumerate(jax.random.split(jax.random.PRNGKey(9), 2)):
        jout = run(js, key, jcar, jprev)
        tout = TA.run_episodes(port_eval, ts, JaxChainDraws(key, cfg, b),
                               cfg, chunk, opponent=TA.OPP_SCRIPT,
                               carry_in=tcar, prev_in=tprev, **kw)
        js, jcar, jprev = jout.state, jout.carry, jout.prev_player
        ts, tcar, tprev = tout.state, tout.carry, tout.prev_player
        _assert_states_equal(ts, js, f"chunk {c}")
        _assert_carry_equal(tcar, jcar, f"chunk {c}")
        np.testing.assert_array_equal(tout.status.numpy(),
                                      np.asarray(jout.status))
        np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
    # both seats moved: the games left setup and reached the battle phases
    assert (ts.round > 28).all() and int(tout.az_decisions) > 0


def jax_eval_b(state, legal):
    """A second fake network (the arena's model B): another prior, the
    negated value."""
    w = (jnp.arange(43) % 5 + 1).astype(jnp.float32)
    prior = jnp.where(legal, w, 0.0)
    return (prior / prior.sum(-1, keepdims=True),
            -jax_eval(state, legal)[1])


def port_eval_b(state, legal):
    w = (torch.arange(43) % 5 + 1).to(torch.float32)
    prior = torch.where(legal, w, 0.0)
    return (prior / prior.sum(-1, keepdim=True),
            -port_eval(state, legal)[1])


def jax_paired(state, legal, use_a):
    pa, va = jax_eval(state, legal)
    pb, vb = jax_eval_b(state, legal)
    return jnp.where(use_a[:, None], pa, pb), jnp.where(use_a, va, vb)


def port_paired(state, legal, use_a):
    pa, va = port_eval(state, legal)
    pb, vb = port_eval_b(state, legal)
    return torch.where(use_a[:, None], pa, pb), torch.where(use_a, va, vb)


RECORD_MODES = {
    # self-play as generate_selfplay runs it, with root Dirichlet noise
    "selfplay_noise": dict(
        cfg=dict(use_dirichlet_noise=True), evals=(jax_eval, port_eval),
        kw=dict(sample_moves=True)),
    "versus_script_record_all": dict(
        cfg={}, evals=(jax_eval, port_eval),
        kw=dict(opponent=1, az_seats=(True, False), sample_moves=False,
                record_all=True)),
    "versus_random_record_all": dict(
        cfg={}, evals=(jax_eval, port_eval),
        kw=dict(opponent=2, az_seats=(True, False), sample_moves=True,
                record_all=True)),
    "paired_arena": dict(
        cfg={}, evals=(jax_paired, port_paired),
        kw=dict(sample_moves=False, paired_eval=True)),
}


@pytest.mark.parametrize("mode", sorted(RECORD_MODES))
def test_run_episodes_records_match_jax(mode):
    """States, opponent carry and every ``SampleBatch`` field bit-equal
    (policies are visit shares or one-hot rows, rounded to float16 the same
    way); then ``backfill_values`` on those records, plain and
    round-weighted, equal too."""
    spec = RECORD_MODES[mode]
    cfg = Config(mcts_simulations=4, max_depth=8, **spec["cfg"])
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    b, steps = 4, 40
    jeval, teval = spec["evals"]
    js = mirrored_initial_states(jax.random.PRNGKey(5), b)
    ts = _port_state(js)
    key = jax.random.PRNGKey(11)
    jout = jax.jit(lambda s, k: JA.run_episodes(
        jeval, s, k, jc, steps, **spec["kw"]))(js, key)
    draws = JaxChainDraws(key, cfg, b, fast_forward=False)
    tout = TA.run_episodes(teval, ts, draws, cfg, steps, **spec["kw"])
    _assert_states_equal(tout.state, jout.state, mode)
    _assert_carry_equal(tout.carry, jout.carry, mode)
    np.testing.assert_array_equal(tout.prev_player.numpy(),
                                  np.asarray(jout.prev_player))
    valid = np.asarray(jout.samples.valid)
    assert valid.shape == (steps, b) and valid.sum() > steps
    for name in TA.SampleBatch._fields:
        t, j = getattr(tout.samples, name), getattr(jout.samples, name)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=f"{mode} samples.{name}")
    if "record_all" in mode:
        # opponent decisions are recorded as one-hot rows
        opp = valid & (np.asarray(jout.samples.cur_player) == 1)
        assert opp.any()
        assert (np.asarray(jout.samples.policy)[opp].max(-1) == 1).all()
    # value targets: a made-up final status exercises win, loss, draw and
    # unfinished; final rounds for the round-weighted variant
    status = np.array([0, 1, -2, -1], np.int32)
    final_round = np.array([50, 40, 58, 30], np.int32)
    for rw in (False, True):
        jz = JA.backfill_values(jout.samples, jnp.asarray(status),
                                jnp.asarray(final_round), rw).value
        tz = TA.backfill_values(tout.samples, _t(status), _t(final_round),
                                rw).value
        assert tz.dtype == torch.float32
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_state_and_features_of_samples_match_jax():
    """Records -> GameState -> feature planes, both packages, bit-equal."""
    from test_torch_replay import fake_samples
    flat = fake_samples(64)
    jsb = JA.SampleBatch(valid=None, **{k: jnp.asarray(v)
                                        for k, v in flat.items()})
    tsb = TA.SampleBatch(valid=None, **{k: torch.from_numpy(v)
                                        for k, v in flat.items()})
    cfg, jc = Config(), jconfig.Config()
    _assert_states_equal(TA.state_of_samples(tsb, cfg),
                         JA.state_of_samples(jsb, jc), "state_of_samples")
    np.testing.assert_array_equal(
        TA.features_of_samples(tsb, cfg).numpy(),
        np.asarray(JA.features_of_samples(jsb, jc)))


@pytest.mark.parametrize("threshold", [0.5, 0.55])
def test_sequential_verdict_matches_jax(threshold):
    for wins in range(0, 130, 3):
        for losses in range(0, 130, 3):
            for z, floor in ((2.24, 96), (0.1, 2)):
                assert TT.sequential_verdict(
                    wins, losses, threshold, z=z, min_decided=floor) == \
                    JT.sequential_verdict(wins, losses, threshold, z=z,
                                          min_decided=floor)


def test_trainer_play_int8_to_the_end(tmp_path, monkeypatch):
    """The first slice's entry point on the CPU at a tiny width: the
    folded, quantized and calibrated int8 network (plain K1, K4, K5) and
    plain K2/K3/K6."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(blocks=2, filters=32, value_hidden=16, mcts_simulations=4,
                 max_depth=8, env_batch_per_device=4, actor_chunk_steps=64,
                 fast_infer=True, fast_infer_int8=True)
    trainer = Trainer(cfg, seed=0, device="cpu")
    assert "act_s" in trainer.folded()
    res = trainer.play(TA.OPP_SCRIPT, 3)          # rounded up to a pair
    assert res["games"] == 4 and res["unfinished"] == 0
    assert res["p0_wins"] + res["p1_wins"] + res["draws"] == 4
    assert trainer.play_stats["az_decisions"] > 0


TINY = Config(blocks=2, filters=32, value_hidden=16, mcts_simulations=2,
              max_depth=6, batch_size=32, env_batch_per_device=4,
              train_iteration_games=4, compare_games=4, epochs=2,
              benchmark_games_random=2, benchmark_games_script=2,
              max_game_steps=192, actor_chunk_steps=64,
              samples_storage_min_batches=2, samples_storage_max_batches=64,
              use_dirichlet_noise=True, fast_infer=True,
              fast_infer_int8=True, arena_early_stop_min_games=2)


def _events(trainer):
    with open(os.path.join(trainer.logs.dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_train_iteration_and_resume(tmp_path, monkeypatch):
    """One iteration of ``Trainer.train`` on the CPU (self-play with
    records and root noise, trim, epochs, paired-eval gate, accept or
    revert, benchmark, checkpoint, meta, replay npz), then a second trainer
    resumes at iteration 1."""
    monkeypatch.chdir(tmp_path)
    t = Trainer(TINY, seed=0, device="cpu")
    before = {k: v.clone() for k, v in t.train_state.net.state_dict().items()}
    t.train(iterations=1, resume=False)
    kinds = [e["kind"] for e in _events(t)]
    for kind in ("selfplay", "nn_epoch", "improvement", "iteration"):
        assert kind in kinds, kinds
    sp = next(e for e in _events(t) if e["kind"] == "selfplay")
    assert sp["games"] == 4 and sp["samples"] > 100
    assert len(t.replay) >= sp["samples"]      # + the arena's records
    assert len(t.epoch_log) == 2
    assert all(np.isfinite(e["pi_loss"]) and np.isfinite(e["v_loss"])
               for e in t.epoch_log)
    after = t.train_state.net.state_dict()
    accepted = "benchmark" in kinds
    assert t.ckpt.exists("latest") and t.ckpt.load_meta()["iteration"] == 1
    assert t.ckpt.exists("best") == accepted
    assert t.ckpt.exists("iter-0") == accepted
    if accepted:     # the learner's weights moved and were promoted
        assert any(not torch.equal(after[k], before[k]) for k in before)
        assert all(torch.equal(v, after[k])
                   for k, v in t.net.state_dict().items())
    else:            # reverted to the last accepted weights
        assert all(torch.equal(after[k], before[k]) for k in before)
    assert os.path.exists(t._replay_path())

    t2 = Trainer(TINY.replace(compare_games=0), seed=0, device="cpu")
    fresh_gen = t2.gen.get_state().clone()
    t2.train(iterations=1, resume=True, do_benchmark=False)
    assert t2.iteration == 1 and t2.ckpt.exists("iter-1")
    assert t2.ckpt.load_meta()["iteration"] == 2
    assert not torch.equal(t2.gen.get_state(), fresh_gen)
    assert len(t2.replay) > len(t.replay)      # restored, then extended
    # the restored learner continued from the saved step count
    assert t2.train_state.step > t.train_state.step


def test_gate_early_stop_and_revert(tmp_path, monkeypatch):
    """The gate's sequential early stop on a tiny arena, and the revert:
    a rejected candidate leaves the learner on the actor's weights."""
    monkeypatch.chdir(tmp_path)
    cfg = TINY.replace(arena_early_stop_z=0.1, compare_threshold=1.1,
                       use_dirichlet_noise=False)
    t = Trainer(cfg, seed=5, device="cpu")
    from test_torch_replay import fake_samples
    t.replay.extend(fake_samples(64))
    t.train_epochs(epochs=1)
    n0 = len(t.replay)
    assert t.gate() is False                   # nobody wins 110%
    assert len(t.replay) > n0                  # arena records were kept
    assert any(e["kind"] == "gate_early_stop" for e in _events(t))
    assert not t.ckpt.exists("best")
    for k, v in t.net.state_dict().items():
        assert torch.equal(v, t.train_state.net.state_dict()[k]), k


def test_train_epochs_chunked_upload(tmp_path, monkeypatch):
    """Buffers above ``train_upload_max_samples`` train as fixed-size
    chunks whose tail wraps (3 chunks of 96 over 250 samples)."""
    monkeypatch.chdir(tmp_path)
    from test_torch_replay import fake_samples
    t = Trainer(TINY.replace(train_upload_max_samples=96), seed=0,
                device="cpu")
    t.replay.extend(fake_samples(250))
    pi, v = t.train_epochs(epochs=2)
    assert np.isfinite(pi) and np.isfinite(v)
    assert t.train_state.step == 2 * 3 * (96 // 32)


def test_reuse_and_ring_run_and_full_cards_searches_refuse(tmp_path,
                                                          monkeypatch):
    """The two switches the port once refused now run: under
    ``tree_reuse`` the Trainer plays its games on trees of JAX's node
    budget (2 S + 2), and under ``device_replay`` it keeps a ring of JAX's
    capacity, fields and dtypes.  Full cards stay refused by every
    searching path, as in JAX."""
    monkeypatch.chdir(tmp_path)
    from alphazero_risk_tpu.training import device_replay as JDR
    from alphazero_risk_tpu_torch.training import device_replay as TDR
    reuse = TINY.replace(tree_reuse=True)
    assert reuse.num_nodes == jconfig.Config(
        **dataclasses.asdict(reuse)).num_nodes == 2 * 2 + 2
    t = Trainer(reuse, device="cpu")
    res = t.play(TA.OPP_SCRIPT, 2)
    assert res["games"] == 2 and t.play_stats["az_decisions"] > 0
    ring_cfg = TINY.replace(device_replay=True)
    ring = Trainer(ring_cfg, device="cpu").replay
    jring = JDR.DeviceReplay(jconfig.Config(**dataclasses.asdict(ring_cfg)))
    assert isinstance(ring, TDR.DeviceReplay) and ring.cap == jring.cap
    for k, v in ring.data.items():
        j = np.asarray(jring.data[k])
        assert (tuple(v.shape), v.numpy().dtype) == (j.shape, j.dtype), k
        np.testing.assert_array_equal(v.numpy(), j)
    # full cards are ported, but neither package searches under them (no
    # card uniform for step_with_outcome): the port refuses up front
    from alphazero_risk_tpu.env import rules as JR
    from alphazero_risk_tpu.env.state import new_game as j_new_game
    from alphazero_risk_tpu_torch.env import rules as TR
    from alphazero_risk_tpu_torch.mcts import search as TM
    full = TINY.replace(simple_cards=False)
    with pytest.raises(ValueError, match=TR.NEEDS_UNIFORM):
        Trainer(full, device="cpu").play(TA.OPP_SCRIPT, 2)
    root = _port_state(j_new_game(jax.random.PRNGKey(0), 2))
    node = torch.zeros(2, dtype=torch.int32)
    for refused in (
            lambda: TM.search(root, None, full, None),
            lambda: TM.search_with_reuse(root, None, full, None, None, None),
            lambda: TA.run_episodes(None, root, None, full, 1),
            lambda: TR.expand(TS.tree_map(lambda x: x[:, None], root), node,
                              node, node, full)):
        with pytest.raises(ValueError, match=TR.NEEDS_UNIFORM):
            refused()
    zeros = jnp.zeros((2,), jnp.int32)
    with pytest.raises(AssertionError, match=TR.NEEDS_UNIFORM):
        JR.step_with_outcome(j_new_game(jax.random.PRNGKey(0), 2), zeros,
                             zeros, jconfig.Config(**dataclasses.asdict(
                                 full)))


def test_cli_train_and_play_random(tmp_path, monkeypatch, capsys):
    """``-m train`` on the CPU writes its settings dump, checkpoints, meta
    and the replay npz; ``-m play --p2 rp`` then loads ``latest``."""
    monkeypatch.chdir(tmp_path)
    tiny = ["--cpu", "--blocks", "1", "--filters", "16", "--value-hidden",
            "8", "--mcts", "2", "--env-batch", "4", "--max-steps", "128",
            "--bench-random", "2", "--bench-script", "2", "--fast", "--int8"]
    cli.main(["-m", "train", "--ti", "1", "--tg", "4", "--games", "2",
              "--e", "1", "--bs", "32", *tiny])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "train" and out["samples"] > 0
    assert np.isfinite(out["pi_loss"])
    for rel in ("log/settings.txt", "checkpoints/latest.pt",
                "checkpoints/meta.json", "data/training_samples.npz"):
        assert os.path.exists(rel), rel
    buf = ReplayBuffer(Config())
    assert buf.load("data/training_samples.npz")
    assert len(buf) == out["samples"]
    cli.main(["-m", "play", "--p2", "rp", "--c1", "latest", "--games", "2",
              *tiny])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["p2"] == "rp" and res["games"] == 2


@pytest.mark.parametrize("trained", [True, False])
def test_cli_play_without_c1_plays_latest(tmp_path, monkeypatch, capsys,
                                          trained):
    """``-m play`` with no ``--c1`` plays the checkpoint role ``latest``,
    as the JAX CLI does (``--c1`` defaults to ``latest``,
    ``alphazero_risk_tpu/cli.py:37-38,207-211``): the weights played are
    those of the ``latest`` that a one-iteration ``-m train`` under another
    seed wrote, not the fresh weights of the play's own ``--seed``.  With
    no ``latest`` the restore keeps the fresh weights, as JAX's
    ``CheckpointManager.restore`` does."""
    monkeypatch.chdir(tmp_path)
    tiny = ["--cpu", "--blocks", "1", "--filters", "16", "--value-hidden",
            "8", "--mcts", "2", "--env-batch", "4", "--max-steps", "128",
            "--bench-random", "2", "--bench-script", "2", "--fast", "--int8"]
    if trained:
        cli.main(["-m", "train", "--ti", "1", "--tg", "4", "--games", "2",
                  "--e", "1", "--bs", "32", "--seed", "3", *tiny])
        assert os.path.exists("checkpoints/latest.pt")
    played = []
    real_play = Trainer.play

    def play(self, opponent, games):
        played.append({k: v.clone() for k, v in self.net.state_dict().items()})
        return real_play(self, opponent, games)

    monkeypatch.setattr(Trainer, "play", play)
    capsys.readouterr()
    cli.main(["-m", "play", "--p2", "rp", "--games", "2", *tiny])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["p2"] == "rp" and res["games"] == 2 and len(played) == 1
    fresh = Trainer(cli.config_from_args(cli.build_parser().parse_args(
        tiny)), seed=0, device="cpu").net.state_dict()
    if trained:
        want = torch.load("checkpoints/latest.pt", weights_only=True)["net"]
        assert any(not torch.equal(fresh[k], want[k]) for k in want)
    else:
        want = fresh
    assert played[0].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(played[0][k], v), k
