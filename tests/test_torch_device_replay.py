"""Port parity: the device-resident replay ring and its epochs.

The port's ``DeviceReplay`` (on the CPU here) against JAX's, bit for bit
after every operation: the physical arrays, ``start``, ``size``,
``old_game_index`` and the write-time overflow flag.  The ring's logical
contents against the port's host ``ReplayBuffer`` fed the same records;
the npz files of either ring loaded by the other package's buffers; the
ring epoch against JAX's ``make_ring_epoch_fn`` from the same carried
weights and uniforms; and the port's ``Trainer`` on the ring (one
``train`` iteration with resume, one ``train_on_data`` loop), whose buffer
after self-play equals a host-buffer trainer's from the same seed.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.training import actor as JA
from alphazero_risk_tpu.training import device_replay as JDR
from alphazero_risk_tpu.training import learner as JL
from alphazero_risk_tpu.training import replay as JR

from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.training import actor as TA
from alphazero_risk_tpu_torch.training import device_replay as TDR
from alphazero_risk_tpu_torch.training import learner as TL
from alphazero_risk_tpu_torch.training import replay as TR
from alphazero_risk_tpu_torch.training.trainer import Trainer

from test_torch_learner import (CFG as LCFG, JCFG as LJCFG, _compare_states,
                                _port_state, make_batch,
                                setup)  # noqa: F401
from test_torch_replay import fake_samples
from test_torch_slice import TINY

torch.set_num_threads(1)
# cap = 2 * 16 = 32 samples, min 16
KW = dict(batch_size=16, samples_storage_min_batches=1,
          samples_storage_max_batches=2)


def actor_batch(seed, t=7, b=5):
    """A stacked [T, B] record batch and a final status, as an actor emits
    them, made with numpy: (port SampleBatch, status), (JAX ones)."""
    rng = np.random.default_rng(seed)
    flat = fake_samples(t * b, seed=seed)
    arrays = {k: v.reshape((t, b) + v.shape[1:]) for k, v in flat.items()}
    arrays["policy"] = arrays["policy"].astype(np.float16)
    arrays["value"] = np.zeros((t, b), np.float32)
    valid = rng.random((t, b)) < 0.8
    status = rng.integers(-2, 2, b).astype(np.int32)
    port = (TA.SampleBatch(valid=torch.from_numpy(valid),
                           **{k: torch.from_numpy(v)
                              for k, v in arrays.items()}),
            torch.from_numpy(status))
    jax_ = (JA.SampleBatch(valid=jnp.asarray(valid),
                           **{k: jnp.asarray(v) for k, v in arrays.items()}),
            jnp.asarray(status))
    return port, jax_


def assert_rings_equal(tr, jr, msg):
    assert (tr.start, tr.size, tr.old_game_index, tr._overflowed) == (
        jr.start, jr.size, jr.old_game_index, jr._overflowed), msg
    for k in TR.FIELDS:
        t, j = tr.data[k].numpy(), np.asarray(jr.data[k])
        assert t.dtype == j.dtype, (msg, k)
        np.testing.assert_array_equal(t, j, err_msg=f"{msg} {k}")


def _ingest(t, b):
    def op(tr, jr, seed):
        (ts, tst), (js, jst) = actor_batch(seed, t, b)
        assert tr.extend_from_actor(ts, tst) == jr.extend_from_actor(js, jst)
    return op


def _extend(n):
    def op(tr, jr, seed):
        s = fake_samples(n, seed=seed)
        assert tr.extend(s) == jr.extend(s)
    return op


def _mark(tr, jr, seed):
    tr.mark_old_games()
    jr.mark_old_games()


def _trim(tr, jr, seed):
    assert tr.trim() == jr.trim()


def _load(n):
    def op(tr, jr, seed, path):
        host = JR.ReplayBuffer(jconfig.Config(**KW))
        host.extend(fake_samples(n, seed=seed))
        host.old_game_index = n - 3
        host.save(path)
        assert tr.load(path) and jr.load(path)
    return op


SCENARIOS = {
    # ~28 valid rows into 128 slots
    "under_capacity": (dict(samples_storage_max_batches=8),
                       [_ingest(7, 5), _ingest(7, 5), _mark, _trim]),
    # six ingests into 32 slots: the window wraps
    "wrap_around": ({}, [_ingest(7, 5)] * 6),
    # one ingest of ~80 valid rows into 32 slots keeps the newest 32
    "over_capacity_ingest": ({}, [_ingest(20, 5), _ingest(3, 2)]),
    # the overflow of the same iteration makes trim() skip the old-game
    # rule once; the next trim() applies it
    "trim_after_overflow": ({}, [_ingest(5, 5), _mark, _ingest(5, 5), _trim,
                                 _trim, _mark, _trim]),
    "trim_without_overflow": (dict(samples_storage_max_batches=8),
                              [_ingest(7, 5), _mark, _ingest(7, 5), _trim,
                               _trim]),
    # host arrays, wrapping past the end
    "extend": ({}, [_extend(20), _ingest(2, 3), _extend(25), _mark,
                    _extend(9), _trim]),
    # a file of 100 rows into 32 slots: the newest 32, the marker moved
    "load_longer_than_cap": ({}, [_ingest(5, 5), _load(100), _ingest(4, 4),
                                  _trim]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ring_operations_match_jax(name, tmp_path):
    extra, ops = SCENARIOS[name]
    kw = dict(KW, **extra)
    tr = TDR.DeviceReplay(Config(**kw), device="cpu")
    jr = JDR.DeviceReplay(jconfig.Config(**kw))
    assert tr.cap == jr.cap
    for i, op in enumerate(ops):
        args = (tr, jr, 100 * i + 1)
        if op.__code__.co_argcount == 4:
            args += (str(tmp_path / f"buf{i}.npz"),)
        op(*args)
        assert_rings_equal(tr, jr, f"{name} after op {i}")
    for cap in (None, 5):
        ta, ja = tr.sample_arrays(cap), jr.sample_arrays(cap)
        for k in TR.FIELDS:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    data, start, size = tr.epoch_view()
    assert data is tr.data and (start, size) == (tr.start, len(tr))


@pytest.mark.parametrize("rounds", [2, 6])
def test_ring_matches_host_buffer(rounds):
    """The ring's logical window equals the host buffer's after the host
    applies the MAX rule (the ring applies it at write time)."""
    cfg = Config(**KW)
    ring, host = TDR.DeviceReplay(cfg, device="cpu"), TR.ReplayBuffer(cfg)
    for i in range(rounds):
        (ts, tst), _ = actor_batch(i)
        assert ring.extend_from_actor(ts, tst) == host.extend_from_actor(
            ts, tst)
    host.trim()
    assert len(ring) == len(host) == min(len(host), ring.cap)
    got = ring.sample_arrays()
    for k in TR.FIELDS:
        np.testing.assert_array_equal(got[k], host.data[k], err_msg=k)
    assert np.abs(got["value"]).sum() > 0          # values were backfilled


@pytest.mark.parametrize("writer", ["port_ring", "jax_ring", "jax_host"])
def test_ring_npz_interchange(tmp_path, writer):
    """The port ring's file loads in JAX's host buffer and ring; JAX's
    ring and host files load in the port's ring and host buffer."""
    kw = dict(KW, samples_storage_max_batches=8)
    cfg, jc = Config(**kw), jconfig.Config(**kw)
    srcs = {"port_ring": TDR.DeviceReplay(cfg, device="cpu"),
            "jax_ring": JDR.DeviceReplay(jc), "jax_host": JR.ReplayBuffer(jc)}
    src = srcs[writer]
    for i in range(3):
        (ts, tst), (js, jst) = actor_batch(10 + i)
        if writer == "port_ring":
            src.extend_from_actor(ts, tst)
        else:
            src.extend_from_actor(js, jst)
    src.mark_old_games()
    path = str(tmp_path / "samples.npz")
    src.save(path)
    want = src.sample_arrays()
    if writer == "port_ring":
        dsts = [JR.ReplayBuffer(jc), JDR.DeviceReplay(jc)]
    else:
        dsts = [TR.ReplayBuffer(cfg), TDR.DeviceReplay(cfg, device="cpu")]
    for dst in dsts:
        assert dst.load(path)
        assert len(dst) == len(src) and \
            dst.old_game_index == src.old_game_index
        got = dst.sample_arrays()
        for k in TR.FIELDS:
            assert np.asarray(got[k]).dtype == want[k].dtype, k
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=k)


WINDOWS = [(70, 90), (90, 20), (0, 96)]


@pytest.mark.parametrize("setup", ["float32"], indirect=True)
@pytest.mark.parametrize("start,size", WINDOWS)
def test_ring_epoch_matches_jax(setup, start, size):
    """A wrapped window (2 steps at batch 32), a window smaller than one
    batch (no step, NaN losses in both) and a full ring (3 steps), from the
    same carried weights and the same uniforms ``r``, in float32 (the
    algorithm; the bf16 learner is held against JAX by
    ``tests/test_torch_learner.py``, and the ring epoch against the host
    epoch in bf16 below).  The slots hold the learner test's minibatch rows
    (``make_batch``), so its float32 tolerances apply as stated there; the
    compact records' features are held by the trainer test below."""
    precision, jnet, tx, jstate = setup
    # at most 3 updates: the learner test's span, which its fixed float32
    # bound on the BatchNorm statistics (1e-5) is stated for
    cap = 96
    data = make_batch(cap, 40)
    key = jax.random.PRNGKey(5)
    r = np.array(jax.random.uniform(key, (cap,)))
    tstate = _port_state(jstate)
    step0 = tstate.step
    jepoch = jax.jit(JL.make_ring_epoch_fn(jnet, tx, LJCFG))
    jstate, jm = jepoch(jstate, {k: jnp.asarray(v) for k, v in data.items()},
                        jnp.int32(start), jnp.int32(size), key)
    seen = []

    def prepare(d, idx):
        seen.append(idx.numpy().copy())
        return {k: v[idx] for k, v in d.items()}

    tstate, tm = TL.make_ring_epoch_fn(LCFG, prepare_batch=prepare)(
        tstate, {k: torch.from_numpy(v) for k, v in data.items()}, start,
        size, r=torch.from_numpy(r))
    steps = size // LCFG.batch_size
    assert tstate.step == step0 + steps
    # the window's logical slots, shuffled by r, mapped to physical ones
    order = np.argsort(r + (np.arange(cap) >= size), kind="stable")
    want = (start + order[:steps * 32]) % cap
    np.testing.assert_array_equal(
        np.concatenate(seen) if seen else np.zeros(0, int), want)
    assert len(set(want.tolist())) == steps * 32
    if steps == 0:
        assert np.isnan(float(tm["pi_loss"])) and np.isnan(
            float(jm["pi_loss"]))
        assert np.isnan(float(tm["first_pi_loss"]))
    for k in ("pi_loss", "v_loss"):
        np.testing.assert_allclose(
            float(tm[k]), float(jm[k]),
            rtol=1e-4 if precision == "float32" else 2e-2, err_msg=k)
    _compare_states(precision, tstate, jstate, updates=steps)


@pytest.mark.parametrize("start,size", WINDOWS)
def test_ring_epoch_is_the_host_epoch_over_its_window(start, size):
    """As shipped (bf16 activations): the ring epoch equals
    ``make_epoch_fn`` over the logical window ``[start, start + size) mod
    cap`` shuffled by the same ``r`` -- losses and weights bit for bit."""
    cap = 96
    data = {k: torch.from_numpy(v) for k, v in make_batch(cap, 41).items()}
    r = torch.rand(cap, generator=torch.Generator().manual_seed(8))
    base = TL.create_train_state(LCFG, seed=0, device="cpu")
    ring = TL.train_state_of(copy.deepcopy(base.net), LCFG)
    host = TL.train_state_of(copy.deepcopy(base.net), LCFG)
    ring, rm = TL.make_ring_epoch_fn(LCFG)(ring, data, start, size, r=r)
    window = (start + torch.arange(size)) % cap
    order = torch.argsort(r + (torch.arange(cap) >= size).float(),
                          stable=True)[:size]
    host, hm = TL.make_epoch_fn(LCFG)(
        host, {k: v[window] for k, v in data.items()}, perm=order)
    assert ring.step == host.step == size // LCFG.batch_size
    for k in rm:
        np.testing.assert_array_equal(rm[k].numpy(), hm[k].numpy(), k)
    for k, v in ring.net.state_dict().items():
        assert torch.equal(v, host.net.state_dict()[k]), k


def test_ring_epoch_draws_its_uniforms_from_the_generator():
    state = TL.create_train_state(LCFG, seed=0, device="cpu")
    data = {k: torch.from_numpy(v) for k, v in fake_samples(96).items()}
    epoch = TL.make_ring_epoch_fn(
        LCFG, prepare_batch=lambda d, i: TA.prepare_samples(d, i, LCFG))
    gen = torch.Generator().manual_seed(3)
    g0 = gen.get_state().clone()
    state, m = epoch(state, data, 90, 70, generator=gen)
    assert state.step == 2 and np.isfinite(float(m["loss"]))
    assert not torch.equal(gen.get_state(), g0)


def test_trainer_on_the_ring(tmp_path, monkeypatch):
    """``Trainer(device_replay=True)`` on the CPU: one ``train`` iteration,
    whose self-play fills the ring with exactly what a host-buffer
    trainer's self-play from the same seed stores; a second trainer
    resumes from the files (the ring loads the replay npz); one
    ``train_on_data`` loop into a fresh ring.  A host buffer swapped into a
    ring trainer trains through the host path (the dispatch follows the
    buffer's type)."""
    monkeypatch.chdir(tmp_path)
    cfg = TINY.replace(device_replay=True, compare_games=2,
                       max_game_steps=128)
    t = Trainer(cfg, seed=0, device="cpu")
    assert isinstance(t.replay, TDR.DeviceReplay)
    after_selfplay = {}
    selfplay = t.generate_selfplay

    def watched():
        n = selfplay()
        after_selfplay.update(t.replay.sample_arrays())
        return n

    t.generate_selfplay = watched
    t.train(iterations=1, resume=False, do_benchmark=False)
    host = Trainer(cfg.replace(device_replay=False), seed=0, device="cpu")
    assert isinstance(host.replay, TR.ReplayBuffer)
    assert host.generate_selfplay() == len(after_selfplay["value"]) > 0
    for k in TR.FIELDS:
        np.testing.assert_array_equal(after_selfplay[k], host.replay.data[k],
                                      err_msg=k)
    assert t.ckpt.load_meta()["iteration"] == 1
    assert len(t.epoch_log) == cfg.epochs and all(
        np.isfinite(e["pi_loss"]) for e in t.epoch_log)
    saved = TR.ReplayBuffer(cfg)
    assert saved.load(t._replay_path()) and len(saved) == len(t.replay)

    t2 = Trainer(cfg.replace(compare_games=0), seed=1, device="cpu")
    seen = []
    selfplay2, trim2 = t2.generate_selfplay, t2.replay.trim
    t2.generate_selfplay = lambda: seen.append(selfplay2()) or seen[-1]
    t2.replay.trim = lambda: seen.append(len(t2.replay)) or trim2()
    t2.train(iterations=1, resume=True, do_benchmark=False)
    assert t2.iteration == 1 and isinstance(t2.replay, TDR.DeviceReplay)
    # the ring was restored from the npz, then extended by self-play
    assert seen[1] == len(t.replay) + seen[0] and seen[0] > 0
    assert t2.train_state.step > t.train_state.step

    d = Trainer(cfg.replace(data_games_ss=2, data_games_sr=2,
                            max_game_steps=64), seed=2, device="cpu")
    d.train_on_data(loops=1, do_benchmark=False)
    assert isinstance(d.replay, TDR.DeviceReplay) and len(d.replay) > 0
    assert len(d.epoch_log) == 3 and all(np.isfinite(e["pi_loss"])
                                         for e in d.epoch_log)
    assert d.ckpt.exists("temp") and d.ckpt.exists("latest")
    d.replay = TR.ReplayBuffer(cfg)
    d.replay.extend(fake_samples(64))
    step = d.train_state.step
    d.train_epochs(epochs=1)
    assert d.train_state.step == step + 64 // cfg.batch_size
