"""Port parity: the host replay buffer.

The cases of ``tests/test_training.py`` that cover ``ReplayBuffer`` (trim
semantics, save/load), the same operations run through both packages'
buffers side by side, ``extend_from_actor`` on the same stacked records,
and the npz file written by each package loaded by the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.training import actor as JA
from alphazero_risk_tpu.training import replay as JR

from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.training import actor as TA
from alphazero_risk_tpu_torch.training import replay as TR

KW = dict(batch_size=32, samples_storage_min_batches=2,
          samples_storage_max_batches=4)          # min 64, max 128
CFG, JCFG = Config(**KW), jconfig.Config(**KW)


def fake_samples(n, seed=0):
    rng = np.random.default_rng(seed)
    pol = rng.random((n, 43)).astype(np.float32)
    pol /= pol.sum(-1, keepdims=True)
    return {
        "owner": rng.integers(0, 3, (n, 42)).astype(np.int8),
        "army": rng.integers(1, 33, (n, 42)).astype(np.int8),
        "cur_player": rng.integers(0, 2, n).astype(np.int8),
        "phase": rng.integers(0, 6, n).astype(np.int8),
        "round": rng.integers(1, 59, n).astype(np.int16),
        "reinforcements": rng.integers(0, 20, n).astype(np.int16),
        "attacks_during_turn": rng.integers(0, 8, n).astype(np.int16),
        "can_draw_card": rng.integers(0, 2, n).astype(bool),
        "policy": pol,
        "value": rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32),
    }


def _assert_buffers_equal(tb, jb):
    assert len(tb) == len(jb) and tb.old_game_index == jb.old_game_index
    for k in TR.FIELDS:
        assert tb.data[k].dtype == jb.data[k].dtype, k
        np.testing.assert_array_equal(tb.data[k], jb.data[k], err_msg=k)


def test_fields_match_jax():
    assert list(TR.FIELDS) == list(JR.FIELDS)
    for k, (dt, shape) in TR.FIELDS.items():
        assert (np.dtype(dt), shape) == (np.dtype(JR.FIELDS[k][0]),
                                         JR.FIELDS[k][1]), k
    assert TR.FORMAT_VERSION == JR.FORMAT_VERSION


def test_replay_trim_semantics():
    buf = TR.ReplayBuffer(CFG)
    buf.extend(fake_samples(100))
    assert buf.trim() == 0          # below max, no old marker
    buf.mark_old_games()            # old_game_index = 99
    buf.extend(fake_samples(60))
    # 160 > max(128): drop oldest 32 regardless of marker
    assert buf.trim() == 32
    assert len(buf) == 128
    # now above min(64) with marker: drop min(old_index, excess)
    assert buf.old_game_index == 67
    assert buf.trim() == 64
    assert len(buf) == 64


def test_replay_operations_match_jax():
    """The same extend / mark / trim / sample sequence on both buffers."""
    tb, jb = TR.ReplayBuffer(CFG), JR.ReplayBuffer(JCFG)
    for step, n in enumerate((100, 60, 10, 90)):
        s = fake_samples(n, seed=step)
        assert tb.extend(s) == jb.extend(s)
        if step % 2 == 0:
            tb.mark_old_games()
            jb.mark_old_games()
        assert tb.trim() == jb.trim()
        _assert_buffers_equal(tb, jb)
        assert tb.trim() == jb.trim()
        _assert_buffers_equal(tb, jb)
    for cap in (None, 16, 1000):
        ta, ja = tb.sample_arrays(cap), jb.sample_arrays(cap)
        for k in TR.FIELDS:
            np.testing.assert_array_equal(ta[k], ja[k])
    assert tb.extend(fake_samples(0)) == 0


@pytest.mark.parametrize("round_weighted", [False, True])
def test_extend_from_actor_matches_jax(round_weighted):
    """Stacked [T, B] records with a valid mask: backfill, filter and
    flatten give the same buffer in both packages."""
    t_steps, b = 12, 4
    flat = fake_samples(t_steps * b, seed=3)
    rng = np.random.default_rng(4)
    valid = rng.random((t_steps, b)) < 0.7
    status = np.array([0, 1, -2, -1], np.int32)
    final_round = np.array([40, 50, 58, 20], np.int32)

    def stacked(conv):
        d = {k: conv(v.reshape((t_steps, b) + v.shape[1:]))
             for k, v in flat.items()}
        d["policy"] = conv(flat["policy"].astype(np.float16).reshape(
            t_steps, b, 43))
        return d

    tsb = TA.SampleBatch(valid=torch.from_numpy(valid),
                         **stacked(torch.from_numpy))
    jsb = JA.SampleBatch(valid=jnp.asarray(valid), **stacked(jnp.asarray))
    kw = dict(KW, round_weighted_value=round_weighted)
    tb = TR.ReplayBuffer(Config(**kw))
    jb = JR.ReplayBuffer(jconfig.Config(**kw))
    nt = tb.extend_from_actor(tsb, torch.from_numpy(status),
                              final_round=torch.from_numpy(final_round))
    nj = jb.extend_from_actor(jsb, jnp.asarray(status),
                              final_round=jnp.asarray(final_round))
    assert nt == nj == int(valid.sum())
    _assert_buffers_equal(tb, jb)
    assert set(np.unique(np.sign(tb.data["value"]))) == {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_npz_interchange(tmp_path, writer):
    """A buffer saved by either package loads in the other, equal."""
    bufs = {"port": TR.ReplayBuffer(CFG), "jax": JR.ReplayBuffer(JCFG)}
    src = bufs.pop(writer)
    (dst,) = bufs.values()
    src.extend(fake_samples(70, seed=5))
    src.mark_old_games()
    src.extend(fake_samples(9, seed=6))
    path = str(tmp_path / "samples.npz")
    src.save(path)
    assert dst.load(path)
    _assert_buffers_equal(*((src, dst) if writer == "port" else (dst, src)))
    assert dst.old_game_index == 69
    assert not dst.load(str(tmp_path / "missing.npz"))
