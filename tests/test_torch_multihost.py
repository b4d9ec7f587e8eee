"""Port parity: the process world's collectives (``parallel/distributed.py``,
``parallel/mesh.py``) and the world update of the learner.

Each world is a few gloo processes on 127.0.0.1 at a free port, on the CPU,
each with its own timeout (``torch_world.run_world``; the worker functions
import torch and the port only).

The world update: a 2-rank world takes one update on a global minibatch
whose halves differ in distribution, so that per-rank BatchNorm statistics
would differ from the global ones.  The ranks end bit-equal, and equal to
the port's one-process ``update`` on the concatenated batch within 1e-5 of
each tensor's largest entry (float32; gradient sums in another order), and
to JAX's ``make_update_fn`` on the same global batch within the bounds of
``tests/test_torch_learner.py`` (float32).  With per-rank BatchNorm
statistics the same check fails.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.models.resnet import AZNet as JAZNet
from alphazero_risk_tpu.parallel import distributed as JD
from alphazero_risk_tpu.training import learner as JL

from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.models import resnet as TRN
from alphazero_risk_tpu_torch.parallel import distributed as D
from alphazero_risk_tpu_torch.parallel import mesh as M
from alphazero_risk_tpu_torch.training import learner as TL

import torch_world as W
from test_torch_learner import _compare_states, _j, _port_state
from test_torch_model import _randomized_variables

CFG = Config(blocks=2, filters=32, value_hidden=16, batch_size=32)
JCFG = jconfig.Config(**dataclasses.asdict(CFG))


# ---------------------------------------------------------------- collectives

@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return W.run_world(W.collectives, 4, tmp_path_factory.mktemp("four"))


def test_allgather_min_max_and_metrics_in_4_ranks(four):
    for r, out in enumerate(four):
        assert (out["world"], out["rank"]) == (4, r)
        assert out["min"] == 3 and out["max"] == 6
        # world sums as floats under the sorted keys, as JAX's
        assert out["metrics"] == {"contrib": 10.0, "one": 4.0}
        assert list(out["metrics"]) == ["contrib", "one"]
        assert all(isinstance(v, float) for v in out["metrics"].values())
        # the differentiable sum of (r + 1) * t_r, t_r = r + 1: 30; every
        # rank's loss holds it, so the gradient of the four losses'
        # total with respect to t_r is 4 * (r + 1)
        assert torch.equal(out["sum"], torch.full((3,), 30.0))
        assert torch.equal(out["grad"], torch.full((3,), 4.0 * (r + 1)))


def test_host_local_batch_rows_tile_the_batch(four):
    for b in (4, 12, 1024):
        rows = [out["rows"][b] for out in four]
        assert rows[0].start == 0 and rows[-1].stop == b
        assert all(a.stop == c.start for a, c in zip(rows, rows[1:]))
        assert len({s.stop - s.start for s in rows}) == 1
    assert all("does not split" in out["uneven"] for out in four)
    for r, out in enumerate(four):
        assert out["mesh"] == (4, r, "cpu", "dp")
        assert torch.equal(out["shard"]["x"], torch.arange(2 * r, 2 * r + 2))
        assert torch.equal(out["shard"]["y"][0],
                           torch.arange(16).reshape(8, 2)[2 * r:2 * r + 2])


def test_replicate_leaves_rank_0_parameters(four):
    from alphazero_risk_tpu_torch.models.resnet import build_network
    want = build_network(Config(blocks=1, filters=8, value_hidden=4),
                         device="cpu", seed=0).state_dict()
    for out in four:
        # the nets were built from different seeds: the check raised on
        # every rank, rank 0's included
        assert "differ from rank 0" in out["replicate_check"]
        for k, v in want.items():
            assert torch.equal(out["replicated"][k], v), k


def test_world_of_one_passes_through():
    """Outside a world every function is JAX's world of one."""
    assert (D.world(), D.rank(), D.device()) == (1, 0, None)
    assert D.initialize() is None and D.world() == 1
    assert D.allgather_min(7) == JD.allgather_min(7) == 7
    vals = {"b": 2, "a": 1.5}
    assert D.allgather_metrics(vals) == JD.allgather_metrics(vals) == vals
    assert D.allgather_max(-3) == -3
    assert D.host_local_batch(10) == slice(0, 10)
    tree = {"x": torch.arange(3)}
    assert D.local_shards(tree) is tree
    mesh = M.make_mesh(device="cpu")
    assert mesh == M.Mesh(1, 0, torch.device("cpu"), "dp")
    assert M.shard_batch(mesh, tree)["x"].tolist() == [0, 1, 2]
    net = torch.nn.Linear(2, 2)
    assert M.replicate(mesh, net, check=True) is net
    with pytest.raises(ValueError, match="one process per card"):
        M.make_mesh(2, device="cpu")
    t = torch.ones(2, requires_grad=True)
    D.all_reduce_sum(t * 3).sum().backward()
    assert t.grad.tolist() == [3.0, 3.0]


# ------------------------------------------------------------ world update

def _make_batch(n, seed):
    """A global minibatch whose two halves differ in distribution."""
    rng = np.random.default_rng(seed)
    pol = rng.random((n, 43)).astype(np.float32) ** 3
    feats = rng.random((n, 7, 6, CFG.num_features)).astype(np.float32)
    feats[n // 2:] = feats[n // 2:] * 3.0 + 1.0
    return {"features": feats, "policy": pol / pol.sum(-1, keepdims=True),
            "value": rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)}


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """The JAX learner after one warm-up update (float32 net), the port's
    state from it, saved for the ranks, and the global batch."""
    tmp = tmp_path_factory.mktemp("update")
    _, variables = _randomized_variables(CFG)
    jnet = JAZNet(blocks=CFG.blocks, filters=CFG.filters,
                  value_hidden=CFG.value_hidden, dtype=jnp.float32)
    tx = optax.adam(CFG.learning_rate)
    jstate = JL.TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    jupdate = jax.jit(JL.make_update_fn(jnet, tx, JCFG))
    jstate, _ = jupdate(jstate, _j(_make_batch(32, 0)))
    tstate = _port_state(jstate)
    batch = _make_batch(32, 1)
    paths = (str(tmp / "start.pt"), str(tmp / "batch.pt"))
    torch.save(tstate, paths[0])
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, paths[1])
    jafter, jm = jupdate(jstate, _j(batch))
    return tmp, paths, tstate, batch, jafter, jm


def _world_update(start, precision, local_bn=False):
    tmp, paths = start[0], start[1]
    return W.run_world(W.learner_update, 2, tmp, CFG, *paths, precision,
                       local_bn)


def _one_update(start, precision, monkeypatch):
    if precision == "float32":
        monkeypatch.setattr(TRN, "_bf16", lambda x: x)
    state = copy.deepcopy(start[2])
    return TL.update(state, CFG, {k: torch.from_numpy(v)
                                  for k, v in start[3].items()})


def _max_rel(a, b):
    """Largest difference of two states' tensors, each relative to the
    one-process tensor's largest entry: parameters, BatchNorm statistics
    and Adam's moments."""
    worst = 0.0
    pairs = [(a["sd"][k], v) for k, v in b.net.state_dict().items()
             if v.is_floating_point()]
    for n, p in b.net.named_parameters():
        pairs += [(a["adam"][n][m], b.opt.state[p][m])
                  for m in ("exp_avg", "exp_avg_sq")]
    for x, y in pairs:
        scale = float(y.abs().max())
        if scale:
            worst = max(worst, float((x - y).abs().max()) / scale)
    return worst


def _ranks_equal(world):
    a, b = world
    return all(torch.equal(a["sd"][k], b["sd"][k]) for k in a["sd"]) and \
        all(torch.equal(a["adam"][n][m], b["adam"][n][m])
            for n in a["adam"] for m in a["adam"][n])


def test_world_update_matches_one_process_and_jax(start, monkeypatch):
    world = _world_update(start, "float32")
    assert _ranks_equal(world)
    one, m = _one_update(start, "float32", monkeypatch)
    assert _max_rel(world[0], one) <= 1e-5
    for k in ("loss", "pi_loss", "v_loss"):
        assert world[0]["metrics"][k] == world[1]["metrics"][k]
        np.testing.assert_allclose(world[0]["metrics"][k], float(m[k]),
                                   rtol=1e-5)
        np.testing.assert_allclose(world[0]["metrics"][k],
                                   float(start[5][k]), rtol=1e-4)
    # against JAX's update of the global batch: the bounds of
    # test_torch_learner.py, BatchNorm running statistics included
    got = copy.deepcopy(start[2])
    got.net.load_state_dict(world[0]["sd"])
    for n, p in got.net.named_parameters():
        got.opt.state[p] = world[0]["adam"][n]
    got.step += 1
    _compare_states("float32", got, start[4], updates=1)


def test_world_update_with_rank_batchnorm_fails_the_check(start,
                                                          monkeypatch):
    """The negative case: BatchNorm on each rank's half alone.  The losses
    and gradients are still all-reduced, but the model is another one."""
    world = _world_update(start, "float32", local_bn=True)
    one, _ = _one_update(start, "float32", monkeypatch)
    assert _max_rel(world[0], one) > 1e-2
    assert not _ranks_equal(world)       # each rank's running statistics


def test_world_update_in_bf16_agrees_across_ranks(start, monkeypatch):
    """As shipped (bf16-rounded activations): the ranks end bit-equal and
    the world's losses are the one-process update's within 1e-3: a
    BatchNorm mean summed in another order can round an activation to the
    neighbouring bf16 value, 2^-8 away."""
    world = _world_update(start, "bf16")
    assert _ranks_equal(world)
    _, m = _one_update(start, "bf16", monkeypatch)
    for k in ("loss", "pi_loss", "v_loss"):
        np.testing.assert_allclose(world[0]["metrics"][k], float(m[k]),
                                   rtol=1e-3)
