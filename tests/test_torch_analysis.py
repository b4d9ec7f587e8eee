"""Port parity: k-fold cross-validation (``-m analysis``).

``cross_validate`` in both packages over the same buffer file: the same
numpy fold split, each fold's fresh weights and each epoch's shuffle taken
from JAX (``train_state_from_jax`` and the permutations of JAX's key
chain), in float32 on both sides (the learner's algorithm,
``tests/test_torch_learner.py``) and as shipped (bf16).  Then the CLI's
``-m analysis`` on the CPU over the replay file that ``-m train`` wrote.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.models.resnet import AZNet as JAZNet
from alphazero_risk_tpu.training import analysis as JAN
from alphazero_risk_tpu.training import learner as JL

from alphazero_risk_tpu_torch import cli
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.models import resnet as TRN
from alphazero_risk_tpu_torch.training import analysis as TAN
from alphazero_risk_tpu_torch.training import replay as TR
from alphazero_risk_tpu_torch.training.checkpoints import (
    train_state_from_jax)

from test_torch_learner import _flat_params
from test_torch_model import _flat
from test_torch_replay import fake_samples

torch.set_num_threads(1)
CFG = Config(blocks=2, filters=32, value_hidden=16, batch_size=32)
JCFG = jconfig.Config(**dataclasses.asdict(CFG))
# float32: the learner's loss tolerance over one epoch, for histories of
# up to 6 epochs; bf16: its forward-loss tolerance
RTOL = {"float32": 1e-4, "bf16": 2e-2}


def _jax_inputs(n, folds, max_epochs, seed):
    """Fold f's initial train state and epoch shuffles as JAX's
    ``cross_validate`` makes them: ``create_train_state(cfg, PRNGKey(seed +
    f))``, and per epoch ``key, sub = split(key)`` from ``PRNGKey(1000 +
    f)``, ``permutation(sub, n_train)``."""
    n_train = n - n // folds
    states, perms = [], []
    for f in range(folds):
        _, _, js = JL.create_train_state(JCFG, jax.random.PRNGKey(seed + f))
        zeros = _flat_params(jax.tree.map(jnp.zeros_like, js.params))
        states.append(train_state_from_jax(
            CFG, _flat({"params": js.params, "batch_stats": js.batch_stats}),
            zeros, zeros, 0, device="cpu"))
        key, fold_perms = jax.random.PRNGKey(1000 + f), []
        for _ in range(max_epochs):
            key, sub = jax.random.split(key)
            fold_perms.append(torch.from_numpy(np.array(
                jax.random.permutation(sub, n_train))))
        perms.append(fold_perms)
    return states, perms


@pytest.mark.parametrize("precision", ["float32", "bf16"])
def test_cross_validate_matches_jax(tmp_path, monkeypatch, precision):
    if precision == "float32":
        monkeypatch.setattr(TRN, "_bf16", lambda x: x)
        monkeypatch.setattr(JL, "build_network", lambda cfg: JAZNet(
            blocks=cfg.blocks, filters=cfg.filters,
            value_hidden=cfg.value_hidden, dtype=jnp.float32))
    path = str(tmp_path / "training_samples.npz")
    buf = TR.ReplayBuffer(CFG)
    buf.extend(fake_samples(163, seed=12))
    buf.save(path)
    kw = dict(folds=2, max_epochs=6, seed=3, patience=2)
    want = JAN.cross_validate(JCFG, path, **kw)
    states, perms = _jax_inputs(163, 2, 6, 3)
    got = TAN.cross_validate(CFG, path, device="cpu", init_states=states,
                             perms=perms, **kw)
    assert got["samples"] == want["samples"] == 163
    assert len(got["folds"]) == len(want["folds"]) == 2
    for g, w in zip(got["folds"], want["folds"]):
        assert g["fold"] == w["fold"] and g["epochs"] == w["epochs"]
        assert [h["epoch"] for h in g["history"]] == list(range(g["epochs"]))
        for gh, wh in zip(g["history"], w["history"]):
            for k in ("val_pi", "val_v"):
                np.testing.assert_allclose(gh[k], wh[k],
                                           rtol=RTOL[precision], err_msg=k)
        np.testing.assert_allclose(g["best_val"], w["best_val"],
                                   rtol=RTOL[precision])


def test_cross_validate_draws_its_own_shuffles(tmp_path):
    path = str(tmp_path / "s.npz")
    buf = TR.ReplayBuffer(CFG)
    buf.extend(fake_samples(100, seed=1))
    buf.save(path)
    r = TAN.cross_validate(CFG, path, folds=2, max_epochs=2, device="cpu")
    assert [f["epochs"] for f in r["folds"]] == [2, 2]
    assert all(np.isfinite(h["val_pi"]) for f in r["folds"]
               for h in f["history"])
    assert TAN.cross_validate(CFG, str(tmp_path / "none.npz"),
                              device="cpu") == {
        "error": f"no samples at {tmp_path / 'none.npz'}"}


def test_cli_analysis_over_the_train_replay(tmp_path, monkeypatch, capsys):
    """``-m train`` writes ``data/training_samples.npz``; ``-m analysis``
    cross-validates over it and prints the report as one JSON line (at
    batch size 256: one update per epoch over the ~400 training rows of a
    fold)."""
    monkeypatch.chdir(tmp_path)
    tiny = ["--cpu", "--blocks", "1", "--filters", "16", "--value-hidden",
            "8"]
    cli.main(["-m", "train", "--mcts", "2", "--env-batch", "4",
              "--max-steps", "32", "--ti", "1", "--tg", "2", "--games", "2",
              "--e", "1", "--bench-random", "2", "--bench-script", "2",
              "--fast", "--int8", *tiny, "--bs", "32"])
    n = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "samples"]
    cli.main(["-m", "analysis", *tiny, "--bs", "256"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["samples"] == n > 0
    assert len(report["folds"]) == 5
    for f in report["folds"]:
        assert 1 <= f["epochs"] <= 30 and np.isfinite(f["best_val"])
