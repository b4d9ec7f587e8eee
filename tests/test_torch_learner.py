"""Port parity: the learner (loss, gradients, Adam updates, epochs).

Both learners start from the same state (``train_state_from_jax``: the
parameters, the BatchNorm statistics and Adam's moments and count as numpy
arrays) and see the same minibatches, made with numpy from a seed.

Two precisions.  ``float32``: the Flax net built with ``dtype=float32``
and the port with its bf16 rounding switched off.  That compares the
algorithm (the BatchNorm training step and its backward, the three loss
terms, Adam) and agrees to float32 rounding.  ``bf16``: both as they ship.
Flax then runs the backward pass in bf16 too, while the port rounds only
the forward activations, so gradients agree in direction (cosine >= 0.98
per leaf) but differ by up to ~13% in norm on a 2x32 net; the forward
loss terms agree to 1e-2 relative (a bf16 value keeps 8 bits).

Adam's first step is ``lr * sign(g)`` whatever the size of ``g``, so an
entry whose gradient is near zero can move the other way in the two
packages: parameters after k updates are held to ``2 * k * lr`` at most,
and in float32 also to a mean difference far below ``lr``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.models.resnet import AZNet as JAZNet
from alphazero_risk_tpu.training import learner as JL

from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.models import resnet as TRN
from alphazero_risk_tpu_torch.training import learner as TL
from alphazero_risk_tpu_torch.training.checkpoints import (
    params_from_jax, params_to_jax, train_state_from_jax)

from test_torch_model import _flat, _randomized_variables

torch.set_num_threads(1)
CFG = Config(blocks=2, filters=32, value_hidden=16, batch_size=32)
JCFG = jconfig.Config(**dataclasses.asdict(CFG))
LR = CFG.learning_rate
# bf16: Adam's moments, relative to each leaf's largest entry (mu follows
# the gradients' ~13% spread, nu their squares)
MU_TOL, NU_TOL = 0.35, 0.5
# float32: entries that Adam's sign step moved apart by ~lr change the next
# gradients by a fraction of a percent
F32_TOL = 3e-2


def make_batch(n, seed):
    rng = np.random.default_rng(seed)
    pol = rng.random((n, 43)).astype(np.float32) ** 3
    return {
        "features": rng.random((n, 7, 6, CFG.num_features)).astype(
            np.float32),
        "policy": pol / pol.sum(-1, keepdims=True),
        "value": rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32),
    }


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat_params(tree):
    """A JAX params-shaped pytree (params, gradients, Adam moments) under
    the ``p/...`` keys of ``save_params_npz``."""
    return {"p/" + "/".join(e.key for e in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(params=["float32", "bf16"])
def setup(request, monkeypatch):
    """(precision, JAX net, tx, JAX TrainState after one warm-up update,
    so that Adam's moments and count are not zero)."""
    precision = request.param
    _, variables = _randomized_variables(CFG)
    dtype = jnp.float32 if precision == "float32" else jnp.bfloat16
    jnet = JAZNet(blocks=CFG.blocks, filters=CFG.filters,
                  value_hidden=CFG.value_hidden, dtype=dtype)
    if precision == "float32":
        monkeypatch.setattr(TRN, "_bf16", lambda x: x)
    tx = optax.adam(CFG.learning_rate)
    state = JL.TrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    state, _ = JL.make_update_fn(jnet, tx, JCFG)(state, _j(make_batch(32, 0)))
    return precision, jnet, tx, state


def _port_state(jstate):
    adam = jstate.opt_state[0]
    flat = _flat({"params": jstate.params,
                  "batch_stats": jstate.batch_stats})
    return train_state_from_jax(
        CFG, flat, _flat_params(adam.mu), _flat_params(adam.nu),
        int(adam.count), step=int(jstate.step), device="cpu")


def _compare_states(precision, tstate, jstate, updates):
    """Parameters, BatchNorm statistics and Adam moments after ``updates``
    more updates than the state both started from."""
    sd = tstate.net.state_dict()
    ref = params_from_jax(_flat({"params": jstate.params,
                                 "batch_stats": jstate.batch_stats}))
    adam = jstate.opt_state[0]
    mu = params_from_jax(_flat_params(adam.mu))
    nu = params_from_jax(_flat_params(adam.nu))
    f32 = precision == "float32"
    diffs = []
    for name, r in ref.items():
        d = (sd[name] - r).abs()
        if "running" in name:
            # BatchNorm statistics: 0.99 * old + 0.01 * batch
            assert float(d.max()) <= (1e-5 if f32 else 1e-3), name
        else:
            assert float(d.max()) <= 2 * updates * LR * 1.001, name
            diffs.append(d.flatten())
    mean_diff = float(torch.cat(diffs).mean())
    assert mean_diff <= (LR * 1e-2 if f32 else LR * 0.25), mean_diff
    for name, p in tstate.net.named_parameters():
        st = tstate.opt.state[p]
        scale = float(mu[name].abs().max())
        dm = float((st["exp_avg"] - mu[name]).abs().max()) / scale
        dn = float((st["exp_avg_sq"] - nu[name]).abs().max()) / float(
            nu[name].max())
        assert dm <= (F32_TOL if f32 else MU_TOL), f"mu {name} {dm}"
        assert dn <= (F32_TOL if f32 else NU_TOL), f"nu {name} {dn}"
        assert int(st["step"]) == int(adam.count)
    assert tstate.step == int(jstate.step)


def test_loss_terms_and_gradients_match_jax(setup):
    precision, jnet, tx, jstate = setup
    batch = make_batch(32, 1)
    (jt, jaux), jgrads = jax.value_and_grad(
        lambda p: JL.loss_fn(jnet, JCFG, p, jstate.batch_stats, _j(batch)),
        has_aux=True)(jstate.params)
    tstate = _port_state(jstate)
    tt, taux = TL.loss_fn(tstate.net, CFG, _t(batch))
    tt.backward()
    f32 = precision == "float32"
    tol = 1e-5 if f32 else 1e-2
    for k in ("pi_loss", "v_loss", "l2"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(float(tt), float(jt), rtol=tol)
    # the L2 term is l2_coeff * sum(w^2) over the kernels alone
    np.testing.assert_allclose(
        float(TL.l2_penalty(tstate.net)),
        float(JL.l2_penalty(jstate.params)), rtol=1e-5)
    assert len(TL.kernel_parameters(tstate.net)) == sum(
        k.endswith("kernel") for k in _flat_params(jstate.params))
    ref = params_from_jax(_flat_params(jgrads))
    for name, p in tstate.net.named_parameters():
        g, r = p.grad, ref[name]
        rel = float((g - r).norm() / r.norm())
        cos = float((g * r).sum() / (g.norm() * r.norm()))
        assert rel <= (1e-4 if f32 else 0.2), (name, rel)
        assert cos >= (1 - 1e-6 if f32 else 0.98), (name, cos)
    # the training-mode forward moved the running statistics as Flax does
    new_bs = params_from_jax(_flat({"params": {},
                                    "batch_stats": jaux["batch_stats"]}))
    sd = tstate.net.state_dict()
    for name, r in new_bs.items():
        torch.testing.assert_close(sd[name], r, rtol=0,
                                   atol=1e-6 if f32 else 1e-3, msg=name)
    assert not tstate.net.training      # loss_fn leaves the net in eval()


def test_two_updates_match_jax(setup):
    precision, jnet, tx, jstate = setup
    tstate = _port_state(jstate)
    _compare_states(precision, tstate, jstate, updates=0)
    jupdate = jax.jit(JL.make_update_fn(jnet, tx, JCFG))
    for i in range(2):
        batch = make_batch(32, 10 + i)
        jstate, jm = jupdate(jstate, _j(batch))
        tstate, tm = TL.update(tstate, CFG, _t(batch))
        for k in ("loss", "pi_loss", "v_loss"):
            np.testing.assert_allclose(
                float(tm[k]), float(jm[k]),
                rtol=1e-4 if precision == "float32" else 2e-2, err_msg=k)
        _compare_states(precision, tstate, jstate, updates=i + 1)


def test_epoch_with_injected_permutation_matches_jax(setup):
    """One epoch over 100 samples at batch size 32: three minibatches, the
    remainder dropped, in the order of the JAX permutation."""
    precision, jnet, tx, jstate = setup
    data = make_batch(100, 20)
    key = jax.random.PRNGKey(4)
    perm = np.asarray(jax.random.permutation(key, 100))
    tstate = _port_state(jstate)
    step0 = tstate.step
    jstate, jm = jax.jit(JL.make_epoch_fn(jnet, tx, JCFG))(jstate, _j(data),
                                                           key)
    seen = []

    def prepare(d, idx):
        seen.append(idx.numpy().copy())
        return {k: v[idx] for k, v in d.items()}

    tstate, tm = TL.make_epoch_fn(CFG, prepare_batch=prepare)(
        tstate, _t(data), perm=torch.from_numpy(perm))
    assert tstate.step == step0 + 3
    np.testing.assert_array_equal(np.concatenate(seen), perm[:96])
    for k in ("pi_loss", "v_loss"):
        np.testing.assert_allclose(
            float(tm[k]), float(jm[k]),
            rtol=1e-4 if precision == "float32" else 2e-2, err_msg=k)
    assert float(tm["first_pi_loss"]) > 0
    _compare_states(precision, tstate, jstate, updates=3)


def test_epoch_draws_its_permutation_from_the_generator():
    state = TL.create_train_state(CFG, seed=0, device="cpu")
    data = _t(make_batch(70, 30))
    epoch = TL.make_epoch_fn(CFG)
    gen = torch.Generator().manual_seed(3)
    state, m = epoch(state, data, generator=gen)
    assert state.step == 2 and np.isfinite(float(m["loss"]))
    # fewer samples than one minibatch: no update, NaN metrics
    state, m = epoch(state, _t(make_batch(8, 31)), generator=gen)
    assert state.step == 2 and np.isnan(float(m["pi_loss"]))


def test_predict_fn_matches_jax():
    jnet, variables = _randomized_variables(CFG)
    batch = make_batch(16, 40)
    legal = np.random.default_rng(41).random((16, 43)) < 0.5
    legal[:, 42] = True
    jp, jv = JL.make_predict_fn(jnet, JCFG)(
        variables["params"], variables["batch_stats"],
        jnp.asarray(batch["features"]), jnp.asarray(legal))
    zeros = {k: np.zeros_like(v) for k, v in _flat(variables).items()
             if k.startswith("p/")}
    net = train_state_from_jax(CFG, _flat(variables), zeros, zeros, 0,
                               device="cpu").net
    tp, tv = TL.make_predict_fn(CFG)(net, torch.from_numpy(
        batch["features"]), torch.from_numpy(legal))
    # both nets run bf16: the bounds of tests/test_fast_infer.py
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=0.05)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.25)
    assert (tp.numpy()[~legal] == 0).all()
    np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, atol=1e-5)


def test_params_to_jax_inverts_params_from_jax():
    _, variables = _randomized_variables(CFG, seed=6)
    flat = _flat(variables)
    back = params_to_jax(params_from_jax(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v.astype(np.float32),
                                      err_msg=k)
