"""Port parity: AZNet, parameter loading and the BN-folded fast path.

The port's network and its bf16/int8 inference path against the JAX
package on identical weights and inputs, on the CPU.  The int8 trunk runs
through ``conv3x3_i8``, whose CPU path is the plain version of kernel K1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.models import fast_infer as JF
from alphazero_risk_tpu.models.resnet import init_network

from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env.state import new_game
from alphazero_risk_tpu_torch.env import rules
from alphazero_risk_tpu_torch.models import fast_infer as TF
from alphazero_risk_tpu_torch.models.resnet import build_network
from alphazero_risk_tpu_torch.training.checkpoints import (
    folded_from_jax, load_params_npz, params_from_jax)

torch.set_num_threads(1)
CFG = Config(blocks=2, filters=32, value_hidden=16)
FLAGSHIP = "artifacts/params-20block-r4-best.npz"


def _randomized_variables(cfg, seed=0):
    """As tests/test_fast_infer.py: init, then randomize params AND batch
    stats so BN folding sees non-trivial scale/bias/mean/var."""
    net, variables = init_network(jconfig.Config(**dataclasses.asdict(cfg)),
                                  jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    out = [0.15 * jax.random.normal(k, l.shape, jnp.float32)
           + l.astype(jnp.float32) for l, k in zip(leaves, keys)]
    variables = jax.tree.unflatten(treedef, out)

    def fix(path, x):
        name = "/".join(str(p) for p in path)
        return jnp.abs(x) + 0.5 if name.endswith("var')]") else x

    return net, jax.tree.map_with_path(fix, variables)


def _flat(variables):
    """The save_params_npz key layout: p/<module>/<leaf>, b/<bn>/<leaf>."""
    flat = {}
    for kind, tree in (("p", variables["params"]),
                       ("b", variables["batch_stats"])):
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = kind + "/" + "/".join(e.key for e in kp)
            flat[key] = np.asarray(leaf)
    return flat


def _port_net(variables, cfg=CFG):
    net = build_network(cfg, device="cpu")
    sd = params_from_jax(_flat(variables))
    sd.update({k: v for k, v in net.state_dict().items()
               if k.endswith("num_batches_tracked")})
    net.load_state_dict(sd)
    return net


def _inputs(cfg, batch, seed=2):
    x = jax.random.uniform(jax.random.PRNGKey(seed),
                           (batch, 7, 6, cfg.num_features))
    return x, torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("batch", [8, 48])
def test_aznet_matches_flax(batch):
    """Bounds of tests/test_fast_infer.py:61-70 (both nets run bf16)."""
    jnet, variables = _randomized_variables(CFG)
    jx, tx = _inputs(CFG, batch)
    ref_l, ref_v = (np.asarray(a) for a in jnet.apply(variables, jx,
                                                       train=False))
    with torch.no_grad():
        l, v = (a.numpy() for a in _port_net(variables)(tx))
    np.testing.assert_allclose(l, ref_l, atol=0.5, rtol=0.1)
    np.testing.assert_allclose(v, ref_v, atol=0.25)
    assert np.abs(v - ref_v).mean() < 0.05
    assert (l.argmax(-1) == ref_l.argmax(-1)).mean() >= 0.9


def test_load_params_npz_roundtrip(tmp_path):
    _, variables = _randomized_variables(CFG, seed=4)
    flat = {k: v.astype(np.float16) for k, v in _flat(variables).items()}
    path = tmp_path / "p.npz"
    np.savez_compressed(path, **flat)
    net = load_params_npz(str(path), CFG, device="cpu")
    sd = net.state_dict()
    for k, v in params_from_jax(flat).items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
        assert sd[k].dtype == torch.float32


def test_flagship_npz_matches_flax():
    """The committed 20x256 flagship, loaded by both packages, on
    featurized states: the same bounds as the randomized net."""
    cfg = Config()
    with np.load(FLAGSHIP) as z:
        flat = dict(z)
    jnet, variables = init_network(jconfig.Config(), jax.random.PRNGKey(0))

    def rebuild(kind, tree):
        leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
        vals = [jnp.asarray(flat[kind + "/" + "/".join(e.key for e in kp)]
                            .astype(np.float32)) for kp, _ in leaves]
        return jax.tree_util.tree_unflatten(treedef, vals)

    variables = {"params": rebuild("p", variables["params"]),
                 "batch_stats": rebuild("b", variables["batch_stats"])}
    net = load_params_npz(FLAGSHIP, cfg, device="cpu")
    st = new_game(4, generator=torch.Generator().manual_seed(1),
                  device="cpu")
    from alphazero_risk_tpu_torch.env.featurize import featurize
    x = featurize(st, cfg)
    ref_l, ref_v = (np.asarray(a) for a in jnet.apply(
        variables, jnp.asarray(x.numpy()), train=False))
    with torch.no_grad():
        l, v = (a.numpy() for a in net(x))
    np.testing.assert_allclose(l, ref_l, atol=0.5, rtol=0.1)
    np.testing.assert_allclose(v, ref_v, atol=0.25)
    assert (l.argmax(-1) == ref_l.argmax(-1)).all()


def test_fold_and_quantize_match():
    """fold_params gives the JAX folded values; quantize_trunk and
    calibrate_trunk on the same folded input give the same int8 weights,
    weight scales and activation scales."""
    _, variables = _randomized_variables(CFG)
    jfold = JF.fold_params(variables, jconfig.Config(
        **dataclasses.asdict(CFG)))
    tfold = TF.fold_params(_port_net(variables), CFG)
    for k, v in jfold.items():
        ref = np.asarray(v.astype(jnp.float32))
        # folding is sqrt/div/mul in float32 (XLA may use rsqrt), then a
        # bf16 round for the conv kernels: one bf16 ulp at most
        tol = 2.0 ** -7 if v.dtype == jnp.bfloat16 else 1e-6
        np.testing.assert_allclose(tfold[k].float().numpy(), ref, rtol=tol,
                                   atol=1e-6, err_msg=k)
    jq = JF.quantize_trunk(jfold)
    tq = TF.quantize_trunk(folded_from_jax(jfold, device="cpu"))
    np.testing.assert_array_equal(tq["trunk_wq"].numpy(),
                                  np.asarray(jq["trunk_wq"]))
    np.testing.assert_array_equal(tq["trunk_ws"].numpy(),
                                  np.asarray(jq["trunk_ws"]))
    jx, tx = _inputs(CFG, 32, seed=7)
    jc = JF.calibrate_trunk(jq, jx)
    tc = TF.calibrate_trunk(tq, tx)
    np.testing.assert_allclose(tc["act_s"].numpy(), np.asarray(jc["act_s"]),
                               rtol=1e-5)


def _jax_int8_folded(calibrated):
    _, variables = _randomized_variables(CFG)
    jc = jconfig.Config(**dataclasses.asdict(CFG))
    folded = JF.quantize_trunk(JF.fold_params(variables, jc))
    if calibrated:
        folded = JF.calibrate_trunk(folded, _inputs(CFG, 64, seed=7)[0])
    return folded


@pytest.mark.parametrize("layer,conv", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_int8_conv_accumulators_equal(layer, conv):
    """K1's plain version against JAX _conv_i8 on identical int8 inputs."""
    folded = _jax_int8_folded(True)
    tf = folded_from_jax(folded, device="cpu")
    rng = np.random.default_rng(layer * 2 + conv)
    q = rng.integers(-127, 128, (16, 7, 6, CFG.filters)).astype(np.int8)
    ref = np.asarray(JF._conv_i8(jnp.asarray(q),
                                 folded["trunk_wq"][layer, conv]))
    tq = torch.from_numpy(q)
    _, _, acc = TF.conv3x3_i8(
        tq, tf["trunk_wq"][layer, conv], tf["trunk_ws"][layer, conv],
        tf["trunk_b"][layer, conv], tf["act_s"][layer, conv],
        want_acc=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), ref)


@pytest.mark.parametrize("calibrated", [False, True])
def test_int8_end_to_end(calibrated):
    """Port vs JAX apply_folded(int8) with the same folded pytree.  The
    stem is a float32 conv summed in another order, so an activation can
    land on the other side of a rounding boundary of the int8 grid; the
    logits then move by about one quantization step: atol 0.02 on logits
    of scale ~1, argmax identical."""
    folded = _jax_int8_folded(calibrated)
    jx, tx = _inputs(CFG, 32)
    ref_l, ref_v = (np.asarray(a) for a in JF.apply_folded(folded, jx,
                                                            int8=True))
    l, v = (a.numpy() for a in TF.apply_folded(
        folded_from_jax(folded, device="cpu"), tx, int8=True))
    np.testing.assert_allclose(l, ref_l, atol=0.02)
    np.testing.assert_allclose(v, ref_v, atol=0.02)
    np.testing.assert_array_equal(l.argmax(-1), ref_l.argmax(-1))


def test_bf16_fast_path_matches():
    """Port vs JAX apply_folded(bf16) with the same folded pytree: both
    run float32 convs on bf16-rounded inputs, so they differ only by
    summation order and the bf16 rounding it can flip: atol 0.01."""
    _, variables = _randomized_variables(CFG)
    folded = JF.fold_params(variables, jconfig.Config(
        **dataclasses.asdict(CFG)))
    jx, tx = _inputs(CFG, 32)
    ref_l, ref_v = (np.asarray(a) for a in JF.apply_folded(folded, jx))
    l, v = (a.numpy() for a in TF.apply_folded(
        folded_from_jax(folded, device="cpu"), tx))
    np.testing.assert_allclose(l, ref_l, atol=0.01)
    np.testing.assert_allclose(v, ref_v, atol=0.01)
    np.testing.assert_array_equal(l.argmax(-1), ref_l.argmax(-1))


@pytest.mark.parametrize("int8", [False, True])
def test_eval_fn_masks_and_normalizes(int8):
    _, variables = _randomized_variables(CFG)
    folded = TF.fold_params(_port_net(variables), CFG)
    if int8:
        folded = TF.calibrate_trunk(TF.quantize_trunk(folded),
                                    TF.default_calib_feats(
                                        CFG, torch.Generator().manual_seed(3),
                                        batch=16, device="cpu"))
    state = new_game(8, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    legal = rules.legal_actions(state, CFG)
    probs, value = TF.make_fast_eval_fn(CFG, int8=int8)(folded, state, legal)
    assert probs.shape == (8, 43)
    assert (probs[~legal] == 0).all()
    torch.testing.assert_close(probs.sum(-1), torch.ones(8), atol=1e-5,
                               rtol=0)
    assert (value.abs() <= 1.0).all()
