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
        tq, tf["trunk_wqk"][layer, conv], tf["trunk_ws"][layer, conv],
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


# ---- training mode, the plain versions of kernels K4 and K5, and the
# params npz both ways ----

@pytest.mark.parametrize("channels", [1, 32])
def test_bn_training_step_matches_flax(channels):
    """One training-mode BatchNorm call against Flax's: the output (bf16,
    one ulp), the running mean, and the running variance, which is the
    biased one (``nn.BatchNorm2d``'s own forward would store the unbiased
    one)."""
    from flax import linen as fnn
    from alphazero_risk_tpu_torch.models import resnet as TRN
    rng = np.random.default_rng(channels)
    x = jnp.asarray(rng.normal(0.3, 1.5, (16, 7, 6, channels)),
                    jnp.bfloat16)
    old = {"mean": rng.normal(0, 1, channels).astype(np.float32),
           "var": (rng.random(channels) + 0.5).astype(np.float32)}
    par = {"scale": rng.normal(1, 0.2, channels).astype(np.float32),
           "bias": rng.normal(0, 0.2, channels).astype(np.float32)}
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                        epsilon=1e-3, dtype=jnp.bfloat16)
    ref, mutated = mod.apply({"params": par, "batch_stats": old}, x,
                             mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(channels, eps=1e-3, momentum=0.01)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(par["scale"]))
        bn.bias.copy_(torch.from_numpy(par["bias"]))
        bn.running_mean.copy_(torch.from_numpy(old["mean"]))
        bn.running_var.copy_(torch.from_numpy(old["var"]))
    bn.train()
    xf = np.asarray(x.astype(jnp.float32))
    tx = torch.from_numpy(xf).permute(0, 3, 1, 2).requires_grad_()
    out = TRN._bn(bn, tx)
    np.testing.assert_allclose(
        out.detach().permute(0, 2, 3, 1).numpy(),
        np.asarray(ref.astype(jnp.float32)), rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(
        bn.running_mean.numpy(),
        np.asarray(mutated["batch_stats"]["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        np.asarray(mutated["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)
    biased = xf.reshape(-1, channels).astype(np.float64).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.99 * old["var"] + 0.01 * biased, rtol=1e-4)
    n = xf.size // channels
    assert not np.allclose(bn.running_var.numpy(),
                           0.99 * old["var"] + 0.01 * biased * n / (n - 1),
                           rtol=1e-5, atol=0)
    out.sum().backward()                  # differentiable through the stats
    assert tx.grad is not None and torch.isfinite(tx.grad).all()


def _bf16_folded():
    _, variables = _randomized_variables(CFG)
    folded = JF.fold_params(variables, jconfig.Config(
        **dataclasses.asdict(CFG)))
    return folded, folded_from_jax(folded, device="cpu")


def test_conv3x3_bf16_plain_matches_jax_stem_and_block():
    """K4's plain version against JAX ``_stem`` (Cin = 13) and one block of
    ``_trunk_xla_bf16`` (conv, then conv with the residual).  bf16 x bf16
    products are exact in float32, so one conv differs by the order of the
    float32 sums only: 1e-5 of the largest output.  In the block a sum that
    lands on the other side of a bf16 rounding boundary of ``y`` moves one
    input of the second conv by 2^-8 relative: 2e-3 of the largest output."""
    jfold, tfold = _bf16_folded()
    jx, tx = _inputs(CFG, 16, seed=11)
    ref = np.asarray(JF._stem(jfold, jx))
    h, _, _ = TF.conv3x3_bf16(tx, tfold["stem_w"], tfold["stem_b"])
    assert h.dtype == torch.float32 and tuple(h.shape) == (16, 7, 6, 32)
    np.testing.assert_allclose(h.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(TF._stem(tfold, tx)[0].numpy(), h.numpy())
    one = {"trunk_w": jfold["trunk_w"][:1], "trunk_b": jfold["trunk_b"][:1]}
    jh = jnp.asarray(ref)
    ref_blk = np.asarray(JF._trunk_xla_bf16(one, jh))
    th = torch.from_numpy(ref.copy())
    w, b = tfold["trunk_w"], tfold["trunk_b"]
    y, _, _ = TF.conv3x3_bf16(th, w[0, 0], b[0, 0])
    blk, _, _ = TF.conv3x3_bf16(y, w[0, 1], b[0, 1], residual=th)
    np.testing.assert_allclose(blk.numpy(), ref_blk, rtol=0,
                               atol=2e-3 * np.abs(ref_blk).max())
    assert (blk >= 0).all() and (blk > 0).any()
    np.testing.assert_array_equal(
        TF._trunk_xla_bf16({"trunk_w": w[:1], "trunk_b": b[:1]}, th,
                           th.to(torch.bfloat16)).numpy(),
        blk.numpy())


@pytest.mark.parametrize("variant", ["stem", "bf16_in", "residual",
                                     "f32_residual"])
def test_conv3x3_bf16_outputs_agree(variant):
    """K4's outputs: the bf16 one is ``.to(bfloat16)`` of the f32 one
    (round to nearest even), whichever is asked for alone or both; a bf16
    input gives what its f32 value gives (the conv rounds its input to
    bf16 either way); the int8 one is ``_quantize`` of the f32 one at the
    given inverse scale, alone or beside the others, and the destinations
    ``out`` and ``out_q`` receive the same values."""
    _, tfold = _bf16_folded()
    _, tx = _inputs(CFG, 8, seed=13)
    h, hb, none = TF._stem(tfold, tx, want_bf16=True)
    assert none is None
    w, b = tfold["trunk_w"], tfold["trunk_b"]
    args = {"stem": (tx, tfold["stem_w"], tfold["stem_b"], None),
            "bf16_in": (hb, w[0, 0], b[0, 0], None),
            "residual": (hb, w[0, 1], b[0, 1], h),
            "f32_residual": (h, w[0, 1], b[0, 1], h)}[variant]
    f32, bf, q = TF.conv3x3_bf16(*args, want_bf16=True)
    assert f32.dtype == torch.float32 and bf.dtype == torch.bfloat16
    assert q is None
    assert torch.equal(bf, f32.to(torch.bfloat16))
    assert TF.conv3x3_bf16(*args)[1] is None
    only_f32, _, _ = TF.conv3x3_bf16(*args)
    _, only_bf, _ = TF.conv3x3_bf16(*args, want_f32=False, want_bf16=True)
    assert torch.equal(only_f32, f32) and torch.equal(only_bf, bf)
    if variant in ("bf16_in", "residual"):
        from_f32, _, _ = TF.conv3x3_bf16(h, *args[1:])
        assert torch.equal(from_f32, f32)
    with pytest.raises(ValueError):
        TF.conv3x3_bf16(*args, want_f32=False)
    # a scale that clips the largest outputs and leaves ties to round
    inv = torch.tensor(150.0 / float(f32.max()))
    want = TF._quantize(f32, inv)
    assert want.dtype == torch.int8 and int(want.max()) == 127
    _, _, only_q = TF.conv3x3_bf16(*args, want_f32=False, inv_s_next=inv)
    assert torch.equal(only_q, want)
    out = torch.full_like(f32, float("nan"))
    out_q = torch.zeros_like(want)
    got, got_bf, got_q = TF.conv3x3_bf16(*args, want_f32=False,
                                         want_bf16=True, inv_s_next=inv,
                                         out=out, out_q=out_q)
    assert got is out and got_q is out_q
    assert torch.equal(out, f32) and torch.equal(out_q, want)
    assert torch.equal(got_bf, bf)
    with pytest.raises(ValueError):
        TF.conv3x3_bf16(*args, out_q=out_q)
    with pytest.raises(ValueError):
        TF.conv3x3_bf16(*args, out=out[:1])


@pytest.mark.parametrize("boards,cin,cout,device,wide", [
    (199, 13, 256, "cuda", False), (200, 13, 256, "cuda", True),
    (4096, 13, 256, "cuda", True), (4096, 16, 256, "cuda", True),
    (4096, 17, 256, "cuda", False), (4096, 13, 128, "cuda", False),
    (4096, 13, 256, "cpu", False)])
def test_stem_wide_takes_stems_that_fill_the_card(monkeypatch, boards, cin,
                                                  cout, device, wide):
    """``conv3x3_bf16`` takes K4's stem design for Cin <= 16, Cout = 256
    and a tile of 64 rows for every SM (on 132 SMs: B >= 200, as K1's wide
    design); never off the card."""
    monkeypatch.setattr(TF, "_sm_count", lambda index: 132)
    assert TF.stem_wide(boards, cin, cout, torch.device(device)) == wide


def test_bf16_trunk_hand_off_matches_jax():
    """The 2-block bf16 trunk with the bf16 hand-off between convs against
    JAX ``_trunk_xla_bf16``, within the per-block bound of the test above
    (2e-3 of the largest output); and bit for bit the trunk of f32 convs
    that round their inputs themselves, which is what it replaced."""
    jfold, tfold = _bf16_folded()
    jx, tx = _inputs(CFG, 16, seed=14)
    jh = JF._stem(jfold, jx)
    ref = np.asarray(JF._trunk_xla_bf16(jfold, jh))
    h, hb, _ = TF._stem(tfold, tx, want_bf16=True)
    got = TF._trunk_xla_bf16(tfold, h, hb)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max())
    w, b = tfold["trunk_w"], tfold["trunk_b"]
    plain = h
    for l in range(w.shape[0]):
        y = TF._conv3x3_bf16_plain(plain, w[l, 0], b[l, 0])
        plain = TF._conv3x3_bf16_plain(y, w[l, 1], b[l, 1], plain)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(
        TF._trunk_xla_bf16(tfold, h, h.to(torch.bfloat16)).numpy(),
        got.numpy())


@pytest.mark.parametrize("channels", [32, 64])
def test_trunk_wq_packing_matches_jax_conv(channels):
    """K1's weight packed at fold time: ``quantize_trunk`` and
    ``folded_from_jax`` give the same ``trunk_wqk`` (and the HWIO
    ``trunk_wq`` of JAX), and the plain conv on the packed layout equals
    JAX ``_conv_i8`` exactly on int8 inputs."""
    cfg = Config(blocks=1, filters=channels, value_hidden=16)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    _, variables = _randomized_variables(cfg, seed=channels)
    jq = JF.quantize_trunk(JF.fold_params(variables, jc))
    from_jax = folded_from_jax(jq, device="cpu")
    ours = TF.quantize_trunk(TF.fold_params(_port_net(variables, cfg), cfg))
    np.testing.assert_array_equal(from_jax["trunk_wq"].numpy(),
                                  np.asarray(jq["trunk_wq"]))
    np.testing.assert_array_equal(ours["trunk_wq"].numpy(),
                                  np.asarray(jq["trunk_wq"]))
    for f in (from_jax, ours):
        assert f["trunk_wqk"].is_contiguous()
        assert tuple(f["trunk_wqk"].shape) == (1, 2, 3, 3, channels,
                                               channels)
        np.testing.assert_array_equal(
            f["trunk_wqk"].numpy(),
            np.asarray(jq["trunk_wq"]).swapaxes(-1, -2))
    rng = np.random.default_rng(channels)
    q = rng.integers(-127, 128, (6, 7, 6, channels)).astype(np.int8)
    for conv in (0, 1):
        ref = np.asarray(JF._conv_i8(jnp.asarray(q), jq["trunk_wq"][0, conv]))
        got = TF._conv_i8_plain(torch.from_numpy(q),
                                from_jax["trunk_wqk"][0, conv])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [7, 15])
def test_calibrate_trunk_act_s_matches_jax(seed):
    """``calibrate_trunk`` through K4's outputs (conv_a's f32 output sets
    its scale, its bf16 copy feeds conv_b) gives JAX's ``act_s``."""
    _, variables = _randomized_variables(CFG, seed=seed)
    jq = JF.quantize_trunk(JF.fold_params(
        variables, jconfig.Config(**dataclasses.asdict(CFG))))
    jx, tx = _inputs(CFG, 24, seed=seed)
    ref = np.asarray(JF.calibrate_trunk(jq, jx)["act_s"])
    got = TF.calibrate_trunk(folded_from_jax(jq, device="cpu"), tx)["act_s"]
    assert tuple(got.shape) == (CFG.blocks, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_heads_eval_plain_matches_jax_heads_and_softmax():
    """K5's plain version against JAX ``_heads`` and the eval epilogue
    ``softmax(where(legal, logits, -inf))``, float32 throughout: sums in
    another order, exp and tanh of another library: 1e-5.  A row with no
    legal action is NaN in both."""
    jfold, tfold = _bf16_folded()
    rng = np.random.default_rng(12)
    h = np.maximum(rng.normal(0, 1, (24, 42, CFG.filters)), 0).astype(
        np.float32)
    legal = rng.random((24, 43)) < 0.4
    legal[0], legal[1] = True, False
    jl, jv = JF._heads(jfold, jnp.asarray(h))
    jp = jax.nn.softmax(jnp.where(jnp.asarray(legal), jl, -jnp.inf), axis=-1)
    probs, value, logits = TF.heads_eval(tfold, torch.from_numpy(h),
                                         torch.from_numpy(legal))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6, equal_nan=True)
    assert np.isnan(probs[1].numpy()).all() and np.isnan(jp[1]).all()
    assert (probs[2:].numpy()[~legal[2:]] == 0).all()


@pytest.mark.parametrize("channels,hidden", [(32, 16), (32, 10), (16, 7)])
def test_heads_pack_decodes_to_the_head_weights(channels, hidden):
    """K5's pack (``fold_params``), decoded in PyTorch by ``heads_layout``,
    holds exactly the ten head tensors ``_heads`` reads, and zeros in its
    padding; ``folded_from_jax`` packs a JAX fold the same way."""
    cfg = Config(blocks=1, filters=channels, value_hidden=hidden)
    _, variables = _randomized_variables(cfg)
    net = _port_net(variables, cfg)
    for f in (TF.fold_params(net, cfg), folded_from_jax(JF.fold_params(
            variables, jconfig.Config(**dataclasses.asdict(cfg))),
            device="cpu")):
        pack, lay = f["heads_pack"], TF.heads_layout(channels, hidden)
        vp = -(-hidden // 4) * 4
        assert pack.dtype == torch.float32 and pack.numel() == lay["end"]
        assert lay["pol_dense_w"] % 4 == 0 and lay["val_d1_w"] % 4 == 0

        def part(name, *shape):
            o = lay[name]
            return pack[o:o + int(np.prod(shape))].view(*shape)

        conv = part("conv", channels, 4)
        bias = part("bias", 4)
        d1w = part("val_d1_w", 42, vp)
        d1b, d2w = part("val_d1_b", vp), part("val_d2_w", vp)
        decoded = {
            "pol_w": conv[:, :2], "val_w": conv[:, 2:3],
            "pol_b": bias[:2], "val_b": bias[2:3], "val_d2_b": bias[3:],
            "pol_dense_w": part("pol_dense_w", 43, 84).T,
            "pol_dense_b": part("pol_dense_b", 44)[:43],
            "val_d1_w": d1w[:, :hidden], "val_d1_b": d1b[:hidden],
            "val_d2_w": d2w[:hidden, None]}
        assert decoded.keys() == TF._HEAD_SHAPES.keys()
        for k, v in decoded.items():
            assert torch.equal(v, f[k]), k
        pads = (conv[:, 3], part("pol_dense_b", 44)[43:], d1w[:, hidden:],
                d1b[hidden:], d2w[hidden:])
        assert all(bool((p == 0).all()) for p in pads)


def test_heads_eval_plain_on_the_port_fold_matches_jax_heads():
    """K5's plain version on the port's own fold (``fold_params`` of a net
    holding the JAX weights) against JAX ``_heads`` and the softmax on the
    JAX fold, on the same numpy inputs.  The two folds differ by float32
    rounding of the BN fold (1e-6 relative), the sums by their order: 1e-5
    of the largest |logit| and |value|, probabilities within 1e-5."""
    _, variables = _randomized_variables(CFG)
    jfold = JF.fold_params(variables, jconfig.Config(
        **dataclasses.asdict(CFG)))
    tfold = TF.fold_params(_port_net(variables), CFG)
    rng = np.random.default_rng(13)
    h = np.maximum(rng.normal(0, 1, (24, 42, CFG.filters)), 0).astype(
        np.float32)
    legal = rng.random((24, 43)) < 0.4
    legal[0], legal[1] = True, False
    jl, jv = (np.asarray(a) for a in JF._heads(jfold, jnp.asarray(h)))
    jp = np.asarray(jax.nn.softmax(
        jnp.where(jnp.asarray(legal), jl, -jnp.inf), axis=-1))
    probs, value, logits = (a.numpy() for a in TF._heads_eval_plain(
        tfold, torch.from_numpy(h), torch.from_numpy(legal)))
    assert np.abs(logits - jl).max() <= 1e-5 * max(np.abs(jl).max(), 1.0)
    assert np.abs(value - jv).max() <= 1e-5 * max(np.abs(jv).max(), 1.0)
    np.testing.assert_allclose(probs, jp, rtol=0, atol=1e-5, equal_nan=True)
    assert np.isnan(probs[1]).all() and np.isnan(jp[1]).all()
    assert (probs[2:][~legal[2:]] == 0).all()


def test_heads_eval_takes_only_the_packed_heads():
    """On a card the wrapper reads the head weights from the fold's pack:
    a folded dict without one, or with one of another width, raises before
    any launch (meta tensors stand for the card's)."""
    meta = torch.device("meta")
    f = {k: torch.empty(1, device=meta) for k in TF._HEAD_SHAPES}
    f["val_d1_w"] = torch.empty((42, 16), device=meta)
    h = torch.empty((2, 42, 32), device=meta)
    legal = torch.empty((2, 43), dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="heads_pack"):
        TF.heads_eval(f, h, legal)
    with pytest.raises(ValueError, match="pack_heads: pol_w"):
        TF.pack_heads({**f, "pol_w": torch.empty((32, 3))})


@pytest.mark.parametrize("int8", [False, True])
def test_fast_paired_eval_matches_jax(int8):
    """Two folded nets, selected per game by ``use_a``: the port's paired
    eval (the heads once per net, rows selected after the softmax) against
    the JAX one (logits selected before it).  Tolerances of the single-net
    fast-path tests above."""
    jc = jconfig.Config(**dataclasses.asdict(CFG))
    folds = []
    for seed in (0, 5):
        _, variables = _randomized_variables(CFG, seed=seed)
        f = JF.fold_params(variables, jc)
        if int8:
            f = JF.calibrate_trunk(JF.quantize_trunk(f),
                                   _inputs(CFG, 64, seed=7)[0])
        folds.append(f)
    state = new_game(8, generator=torch.Generator().manual_seed(2),
                     device="cpu")
    legal = rules.legal_actions(state, CFG)
    use_a = torch.arange(8) % 2 == 0
    from alphazero_risk_tpu.env.state import GameState as JGameState
    jstate = JGameState(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                           for f in dataclasses.fields(state)})
    jp, jv = JF.make_fast_paired_eval_fn(jc, int8=int8)(
        folds[0], folds[1], jnp.asarray(use_a.numpy()), jstate,
        jnp.asarray(legal.numpy()))
    tp, tv = TF.make_fast_paired_eval_fn(CFG, int8=int8)(
        folded_from_jax(folds[0], device="cpu"),
        folded_from_jax(folds[1], device="cpu"), use_a, state, legal)
    tol = 0.02 if int8 else 0.01
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=tol)
    # and each row is its own net's single evaluation
    single = TF.make_fast_eval_fn(CFG, int8=int8)
    for i, f in enumerate(folds):
        sp, sv = single(folded_from_jax(f, device="cpu"), state, legal)
        rows = use_a if i == 0 else ~use_a
        np.testing.assert_array_equal(tp[rows].numpy(), sp[rows].numpy())
        np.testing.assert_array_equal(tv[rows].numpy(), sv[rows].numpy())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_params_npz_interchange(tmp_path, writer):
    """A params npz written by either package (``save_params_npz``) loads
    in the other: same keys, float16 storage, HWIO conv kernels."""
    from alphazero_risk_tpu.training import learner as JL
    from alphazero_risk_tpu.training.checkpoints import (
        CheckpointManager as JCkpt)
    from alphazero_risk_tpu_torch.training.checkpoints import (
        params_to_jax, save_params_npz)
    jc = jconfig.Config(**dataclasses.asdict(CFG))
    _, variables = _randomized_variables(CFG, seed=8)
    _, _, jstate = JL.create_train_state(jc, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    jck = JCkpt(jc, base_dir=str(tmp_path / "jck"))
    path = str(tmp_path / "w.npz")
    half = {k: v.astype(np.float16).astype(np.float32)
            for k, v in _flat(variables).items()}
    if writer == "jax":
        jck.save_params_npz(path, jstate)
        net = load_params_npz(path, CFG, device="cpu")
        got = params_to_jax(net.state_dict())
    else:
        save_params_npz(path, _port_net(variables))
        with np.load(path) as z:
            assert all(z[k].dtype == np.float16 for k in z.files)
            assert z["p/stem_conv/kernel"].shape == (3, 3, 13, CFG.filters)
        _, _, fresh = JL.create_train_state(jc, jax.random.PRNGKey(1))
        loaded = jck.load_params_npz(path, fresh)
        got = _flat({"params": loaded.params,
                     "batch_stats": loaded.batch_stats})
    assert sorted(got) == sorted(half)
    for k, v in half.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _trunk_by_index(f, h):
    """The int8 trunk with each conv's operands indexed out of the stacks
    at each call."""
    w, ws, b, act_s = (f["trunk_wqk"], f["trunk_ws"], f["trunk_b"],
                       f.get("act_s"))
    for l in range(w.shape[0]):
        x = h
        if act_s is None:
            q, s = TF._quant_dyn(x)
            y, _, _ = TF.conv3x3_i8(q, w[l, 0], ws[l, 0], b[l, 0], s)
            q2, s2 = TF._quant_dyn(y)
            h, _, _ = TF.conv3x3_i8(q2, w[l, 1], ws[l, 1], b[l, 1], s2,
                                    residual=x)
            continue
        inv = 1.0 / act_s
        q = TF._quantize(x, inv[l, 0])
        y, _, _ = TF.conv3x3_i8(q, w[l, 0], ws[l, 0], b[l, 0], act_s[l, 0])
        q2 = TF._quantize(y, inv[l, 1])
        h, _, _ = TF.conv3x3_i8(q2, w[l, 1], ws[l, 1], b[l, 1], act_s[l, 1],
                                residual=x)
    return h


@pytest.mark.parametrize("calibrated", [False, True])
def test_trunk_convs_are_made_once_a_fold(calibrated):
    """``fold_for_inference`` and ``folded_from_jax`` keep K1's per-conv
    operands, ``trunk_convs``: views of the fold's own stacks (conv k =
    2l + i) and of ``act_s`` and its inverse (None without ``act_s``); the
    int8 trunk on them equals the trunk that indexes the stacks conv by
    conv; and ``_trunk_out``, whose stem hands the trunk its int8 codes,
    equals that trunk after the stem and ``_quantize``, exactly."""
    _, variables = _randomized_variables(CFG, seed=21)
    jx, tx = _inputs(CFG, 8, seed=21)
    jq = JF.quantize_trunk(JF.fold_params(
        variables, jconfig.Config(**dataclasses.asdict(CFG))))
    if calibrated:
        jq = JF.calibrate_trunk(jq, jx)
    folds = [TF.fold_for_inference(_port_net(variables, CFG), CFG, int8=True,
                                   calib_feats=tx if calibrated else None),
             folded_from_jax(jq, device="cpu")]
    for f in folds:
        convs = f["trunk_convs"]
        assert len(convs) == 2 * CFG.blocks
        for k, (w, ws, b, s, inv) in enumerate(convs):
            l, i = divmod(k, 2)
            for view, key in ((w, "trunk_wqk"), (ws, "trunk_ws"),
                              (b, "trunk_b")):
                whole = f[key]
                assert (view.untyped_storage().data_ptr()
                        == whole.untyped_storage().data_ptr())
                assert torch.equal(view, whole[l, i])
            if calibrated:
                assert torch.equal(s, f["act_s"][l, i])
                assert torch.equal(inv, (1.0 / f["act_s"])[l, i])
            else:
                assert s is None and inv is None
        h, _, _ = TF._stem(f, tx)
        old = _trunk_by_index(f, h)
        assert torch.equal(TF._trunk_xla_int8(f, h), old)
        assert torch.equal(TF._trunk_out(f, tx, True),
                           old.reshape(old.shape[0], 42, -1))
