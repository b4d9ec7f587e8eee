"""The plain reference against the port at a small size on the CPU, where
the port runs its own plain versions: both must compute the same
functions."""

import dataclasses

import torch

from benchmarks import harness

from benchmarks.reference import params as ref_params
from benchmarks.reference import play as ref_play
from benchmarks.reference.config import Config as RefConfig
from benchmarks.reference.env import rules as ref_rules
from benchmarks.reference.models import fast_infer as ref_fast

from alphazero_risk_tpu_torch.agents.driver import mirrored_initial_states
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env import rules
from alphazero_risk_tpu_torch.mcts import search
from alphazero_risk_tpu_torch.models import fast_infer
from alphazero_risk_tpu_torch.models.resnet import AZNet

CPU = torch.device("cpu")
W = dict(blocks=2, filters=64, value_hidden=16, mcts_simulations=4)


def _nets():
    rcfg, cfg = RefConfig(**W), Config(**W)
    sd = ref_params.seeded_state_dict(rcfg, 5, CPU)
    net = AZNet(cfg.blocks, cfg.filters, cfg.value_hidden, cfg.num_features)
    net.load_state_dict(sd)
    return cfg, rcfg, net.eval(), ref_params.load_net(sd, rcfg, CPU), sd


def _states(n=8, seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return mirrored_initial_states(n, generator=g, device=CPU), g


def test_deal_equal():
    g = torch.Generator()
    g.manual_seed(9)
    gs = g.get_state()
    prog = mirrored_initial_states(8, generator=g, device=CPU)
    fields = {f.name: getattr(prog, f.name)
              for f in dataclasses.fields(prog)}
    assert ref_play.check_deal(8, gs, CPU, fields) == 0


def test_int8_network_equal():
    cfg, rcfg, net, rnet, _ = _nets()
    g = torch.Generator(device=CPU)
    g.manual_seed(17)
    calib = fast_infer.default_calib_feats(cfg, g, device=CPU)
    folded = fast_infer.fold_for_inference(net, cfg, int8=True,
                                           calib_feats=calib)
    ref = ref_fast.prepare(rnet, rcfg, 17, CPU)
    assert torch.equal(folded["act_s"], ref["act_s"])
    state, _ = _states()
    legal = rules.legal_actions(state, cfg)
    p, v = fast_infer.make_fast_eval_fn(cfg, int8=True)(folded, state, legal)
    rp, rv = ref_fast.evaluate(ref, rcfg, state, legal)
    assert torch.allclose(p, rp, atol=1e-6) and torch.allclose(v, rv,
                                                               atol=1e-6)


def test_int4_control_differs():
    """The control network (int4 trunk) on the 5-block play weights reads
    far from the int8 reference already at the deal."""
    rcfg = RefConfig(blocks=5)
    rnet = ref_params.load_net(ref_params.state_dict_of_npz(
        str(harness.ROOT / "artifacts/params-5block-scratch-r5-iter37.npz")),
        rcfg, CPU)
    g = torch.Generator()
    g.manual_seed(3)
    state = ref_play.mirrored_deal(16, g)
    legal = ref_rules.legal_actions(state, rcfg)
    p8, v8 = ref_fast.evaluate(ref_fast.prepare(rnet, rcfg, 17, CPU), rcfg,
                               state, legal)
    p4, v4 = ref_fast.evaluate(ref_fast.prepare(rnet, rcfg, 17, CPU,
                                                qmax=7), rcfg, state, legal)
    assert (p8 - p4).abs().max() > 0.1 and (v8 - v4).abs().max() > 0.1


def test_search_step_and_pick_equal():
    cfg, rcfg, net, rnet, _ = _nets()
    g = torch.Generator(device=CPU)
    g.manual_seed(17)
    folded = fast_infer.fold_for_inference(
        net, cfg, int8=True,
        calib_feats=fast_infer.default_calib_feats(cfg, g, device=CPU))
    fast = fast_infer.make_fast_eval_fn(cfg, int8=True)
    state, gen = _states()
    gumbel = search.draw_gumbel(gen, cfg, 8, CPU)
    res = search.search(state, gumbel, cfg, lambda s, m: fast(folded, s, m))
    action = search.pick_move(res, state, cfg, False)
    dice = rules.roll_dice(gen, 8)
    nxt = rules.step(state, action, dice, cfg)
    rows = torch.arange(8)
    r = res.tree.root.long()
    cap = {"state": ref_play.state_fields(state), "gumbel": gumbel,
           "prior": res.tree.prior[rows, r], "value": res.root_value,
           "visits": res.visit_counts, "action": action, "pick_noise": None,
           "dice": dice, "next": ref_play.state_fields(nxt)}
    out = ref_play.check_step(cap, ref_fast.prepare(rnet, rcfg, 17, CPU),
                              rcfg)
    assert out["net_gap_max"] < 1e-6 and out["visit_gap"] == 0.0
    assert out["pick_mismatch"] == 0 and out["rules_mismatch"] == 0

