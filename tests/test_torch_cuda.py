"""The port's CUDA kernels against their plain versions, on the card.

Skipped without an NVIDIA card.  Imports nothing of JAX, so it also runs
where JAX is not installed (skipping the repo's conftest, which is):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from alphazero_risk_tpu_torch import kernels
from alphazero_risk_tpu_torch.agents import blocks as AB
from alphazero_risk_tpu_torch.agents import random_agent as RA
from alphazero_risk_tpu_torch.agents import script_agent as SA
from alphazero_risk_tpu_torch.agents.common import (BlockDraws,
                                                    draw_step_randoms)
from alphazero_risk_tpu_torch.agents.driver import \
    mixed_play as mixed_play_states
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env import rules
from alphazero_risk_tpu_torch.env.featurize import _featurize_plain, featurize
from alphazero_risk_tpu_torch.env.state import GameState, new_game, tree_map
from alphazero_risk_tpu_torch.models import fast_infer as FI
from alphazero_risk_tpu_torch.mcts import search as S
from alphazero_risk_tpu_torch.training import actor as A
from alphazero_risk_tpu_torch.training.trainer import Trainer

from chip_smoke import TIE_CASES, card_states, mixed_states, tie_tree

pytestmark = pytest.mark.cuda


def played_roots(batch, steps, seed):
    cfg = Config()
    gen = torch.Generator().manual_seed(seed)
    st = new_game(batch, generator=gen, device="cpu")
    for _ in range(steps):
        legal = rules.legal_actions(st, cfg)
        g = torch.rand(legal.shape, generator=gen)
        st = rules.step_key(st, torch.argmax(torch.where(legal, g, -1.0), -1)
                            .to(torch.int32), gen, cfg)
    return st


def uniform_eval(state, legal):
    probs = legal.float() / legal.sum(-1, keepdim=True)
    own = state.owner == state.cur_player[:, None]
    return probs, (own.sum(-1) % 5 - 2).float() / 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _to(tree, dev):
    return type(tree)(**{
        f.name: (tree_map(lambda x: x.to(dev), getattr(tree, f.name))
                 if isinstance(getattr(tree, f.name), GameState)
                 else getattr(tree, f.name).to(dev))
        for f in dataclasses.fields(tree)})


# every batch the paths launch: lockstep games, and 512 calibration features
CONV_BATCHES = [2, 4, 16, 32, 64, 512, 1024]
# K1 also at self-play's batches, ragged ones, and either side of the
# batch from which its wide design takes the launch (resolved on the card)
CONV_I8_BATCHES = CONV_BATCHES + [1021, 2048, 4093, 4096, "switch",
                                  "switch-1"]


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _k1_wide(boards, cout, sms):
    """K1's wide design: C=256 and a tile of 64 rows for every SM."""
    return cout == 256 and -(-boards * 42 // 64) >= sms


def _batch(batch, sms):
    """A batch of CONV_I8_BATCHES on a card of ``sms`` SMs: "switch" is
    the least batch the wide design takes."""
    switch = (sms - 1) * 64 // 42 + 1
    return {"switch": switch, "switch-1": switch - 1}.get(batch, batch)


@pytest.mark.parametrize("boards,cout", [(1024, 256), (512, 256),
                                         (256, 256), (64, 256), (2, 256),
                                         (1024, 64), (1024, 128),
                                         (4096, 256), ("switch", 256),
                                         ("switch-1", 256)])
def test_conv_tile_choice(cuda, boards, cout):
    """K1's and K4's tiles, as their libraries choose them.  K4 and K1's
    tiled design: 6 boards per block where that still gives every SM of
    the card a block, else 3; 64 output channels per block either way.
    K1 takes its wide design instead where C=256 and tiles of 64 rows x
    all 256 channels give every SM one: then ceil(42 B / 64) tiles, and no
    boards per tile."""
    sms = _sms(cuda)
    boards = _batch(boards, sms)
    per = 6 if -(-boards // 6) * (cout // 64) >= sms else 3
    tiled = (per, -(-boards // per) * (cout // 64))
    assert FI.conv_tile(kernels.CONV3X3_BF16, boards, cout) == tiled
    wide = _k1_wide(boards, cout, sms)
    assert FI.k1_wide(boards, cout, cuda) == wide
    assert FI.conv_tile(kernels.CONV3X3_I8, boards, cout) == (
        (0, -(-boards * 42 // 64)) if wide else tiled)


@pytest.mark.parametrize("channels", [64, 128, 256])
@pytest.mark.parametrize("batch", CONV_I8_BATCHES)
def test_conv3x3_i8_matches_plain(cuda, batch, channels):
    """K1 against its plain version, with and without the residual, on
    every output combination: int32 accumulators equal, h within 1e-6
    relative (the same float operations in the same order, no FMA), the
    requantized int8 within 1 (a rint tie).  Either design, as the batch
    and the channels choose it."""
    batch = _batch(batch, _sms(cuda))
    g = torch.Generator(device=cuda).manual_seed(batch * channels)
    c = channels
    q = torch.randint(-127, 128, (batch, 7, 6, c), generator=g, device=cuda,
                      dtype=torch.int8)
    w = FI.pack_trunk_wq(torch.randint(-127, 128, (3, 3, c, c), generator=g,
                                       device=cuda, dtype=torch.int8))
    ws = torch.rand(c, generator=g, device=cuda) / 127
    b = torch.randn(c, generator=g, device=cuda)
    s = torch.tensor(0.01, device=cuda)
    res = torch.randn((batch, 7, 6, c), generator=g, device=cuda)
    inv = torch.tensor(1 / 3.0, device=cuda)
    ref_acc = FI._conv_i8_plain(q, w)
    for r in (None, res):
        ref_h, ref_q = FI._epilogue_plain(ref_acc, ws, b, s, r, inv)
        for want_h, inv_next, want_acc in [(True, inv, True),
                                           (True, None, False),
                                           (False, inv, False),
                                           (False, None, True),
                                           (True, inv, False)]:
            h, qn, acc = FI.conv3x3_i8(q, w, ws, b, s, residual=r,
                                       inv_s_next=inv_next, want_h=want_h,
                                       want_acc=want_acc)
            assert (h is not None, qn is not None, acc is not None) == (
                want_h, inv_next is not None, want_acc)
            if acc is not None:
                assert torch.equal(acc, ref_acc)
            if h is not None:
                torch.testing.assert_close(h, ref_h, rtol=1e-6, atol=1e-6)
            if qn is not None:
                assert int((qn.int() - ref_q.int()).abs().max()) <= 1


def test_descend_and_backup_match_plain(cuda):
    cfg = Config(mcts_simulations=6, max_depth=10)
    root = played_roots(64, 120, seed=3)
    gum = S.draw_gumbel(torch.Generator().manual_seed(1), cfg, 64, "cpu")
    tree = _to(S.search(root, gum, cfg, uniform_eval).tree, cuda)
    g0 = gum[0].to(cuda)
    path = S.descend(tree, g0, cfg)
    for a, r in zip(path, S._descend_plain(tree, g0, cfg)):
        assert torch.equal(a, r)
    leaf_v = torch.linspace(-1, 1, 64, device=cuda)
    leaf_p = tree.player[torch.arange(64, device=cuda), path.cur.long()]
    visit, wsum = tree.visit.clone(), tree.wsum.clone()
    S.backup(tree, path, leaf_v, leaf_p)
    kv, kw = tree.visit.clone(), tree.wsum.clone()
    tree.visit.copy_(visit)
    tree.wsum.copy_(wsum)
    S._backup_plain(tree, path, leaf_v, leaf_p)
    assert torch.equal(kv, tree.visit)
    assert torch.equal(kw, tree.wsum)


def _games(tree, n):
    """A contiguous copy of the first ``n`` games of ``tree``."""
    return type(tree)(**{
        f.name: (tree_map(lambda x: x[:n].clone(), getattr(tree, f.name))
                 if isinstance(getattr(tree, f.name), GameState)
                 else getattr(tree, f.name)[:n].clone())
        for f in dataclasses.fields(tree)})


@pytest.fixture(scope="module")
def grown_trees():
    """Search trees over 1,024 games of random play, grown on the card with
    8 and 32 simulations (N = 10 and 34), by N."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = Config()
    gen = torch.Generator(device="cuda").manual_seed(4)
    st = new_game(1024, generator=gen, device="cuda")
    for _ in range(120):
        legal = rules.legal_actions(st, cfg)
        g = torch.rand(legal.shape, generator=gen, device="cuda")
        st = rules.step_key(st, torch.argmax(torch.where(legal, g, -1.0), -1)
                            .to(torch.int32), gen, cfg)
    trees = {}
    for sims in (8, 32):
        c = Config(mcts_simulations=sims)
        gum = S.draw_gumbel(gen, c, 1024, "cuda")
        trees[c.num_nodes] = S.search(st, gum, c, uniform_eval).tree
    return trees


def _assert_descent_matches_plain(tree, gum, cfg):
    path = S.descend(tree, gum, cfg)
    for name, a, r in zip(S.Descent._fields, path,
                          S._descend_plain(tree, gum, cfg)):
        assert torch.equal(a, r), name
    return path


@pytest.mark.parametrize("n_nodes", [10, 34])
@pytest.mark.parametrize("batch", [1, 2, 4, 16, 32, 33, 64, 256, 1024])
def test_descend_batches_match_plain(cuda, grown_trees, batch, n_nodes):
    """K2 (one warp per game, four per block) against ``_descend_plain``:
    every output equal on the first ``batch`` games of a grown tree, at
    max_depth 48 and at 3 (which cuts paths), for three simulations'
    noise."""
    tree = _games(grown_trees[n_nodes], batch)
    for d_cap in (48, 3):
        cfg = Config(mcts_simulations=3, max_depth=d_cap)
        gen = torch.Generator(device="cuda").manual_seed(batch + d_cap)
        for gum in S.draw_gumbel(gen, cfg, batch, cuda):
            path = _assert_descent_matches_plain(tree, gum, cfg)
            assert int(path.depth.max()) <= d_cap


@pytest.mark.parametrize("case", TIE_CASES)
def test_descend_tie_trees_match_plain(cuda, grown_trees, case):
    """K2 against ``_descend_plain`` on the grown trees rewritten into
    ties (``chip_smoke.tie_tree``: every legal action tied, rows with no
    legal action, attack sources with equal armies or none), at 33 and
    1,024 games."""
    cfg = Config(mcts_simulations=2)
    for tree in grown_trees.values():
        tied = tie_tree(tree, case)
        for batch in (33, 1024):
            t = _games(tied, batch)
            gen = torch.Generator(device="cuda").manual_seed(batch)
            for gum in S.draw_gumbel(gen, cfg, batch, cuda):
                _assert_descent_matches_plain(t, gum, cfg)


def _synthetic_paths(tree, d_cap, gen):
    """Paths of up to ``d_cap`` edges through ``tree``'s games (no
    (node, action) pair twice in a path, as the descent makes them),
    every depth from 0 to ``d_cap`` among the games, random movers, leaf
    values and leaf movers."""
    b, n = tree.player.shape
    dev = tree.player.device
    cells = torch.rand((b, n * 43), generator=gen, device=dev).argsort(-1)
    cells = cells[:, :d_cap].to(torch.int32)
    pp = torch.randint(0, 2, (b, d_cap), generator=gen, device=dev,
                       dtype=torch.int32)
    depth = (torch.arange(b, device=dev, dtype=torch.int32) * 7) % (d_cap + 1)
    depth[-1] = d_cap
    zero = torch.zeros_like(depth)
    path = S.Descent(cells // 43, cells % 43, pp, depth, zero, zero - 1, zero,
                     zero)
    leaf_v = torch.rand(b, generator=gen, device=dev) * 2 - 1
    leaf_p = torch.randint(0, 2, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    return path, leaf_v, leaf_p


def _as_descent_buffers(path):
    """``path`` as ``descend`` returns it on the card: rows of one
    [3, B, D] buffer and one [5, B] buffer."""
    paths = torch.stack([path.pn, path.pa, path.pp])
    ends = torch.stack(list(path[3:]))
    return S.Descent(*paths.unbind(0), *ends.unbind(0))


@pytest.mark.parametrize("n_nodes", [10, 34])
@pytest.mark.parametrize("batch", [1, 3, 5, 33, 64, 1023, 1024])
def test_backup_batches_match_plain(cuda, grown_trees, batch, n_nodes):
    """K3 (one warp per game, a path's edges over the lanes) against
    ``_backup_plain``, visit and wsum bit for bit: on the first ``batch``
    games of a grown tree with K2's descent and the tree's own leaf
    buffers (the search's call), and with synthetic paths of up to 48
    and 64 edges (both lane halves, every depth), given as separate
    tensors and as rows of K2's buffers."""
    tree = _games(grown_trees[n_nodes], batch)
    cfg = Config(mcts_simulations=1)
    gen = torch.Generator(device=cuda).manual_seed(batch + n_nodes)
    gum = S.draw_gumbel(gen, cfg, batch, cuda)[0]

    def held(path, leaf_v, leaf_p):
        visit, wsum = tree.visit.clone(), tree.wsum.clone()
        S.backup(tree, path, leaf_v, leaf_p)
        kv, kw = tree.visit.clone(), tree.wsum.clone()
        tree.visit.copy_(visit)
        tree.wsum.copy_(wsum)
        S._backup_plain(tree, path, leaf_v, leaf_p)
        assert torch.equal(kv, tree.visit)
        assert torch.equal(kw, tree.wsum)
        assert not torch.equal(kv, visit) or not bool((path.depth > 0).any())

    path = S.descend(tree, gum, cfg)
    leaf_v, leaf_p = S.write_nodes(
        tree, *S.expansion_inputs(tree, path, cfg, uniform_eval), path)
    kernels.MCTS_BACKUP.launches = 0
    held(path, leaf_v, leaf_p)
    assert kernels.MCTS_BACKUP.launches == 1
    for d_cap in (48, 64):
        syn = _synthetic_paths(tree, d_cap, gen)
        held(*syn)
        held(_as_descent_buffers(syn[0]), *syn[1:])


def test_play_launches_every_kernel(cuda):
    cfg = Config(blocks=2, filters=64, value_hidden=16, mcts_simulations=4,
                 max_depth=8, env_batch_per_device=4, fast_infer=True,
                 fast_infer_int8=True)
    trainer = Trainer(cfg, seed=0, device=cuda)
    kernels.reset_counts()
    res = trainer.play(A.OPP_SCRIPT, 4)
    assert res["unfinished"] == 0
    # every kernel but the RandomPlayer's and K9's single step: the
    # ScriptPlayer fast-forwards through K9's multi-step entry
    counts = kernels.counts()
    assert counts.pop("random_step") == 0
    assert counts.pop("script_step") == 0
    assert all(n > 0 for n in counts.values()), counts


@pytest.mark.parametrize("cin,cout", [(13, 64), (13, 256), (64, 64),
                                      (128, 128), (256, 256), (128, 256)])
@pytest.mark.parametrize("batch", CONV_BATCHES)
def test_conv3x3_bf16_matches_plain(cuda, batch, cin, cout):
    """K4 against its plain version with f32 and bf16 inputs (bf16 only
    where Cin % 8 == 0), with and without the residual, on every output
    combination: the f32 output within 1e-5 of the largest output (bf16 x
    bf16 products are exact in float32: only the order of the float32 sums
    differs), the bf16 output equal to ``.to(bfloat16)`` of the f32 one."""
    g = torch.Generator(device=cuda).manual_seed(batch * cin + cout)
    x = torch.randn((batch, 7, 6, cin), generator=g, device=cuda)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
         / (9 * cin) ** 0.5).to(torch.bfloat16)
    b = torch.randn(cout, generator=g, device=cuda)
    res = torch.randn((batch, 7, 6, cout), generator=g, device=cuda)
    inputs = [x] + ([x.to(torch.bfloat16)] if cin % 8 == 0 else [])
    tf32 = torch.backends.cudnn.allow_tf32
    for r in (None, res):
        torch.backends.cudnn.allow_tf32 = False    # the reference in full f32
        try:
            ref = FI._conv3x3_bf16_plain(x, w, b, r)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        tol = 1e-5 * float(ref.abs().max())
        for xin in inputs:
            for want_f32, want_bf16 in [(True, False), (False, True),
                                        (True, True)]:
                out, outb, _ = FI.conv3x3_bf16(xin, w, b, r,
                                               want_f32=want_f32,
                                               want_bf16=want_bf16)
                assert (out is not None, outb is not None) == (want_f32,
                                                               want_bf16)
                if out is not None:
                    assert float((out - ref).abs().max()) <= tol
                if outb is not None:
                    full, _, _ = FI.conv3x3_bf16(xin, w, b, r)
                    assert torch.equal(outb, full.to(torch.bfloat16))


@pytest.mark.parametrize("cin", [13, 256])
@pytest.mark.parametrize("batch", [64, 1024, 4096])
def test_conv3x3_bf16_int8_output_matches_quantize(cuda, batch, cin):
    """K4's int8 output (the int8 trunk's first input, from the stem's
    epilogue) against ``_quantize`` of its own f32 output, code for code:
    both round the same f32 product half to even, so any difference is a
    defect.  Either template (3 or 6 boards a block, as the batch
    chooses), f32 and bf16 inputs, with and without the residual, alone or
    beside the f32 and bf16 outputs, into destination tensors or new
    ones."""
    g = torch.Generator(device=cuda).manual_seed(batch + cin)
    cout = 256
    x = torch.randn((batch, 7, 6, cin), generator=g, device=cuda)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
         / (9 * cin) ** 0.5).to(torch.bfloat16)
    b = torch.randn(cout, generator=g, device=cuda)
    res = torch.randn((batch, 7, 6, cout), generator=g, device=cuda)
    inputs = [x] + ([x.to(torch.bfloat16)] if cin % 8 == 0 else [])
    for r in (None, res):
        for xin in inputs:
            full, _, none = FI.conv3x3_bf16(xin, w, b, r)
            assert none is None
            # a scale that clips the largest outputs to 127
            inv = (150.0 / full.max()).reshape(())
            want = FI._quantize(full, inv)
            assert int(want.max()) == 127 and int(want.min()) == 0
            _, _, q = FI.conv3x3_bf16(xin, w, b, r, want_f32=False,
                                      inv_s_next=inv)
            assert torch.equal(q, want)
            out = torch.full_like(full, float("nan"))
            out_q = torch.zeros_like(want)
            h, hb, q2 = FI.conv3x3_bf16(xin, w, b, r, want_bf16=True,
                                        inv_s_next=inv, out=out,
                                        out_q=out_q)
            torch.cuda.synchronize()
            assert h is out and q2 is out_q
            assert torch.equal(out, full) and torch.equal(out_q, want)
            assert torch.equal(hb, full.to(torch.bfloat16))


def _int8_fold(dev, blocks=2, seed=0):
    """A calibrated int8 fold of a random ``blocks`` x 256 net."""
    from alphazero_risk_tpu_torch.models.resnet import build_network
    cfg = Config(blocks=blocks)
    net = build_network(cfg, device=dev, seed=seed).eval()
    calib = FI.default_calib_feats(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    return FI.fold_for_inference(net, cfg, int8=True, calib_feats=calib)


def _eager_trunk_out(folded, x):
    """Stem and int8 trunk launched conv by conv (no graph)."""
    h, _, q = FI._stem(folded, x, inv_s=folded["trunk_convs"][0][4])
    h = FI._trunk_xla_int8(folded, h, q)
    return h.reshape(h.shape[0], 42, -1)


@pytest.mark.parametrize("batch", [64, 1024])
def test_trunk_replay_matches_eager(cuda, batch):
    """The int8 trunk as one graph replay against the trunk launched conv
    by conv, bit for bit, at a batch of K1's tiled design (64) and of its
    wide design (1,024): the first evaluation (eager, then the capture),
    two successive inputs replayed, the first again, and after a re-fold
    (new scales: new graphs) while the old fold's graph still replays.
    Each evaluation counts 2 x blocks K1 launches and one K4 launch; the
    stem's int8 output in the graph's input is ``_quantize`` of its f32
    one."""
    blocks = 2
    folded = _int8_fold(cuda, blocks)
    gen = torch.Generator(device=cuda).manual_seed(batch)
    xs = [torch.rand((batch, 7, 6, 13), generator=gen, device=cuda)
          for _ in range(2)]
    refs = [_eager_trunk_out(folded, x) for x in xs]

    def evaluate(f, x):
        k1, k4 = kernels.CONV3X3_I8.launches, kernels.CONV3X3_BF16.launches
        out = FI._trunk_out(f, x, True).clone()
        assert kernels.CONV3X3_I8.launches - k1 == 2 * blocks
        assert kernels.CONV3X3_BF16.launches - k4 == 1
        return out

    for i in (0, 1, 0, 1):
        assert torch.equal(evaluate(folded, xs[i]), refs[i])
    graphs = folded["trunk_graphs"]
    g = graphs.by_boards[batch]
    assert g.graph is not None and set(graphs.by_boards) == {batch}
    assert torch.equal(g.q0, FI._quantize(g.h0, folded["trunk_convs"][0][4]))
    refold = FI.calibrate_trunk(folded, xs[1])
    assert not torch.equal(refold["act_s"], folded["act_s"])
    ref2 = _eager_trunk_out(refold, xs[0])
    for _ in range(2):
        assert torch.equal(evaluate(refold, xs[0]), ref2)
    assert refold["trunk_graphs"] is not graphs
    assert torch.equal(evaluate(folded, xs[1]), refs[1])


def test_heads_eval_matches_plain(cuda):
    cfg = Config(blocks=1, filters=64, value_hidden=48)
    trainer = Trainer(cfg, seed=3, device=cuda)
    folded = trainer.folded()
    g = torch.Generator(device=cuda).manual_seed(4)
    h = torch.randn((9, 42, 64), generator=g, device=cuda).relu()
    legal = torch.rand((9, 43), generator=g, device=cuda) < 0.4
    legal[0] = True
    legal[1] = False            # no legal action: NaN row in both
    probs, value, logits = FI.heads_eval(folded, h, legal)
    rp, rv, rl = FI._heads_eval_plain(folded, h, legal)
    # float32 sums in another order, expf and tanhf: 1e-5 absolute
    torch.testing.assert_close(logits, rl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(value, rv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(probs, rp, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    assert torch.isnan(probs[1]).all() and torch.isnan(rp[1]).all()


def _random_heads(c, v, dev, seed):
    """A folded dict holding random head weights of C channels and V
    value-hidden units, and their K5 pack."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = {k: tuple({"c": c, "v": v}.get(d, d) for d in shape)
              for k, shape in FI._HEAD_SHAPES.items()}
    folded = {k: 0.2 * torch.randn(shape, generator=g, device=dev)
              for k, shape in shapes.items()}
    return {**folded, "heads_pack": FI.pack_heads(folded)}


def _assert_heads_match(got, ref, legal):
    """K5's stated bound: logits within 1e-5 of the largest |logit| (at
    least 1), the value within 1e-5, probs a distribution over the legal
    moves within 1e-5 of the plain ones (NaN rows where none is legal)."""
    (probs, value, logits), (rp, rv, rl) = got, ref
    top = max(float(rl.abs().max()), 1.0)
    assert float((logits - rl).abs().max()) <= 1e-5 * top
    assert float((value - rv).abs().max()) <= 1e-5 * max(
        float(rv.abs().max()), 1.0)
    some = legal.any(-1)
    assert torch.isnan(probs[~some]).all() and torch.isnan(rp[~some]).all()
    assert float((probs[some] - rp[some]).abs().max()) <= 1e-5
    assert bool((probs[some][~legal[some]] == 0).all())
    torch.testing.assert_close(probs[some].sum(-1),
                               torch.ones_like(probs[some][:, 0]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("c,v", [(32, 16), (64, 48), (128, 256),
                                 (256, 256), (256, 16), (32, 256), (96, 10)])
@pytest.mark.parametrize("batch", [1, 3, 64, 65, 128, 512, 1024])
def test_heads_eval_shapes_match_plain(cuda, batch, c, v):
    """K5 (one block per game, one per SM looping over games past 132)
    against ``_heads_eval_plain`` at batches the paths launch it with and
    on both sides of one block per SM, C = 32..256, V = 16..256 (and a V
    that is no multiple of 4), with rows that have no legal action."""
    folded = _random_heads(c, v, cuda, seed=batch + c + v)
    g = torch.Generator(device=cuda).manual_seed(batch)
    h = torch.randn((batch, 42, c), generator=g, device=cuda).relu()
    legal = torch.rand((batch, 43), generator=g, device=cuda) < 0.3
    legal[0] = True
    if batch > 1:
        legal[1] = False
    legal[2::7] = False
    _assert_heads_match(FI.heads_eval(folded, h, legal),
                        FI._heads_eval_plain(folded, h, legal), legal)


def test_heads_pack_is_rebuilt_by_each_fold(cuda):
    """``fold_params`` packs the heads anew on every fold: after the net's
    weights change, a second fold's K5 matches the plain heads of the new
    weights, with the first fold's pack spoiled (so it is never read)."""
    cfg = Config(blocks=1, filters=64, value_hidden=48)
    trainer = Trainer(cfg, seed=3, device=cuda)
    first = FI.fold_params(trainer.net, cfg)
    with torch.no_grad():
        for p in trainer.net.parameters():
            p.mul_(1.5).add_(0.01)
    second = FI.fold_params(trainer.net, cfg)
    assert second["heads_pack"].data_ptr() != first["heads_pack"].data_ptr()
    g = torch.Generator(device=cuda).manual_seed(4)
    h = torch.randn((9, 42, 64), generator=g, device=cuda).relu()
    legal = torch.rand((9, 43), generator=g, device=cuda) < 0.4
    legal[:, 42] = True
    old = FI._heads_eval_plain(first, h, legal)
    first["heads_pack"].fill_(float("nan"))
    got = FI.heads_eval(second, h, legal)
    _assert_heads_match(got, FI._heads_eval_plain(second, h, legal), legal)
    assert float((got[2] - old[2]).abs().max()) > 1e-3


def _clone_tree(tree):
    return type(tree)(**{
        f.name: (tree_map(torch.clone, getattr(tree, f.name))
                 if isinstance(getattr(tree, f.name), GameState)
                 else getattr(tree, f.name).clone())
        for f in dataclasses.fields(tree)})


def _assert_trees_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, GameState):
            for sf in dataclasses.fields(GameState):
                assert torch.equal(getattr(x, sf.name), getattr(y, sf.name)), \
                    sf.name
        else:
            assert torch.equal(x, y), f.name


def test_write_nodes_matches_plain(cuda):
    cfg = Config(mcts_simulations=6, max_depth=10)
    root = played_roots(64, 120, seed=5)
    gum = S.draw_gumbel(torch.Generator().manual_seed(2), cfg, 64, "cpu")
    cpu_tree = S.search(root, gum, cfg, uniform_eval).tree
    # root write: the tree init_tree builds on the card against the CPU's
    croot = tree_map(lambda x: x.to(cuda), root)
    _assert_trees_equal(_to(S.init_tree(root, cfg, uniform_eval), cuda),
                        S.init_tree(croot, cfg, uniform_eval))
    # expansion write on a grown tree
    tree = _to(cpu_tree, cuda)
    path = S.descend(tree, gum[1].to(cuda), cfg)
    ref_tree = _clone_tree(tree)
    args = (*S.expansion_inputs(tree, path, cfg, uniform_eval), path)
    lv, lp = S.write_nodes(tree, *args)
    rv, rp = S._write_nodes_plain(ref_tree, *args)
    assert bool((path.exp_n >= 0).any())
    assert torch.equal(lv, rv) and torch.equal(lp, rp)
    _assert_trees_equal(tree, ref_tree)


@pytest.mark.parametrize("n_nodes", [10, 34])
@pytest.mark.parametrize("batch", [1, 3, 4, 5, 31, 33, 64, 512, 1024])
def test_write_nodes_batches_match_plain(cuda, grown_trees, batch, n_nodes):
    """K6 (one warp per game, four per block) on the first ``batch`` games
    of the trees grown with 8 and 32 simulations (full: next_free at the
    last node), every fifth game not expanding, the child's status drawn
    from running, draw and either winner (terminal children): the
    expansion write, its leaf outputs and the root write of a fresh tree,
    bit for bit against the plain version."""
    tree = _games(grown_trees[n_nodes], batch)
    cfg = Config(mcts_simulations=2)
    gen = torch.Generator(device=cuda).manual_seed(batch + n_nodes)
    path = S._descend_plain(tree, S.draw_gumbel(gen, cfg, batch, cuda)[0],
                            cfg)
    exp_n = path.exp_n.clone()
    exp_n[::5] = -1
    path = path._replace(exp_n=exp_n)
    child, status, value, legal, probs = S.expansion_inputs(
        tree, path, cfg, uniform_eval)
    status = torch.tensor([-1, -2, 0, 1], dtype=torch.int32, device=cuda)[
        torch.randint(0, 4, (batch,), generator=gen, device=cuda)]
    args = (child, status, value, legal, probs, path)
    kt, pt = _clone_tree(tree), _clone_tree(tree)
    lv, lp = S.write_nodes(kt, *args)
    rv, rp = S._write_nodes_plain(pt, *args)
    assert torch.equal(lv, rv) and torch.equal(lp, rp)
    _assert_trees_equal(kt, pt)
    assert bool((tree.next_free >= n_nodes - 1).all())
    kr, pr = S._empty_tree(child, cfg), S._empty_tree(child, cfg)
    S.write_nodes(kr, child, status, value, legal, probs)
    S._write_nodes_plain(pr, child, status, value, legal, probs, None)
    _assert_trees_equal(kr, pr)


def test_train_iteration_launches_every_kernel(cuda, tmp_path):
    cfg = Config(blocks=2, filters=64, value_hidden=16, mcts_simulations=4,
                 max_depth=8, env_batch_per_device=4, fast_infer=True,
                 fast_infer_int8=True, batch_size=32,
                 train_iteration_games=4, compare_games=4, epochs=1,
                 benchmark_games_random=2, benchmark_games_script=2,
                 max_game_steps=256, samples_storage_min_batches=2,
                 samples_storage_max_batches=64,
                 checkpoint_dir=str(tmp_path / "ck"),
                 data_dir=str(tmp_path / "data"),
                 log_dir=str(tmp_path / "log"))
    trainer = Trainer(cfg, seed=0, device=cuda)
    kernels.reset_counts()
    trainer.train(iterations=1, resume=False)
    if not trainer.ckpt.exists("best"):
        # a rejected gate skips the benchmark, the one part of train() that
        # meets the ScriptPlayer and the RandomPlayer
        trainer.benchmark()
    # both opponents only fast-forward here: the multi-step entry, not
    # their single steps
    counts = kernels.counts()
    assert counts.pop("script_step") == 0
    assert counts.pop("random_step") == 0
    assert all(n > 0 for n in counts.values()), counts
    assert trainer.ckpt.exists("latest")


@pytest.fixture(scope="module")
def mixed_play():
    """Every 15th of 900 steps of 64 games of mixed play on the card
    (``driver.mixed_play``), on the CPU: every phase, fortify ties, full
    lands, terminal games."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = Config()
    mx = mixed_play_states(64, 900, cfg, torch.Generator(
        device="cuda").manual_seed(11), every=15).apply(lambda x: x.cpu())
    status = rules.game_status(mx.state, cfg)
    assert set(mx.state.phase.tolist()) == set(range(6))
    assert bool((status != -1).any()) and bool((status == -1).any())
    return mx


def _on(x, dev):
    """``x`` (a tensor, a dataclass of tensors or a tuple of them) on
    ``dev``."""
    if isinstance(x, tuple):
        return tuple(_on(y, dev) for y in x)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return tree_map(lambda t: t.to(dev), x)


def _assert_states_equal(a, b):
    for f in dataclasses.fields(GameState):
        assert torch.equal(getattr(a, f.name).cpu(),
                           getattr(b, f.name).cpu()), f.name


@pytest.mark.parametrize("cfg", [Config(), Config(limit_attack_moves=True),
                                 Config(exact_fortify_tiebreak=False)])
def test_rules_step_matches_plain(cuda, mixed_play, cfg):
    """K7: ``step`` with dice and ``step_with_outcome`` against the plain
    versions, on a random legal action and on an arbitrary one."""
    state, dice, a = mixed_play.state, mixed_play.dice, mixed_play.action
    g = torch.Generator().manual_seed(1)
    anyway = torch.randint(0, 43, a.shape, generator=g, dtype=torch.int32)
    outcome = torch.randint(0, 3, a.shape, generator=g, dtype=torch.int32)
    cs = _on(state, cuda)
    for act in (a, anyway):
        kernels.RULES_STEP.launches = 0
        _assert_states_equal(rules.step(cs, act.to(cuda), dice.to(cuda), cfg),
                             rules._step_plain(state, act, dice, cfg))
        _assert_states_equal(
            rules.step_with_outcome(cs, act.to(cuda), outcome.to(cuda), cfg),
            rules._step_with_outcome_plain(state, act, outcome, cfg))
        assert kernels.RULES_STEP.launches == 2


def test_rules_expand_matches_plain(cuda):
    """K7's expand entry: the child of node exp_n read from the tree, its
    status and legal mask."""
    cfg = Config(mcts_simulations=6, max_depth=10)
    root = played_roots(64, 120, seed=7)
    gum = S.draw_gumbel(torch.Generator().manual_seed(3), cfg, 64, "cpu")
    tree = S.search(root, gum, cfg, uniform_eval).tree
    path = S._descend_plain(tree, gum[1], cfg)
    exp_n = path.exp_n.clone()
    exp_n[::5] = -1                 # no expansion: node 0 is read
    assert bool((exp_n > 0).any())
    ref = rules._expand_plain(tree.states, exp_n, path.exp_a, path.exp_o,
                              cfg)
    got = rules.expand(_on(tree.states, cuda), exp_n.to(cuda),
                       path.exp_a.to(cuda), path.exp_o.to(cuda), cfg)
    _assert_states_equal(got[0], ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    assert torch.equal(got[2].cpu(), ref[2])


@pytest.fixture(scope="module")
def mixed_mix():
    """1,024 states of mixed play on the card in a shuffled order whose
    prefixes mix every phase, fortify ties under the random action, full
    lands and terminal games (``chip_smoke.mixed_states``), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return mixed_states(Config(), torch.device("cuda"))


RULES_BATCHES = [1, 3, 4, 5, 31, 33, 64, 512, 1024]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("batch", RULES_BATCHES)
def test_rules_step_batches_match_plain(cuda, mixed_mix, batch, exact):
    """K7 (one warp per game, four per block) at batches ragged against
    the block: ``step`` with the dice and ``step_with_outcome`` against the
    plain versions, every field bit for bit, on the random legal action and
    on an arbitrary one, the fortify tie-break exact and not."""
    cfg = Config(exact_fortify_tiebreak=exact)
    mx = mixed_mix.apply(lambda x: x[:batch].contiguous())
    st, dice = mx.state, mx.dice
    g = torch.Generator(device=cuda).manual_seed(batch)
    anyway = torch.randint(0, 43, (batch,), generator=g, device=cuda,
                           dtype=torch.int32)
    outcome = torch.randint(0, 3, (batch,), generator=g, device=cuda,
                            dtype=torch.int32)
    for act in (mx.action, anyway):
        _assert_states_equal(rules.step(st, act, dice, cfg),
                             rules._step_plain(st, act, dice, cfg))
        _assert_states_equal(
            rules.step_with_outcome(st, act, outcome, cfg),
            rules._step_with_outcome_plain(st, act, outcome, cfg))
    if batch == 1024:
        status = rules._game_status_plain(st, cfg)
        assert set(st.phase.tolist()) == set(range(6))
        assert bool((status != -1).any())
        assert bool((st.army >= cfg.land_army_max).any())
        assert bool(rules.fortify_needs_rank(st, mx.action, cfg).any())


@pytest.mark.parametrize("n_nodes", [10, 34])
@pytest.mark.parametrize("batch", RULES_BATCHES)
def test_rules_expand_batches_match_plain(cuda, grown_trees, batch,
                                          n_nodes):
    """K7's expand entry on the first ``batch`` games of the trees grown
    with 8 and 32 simulations: the child of the node the descent picks
    (node 0 where it picks none), its status and legal mask, bit for
    bit."""
    tree = _games(grown_trees[n_nodes], batch)
    cfg = Config(mcts_simulations=2)
    gen = torch.Generator(device=cuda).manual_seed(batch + n_nodes)
    path = S._descend_plain(tree, S.draw_gumbel(gen, cfg, batch, cuda)[0],
                            cfg)
    exp_n = path.exp_n.clone()
    exp_n[::5] = -1
    args = (tree.states, exp_n, path.exp_a, path.exp_o, cfg)
    got, ref = rules.expand(*args), rules._expand_plain(*args)
    _assert_states_equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("version", [1, 2, 3])
def test_state_views_match_plain(cuda, mixed_play, version):
    """K8: legality, status and features, each alone and all three from
    one launch, against the plain versions on the CPU (the features bit
    for bit, NaN where a share is 0/0)."""
    cfg = Config(feature_version=version)
    state = mixed_play.state
    cs = _on(state, cuda)
    want = (rules._legal_actions_plain(state, cfg),
            rules._game_status_plain(state, cfg), _featurize_plain(state, cfg))
    kernels.STATE_VIEWS.launches = 0
    alone = (rules.legal_actions(cs, cfg), rules.game_status(cs, cfg),
             featurize(cs, cfg))
    both = rules.state_views(cs, cfg, legal=True, status=True,
                             features=True)
    assert kernels.STATE_VIEWS.launches == 4
    for got in (alone, both):
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0,
                                       equal_nan=True)


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 31, 33, 64, 512, 1024])
def test_state_views_batches_match_plain(cuda, mixed_play, batch, version):
    """K8 (one warp per game, four per block) at ragged and large batches:
    each output alone, legality with status, and all three, bit for bit
    against the plain versions (the first game's lands all neutral: a 0/0
    army share, NaN)."""
    cfg = Config(feature_version=version)
    state = tree_map(lambda x: x[:batch].clone(), mixed_play.state)
    state.owner[0] = 2
    cs = _on(state, cuda)
    names = ("legal", "status", "features")
    want = rules._state_views_plain(state, cfg, True, True, True)
    for wanted in [(True, False, False), (False, True, False),
                   (False, False, True), (True, True, False),
                   (True, True, True)]:
        got = rules.state_views(cs, cfg, **dict(zip(names, wanted)))
        refs = [w for w, on in zip(want, wanted) if on]
        assert len(got) == len(refs)
        for g, w in zip(got, refs):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0,
                                       equal_nan=True)
    assert bool(torch.isnan(want[2][0]).any()) == (version >= 2)


@pytest.mark.parametrize("cfg", [Config(),
                                 Config(limit_reinforcement_moves=False),
                                 Config(exact_fortify_tiebreak=False)])
def test_script_and_random_steps_match_plain(cuda, mixed_play, cfg):
    """K9 and K10 against their plain versions: state, carry, action and
    record."""
    mx = mixed_play
    state, carry, reset, u, dice = mx.state, mx.carry, mx.reset, mx.u, mx.dice
    args = [x.to(cuda) for x in (reset, u, dice)]
    kernels.SCRIPT_STEP.launches = kernels.RANDOM_STEP.launches = 0
    s9, c9, r9 = SA.script_step_recorded(_on(state, cuda), _on(carry, cuda),
                                         *args, cfg)
    p9, pc9, pr9 = SA._script_step_recorded_plain(state, carry, reset, u,
                                                  dice, cfg)
    _assert_states_equal(s9, p9)
    for f in dataclasses.fields(SA.ScriptCarry):
        assert torch.equal(getattr(c9, f.name).cpu(), getattr(pc9, f.name))
    assert all(torch.equal(x.cpu(), y) for x, y in zip(r9, pr9))
    s10, r10 = RA.random_step_recorded(_on(state, cuda), args[1], args[2],
                                       cfg)
    p10, pr10 = RA._random_step_recorded_plain(state, u, dice, cfg)
    _assert_states_equal(s10, p10)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(r10, pr10))
    assert (kernels.SCRIPT_STEP.launches, kernels.RANDOM_STEP.launches) == \
        (1, 1)


@pytest.mark.parametrize("batch", [1, 3, 31, 33, 64, 512, 1024])
def test_script_step_batches_match_plain(cuda, mixed_mix, batch):
    """K9's single step (one warp per game, four per block) at batches
    ragged against the block, on the first ``batch`` mixed states with
    their carries, resets and draws: state, carry, action and record bit
    for bit against the plain version."""
    mx = mixed_mix.apply(lambda x: x[:batch].contiguous())
    cfg = Config()
    args = (mx.state, mx.carry, mx.reset, mx.u, mx.dice, cfg)
    s9, c9, r9 = SA.script_step_recorded(*args)
    p9, pc9, pr9 = SA._script_step_recorded_plain(*args)
    _assert_states_equal(s9, p9)
    for f in dataclasses.fields(SA.ScriptCarry):
        assert torch.equal(getattr(c9, f.name), getattr(pc9, f.name)), f.name
    assert all(torch.equal(x, y) for x, y in zip(r9, pr9))


@pytest.mark.parametrize("batch", [1, 3, 64, 1024])
def test_random_step_batches_match_plain(cuda, mixed_mix, batch):
    """K10 (one warp per game, four per block) at batches ragged against
    the block, on the first ``batch`` mixed states (every phase, fortify
    choices, finished games) with their draws: state, action and record
    bit for bit against the plain version."""
    mx = mixed_mix.apply(lambda x: x[:batch].contiguous())
    cfg = Config()
    s10, r10 = RA.random_step_recorded(mx.state, mx.u, mx.dice, cfg)
    p10, pr10 = RA._random_step_recorded_plain(mx.state, mx.u, mx.dice, cfg)
    _assert_states_equal(s10, p10)
    assert all(torch.equal(x, y) for x, y in zip(r10, pr10))


AZ, SCRIPT, RANDOM = AB.OPP_AZ, AB.OPP_SCRIPT, AB.OPP_RANDOM
KINDS = [(AZ, SCRIPT), (SCRIPT, AZ), (SCRIPT, SCRIPT), (AZ, RANDOM),
         (RANDOM, AZ), (SCRIPT, RANDOM), (RANDOM, SCRIPT), (RANDOM, RANDOM)]


@pytest.mark.parametrize("kinds", KINDS)
@pytest.mark.parametrize("k", [1, 7, 64])
def test_agent_steps_match_plain(cuda, mixed_mix, k, kinds):
    """The multi-step entry against the plain multi-step function on the
    1,024 mixed states, for every pair of seat kinds (an AlphaZero seat
    beside either agent: the fast-forward's stop predicate; two agents:
    a match's): state, carry, prev and step counts bit for bit.  Games
    stop inside the block (ending, or reaching the AlphaZero seat), and
    others run through it."""
    cfg = Config()
    mx = mixed_mix
    b = mx.state.batch_size
    gen = torch.Generator(device=cuda).manual_seed(k)
    draws = [draw_step_randoms(gen, b, cuda) for _ in range(k)]
    u = torch.stack([x[0] for x in draws])
    dice = torch.stack([x[1] for x in draws])
    kernels.AGENT_STEPS.launches = 0
    got = AB.agent_steps(mx.state, mx.carry, mx.prev, u, dice, cfg, kinds)
    assert kernels.AGENT_STEPS.launches == 1
    ref = AB._agent_steps_plain(mx.state, mx.carry, mx.prev, u, dice, cfg,
                                kinds)
    _assert_states_equal(got[0], ref[0])
    for f in dataclasses.fields(SA.ScriptCarry):
        assert torch.equal(getattr(got[1], f.name), getattr(ref[1], f.name))
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    n = ref[3]
    if k > 1:       # games stop inside the block
        assert bool(((n > 0) & (n < k)).any())
    if k <= 16:     # and others run through it
        assert bool((n == k).any())


@pytest.mark.parametrize("agents", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("block", [1, 5, 16])
def test_play_match_blocks_match_plain(cuda, monkeypatch, block, agents):
    """``play_match`` with ScriptPlayer and RandomPlayer seats (driver
    codes) on the card in blocks of the multi-step entry against the same
    match on the plain multi-step function, with ``max_steps`` cutting a
    block short: status, rounds, steps and the generator's state after
    the match."""
    from alphazero_risk_tpu_torch.agents import driver as D
    cfg = Config()

    monkeypatch.setattr(D, "MATCH_BLOCK", block)

    def run():
        gen = torch.Generator(device=cuda).manual_seed(3)
        state = D.mirrored_initial_states(64, generator=gen, device=cuda)
        res = D.play_match(gen, state, *agents, cfg, 123)
        return res, gen.get_state()

    kernels.AGENT_STEPS.launches = kernels.RANDOM_STEP.launches = 0
    got, g1 = run()
    assert kernels.AGENT_STEPS.launches == -(-123 // block)
    assert kernels.RANDOM_STEP.launches == 0
    monkeypatch.setattr(AB, "agent_steps", AB._agent_steps_plain)
    ref, g2 = run()
    assert got.steps == ref.steps == 123
    assert torch.equal(got.status, ref.status)
    assert torch.equal(got.rounds, ref.rounds)
    assert torch.equal(g1, g2)


def test_train_on_data_launches_every_kernel(cuda, tmp_path):
    """A tiny ``train_on_data`` loop: every kernel launches, the scripted
    matches through K9 and K10 only."""
    cfg = Config(blocks=2, filters=64, value_hidden=16, mcts_simulations=4,
                 max_depth=8, env_batch_per_device=4, fast_infer=True,
                 fast_infer_int8=True, batch_size=32, data_games_ss=4,
                 data_games_sr=4, compare_games=4,
                 benchmark_games_random=2, benchmark_games_script=2,
                 max_game_steps=1024, actor_chunk_steps=128,
                 samples_storage_min_batches=2,
                 checkpoint_dir=str(tmp_path / "ck"),
                 data_dir=str(tmp_path / "data"),
                 log_dir=str(tmp_path / "log"))
    trainer = Trainer(cfg, seed=0, device=cuda)
    gen_counts = []
    real = trainer._scripted_call

    def counted(kinds):
        call = real(kinds)

        def run(state, carry, prev):
            c0 = kernels.counts()
            out = call(state, carry, prev)
            gen_counts.append((kinds, {k: v - c0[k] for k, v in
                                       kernels.counts().items()}))
            return out
        return run

    trainer._scripted_call = counted
    kernels.reset_counts()
    trainer.train_on_data(loops=1)
    counts = kernels.counts()
    multi = counts.pop("agent_steps")
    assert all(n > 0 for n in counts.values()), counts
    if multi == 0:
        # a rejected gate skips the benchmark, the one part of the loop
        # that fast-forwards the opponents (the multi-step entry)
        trainer.benchmark()
        assert kernels.counts()["agent_steps"] > 0
    for kinds, c in gen_counts:
        assert c["script_step"] == cfg.actor_chunk_steps
        assert c["random_step"] == (cfg.actor_chunk_steps
                                    if kinds[1] == A.OPP_RANDOM else 0)
        assert c["conv3x3_i8"] == c["mcts_descend"] == c["rules_step"] == 0
    # the single steps run only in the recorded scripted generation
    assert kernels.counts()["random_step"] == sum(
        c["random_step"] for _, c in gen_counts)
    assert trainer.ckpt.exists("temp") and trainer.ckpt.exists("latest")


FULL_CARDS = Config(simple_cards=False)


@pytest.fixture(scope="module")
def card_mix():
    """1,024 full-cards states on the card (``chip_smoke.card_states``):
    mixed play under full cards, three games in eight with their hands and
    piles dealt anew (large hands, empty and nearly empty piles, bonus
    lands at the army cap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return card_states(FULL_CARDS, torch.device("cuda"))


@pytest.mark.parametrize("batch", RULES_BATCHES)
def test_full_cards_rules_step_batches_match_plain(cuda, card_mix, batch):
    """K7's full-cards step (the card uniform u[:, 3]) against
    ``_step_plain``, every field bit for bit, on the random legal action
    and on an arbitrary one; at 1,024 games draws, reshuffles and trades
    happen."""
    mx = card_mix.apply(lambda x: x[:batch].contiguous())
    st, dice, u_card = mx.state, mx.dice, mx.u[:, 3].contiguous()
    g = torch.Generator(device=cuda).manual_seed(batch)
    anyway = torch.randint(0, 43, (batch,), generator=g, device=cuda,
                           dtype=torch.int32)
    for act in (mx.action, anyway):
        kernels.RULES_STEP.launches = 0
        got = rules.step(st, act, dice, FULL_CARDS, u_card)
        ref = rules._step_plain(st, act, dice, FULL_CARDS, u_card)
        assert kernels.RULES_STEP.launches == 1
        _assert_states_equal(got, ref)
    if batch == 1024:
        assert bool((ref.card_sets_played > st.card_sets_played).any())
        assert bool((ref.drawn_cards.sum(-1) < st.drawn_cards.sum(-1)).any())


@pytest.mark.parametrize("batch", RULES_BATCHES)
def test_full_cards_agent_steps_match_plain(cuda, card_mix, batch):
    """K9 and K10 under full cards (the pin's and every reinforcement's
    trade, the turn end's draw with u[:, 3]) against their plain versions:
    state, carry, action and record bit for bit."""
    mx = card_mix.apply(lambda x: x[:batch].contiguous())
    args9 = (mx.state, mx.carry, mx.reset, mx.u, mx.dice, FULL_CARDS)
    got9, ref9 = (SA.script_step_recorded(*args9),
                  SA._script_step_recorded_plain(*args9))
    _assert_states_equal(got9[0], ref9[0])
    for f in dataclasses.fields(SA.ScriptCarry):
        assert torch.equal(getattr(got9[1], f.name), getattr(ref9[1], f.name))
    assert all(torch.equal(x, y) for x, y in zip(got9[2], ref9[2]))
    args10 = (mx.state, mx.u, mx.dice, FULL_CARDS)
    got10, ref10 = (RA.random_step_recorded(*args10),
                    RA._random_step_recorded_plain(*args10))
    _assert_states_equal(got10[0], ref10[0])
    assert all(torch.equal(x, y) for x, y in zip(got10[1], ref10[1]))
    if batch == 1024:
        for ref in (ref9[0], ref10[0]):
            assert bool((ref.card_sets_played
                         > mx.state.card_sets_played).any())


@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("kinds", [(1, 1), (1, 2), (2, 1), (2, 2), (0, 1),
                                   (2, 0)])
def test_full_cards_multi_step_matches_plain(cuda, card_mix, kinds, k):
    """The multi-step entry under full cards against the plain multi-step
    function on the 1,024 full-cards states with their carries and
    previous movers: state (card masks included), carry, prev and step
    counts bit for bit."""
    mx = card_mix
    gen = torch.Generator(device=cuda).manual_seed(40 + k)
    u, dice = BlockDraws(gen, mx.state.batch_size, cuda).block(k)
    args = (mx.state, mx.carry, mx.prev, u, dice, FULL_CARDS, kinds)
    got, ref = AB.agent_steps(*args), AB._agent_steps_plain(*args)
    _assert_states_equal(got[0], ref[0])
    for f in dataclasses.fields(SA.ScriptCarry):
        assert torch.equal(getattr(got[1], f.name), getattr(ref[1], f.name))
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    assert bool((ref[0].card_sets_played > mx.state.card_sets_played).any())


@pytest.mark.parametrize("agents", [(0, 0), (0, 1)])
def test_full_cards_play_match_in_blocks_matches_plain(cuda, agents):
    """``play_match`` under full cards, Script vs Script and Script vs
    Random on 64 mirrored games to the end in blocks of the multi-step
    entry, against the per-iteration loop on the plain versions from the
    same seed: tallies, steps and final rounds."""
    from alphazero_risk_tpu_torch.agents import driver as D
    from chip_smoke import match_by_iteration

    def start():
        gen = torch.Generator(device=cuda).manual_seed(50 + agents[1])
        return gen, D.mirrored_initial_states(64, generator=gen, device=cuda)

    gen, st = start()
    res = D.play_match(gen, st, *agents, FULL_CARDS, 4096)
    gen, st = start()
    ref, steps, _ = match_by_iteration(gen, st, agents, FULL_CARDS, 4096)
    assert res.steps == steps
    assert torch.equal(res.status, rules._game_status_plain(ref, FULL_CARDS))
    assert torch.equal(res.rounds, ref.round)
    assert bool((res.status != -1).all())
    assert bool((ref.card_sets_played > 0).any())


# ------------------------------------------------ tree reuse on the card

def _played_move(cfg, root, seed):
    """One search on the CPU over ``root``, its argmax move, the move's
    dice and the chance outcome they realise."""
    gen = torch.Generator().manual_seed(seed)
    res = S.search(root, S.draw_gumbel(gen, cfg, root.batch_size, "cpu"),
                   cfg, uniform_eval)
    action = S.pick_move(res, root, cfg, False)
    dice = rules.roll_dice(gen, root.batch_size)
    return res.tree, action, dice, A.realised_outcome(root, action, dice)


@pytest.mark.parametrize("sims", [8, 32])
@pytest.mark.parametrize("batch", [1, 3, 64])
def test_reroot_matches_cpu(cuda, batch, sims):
    """``reroot`` on the card (its stable ``int8`` argsort of the drop
    flags) equals the CPU's, which equals JAX's: every array of the
    compacted tree, the garbage past ``n_keep`` included, and the reuse
    flags."""
    cfg = Config(mcts_simulations=sims, max_depth=16, tree_reuse=True)
    root = played_roots(batch, 120, seed=sims + batch)
    tree, action, _, outcome = _played_move(cfg, root, batch)
    want, want_reused = S.reroot(tree, action, outcome, cfg)
    got, got_reused = S.reroot(_to(tree, cuda), action.to(cuda),
                               outcome.to(cuda), cfg)
    assert torch.equal(got_reused.cpu(), want_reused)
    _assert_trees_equal(_to(got, "cpu"), want)
    if batch == 64:
        assert bool(want_reused.any()) and int(want.next_free.max()) > 1


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_search_kernels_on_rerooted_trees_match_plain(cuda, batch):
    """On the tree ``search_with_reuse`` starts from (carried subtrees
    where the played child was expanded, fresh roots elsewhere): K2, K7's
    expand, K6 and K3 against their plain versions; then the whole
    reusing search on the card equal to the CPU's."""
    cfg = Config(mcts_simulations=8, max_depth=16, tree_reuse=True)
    root = played_roots(batch, 120, seed=40 + batch)
    tree, action, dice, outcome = _played_move(cfg, root, batch)
    nxt = rules.step(root, action, dice, cfg)
    carried, reused = S.reroot(tree, action, outcome, cfg)
    gum = S.draw_gumbel(torch.Generator().manual_seed(batch), cfg, batch,
                        "cpu")
    cnxt = tree_map(lambda x: x.to(cuda), nxt)
    ccarried, creused = _to(carried, cuda), reused.to(cuda)
    start = S._select_tree(creused & S.carried_roots_match(ccarried, cnxt),
                           ccarried, S.init_tree(cnxt, cfg, uniform_eval))
    g0 = gum[0].to(cuda)
    path = _assert_descent_matches_plain(start, g0, cfg)
    args = (start.states, path.exp_n, path.exp_a, path.exp_o, cfg)
    got, ref = rules.expand(*args), rules._expand_plain(*args)
    _assert_states_equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    kt, pt = _clone_tree(start), _clone_tree(start)
    ins = S.expansion_inputs(kt, path, cfg, uniform_eval)
    lv, lp = S.write_nodes(kt, *ins, path)
    rv, rp = S._write_nodes_plain(pt, *ins, path)
    assert torch.equal(lv, rv) and torch.equal(lp, rp)
    _assert_trees_equal(kt, pt)
    S.backup(kt, path, lv, lp)
    S._backup_plain(pt, path, rv, rp)
    assert torch.equal(kt.visit, pt.visit) and torch.equal(kt.wsum, pt.wsum)
    on_card = S.search_with_reuse(cnxt, gum.to(cuda), cfg, uniform_eval,
                                  ccarried, creused)
    on_cpu = S.search_with_reuse(nxt, gum, cfg, uniform_eval, carried,
                                 reused)
    _assert_trees_equal(_to(on_card.tree, "cpu"), on_cpu.tree)
    assert torch.equal(on_card.pi.cpu(), on_cpu.pi)


# ------------------------------------------- the device ring on the card

def _actor_samples(t, b, seed):
    """A [t, b] ``SampleBatch`` of random records, about 60% valid."""
    g = torch.Generator().manual_seed(seed)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g).to(dtype)

    pol = torch.rand((t, b, 43), generator=g)
    return A.SampleBatch(
        owner=ints(0, 3, (t, b, 42), torch.int8),
        army=ints(1, 33, (t, b, 42), torch.int8),
        cur_player=ints(0, 2, (t, b), torch.int8),
        phase=ints(0, 6, (t, b), torch.int8),
        round=ints(1, 59, (t, b), torch.int16),
        reinforcements=ints(0, 30, (t, b), torch.int16),
        attacks_during_turn=ints(0, 9, (t, b), torch.int16),
        can_draw_card=ints(0, 2, (t, b), torch.bool),
        policy=(pol / pol.sum(-1, keepdim=True)).half(),
        value=torch.zeros((t, b)),
        valid=torch.rand((t, b), generator=g) < 0.6)


RING = Config(batch_size=16, samples_storage_min_batches=1,
              samples_storage_max_batches=4)          # 64 slots


def _assert_rings_equal(a, b):
    assert (a.start, a.size, a.old_game_index) == \
        (b.start, b.size, b.old_game_index)
    for k in a.data:
        assert torch.equal(a.data[k].cpu(), b.data[k].cpu()), k


def test_device_ring_wraps_on_the_card_as_on_the_cpu(cuda):
    """``DeviceReplay`` on the card and on the CPU, fed the same actor
    records (wrapping ``index_copy_`` writes, an ingest larger than the
    ring that keeps only its newest rows), host arrays and trims: every
    slot, the window and the old-game index equal after each
    operation."""
    from alphazero_risk_tpu_torch.training.device_replay import DeviceReplay
    rings = {"cpu": DeviceReplay(RING, "cpu"), "cuda": DeviceReplay(RING,
                                                                  cuda)}
    for i, (t, b) in enumerate([(6, 4), (9, 5), (20, 8), (3, 2), (30, 6)]):
        samples = _actor_samples(t, b, i)
        status = torch.randint(-2, 2, (b,), generator=torch.Generator()
                               .manual_seed(i)).to(torch.int32)
        final = torch.randint(20, 58, (b,), dtype=torch.int32)
        n = {}
        for name, ring in rings.items():
            dev = ring.device
            n[name] = ring.extend_from_actor(
                A.SampleBatch(*(x.to(dev) for x in samples)),
                status.to(dev), final_round=final.to(dev))
        assert n["cpu"] == n["cuda"] > 0
        _assert_rings_equal(rings["cpu"], rings["cuda"])
        if i % 2:
            for ring in rings.values():
                ring.mark_old_games()
                ring.trim()
            _assert_rings_equal(rings["cpu"], rings["cuda"])
    host = rings["cpu"].sample_arrays(40)
    for ring in rings.values():
        ring.extend(host)
    _assert_rings_equal(rings["cpu"], rings["cuda"])
    assert rings["cuda"].size == RING.samples_storage_max


def test_ring_epoch_order_matches_cpu(cuda, monkeypatch):
    """``make_ring_epoch_fn``'s stable argsort on the card orders a window
    as on the CPU, with the uniforms tied (all equal, or four values) and
    not, at wrapped windows; then one real epoch on the card trains."""
    from alphazero_risk_tpu_torch.training import learner as L
    from alphazero_risk_tpu_torch.training.device_replay import DeviceReplay
    cap = RING.samples_storage_max
    seen = []
    monkeypatch.setattr(L, "_minibatches",
                        lambda state, cfg, data, perm, prep:
                        seen.append(perm.cpu()) or (state, {}))
    epoch = L.make_ring_epoch_fn(RING)
    g = torch.Generator().manual_seed(3)
    data = {"value": torch.zeros(cap)}
    for r in (torch.zeros(cap), torch.randint(0, 4, (cap,), generator=g)
              .float() / 4, torch.rand(cap, generator=g)):
        for start, size in ((0, cap), (37, 50), (60, 20), (5, 15)):
            seen.clear()
            epoch(None, data, start, size, r=r)
            epoch(None, {"value": data["value"].to(cuda)}, start, size,
                  r=r.to(cuda))
            assert torch.equal(seen[0], seen[1]), (start, size)
    monkeypatch.undo()
    from alphazero_risk_tpu_torch.training.learner import create_train_state
    cfg = RING.replace(blocks=1, filters=16, value_hidden=8)
    ring = DeviceReplay(cfg, cuda)
    samples = _actor_samples(30, 6, 9)
    ring.extend_from_actor(A.SampleBatch(*(x.to(cuda) for x in samples)),
                           torch.zeros(6, dtype=torch.int32, device=cuda))
    state = create_train_state(cfg, seed=0, device=cuda)
    state, m = L.make_ring_epoch_fn(
        cfg, prepare_batch=lambda d, i: A.prepare_samples(d, i, cfg))(
        state, *ring.epoch_view(),
        generator=torch.Generator(device=cuda).manual_seed(1))
    assert state.step == ring.size // cfg.batch_size > 0
    assert bool(torch.isfinite(m["loss"]))


# --------------------------------------- the viewer's batch of one

@pytest.mark.parametrize("p2", ["sp", "rp", "az"])
def test_watch_steps_at_one_game_match_plain(cuda, p2):
    """The AlphaZero viewer's step loop (``utils.watch.az_steps``) at
    B=1 on the card: the kernels (K2, K3, K6, K7's step and expand, K8,
    and K9 or K10 for the opponent) against every one of them swapped for
    its plain version (``chip_smoke.plain_versions``) from the same seed,
    through the setup into the battle phases: every state and ``pi``
    equal, the launch counts those the step count implies."""
    import itertools

    from alphazero_risk_tpu_torch.models.resnet import build_network
    from alphazero_risk_tpu_torch.utils import watch as W
    from chip_smoke import plain_versions, watch_launches

    cfg = Config(blocks=1, filters=32, value_hidden=16, mcts_simulations=8,
                 max_depth=16)
    net = build_network(cfg, device=cuda, seed=3).eval()
    if p2 == "az":
        efn = A.make_paired_eval_fn(
            net, build_network(cfg, device=cuda, seed=4).eval(), cfg)
        kw = dict(paired=True)
    else:
        efn = A.make_eval_fn(net, cfg)
        kw = dict(opponent={"sp": A.OPP_SCRIPT, "rp": A.OPP_RANDOM}[p2],
                  az_seats=(True, False))

    def run():
        gen = torch.Generator(device=cuda).manual_seed(5)
        st = new_game(1, generator=gen, device=cuda)
        draws = itertools.repeat(A.GeneratorDraws(gen, cfg, 1, cuda))
        return [(s, pi.clone(), m)
                for s, pi, m in W.az_steps(efn, st, cfg, draws, 90, **kw)]

    kernels.reset_counts()
    got = run()
    counts = kernels.counts()
    with plain_versions():
        ref = run()
    assert len(got) == len(ref) == 90
    for (s, pi, m), (rs, rpi, rm) in zip(got, ref):
        _assert_states_equal(s, rs)
        assert torch.equal(pi, rpi) and m == rm
    want = watch_launches(90, cfg.mcts_simulations, p2)
    want["state_views"] -= 1          # the viewer's closing status
    assert counts == want
    assert 3 in {int(s.phase[0]) for s, _, _ in got}   # an attack phase


def test_world_play_on_one_card_matches_one_process(cuda, tmp_path):
    """A 2-rank gloo world with both ranks on ``cuda:0`` plays
    ``play(OPP_SCRIPT)`` on the kernels (int8 trunk, the search kernels,
    the multi-step entry's fast-forward, agreed over the world): each
    rank's games are its rows of one process's games from the same seed,
    bit for bit, and both ranks report the one-process tally."""
    import torch_world as W
    cfg = Config(blocks=2, filters=64, value_hidden=16, mcts_simulations=4,
                 fast_infer=True, fast_infer_int8=True,
                 env_batch_per_device=8, max_game_steps=192,
                 actor_chunk_steps=48,
                 checkpoint_dir=str(tmp_path / "checkpoints"),
                 data_dir=str(tmp_path / "data"),
                 log_dir=str(tmp_path / "log"))
    one = W.trainer_runs(0, cfg, 3, 16, paths=("play",), device="cuda")
    world = W.run_world(W.trainer_runs, 2, tmp_path, cfg, 3, 16, True,
                        ("play",), timeout=600, device="cuda")
    assert W.world_equals_one(one, world, "play")
    assert [r["play"]["result"] for r in world] == [one["play"]["result"]] * 2
    assert one["play"]["result"]["games"] == 16


def test_spans_time_the_play_path_on_the_card(cuda):
    """Under the profiler the play path's spans carry device seconds from
    their CUDA events, nested as the spans are, and the games and
    decisions equal those played without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from alphazero_risk_tpu_torch.utils import profiling
    cfg = Config(blocks=2, filters=64, value_hidden=16, mcts_simulations=4,
                 max_depth=8, env_batch_per_device=4, fast_infer=True,
                 fast_infer_int8=True)
    plain = Trainer(cfg, seed=0, device=cuda)
    off = plain.play(A.OPP_SCRIPT, 4)
    traced = Trainer(cfg, seed=0, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = traced.play(A.OPP_SCRIPT, 4)
    assert on == off
    assert (traced.play_stats["az_decisions"]
            == plain.play_stats["az_decisions"])
    rep = profiling.report()
    spans = rep["spans"]
    assert set(spans) == {"actor.step", "actor.ff", "host.sync",
                          "search.run", "net.eval", "net.trunk"}
    # the fast-forward's reads, and the episode loop's at the top
    assert set(spans["host.sync"]["parents"]) == {"actor.ff", None}
    assert spans["net.trunk"]["device_s"] > 0
    assert all(v["device_s"] >= 0 for v in spans.values())
    assert rep["counters"]["net.boards"] == 4 * spans["net.trunk"]["count"]
    # four boards of 64 channels: K1's tiled design, never the wide one
    assert rep["counters"]["net.boards_wide"] == 0
    # nested spans on one stream: a child's events lie between its
    # parent's
    dev = {k: v["device_s"] for k, v in spans.items()}
    assert dev["net.trunk"] <= dev["net.eval"] <= dev["search.run"] \
        <= dev["actor.step"]
