"""The port's CUDA kernels against their plain versions, on the card.

Skipped without an NVIDIA card.  Imports nothing of JAX, so it also runs
where JAX is not installed (skipping the repo's conftest, which is):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import dataclasses
from pathlib import Path

import numpy as np
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

from torch_cases import (MIXED, TIE_CASES, card_states, clone_tree, first,
                         heuristic_eval, match_by_iteration, mixed_states,
                         plain_versions, random_play_states, tie_tree,
                         watch_launches)

pytestmark = pytest.mark.cuda


def played_roots(batch, steps, seed):
    return random_play_states(batch, steps, torch.Generator().manual_seed(
        seed), Config(), "cpu")


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
    every output combination: int32 accumulators equal; in the wide design
    h and the requantized int8 bit for bit (the same float operations in
    the same order, no FMA, rint's ties to even), in the tiled design h
    within 1e-6 relative and the int8 within 1.  Either design, as the
    batch and the channels choose it."""
    batch = _batch(batch, _sms(cuda))
    wide = FI.k1_wide(batch, channels, cuda)
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
                if wide:
                    assert torch.equal(h, ref_h)
                else:
                    torch.testing.assert_close(h, ref_h, rtol=1e-6,
                                               atol=1e-6)
            if qn is not None:
                if wide:
                    assert torch.equal(qn, ref_q)
                else:
                    assert int((qn.int() - ref_q.int()).abs().max()) <= 1


@pytest.mark.parametrize("batch", [1021, 4093])
def test_conv3x3_i8_wide_writes_rows_below_m_alone(cuda, batch):
    """K1's wide design at a ragged batch (its last tile part past M),
    launched on views one board into buffers two boards longer, filled
    with values no output takes: every output combination writes its rows
    below M, equal to the plain version, and nothing before or past
    them (the tensor maps clip the last tile's stores)."""
    c, pad = 256, 42
    assert FI.k1_wide(batch, c, cuda)
    m = batch * 42
    g = torch.Generator(device=cuda).manual_seed(batch)
    q = torch.randint(-127, 128, (batch, 7, 6, c), generator=g, device=cuda,
                      dtype=torch.int8)
    w = FI.pack_trunk_wq(torch.randint(-127, 128, (3, 3, c, c), generator=g,
                                       device=cuda, dtype=torch.int8))
    ws = torch.rand(c, generator=g, device=cuda) / 127
    b = torch.randn(c, generator=g, device=cuda)
    s = torch.tensor(0.01, device=cuda)
    inv = torch.tensor(1 / 3.0, device=cuda)
    ref_acc = FI._conv_i8_plain(q, w).reshape(m, c)
    # h >= 0, q_next >= -127 and |acc| < 2^31 - 1: never the sentinels
    fills = {torch.float32: -1.0, torch.int8: -128, torch.int32: -2 ** 31}
    res = torch.full((m + 2 * pad, c), float("nan"), device=cuda)
    res[pad:pad + m] = torch.randn((m, c), generator=g, device=cuda)
    for r in (None, res[pad:pad + m]):
        ref_h, ref_q = FI._epilogue_plain(ref_acc, ws, b, s, r, inv)
        for want in [(True, True, True), (True, True, False),
                     (False, True, False), (True, False, False),
                     (False, False, True)]:
            bufs = [torch.full((m + 2 * pad, c), fill, dtype=dt, device=cuda)
                    if on else None
                    for on, (dt, fill) in zip(want, fills.items())]
            out = [None if t is None else t[pad:pad + m] for t in bufs]
            kernels.CONV3X3_I8.launch(
                *(kernels.ptr(t) for t in (q, w, ws, b, s, r,
                                           inv if want[1] else None, *out)),
                m, c)
            torch.cuda.synchronize()
            for buf, o, ref, fill in zip(bufs, out, (ref_h, ref_q, ref_acc),
                                         fills.values()):
                if buf is None:
                    continue
                assert torch.equal(o, ref)
                assert bool((buf[:pad] == fill).all())
                assert bool((buf[pad + m:] == fill).all())


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
    gen = torch.Generator(device="cuda").manual_seed(4)
    st = random_play_states(1024, 120, gen, Config(), "cuda")
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


def _assert_backup_matches_plain(tree, path):
    """K3 on ``path`` through ``tree`` against ``_backup_plain``, visit and
    wsum bit for bit, with the leaf from the caller's tensors and (the
    search's call) from the tree's own leaf buffers.  Leaves ``tree``'s
    visit and wsum as they were."""
    b, dev = tree.player.shape[0], tree.player.device
    leaf_v = torch.rand(b, generator=torch.Generator(device=dev).manual_seed(
        7), device=dev) * 2 - 1
    leaf_p = tree.player[torch.arange(b, device=dev), path.cur.long()]
    buffers = S._k6_pack(tree)[2]
    buffers[0].copy_(leaf_v)
    buffers[1].copy_(leaf_p)
    visit, wsum = tree.visit.clone(), tree.wsum.clone()
    got = []
    for lv, lp in ((leaf_v, leaf_p), buffers):
        S.backup(tree, path, lv, lp)
        got.append((tree.visit.clone(), tree.wsum.clone()))
        tree.visit.copy_(visit)
        tree.wsum.copy_(wsum)
    S._backup_plain(tree, path, leaf_v, leaf_p)
    for kv, kw in got:
        assert torch.equal(kv, tree.visit) and torch.equal(kw, tree.wsum)
    tree.visit.copy_(visit)
    tree.wsum.copy_(wsum)


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
    ties (``torch_cases.tie_tree``: every legal action tied, rows with no
    legal action, attack sources with equal armies or none), at 33 and
    1,024 games; and K3 on each descent's paths through the tied tree
    against ``_backup_plain``."""
    cfg = Config(mcts_simulations=2)
    for tree in grown_trees.values():
        tied = tie_tree(tree, case)
        for batch in (33, 1024):
            t = _games(tied, batch)
            gen = torch.Generator(device="cuda").manual_seed(batch)
            for gum in S.draw_gumbel(gen, cfg, batch, cuda):
                path = _assert_descent_matches_plain(t, gum, cfg)
                _assert_backup_matches_plain(t, path)


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
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 16, 32, 33, 64, 1023,
                                   1024])
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


def test_descend_and_backup_on_heuristic_trees_match_plain(cuda):
    """K2 and K3 against their plain versions on trees of the stand-in
    network (``torch_cases.heuristic_eval``) over 1,024 played states:
    256 games grown by 8 simulations of the plain versions on the CPU,
    and all 1,024 grown by 8 on the card."""
    grow = Config(mcts_simulations=8)
    cfg = Config(mcts_simulations=32)
    states = random_play_states(1024, 100, torch.Generator(
        device=cuda).manual_seed(1), grow, cuda)
    root = tree_map(lambda x: x[:256].cpu(), states)
    on_cpu = S.search(root, S.draw_gumbel(torch.Generator().manual_seed(5),
                                          grow, 256, "cpu"),
                      grow, heuristic_eval).tree
    on_card = S.search(states, S.draw_gumbel(torch.Generator(
        device=cuda).manual_seed(5), grow, 1024, cuda), grow,
        heuristic_eval).tree
    for tree in (_to(on_cpu, cuda), on_card):
        b = tree.player.shape[0]
        gum = S.draw_gumbel(torch.Generator(device=cuda).manual_seed(6),
                            cfg, b, cuda)[0]
        path = _assert_descent_matches_plain(tree, gum, cfg)
        _assert_backup_matches_plain(tree, path)


def test_play_launches_every_kernel(cuda):
    cfg = Config(blocks=2, filters=64, value_hidden=16, mcts_simulations=4,
                 max_depth=8, env_batch_per_device=4, fast_infer=True,
                 fast_infer_int8=True)
    trainer = Trainer(cfg, seed=0, device=cuda)
    kernels.reset_counts()
    res = trainer.play(A.OPP_SCRIPT, 4)
    assert res["unfinished"] == 0
    # every kernel but the RandomPlayer's and K9's single step: the
    # ScriptPlayer fast-forwards through K9's multi-step entry; and K4's
    # stem design, which takes no stem of 64 channels
    counts = kernels.counts()
    assert counts.pop("random_step") == 0
    assert counts.pop("script_step") == 0
    assert counts.pop("stem_bf16") == 0
    assert all(n > 0 for n in counts.values()), counts


@pytest.mark.parametrize("cin,cout", [(13, 64), (13, 256), (64, 64),
                                      (128, 128), (256, 256), (128, 256)])
@pytest.mark.parametrize("batch", CONV_BATCHES)
def test_conv3x3_bf16_matches_plain(cuda, batch, cin, cout):
    """K4 against its plain version with f32 and bf16 inputs (bf16 only
    where Cin % 8 == 0), with and without the residual, on every output
    combination (the f32 stem to 256 channels without the residual at 512
    and 1,024 in K4's stem design, ``stem_wide``): the f32 output within
    1e-5 of the largest output (bf16 x
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
    chooses) and, for the f32 stem without the residual at 1,024 and
    4,096, K4's stem design; f32 and bf16 inputs, with and without the
    residual, alone or beside the f32 and bf16 outputs, into destination
    tensors or new ones."""
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


# K4's stem at either side of the batch from which its stem design takes
# the launch (200 on an H100's 132 SMs), and at the cells' batches
STEM_BATCHES = [199, 200, 201, 1024, 4096]


@pytest.mark.parametrize("form", ["f32_int8_into", "f32_bf16", "f32"])
@pytest.mark.parametrize("batch", STEM_BATCHES)
def test_stem_matches_plain_on_either_design(cuda, batch, form):
    """K4's stem (13 -> 256 channels, f32 in, no residual) against its
    plain version in the forms the paths launch: f32 and int8 out into the
    caller's buffers (the trunk graph's inputs), f32 and bf16 out (the
    bf16 trunk and calibration), f32 alone.  One launch, of K4's stem
    design where a tile of 64 rows falls to every SM (``stem_wide``), else
    of its tiled design.  h within 1e-5 of the largest output (as K4's
    other tests), the bf16 output h rounded, the int8 codes ``_quantize``
    of h code for code and within one code of the plain output's (a sum
    in another order can cross a rounding tie); the board past the batch
    in the caller's buffers is not written."""
    g = torch.Generator(device=cuda).manual_seed(batch)
    x = torch.randn((batch, 7, 6, 13), generator=g, device=cuda)
    w = (torch.randn((3, 3, 13, 256), generator=g, device=cuda)
         / (9 * 13) ** 0.5).to(torch.bfloat16)
    b = torch.randn(256, generator=g, device=cuda)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False    # the reference in full f32
    try:
        ref = FI._conv3x3_bf16_plain(x, w, b)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # a scale that clips the largest outputs to 127
    inv = (150.0 / ref.max()).reshape(())
    wide = FI.stem_wide(batch, 13, 256, cuda)
    assert wide == (-(-batch * 42 // 64) >= _sms(cuda))
    hbuf = torch.full((batch + 1, 7, 6, 256), float("nan"), device=cuda)
    qbuf = torch.full((batch + 1, 7, 6, 256), 99, dtype=torch.int8,
                      device=cuda)
    kw = {"f32_int8_into": dict(inv_s_next=inv, out=hbuf[:batch],
                                out_q=qbuf[:batch]),
          "f32_bf16": dict(want_bf16=True), "f32": {}}[form]
    n0 = kernels.STEM_BF16.launches, kernels.CONV3X3_BF16.launches
    h, hb, q = FI.conv3x3_bf16(x, w, b, **kw)
    torch.cuda.synchronize()
    assert (kernels.STEM_BF16.launches - n0[0],
            kernels.CONV3X3_BF16.launches - n0[1]) == (
                (1, 0) if wide else (0, 1))
    assert float((h - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert (hb is None) == (form != "f32_bf16")
    if hb is not None:
        assert torch.equal(hb, h.to(torch.bfloat16))
    assert (q is None) == (form != "f32_int8_into")
    if q is not None:
        assert h is kw["out"] and q is kw["out_q"]
        assert torch.equal(q, FI._quantize(h, inv))
        assert int((q.int() - FI._quantize(ref, inv).int()).abs().max()) <= 1
        assert int(q.max()) == 127
        assert bool(hbuf[batch].isnan().all())
        assert bool((qbuf[batch] == 99).all())


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
    Each evaluation counts 2 x blocks K1 launches and one K4 launch (in
    K4's stem design at 1,024); the stem's int8 output in the graph's
    input is ``_quantize`` of its f32 one."""
    blocks = 2
    folded = _int8_fold(cuda, blocks)
    gen = torch.Generator(device=cuda).manual_seed(batch)
    xs = [torch.rand((batch, 7, 6, 13), generator=gen, device=cuda)
          for _ in range(2)]
    refs = [_eager_trunk_out(folded, x) for x in xs]

    stem = (kernels.STEM_BF16 if FI.stem_wide(batch, 13, 256, cuda)
            else kernels.CONV3X3_BF16)

    def evaluate(f, x):
        k1, k4 = kernels.CONV3X3_I8.launches, stem.launches
        out = FI._trunk_out(f, x, True).clone()
        assert kernels.CONV3X3_I8.launches - k1 == 2 * blocks
        assert stem.launches - k4 == 1
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
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 16, 32, 64, 65, 128, 512,
                                   1024])
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
    ref_tree = clone_tree(tree)
    args = (*S.expansion_inputs(tree, path, cfg, uniform_eval), path)
    lv, lp = S.write_nodes(tree, *args)
    rv, rp = S._write_nodes_plain(ref_tree, *args)
    assert bool((path.exp_n >= 0).any())
    assert torch.equal(lv, rv) and torch.equal(lp, rp)
    _assert_trees_equal(tree, ref_tree)


@pytest.mark.parametrize("n_nodes", [10, 34])
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 16, 31, 32, 33, 64, 512,
                                   1024])
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
    kt, pt = clone_tree(tree), clone_tree(tree)
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
    # their single steps; K4's stem design takes no stem of 64 channels
    counts = kernels.counts()
    assert counts.pop("script_step") == 0
    assert counts.pop("random_step") == 0
    assert counts.pop("stem_bf16") == 0
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
    lands and terminal games (``torch_cases.mixed_states``), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return mixed_states(Config(), torch.device("cuda"))


# ragged against a block of four games, and every batch the paths launch:
# lockstep games, the scripted generation's 128, the learner's 512
RULES_BATCHES = [1, 2, 3, 4, 5, 16, 31, 32, 33, 64, 128, 512, 1024]


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
@pytest.mark.parametrize("batch", [1, 2, 4, 16, 31, 32, 33, 64, 128, 512,
                                   1024])
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


def _assert_views_match_plain(st, cfg):
    """K8 on ``st`` in the forms the paths launch: each output alone, all
    three from one launch, legality with status; bit for bit against the
    plain versions (NaN where a share is 0/0)."""
    want = (rules._legal_actions_plain(st, cfg),
            rules._game_status_plain(st, cfg), _featurize_plain(st, cfg))
    for views in ((rules.legal_actions(st, cfg), rules.game_status(st, cfg),
                   featurize(st, cfg)),
                  rules.state_views(st, cfg, legal=True, status=True,
                                    features=True),
                  rules.state_views(st, cfg, legal=True, status=True)):
        for g, w in zip(views, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("batch", RULES_BATCHES)
def test_state_views_on_mixed_states_match_plain(cuda, mixed_mix, batch):
    """K8 on the first ``batch`` of the 1,024 mixed states
    (``torch_cases.mixed_states``: every phase, terminal games, full
    lands) against its plain versions."""
    _assert_views_match_plain(first(mixed_mix, batch).state, Config())


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


def _assert_script_step_matches_plain(*args):
    """K9's single step on ``args`` against the plain version: state,
    carry, action and record bit for bit."""
    got = SA.script_step_recorded(*args)
    ref = SA._script_step_recorded_plain(*args)
    _assert_states_equal(got[0], ref[0])
    for f in dataclasses.fields(SA.ScriptCarry):
        assert torch.equal(getattr(got[1], f.name),
                           getattr(ref[1], f.name)), f.name
    assert all(torch.equal(x, y) for x, y in zip(got[2], ref[2]))
    return ref


def _assert_random_step_matches_plain(*args):
    """K10's single step on ``args`` against the plain version: state,
    action and record bit for bit."""
    got = RA.random_step_recorded(*args)
    ref = RA._random_step_recorded_plain(*args)
    _assert_states_equal(got[0], ref[0])
    assert all(torch.equal(x, y) for x, y in zip(got[1], ref[1]))
    return ref


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 16, 31, 32, 33, 64, 128,
                                   512, 1024])
def test_script_step_batches_match_plain(cuda, mixed_mix, batch):
    """K9's single step (one warp per game, four per block) at batches
    ragged against the block, on the first ``batch`` mixed states with
    their carries, resets and draws: state, carry, action and record bit
    for bit against the plain version."""
    mx = mixed_mix.apply(lambda x: x[:batch].contiguous())
    _assert_script_step_matches_plain(mx.state, mx.carry, mx.reset, mx.u,
                                      mx.dice, Config())


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 16, 32, 64, 128, 1024])
def test_random_step_batches_match_plain(cuda, mixed_mix, batch):
    """K10 (one warp per game, four per block) at batches ragged against
    the block, on the first ``batch`` mixed states (every phase, fortify
    choices, finished games) with their draws: state, action and record
    bit for bit against the plain version."""
    mx = mixed_mix.apply(lambda x: x[:batch].contiguous())
    _assert_random_step_matches_plain(mx.state, mx.u, mx.dice, Config())


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
    s0 = dict(trainer.play_stats)
    kernels.reset_counts()
    trainer.train_on_data(loops=1)
    counts = kernels.counts()
    multi = counts.pop("agent_steps")
    # K4's stem design takes no stem of 64 channels
    assert counts.pop("stem_bf16") == 0
    assert all(n > 0 for n in counts.values()), counts
    if multi == 0:
        # a rejected gate skips the benchmark, the one part of the loop
        # that fast-forwards the opponents (the multi-step entry)
        trainer.benchmark()
        assert kernels.counts()["agent_steps"] > 0
    # the searches' launches: the trainer counts the scripted chunks'
    # lockstep steps too, which search nothing
    st = {k: trainer.play_stats[k] - s0[k]
          for k in ("steps", "paired_steps", "folds")}
    st["steps"] -= len(gen_counts) * cfg.actor_chunk_steps
    want = expected_launches(st, cfg)
    assert {k: kernels.counts()[k] for k in want} == want
    for kinds, c in gen_counts:
        assert c["script_step"] == cfg.actor_chunk_steps
        assert c["random_step"] == (cfg.actor_chunk_steps
                                    if kinds[1] == A.OPP_RANDOM else 0)
        assert c["conv3x3_i8"] == c["mcts_descend"] == c["rules_step"] == 0
    # the single steps run only in the recorded scripted generation
    assert kernels.counts()["random_step"] == sum(
        c["random_step"] for _, c in gen_counts)
    assert trainer.ckpt.exists("temp") and trainer.ckpt.exists("latest")
    assert all(np.isfinite(e["pi_loss"]) for e in trainer.epoch_log)


FULL_CARDS = Config(simple_cards=False)


@pytest.fixture(scope="module")
def card_mix():
    """1,024 full-cards states on the card (``torch_cases.card_states``):
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
    ref9 = _assert_script_step_matches_plain(mx.state, mx.carry, mx.reset,
                                             mx.u, mx.dice, FULL_CARDS)
    ref10 = _assert_random_step_matches_plain(mx.state, mx.u, mx.dice,
                                              FULL_CARDS)
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


@pytest.mark.parametrize("kinds", [(SCRIPT, SCRIPT), (SCRIPT, RANDOM)])
@pytest.mark.parametrize("batch", [64, 1024])
@pytest.mark.parametrize("cards", [False, True])
def test_agent_steps_mid_match_match_plain(cuda, cards, batch, kinds):
    """The multi-step entry's launch of 64 iterations on ``batch``
    mirrored games 100 steps (under full cards 300) into a match of the
    seat kinds, as ``play_match`` launches it mid-match, against the plain
    multi-step function: state, carry, prev and step counts bit for
    bit."""
    from alphazero_risk_tpu_torch.agents import driver as D
    cfg = FULL_CARDS if cards else Config()
    gen = torch.Generator(device=cuda).manual_seed(31)
    st = D.mirrored_initial_states(batch, generator=gen, device=cuda)
    carry = SA.init_carry(batch, cuda)
    prev = torch.full((batch,), -1, dtype=torch.int32, device=cuda)
    draws = BlockDraws(gen, batch, cuda)
    u, dice = draws.block(300 if cards else 100)
    st, carry, prev, _ = AB.agent_steps(st, carry, prev, u, dice, cfg, kinds)
    u, dice = draws.block(64)
    args = (st, carry, prev, u, dice, cfg, kinds)
    _hold_agent_steps([(args, {}, AB.agent_steps(*args))])


@pytest.mark.parametrize("batch", [64, 1024])
@pytest.mark.parametrize("cards", [False, True])
def test_agent_steps_at_k16_for_every_seat_pair_match_plain(
        cuda, request, cards, batch):
    """The multi-step entry at k=16 on the first ``batch`` mixed (or
    full-cards) states with their carries and previous movers, for every
    pair of seat kinds, against the plain multi-step function."""
    mx = first(request.getfixturevalue("card_mix" if cards else "mixed_mix"),
               batch)
    cfg = FULL_CARDS if cards else Config()
    u, dice = BlockDraws(torch.Generator(device=cuda).manual_seed(33), batch,
                         cuda).block(16)
    calls = []
    for kinds in KINDS:
        args = (mx.state, mx.carry, mx.prev, u, dice, cfg, kinds)
        calls.append((args, {}, AB.agent_steps(*args)))
    _hold_agent_steps(calls)


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


@pytest.mark.parametrize("sims", [8, 32])
@pytest.mark.parametrize("batch", [1, 3, 64])
def test_search_kernels_on_rerooted_trees_match_plain(cuda, batch, sims):
    """On the tree ``search_with_reuse`` starts from (carried subtrees
    where the played child was expanded, fresh roots elsewhere; N = 18
    and 66): K2, K7's expand, K6 and K3 against their plain versions;
    then the whole reusing search on the card equal to the CPU's."""
    cfg = Config(mcts_simulations=sims, max_depth=16, tree_reuse=True)
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
    kt, pt = clone_tree(start), clone_tree(start)
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
    its plain version (``torch_cases.plain_versions``) from the same seed,
    through the setup into the battle phases: every state and ``pi``
    equal, the launch counts those the step count implies."""
    import itertools

    from alphazero_risk_tpu_torch.models.resnet import build_network
    from alphazero_risk_tpu_torch.utils import watch as W

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


# ------------------------------------------------ shared by the path tests

def expected_launches(st, cfg):
    """Launches of the search kernels, the network kernels and K7 implied
    by a run's lockstep searches (``steps``, of which ``paired_steps`` ran
    two nets) and folds under ``cfg``: each search evaluates its root and
    one node per simulation, expands (K7) once per simulation, and its
    move is one more K7 launch; each int8 fold calibrates on K4 (the stem
    and every conv), its stem at the 512 calibration features in K4's stem
    design where ``stem_wide`` takes it (256 channels); the searches' stems
    run below the switch, on the tiled design.  K8 and the opponents'
    K9/K10 depend on the run."""
    sims, blocks = cfg.mcts_simulations, cfg.blocks
    evals = (st["steps"] + st["paired_steps"]) * (sims + 1)
    wide = FI.stem_wide(512, cfg.num_features, cfg.filters,
                        torch.device("cuda"))
    return {"conv3x3_bf16": evals + st["folds"] * (2 * blocks + (not wide)),
            "stem_bf16": st["folds"] * wide,
            "heads_eval": evals, "conv3x3_i8": evals * 2 * blocks,
            "write_nodes": st["steps"] * (sims + 1),
            "mcts_descend": st["steps"] * sims,
            "mcts_backup": st["steps"] * sims,
            "rules_step": st["steps"] * (sims + 1)}


def _watch_blocks(monkeypatch, keep=0, every=1):
    """From here on every call of the multi-step entry and of the block
    loop around it is counted: the loops' iterations and blocks, the
    entry's step counts summed on the card (the live micro-steps), and
    every ``every``-th call of the entry, up to ``keep``, with its inputs
    and outputs (for ``_hold_agent_steps``)."""
    w = {"iterations": 0, "blocks": 0, "steps": 0, "calls": [], "n": 0}
    steps_fn, run_fn = AB.agent_steps, AB.run_agent_blocks

    def steps(*a, **kw):
        out = steps_fn(*a, **kw)
        w["steps"] = out[3].sum() + w["steps"]
        if w["n"] % every == 0 and len(w["calls"]) < keep:
            w["calls"].append((a, kw, out))
        w["n"] += 1
        return out

    def run(*a, **kw):
        out = run_fn(*a, **kw)
        w["iterations"] += out[3]
        w["blocks"] += out[4]
        return out

    monkeypatch.setattr(AB, "agent_steps", steps)
    monkeypatch.setattr(AB, "run_agent_blocks", run)
    return w


def _hold_agent_steps(calls):
    """The multi-step entry's recorded calls against the plain multi-step
    function on the same inputs: state, carry, prev and step counts bit
    for bit."""
    assert calls
    for a, kw, out in calls:
        ref = AB._agent_steps_plain(*a, **kw)
        _assert_states_equal(out[0], ref[0])
        for f in dataclasses.fields(SA.ScriptCarry):
            assert torch.equal(getattr(out[1], f.name),
                               getattr(ref[1], f.name)), f.name
        assert torch.equal(out[2], ref[2]) and torch.equal(out[3], ref[3])


def _with_dirs(cfg, tmp_path):
    return cfg.replace(checkpoint_dir=str(tmp_path / "checkpoints"),
                       data_dir=str(tmp_path / "data"),
                       log_dir=str(tmp_path / "log"))


# ------------------------------------------- the scripted paths, 1,024 games

@pytest.mark.parametrize("cards", [False, True])
def test_scripted_chunk_matches_plain_versions(cuda, request, cards):
    """One chunk of 128 steps of ``run_scripted_episodes``, Script vs
    Random, at the 1,024 mixed (or full-cards) states from their carries
    and previous movers, on the kernels and under ``plain_versions`` from
    the same draws: states, carries, prev, status and records equal.  On
    the simple-cards chunk, K8 also on a learner batch of its records
    read back from a replay buffer (states without cards or
    mobilization)."""
    from alphazero_risk_tpu_torch.training.replay import ReplayBuffer
    mx = request.getfixturevalue("card_mix" if cards else "mixed_mix")
    cfg = FULL_CARDS if cards else Config(max_game_steps=2048)

    def chunk():
        draws = A.GeneratorDraws(torch.Generator(device=cuda).manual_seed(21),
                                 cfg, MIXED, cuda)
        return A.run_scripted_episodes(mx.state, draws, cfg, 128,
                                       (A.OPP_SCRIPT, A.OPP_RANDOM),
                                       carry_in=mx.carry, prev_in=mx.prev)

    kernels.reset_counts()
    got = chunk()
    counts = kernels.counts()
    assert counts["script_step"] == counts["random_step"] == 128
    with plain_versions():
        ref = chunk()
    _assert_states_equal(got.state, ref.state)
    for f in dataclasses.fields(SA.ScriptCarry):
        assert torch.equal(getattr(got.carry, f.name),
                           getattr(ref.carry, f.name)), f.name
    for f in A.SampleBatch._fields:
        assert torch.equal(getattr(got.samples, f), getattr(ref.samples, f)), f
    assert torch.equal(got.prev_player, ref.prev_player)
    assert torch.equal(got.status, ref.status)
    assert int(got.samples.valid.sum()) > 0
    if cards:
        return
    rb = ReplayBuffer(cfg)
    rb.extend_from_actor(got.samples, got.status, final_round=got.state.round)
    arrays = rb.sample_arrays()
    pick = np.random.default_rng(0).permutation(len(rb))[:512]
    _assert_views_match_plain(A.state_of_samples(A.SampleBatch(
        valid=None, **{k: torch.from_numpy(v[pick]).to(cuda)
                       for k, v in arrays.items()}), cfg), cfg)


@pytest.mark.parametrize("agents", [(0, 0), (0, 1)])
@pytest.mark.parametrize("cards", [False, True])
def test_play_match_to_the_end_matches_the_loop_by_iteration(
        cuda, monkeypatch, cards, agents):
    """``play_match`` Script vs Script and Script vs Random on 1,024
    mirrored games to the end in blocks of the multi-step entry (the CLI's
    ``-m play --p1 sp --p2 sp|rp``; the supervised bootstrap's data), under
    simple and full cards: every game ends, the entry launches once a
    block and no single step launches, a sample of the blocks equals the
    plain multi-step function, and the per-iteration loop on the plain
    versions from the same seed ends in the same tally, steps, final
    rounds and live micro-steps (under full cards with trades)."""
    from alphazero_risk_tpu_torch.agents import driver as D
    cfg = FULL_CARDS if cards else Config(max_game_steps=2048)
    seed = {(False, 0): 22, (False, 1): 24, (True, 0): 25,
            (True, 1): 26}[cards, agents[1]]

    def start():
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return gen, D.mirrored_initial_states(MIXED, generator=gen,
                                              device=cuda)

    gen, st = start()
    w = _watch_blocks(monkeypatch, keep=16)
    kernels.reset_counts()
    res = D.play_match(gen, st, *agents, cfg, cfg.max_game_steps)
    counts = kernels.counts()
    monkeypatch.undo()
    tally = D.summarize(res)
    assert tally["unfinished"] == 0
    assert counts["agent_steps"] == w["blocks"]
    assert w["iterations"] == res.steps
    assert counts["script_step"] == counts["random_step"] == 0
    _hold_agent_steps(w["calls"])
    gen, st = start()
    ref, steps, live = match_by_iteration(gen, st, agents, cfg,
                                          cfg.max_game_steps)
    assert (steps, live) == (res.steps, int(w["steps"]))
    assert D.summarize(D.MatchResult(
        status=rules._game_status_plain(ref, cfg), rounds=ref.round,
        steps=steps, started_by=st.cur_player)) == tally
    assert torch.equal(ref.round, res.rounds)
    if cards:
        assert int(ref.card_sets_played.sum()) > 0


def test_full_cards_legal_play_through_step_key_matches_plain(cuda):
    """400 steps of random legal moves through ``rules.step_key`` (its own
    dice and card uniforms) on 1,024 fresh full-cards deals: K8's legality
    and K7's step, one launch each a step, against the plain versions on
    the same draws, the final states equal."""
    cfg = FULL_CARDS

    def play(plain):
        gen = torch.Generator(device=cuda).manual_seed(28)
        st = new_game(MIXED, generator=gen, device=cuda)
        for _ in range(400):
            legal = (rules._legal_actions_plain if plain
                     else rules.legal_actions)(st, cfg)
            g = torch.rand(legal.shape, generator=gen, device=cuda)
            a = torch.argmax(torch.where(legal, g, -1.0), -1).to(torch.int32)
            if not plain:
                st = rules.step_key(st, a, gen, cfg)
                continue
            dice = rules.roll_dice(gen, MIXED)
            u_card = torch.rand((MIXED,), generator=gen, device=cuda)
            st = rules._step_plain(st, a, dice, cfg, u_card)
        return st

    kernels.reset_counts()
    got = play(False)
    counts = kernels.counts()
    assert counts["rules_step"] == counts["state_views"] == 400
    ref = play(True)
    _assert_states_equal(got, ref)
    assert int(ref.card_sets_played.sum()) > 0


# --------------------------------------- the flagship's paths at full width

FLAGSHIP = Path(__file__).resolve().parent.parent / "artifacts" / \
    "params-20block-r4-best.npz"
# the training path: depth cut, width kept
TRAIN = dict(mcts_simulations=8, train_iteration_games=64, epochs=2,
             batch_size=512, compare_games=16, arena_early_stop_min_games=8,
             benchmark_games_random=2, benchmark_games_script=4,
             max_game_steps=640, actor_chunk_steps=64,
             use_dirichlet_noise=True)
# the supervised bootstrap: TRAIN's cuts, the reference's train-data mix
# cut from 5,000 + 5,000 to 128 + 128 games, a step cap every scripted game
# ends within
DATA = dict(TRAIN, data_games_ss=128, data_games_sr=128,
            env_batch_per_device=128, actor_chunk_steps=128,
            max_game_steps=2048)
# the lockstep batches of the paths below 64 games: the play slice, the
# arena and the two benchmark matches
PATH_BATCHES = [32, 16, 4, 2]


@pytest.fixture(scope="module")
def flagship():
    """The flagship 20x256 network on the card, and its play config: the
    int8 fast path, 32 simulations."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from alphazero_risk_tpu_torch.training.checkpoints import load_params_npz
    cfg = Config(mcts_simulations=32, fast_infer=True, fast_infer_int8=True)
    return cfg, load_params_npz(str(FLAGSHIP), cfg, device="cuda")


def test_flagship_fast_paths_agree_with_the_plain_network(flagship,
                                                          tmp_path):
    """The flagship's bf16 and int8 folds against the plain network on 256
    played states, within the fast path's agreement bounds
    (``tests/test_fast_infer.py``): top-1 moves, values and logits."""
    cfg, net = flagship
    cuda = torch.device("cuda")
    t = Trainer(_with_dirs(cfg, tmp_path), seed=0, device=cuda)
    t.net = net
    states = random_play_states(1024, 100, torch.Generator(
        device=cuda).manual_seed(1), cfg, cuda)
    x = featurize(states, cfg)[:256]
    with torch.no_grad():
        ref_l, ref_v = t.net(x)
        l16, v16 = FI.apply_folded(FI.fold_params(t.net, cfg), x)
        l8, v8 = FI.apply_folded(t.folded(), x, int8=True)
    for y in (ref_l, ref_v, l16, v16, l8, v8):
        assert bool(torch.isfinite(y).all())
    top = ref_l.argmax(-1)
    assert float((l16.argmax(-1) == top).float().mean()) >= 0.9
    assert float((l8.argmax(-1) == top).float().mean()) >= 0.85
    assert float((v8 - ref_v).abs().mean()) < 0.1
    assert float(np.corrcoef(l8.cpu().numpy().ravel(),
                             ref_l.cpu().numpy().ravel())[0, 1]) > 0.99


def test_calibrate_trunk_on_k4_matches_plain(flagship, tmp_path,
                                             monkeypatch):
    """``calibrate_trunk`` of the flagship's fold on K4 at the 512
    calibration features: every conv within 1e-5 of its largest output of
    the plain conv on that conv's own inputs, and the activation scales
    against those of ``calibrate_trunk`` on the plain version from the
    same features.  Each conv's f32 sums differ from the plain ones in the
    last bits, so a bf16 input of a later conv can round to the other
    neighbour (2^-8 relative), which grows with depth (1.7e-3 on the
    flagship): 1e-2 overall; block 0 reads the stem's output alone: 1e-4
    there.  A wrong tile moves a largest activation by far more."""
    cfg, net = flagship
    cuda = torch.device("cuda")
    t = Trainer(_with_dirs(cfg, tmp_path), seed=0, device=cuda)
    t.net = net
    folded = t.folded()
    calib = FI.default_calib_feats(
        cfg, torch.Generator(device=cuda).manual_seed(17), device=cuda)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    kernel, held = FI.conv3x3_bf16, []

    def on_k4(x, w, bias, residual=None, want_f32=True, want_bf16=False,
              inv_s_next=None, out=None, out_q=None):
        got, got_bf, _ = kernel(x, w, bias, residual, want_bf16=want_bf16)
        ref = FI._conv3x3_bf16_plain(x, w, bias, residual)
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
        held.append(x.shape[-1])
        return (got if want_f32 else None), got_bf, None

    def plain(x, w, bias, residual=None, want_f32=True, want_bf16=False,
              inv_s_next=None, out=None, out_q=None):
        v = FI._conv3x3_bf16_plain(x, w, bias, residual)
        return (v if want_f32 else None,
                v.to(torch.bfloat16) if want_bf16 else None, None)

    monkeypatch.setattr(FI, "conv3x3_bf16", on_k4)
    got = FI.calibrate_trunk(folded, calib)["act_s"]
    monkeypatch.setattr(FI, "conv3x3_bf16", plain)
    ref = FI.calibrate_trunk(folded, calib)["act_s"]
    assert len(held) == 1 + 2 * cfg.blocks
    assert bool(torch.isfinite(got).all())
    per_block = ((got - ref).abs() / ref).amax(dim=1)
    assert float(per_block[0]) <= 1e-4
    assert float(per_block.max()) <= 1e-2


@pytest.fixture(scope="module")
def flagship_path(flagship, tmp_path_factory):
    """The flagship's main path on the card: its int8 fold and evaluation,
    1,024 states of random play and their features and legal moves, the
    trees one search of the first 64 leaves at the play config's 32
    simulations (N = 34) and at TRAIN's 8 (N = 10), the features and
    legal moves of the 32-simulation search's last leaves, and the 512
    calibration features."""
    import types
    cfg, net = flagship
    cuda = torch.device("cuda")
    t = Trainer(_with_dirs(cfg, tmp_path_factory.mktemp("flagship")),
                seed=0, device=cuda)
    t.net = net
    folded, efn = t.folded(), t._eval_fn()
    states = random_play_states(1024, 100, torch.Generator(
        device=cuda).manual_seed(1), cfg, cuda)
    root = tree_map(lambda x: x[:64].contiguous(), states)
    trees = {}
    with torch.no_grad():
        for sims in (TRAIN["mcts_simulations"], cfg.mcts_simulations):
            c = cfg.replace(mcts_simulations=sims)
            gum = S.draw_gumbel(torch.Generator(device=cuda).manual_seed(8),
                                c, 64, cuda)
            trees[c.num_nodes] = S.search(root, gum, c, efn).tree
    tree = trees[cfg.num_nodes]
    leaves = tree_map(lambda x: x[torch.arange(64, device=cuda),
                                  (tree.next_free - 1).long()], tree.states)
    return types.SimpleNamespace(
        cfg=cfg, folded=folded, eval_fn=efn, states=states, root=root,
        trees=trees, leaf=(featurize(leaves, cfg),
                           rules.legal_actions(leaves, cfg)),
        played=(featurize(states, cfg), rules.legal_actions(states, cfg)),
        calib=FI.default_calib_feats(cfg, torch.Generator(
            device=cuda).manual_seed(17), device=cuda))


def _assert_k1_matches_plain(folded, feats):
    """K1 in block 0 of ``folded``'s int8 trunk on the stem's codes of
    ``feats``: conv_a (int8 out) and conv_b on conv_a's plain codes (the
    residual; f32 and int8 out), against the plain conv and epilogue:
    int32 accumulators exact, h within 1e-6, the int8 codes within one (a
    rint tie)."""
    h = FI._stem(folded, feats)[0].contiguous()
    act_s, wq, ws, b = (folded["act_s"], folded["trunk_wqk"],
                        folded["trunk_ws"], folded["trunk_b"])
    inv = 1.0 / act_s
    q = FI._quantize(h, inv[0, 0])
    _, qa, acc_a = FI.conv3x3_i8(q, wq[0, 0], ws[0, 0], b[0, 0], act_s[0, 0],
                                 inv_s_next=inv[0, 1], want_h=False,
                                 want_acc=True)
    ref_acc_a = FI._conv_i8_plain(q, wq[0, 0])
    _, ref_qa = FI._epilogue_plain(ref_acc_a, ws[0, 0], b[0, 0], act_s[0, 0],
                                   None, inv[0, 1])
    hb, qb, acc_b = FI.conv3x3_i8(ref_qa, wq[0, 1], ws[0, 1], b[0, 1],
                                  act_s[0, 1], residual=h,
                                  inv_s_next=inv[1, 0], want_acc=True)
    ref_acc_b = FI._conv_i8_plain(ref_qa, wq[0, 1])
    ref_hb, ref_qb = FI._epilogue_plain(ref_acc_b, ws[0, 1], b[0, 1],
                                        act_s[0, 1], h, inv[1, 0])
    assert torch.equal(acc_a, ref_acc_a) and torch.equal(acc_b, ref_acc_b)
    torch.testing.assert_close(hb, ref_hb, rtol=1e-6, atol=1e-6)
    for got, ref in ((qa, ref_qa), (qb, ref_qb)):
        assert int((got.int() - ref.int()).abs().max()) <= 1


def _assert_k4_matches_plain(folded, feats):
    """K4 on ``feats`` in the three forms the paths launch: the stem (f32
    in and out, and its int8 trunk input code for code ``_quantize`` of
    its f32 output), block 0's conv_a (bf16 in and out) and conv_b (the
    residual; f32 and bf16 out); f32 within 1e-5 of the largest output of
    the plain conv in full float32, bf16 the f32 rounded."""
    w, b = folded["trunk_w"], folded["trunk_b"]
    h = FI._conv3x3_bf16_plain(feats, folded["stem_w"], folded["stem_b"])
    y = FI._conv3x3_bf16_plain(h, w[0, 0], b[0, 0])
    stem = (feats, folded["stem_w"], folded["stem_b"], None)
    for args in (stem, (h.to(torch.bfloat16), w[0, 0], b[0, 0], None),
                 (y.to(torch.bfloat16), w[0, 1], b[0, 1], h)):
        full, got_bf, _ = FI.conv3x3_bf16(*args, want_bf16=True)
        ref = FI._conv3x3_bf16_plain(*args)
        assert float((full - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
        assert torch.equal(got_bf, full.to(torch.bfloat16))
    inv = 1.0 / folded["act_s"][0, 0]
    full = FI.conv3x3_bf16(*stem)[0]
    _, _, q = FI.conv3x3_bf16(*stem, want_f32=False, inv_s_next=inv)
    assert torch.equal(q, FI._quantize(full, inv))


@pytest.mark.parametrize("batch", [2, 4, 16, 32, 64, 128, 512, 1024, 4096])
def test_flagship_network_kernels_match_plain(flagship_path, monkeypatch,
                                              batch):
    """K1, K4 and K5 on the flagship's int8 fold against their plain
    versions, on what the paths feed them: the last leaves of the
    32-simulation search (64 games, and the first 32, 16, 4, 2), the
    played states (the first 128, 512, 1,024, and four times them:
    self-play's 4,096) and at 512 also the calibration features.  K5 on
    the int8 trunk's output with the legal moves."""
    fp = flagship_path
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    if batch <= 64:
        sets = [tuple(x[:batch].contiguous() for x in fp.leaf)]
    else:
        reps = -(-batch // 1024)
        sets = [tuple(x.repeat(reps, *(1,) * (x.dim() - 1))[:batch]
                      .contiguous() for x in fp.played)]
    if batch == 512:
        sets.append((fp.calib, None))
    with torch.no_grad():
        for feats, legal in sets:
            _assert_k1_matches_plain(fp.folded, feats)
            _assert_k4_matches_plain(fp.folded, feats)
            if legal is None:
                continue
            h = FI._trunk_out(fp.folded, feats, True).clone()
            _assert_heads_match(FI.heads_eval(fp.folded, h, legal),
                                FI._heads_eval_plain(fp.folded, h, legal),
                                legal)


def _hold_search_kernels(tree, gum, root, cfg, eval_fn):
    """K2, K3, K6 and K7's expand against their plain versions on
    ``tree`` with one simulation's noise ``gum``: the descent, the backup
    of its paths, the expansion's child, status and legality, the node
    write of that simulation (and with its children's status drawn from
    running, draw and either winner), and the root write of a fresh tree
    over ``root``.  Leaves ``tree`` as it was."""
    path = _assert_descent_matches_plain(tree, gum, cfg)
    _assert_backup_matches_plain(tree, path)
    args = (tree.states, path.exp_n, path.exp_a, path.exp_o, cfg)
    got, ref = rules.expand(*args), rules._expand_plain(*args)
    _assert_states_equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    ins = S.expansion_inputs(tree, path, cfg, eval_fn)
    b, dev = tree.player.shape[0], tree.player.device
    status = torch.tensor([-1, -2, 0, 1], dtype=torch.int32, device=dev)[
        torch.randint(0, 4, (b,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(b))]
    for write in (ins, (ins[0], status, *ins[2:])):
        kt, pt = clone_tree(tree), clone_tree(tree)
        lv, lp = S.write_nodes(kt, *write, path)
        rv, rp = S._write_nodes_plain(pt, *write, path)
        assert torch.equal(lv, rv) and torch.equal(lp, rp)
        _assert_trees_equal(kt, pt)
    rins = S.root_inputs(root, cfg, eval_fn)
    kt, pt = S._empty_tree(root, cfg), S._empty_tree(root, cfg)
    S.write_nodes(kt, *rins)
    S._write_nodes_plain(pt, *rins, None)
    _assert_trees_equal(kt, pt)


def _first_games(st, n):
    return tree_map(lambda x: x[:n].contiguous(), st)


@pytest.mark.parametrize("n_nodes", [10, 34])
def test_flagship_search_kernels_match_plain(flagship_path, n_nodes):
    """K2, K3, K6 and K7's expand against their plain versions on the
    trees one search with the flagship's int8 evaluation leaves over 64
    played games (N = 34: the play path's 32 simulations; N = 10: the
    training path's 8), at 64 games, at the batches the paths launch, at
    one game and at 33; on the 32-simulation tree also K2 and K3 on the
    tree rewritten into ties."""
    fp = flagship_path
    tree = fp.trees[n_nodes]
    cfg = fp.cfg.replace(mcts_simulations=n_nodes - 2)
    gum = S.draw_gumbel(torch.Generator(device="cuda").manual_seed(6), cfg,
                        64, "cuda")[0]
    with torch.no_grad():
        for b in [64] + PATH_BATCHES + [1, 33]:
            _hold_search_kernels(_games(tree, b), gum[:, :b].contiguous(),
                                 _first_games(fp.root, b), cfg, fp.eval_fn)
        if n_nodes != fp.cfg.num_nodes:
            return
        for case in TIE_CASES:
            tied = tie_tree(tree, case)
            _assert_backup_matches_plain(
                tied, _assert_descent_matches_plain(tied, gum, cfg))


@pytest.mark.parametrize("sims", [8, 32])
def test_flagship_search_kernels_on_rerooted_trees_match_plain(
        flagship_path, sims):
    """One search under tree reuse at ``sims`` simulations (N = 2 S + 2)
    with the flagship's int8 evaluation on 64 played games, the argmax
    moves played and each tree rerooted through its played edge: K2, K3,
    K6 and K7's expand against their plain versions on the tree
    ``search_with_reuse`` starts from (at 64 games and the batches the
    paths launch) and on the tree it leaves."""
    fp = flagship_path
    cuda = torch.device("cuda")
    cfg = fp.cfg.replace(mcts_simulations=sims, tree_reuse=True)
    gen = torch.Generator(device=cuda).manual_seed(sims)
    with torch.no_grad():
        res = S.search(fp.root, S.draw_gumbel(gen, cfg, 64, cuda), cfg,
                       fp.eval_fn)
        action = S.pick_move(res, fp.root, cfg, False)
        dice = rules.roll_dice(gen, 64)
        nxt = rules.step(fp.root, action, dice, cfg)
        tree, reused = S.reroot(res.tree, action,
                                A.realised_outcome(fp.root, action, dice),
                                cfg)
        same = reused & S.carried_roots_match(tree, nxt)
        assert bool(same.any())
        start = S._select_tree(same, tree, S.init_tree(nxt, cfg, fp.eval_fn))
        after = S.search_with_reuse(nxt, S.draw_gumbel(gen, cfg, 64, cuda),
                                    cfg, fp.eval_fn, tree, reused).tree
        gum = S.draw_gumbel(torch.Generator(device=cuda).manual_seed(
            sims + 1), cfg, 64, cuda)[0]
        for b in [64] + PATH_BATCHES:
            _hold_search_kernels(_games(start, b), gum[:, :b].contiguous(),
                                 _first_games(nxt, b), cfg, fp.eval_fn)
        _hold_search_kernels(after, gum, nxt, cfg, fp.eval_fn)


@pytest.mark.parametrize("mode", ["int8", "tree_reuse", "bf16"])
def test_flagship_plays_the_script_player(flagship, tmp_path, monkeypatch,
                                          mode):
    """``Trainer.play`` of 32 mirrored games against the ScriptPlayer with
    the flagship at 32 simulations: on the int8 fast path and under tree
    reuse to the end, every game finished and every kernel but the
    agents' single steps launched (the ScriptPlayer only fast-forwards: the
    multi-step entry once a block, a sample of its launches equal to the
    plain multi-step function); under reuse some searches continue a
    carried tree.  On the bf16 fast path three chunks of 8 steps."""
    from alphazero_risk_tpu_torch.mcts import search as S
    cfg, net = flagship
    over = {"int8": {}, "tree_reuse": {"tree_reuse": True},
            "bf16": {"fast_infer_int8": False, "actor_chunk_steps": 8,
                     "max_game_steps": 24}}[mode]
    t = Trainer(_with_dirs(cfg.replace(**over), tmp_path), seed=0,
                device="cuda")
    t.net = net
    t.folded()
    carried, select = [], S._select_tree

    def counted(pred, a, b):
        carried.append(pred.sum())
        return select(pred, a, b)

    monkeypatch.setattr(S, "_select_tree", counted)
    w = _watch_blocks(monkeypatch, keep=24, every=12)
    kernels.reset_counts()
    res = t.play(A.OPP_SCRIPT, 32)
    counts = kernels.counts()
    monkeypatch.undo()
    assert res["games"] == 32
    if mode == "bf16":
        return
    assert res["unfinished"] == 0
    # 32 games: every stem on K4's tiled design (the fold, which ran the
    # calibration's stem, came before the count)
    assert counts["stem_bf16"] == 0
    for k in kernels.ALL:
        if k not in (kernels.RANDOM_STEP, kernels.SCRIPT_STEP,
                     kernels.STEM_BF16):
            assert counts[k.name] > 0, k.name
    assert counts["agent_steps"] == w["blocks"]
    _hold_agent_steps(w["calls"])
    assert (int(sum(carried)) > 0) == (mode == "tree_reuse")


@pytest.mark.parametrize("games", [64, 1024])
def test_flagship_play_chunk_sends_its_stems_to_the_design_of_its_batch(
        flagship, tmp_path, games):
    """One chunk of 8 micro-steps of ``Trainer.play`` against the
    ScriptPlayer with the flagship (int8, 32 simulations), the fold made
    before the count: at 1,024 games every stem launch takes K4's stem
    design and none its tiled one, at 64 the reverse; one stem an
    evaluation (the root and each simulation of a lockstep step)."""
    cfg, net = flagship
    t = Trainer(_with_dirs(cfg.replace(actor_chunk_steps=8,
                                       max_game_steps=8), tmp_path),
                seed=0, device="cuda")
    t.net = net
    t.folded()
    s0 = dict(t.play_stats)
    kernels.reset_counts()
    res = t.play(A.OPP_SCRIPT, games)
    counts = kernels.counts()
    steps = t.play_stats["steps"] - s0["steps"]
    assert res["games"] == games and steps == 8
    evals = steps * (cfg.mcts_simulations + 1)
    assert counts["heads_eval"] == evals
    assert counts["conv3x3_i8"] == evals * 2 * cfg.blocks
    assert FI.stem_wide(games, cfg.num_features, cfg.filters,
                        torch.device("cuda")) == (games == 1024)
    assert (counts["stem_bf16"], counts["conv3x3_bf16"]) == (
        (evals, 0) if games == 1024 else (0, evals))


@pytest.mark.parametrize("ring", [False, True])
def test_flagship_train_iteration(flagship, tmp_path, monkeypatch, ring):
    """One ``Trainer.train`` iteration from the flagship's weights at full
    width (``TRAIN``'s cuts): self-play of 64 games with records, the
    learner's epochs at batch 512, the gate and the benchmark; on the host
    buffer, or on the device ring under tree reuse (the ring after
    self-play equal to a host buffer fed the same records, then
    ``cross_validate`` over the replay file).  The replay holds every
    valid record and nothing else; the losses are finite and the policy
    loss falls; every conv and running statistic moved; the launches are
    those the searches and folds imply, and no single step launched;
    ``latest`` reloaded into a fresh trainer folds to the same int8
    evaluation with its step count, and the replay file reads back
    equal."""
    import json
    from alphazero_risk_tpu_torch.training.analysis import cross_validate
    from alphazero_risk_tpu_torch.training.device_replay import DeviceReplay
    from alphazero_risk_tpu_torch.training.replay import FIELDS, ReplayBuffer
    fcfg, net = flagship
    cuda = torch.device("cuda")
    cfg = _with_dirs(fcfg.replace(**TRAIN, device_replay=ring,
                                  tree_reuse=ring), tmp_path)
    t = Trainer(cfg, seed=3, device=cuda)
    t.load_weights(net)
    t.folded()
    assert isinstance(t.replay, DeviceReplay) == ring
    stats0 = {k: v.clone() for k, v in t.train_state.net.state_dict().items()}
    mirror = ReplayBuffer(cfg)
    seen = {"valid": 0, "added": 0}
    trained, verdicts = {}, []
    extend, selfplay = t.replay.extend_from_actor, t.generate_selfplay
    epochs, gate = t.train_epochs, t.gate

    def counted(samples, status, final_round=None):
        n = extend(samples, status, final_round=final_round)
        assert mirror.extend_from_actor(samples, status,
                                        final_round=final_round) == n
        seen["valid"] += int(samples.valid.sum())
        seen["added"] += n
        return n

    def watched_selfplay(*a, **kw):
        n = selfplay(*a, **kw)
        got = t.replay.sample_arrays()
        assert len(t.replay) == len(mirror) == n > 0
        for k in FIELDS:
            assert np.array_equal(got[k], mirror.data[k]), k
            assert got[k].dtype == mirror.data[k].dtype, k
        seen["selfplay"] = n
        return n

    def watched_epochs(*a, **kw):
        out = epochs(*a, **kw)
        trained.update({k: v.clone() for k, v in
                        t.train_state.net.state_dict().items()})
        return out

    def watched_gate(*a, **kw):
        verdicts.append(bool(gate(*a, **kw)))
        return verdicts[-1]

    monkeypatch.setattr(t.replay, "extend_from_actor", counted)
    monkeypatch.setattr(t, "generate_selfplay", watched_selfplay)
    monkeypatch.setattr(t, "train_epochs", watched_epochs)
    monkeypatch.setattr(t, "gate", watched_gate)
    s0 = dict(t.play_stats)
    kernels.reset_counts()
    t.train(iterations=1, resume=False)
    accepted = verdicts == [True]
    if not accepted:
        # a rejected gate skips the benchmark: run it on the reverted
        # weights
        t.benchmark()
    counts = kernels.counts()

    with open(Path(cfg.log_dir) / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    sp = next(e for e in events if e["kind"] == "selfplay")
    assert sp["games"] == cfg.train_iteration_games
    assert 2 * sp["finished"] >= sp["games"]
    arrays = t.replay.sample_arrays()
    n = len(t.replay)
    assert n == seen["added"] == seen["valid"] >= sp["samples"] > 0
    assert bool((arrays["value"] > 0).any() and (arrays["value"] < 0).any())

    ep = t.epoch_log
    assert len(ep) == cfg.epochs
    assert all(np.isfinite(e["pi_loss"]) and np.isfinite(e["v_loss"])
               for e in ep)
    assert ep[-1]["pi_loss"] < ep[0]["first_pi_loss"]
    assert t.train_state.step == cfg.epochs * (seen["selfplay"]
                                               // cfg.batch_size)
    assert all(bool(torch.isfinite(v).all()) for v in trained.values())
    moved = [k for k, v in trained.items() if "running" in k
             and not torch.equal(v, stats0[k])]
    assert len(moved) == 2 * (3 + 2 * cfg.blocks)
    assert not any(torch.equal(v, stats0[k]) for k, v in trained.items()
                   if k.endswith("conv.weight") or "conv_" in k)

    st = {k: t.play_stats[k] - s0[k]
          for k in ("steps", "paired_steps", "folds")}
    want = expected_launches(st, cfg)
    assert {k: counts[k] for k in want} == want
    assert counts["script_step"] == counts["random_step"] == 0
    assert all(counts[k.name] > 0 for k in kernels.ALL
               if k not in (kernels.SCRIPT_STEP, kernels.RANDOM_STEP))

    meta = t.ckpt.load_meta()
    assert t.ckpt.exists("latest") and meta and meta["iteration"] == 1
    assert t.ckpt.exists("best") == accepted
    fresh = Trainer(cfg.replace(device_replay=False), seed=4, device=cuda)
    fresh.train_state = fresh.ckpt.restore("latest", fresh.train_state)
    assert fresh.train_state.step == t.train_state.step
    x = featurize(new_game(64, generator=torch.Generator(device=cuda)
                           .manual_seed(9), device=cuda), cfg)
    la, va = FI.apply_folded(t._fold(t.train_state.net), x, int8=True)
    lb, vb = FI.apply_folded(fresh._fold(fresh.train_state.net), x,
                             int8=True)
    assert torch.equal(la, lb) and torch.equal(va, vb)
    assert bool(torch.isfinite(la).all())
    back = ReplayBuffer(cfg)
    assert back.load(t._replay_path()) and len(back) == n
    for k in FIELDS:
        assert np.array_equal(back.data[k], arrays[k]), k
        assert back.data[k].dtype == arrays[k].dtype, k
    if not ring:
        return
    report = cross_validate(cfg, t._replay_path(), folds=2, max_epochs=2,
                            seed=0, device=cuda)
    folds = report.get("folds", [])
    assert len(folds) == 2
    assert all(1 <= f["epochs"] <= 2 and np.isfinite(f["best_val"])
               for f in folds)


def test_flagship_train_on_data_iteration(flagship, tmp_path):
    """One loop of ``Trainer.train_on_data`` from the flagship's weights at
    full width (``DATA``'s cuts): every scripted game ends; the fresh
    replay holds exactly the generation's valid records and the learner
    takes three epochs of its batches; the gate reverts nothing; ``temp``,
    ``latest`` and the meta are written; the losses are finite.  The
    generation launches K9 once per lockstep step and K10 once per
    Script-vs-Random step, K10's single step launches nowhere else, and
    the searches launch what their steps and folds imply."""
    fcfg, net = flagship
    cfg = _with_dirs(fcfg.replace(**DATA), tmp_path)
    t = Trainer(cfg, seed=5, device=torch.device("cuda"))
    t.load_weights(net)
    t.folded()
    waves, seen, reverts = [], {}, []
    gen_launches = {"script_step": 0, "random_step": 0}
    real_call, real_epochs = t._scripted_call, t.train_epochs

    def scripted_call(kinds):
        call = real_call(kinds)

        def run(state, carry, prev):
            c0 = kernels.counts()
            out = call(state, carry, prev)
            for k in gen_launches:
                gen_launches[k] += kernels.counts()[k] - c0[k]
            if carry is None:
                waves.append({"kinds": tuple(kinds), "steps": 0,
                              "records": 0})
            waves[-1]["steps"] += cfg.actor_chunk_steps
            waves[-1]["records"] += int(out.samples.valid.sum())
            waves[-1]["status"] = out.status
            return out
        return run

    def epochs(*a, **kw):
        seen["n"], seen["step0"] = len(t.replay), t.train_state.step
        return real_epochs(*a, **kw)

    t._scripted_call = scripted_call
    t.train_epochs = epochs
    t._revert = lambda: reverts.append(1)
    s0 = dict(t.play_stats)
    kernels.reset_counts()
    t.train_on_data(loops=1)
    counts = kernels.counts()

    games = sum(int(w["status"].numel()) for w in waves)
    assert games == cfg.data_games_ss + cfg.data_games_sr
    assert all(bool((w["status"] != -1).all()) for w in waves)
    records = sum(w["records"] for w in waves)
    assert seen["n"] == records > 0
    assert t.train_state.step - seen["step0"] == 3 * (records
                                                      // cfg.batch_size)
    steps = sum(w["steps"] for w in waves)
    sr_steps = sum(w["steps"] for w in waves
                   if w["kinds"][1] == A.OPP_RANDOM)
    assert gen_launches == {"script_step": steps, "random_step": sr_steps}
    assert counts["random_step"] == sr_steps
    # the trainer counts the scripted chunks' lockstep steps too, which
    # search nothing
    st = {k: t.play_stats[k] - s0[k]
          for k in ("steps", "paired_steps", "folds")}
    st["steps"] -= steps
    want = expected_launches(st, cfg)
    assert {k: counts[k] for k in want} == want
    assert not reverts
    assert t.ckpt.exists("temp") and t.ckpt.exists("latest")
    assert t.ckpt.load_meta()["iteration"] == 1
    assert all(np.isfinite(e["pi_loss"]) and np.isfinite(e["v_loss"])
               for e in t.epoch_log)


def test_flagship_watch_az_against_the_script_player_matches_plain(
        flagship, tmp_path, capsys, monkeypatch):
    """The viewer (``watch_game_az``), AlphaZero with the plain 20x256
    flagship restored from ``latest`` against the ScriptPlayer, at B=1 on
    the card, 8 simulations, 90 micro-steps (through the setup into the
    attack phase), once on the kernels and once under ``plain_versions``
    from the same seed: the printed boards and ``pi`` lines equal line for
    line, the launches those micro-steps imply (none under the plain
    versions).  Every 30th search of the kernel run, with its root and the
    ScriptPlayer's inputs of that step, then holds K2, K3, K6, K7 (step
    and expand), K8, K9 and K10 against their plain versions at B=1."""
    from alphazero_risk_tpu_torch.training.checkpoints import (
        CheckpointManager)
    from alphazero_risk_tpu_torch.training.learner import train_state_of
    from alphazero_risk_tpu_torch.utils.watch import watch_game_az
    cfg = flagship[0].replace(mcts_simulations=8)
    CheckpointManager(cfg, str(tmp_path)).save(
        "latest", train_state_of(copy.deepcopy(flagship[1]), cfg))
    search, script = S.search, SA.script_step_recorded
    captured, n = [], [0, 0]

    def captured_search(root, gumbel, c, eval_fn, noise_u=None):
        res = search(root, gumbel, c, eval_fn, noise_u=noise_u)
        if n[0] % 30 == 0:
            captured.append({"root": root, "gum": gumbel,
                             "eval_fn": eval_fn, "tree": res.tree})
        n[0] += 1
        return res

    def captured_script(st, carry, reset, u, dice, c):
        if n[1] % 30 == 0:
            captured[-1]["k9"] = (st, carry, reset, u, dice)
        n[1] += 1
        return script(st, carry, reset, u, dice, c)

    def watch():
        capsys.readouterr()
        kernels.reset_counts()
        watch_game_az("az", "sp", seed=0, cfg=cfg, ckpt_dir=str(tmp_path),
                      roles=("latest", "best"), micro=True, pause=False,
                      max_steps=90, device="cuda")
        return capsys.readouterr().out, kernels.counts()

    monkeypatch.setattr(S, "search", captured_search)
    monkeypatch.setattr(SA, "script_step_recorded", captured_script)
    text, counts = watch()
    monkeypatch.undo()
    with plain_versions():
        plain, plain_counts = watch()
    steps = text.count("[micro-step")
    assert steps == 90 and "  ATTACK  " in text
    assert text.splitlines() == plain.splitlines()
    assert counts == watch_launches(steps, cfg.mcts_simulations, "sp")
    assert not any(plain_counts.values())
    assert len(captured) == 3
    with torch.no_grad():
        for i, c in enumerate(captured):
            root, tree, gum = c["root"], c["tree"], c["gum"]
            assert tree.player.shape[0] == 1
            _hold_search_kernels(tree, gum[0], root, cfg, c["eval_fn"])
            _assert_views_match_plain(root, cfg)
            legal = rules._legal_actions_plain(root, cfg)
            pick = torch.rand(legal.shape, device=legal.device,
                              generator=torch.Generator(
                                  device=legal.device).manual_seed(i))
            action = torch.argmax(torch.where(legal, pick, -1.0), -1).to(
                torch.int32)
            st, carry, reset, u, dice = c["k9"]
            outcome = dice[:, 0] % 3
            _assert_states_equal(rules.step(root, action, dice, cfg),
                                 rules._step_plain(root, action, dice, cfg))
            _assert_states_equal(
                rules.step_with_outcome(root, action, outcome, cfg),
                rules._step_with_outcome_plain(root, action, outcome, cfg))
            _assert_script_step_matches_plain(st, carry, reset, u, dice, cfg)
            _assert_random_step_matches_plain(st, u, dice, cfg)


def test_watch_game_az_against_az_launches_what_its_steps_imply(
        flagship, tmp_path, capsys):
    """The viewer with two AlphaZero seats (``watch_game_az``, ``latest``
    against ``best`` through the paired eval, the plain 20x256 network at
    B=1, 8 simulations) for 10 micro-steps on the card: each printed with
    its ``pi`` line, and the launches those steps imply."""
    from alphazero_risk_tpu_torch.training.checkpoints import (
        CheckpointManager)
    from alphazero_risk_tpu_torch.training.learner import train_state_of
    from alphazero_risk_tpu_torch.utils.watch import watch_game_az
    cfg, net = flagship
    cfg = cfg.replace(mcts_simulations=8)
    mgr = CheckpointManager(cfg, str(tmp_path))
    for role in ("latest", "best"):
        mgr.save(role, train_state_of(copy.deepcopy(net), cfg))
    capsys.readouterr()
    kernels.reset_counts()
    watch_game_az("az", "az", seed=0, cfg=cfg, ckpt_dir=str(tmp_path),
                  roles=("latest", "best"), micro=True, pause=False,
                  max_steps=10, device="cuda")
    counts = kernels.counts()
    text = capsys.readouterr().out
    steps = text.count("[micro-step")
    assert steps == 10 and "pi: " in text
    assert counts == watch_launches(steps, cfg.mcts_simulations, "az")


def test_world_of_two_ranks_on_one_card_plays_and_trains_the_flagship(
        flagship, tmp_path):
    """A 2-rank gloo world, both ranks on ``cuda:0``, from the flagship's
    weights: (a) ``play(OPP_SCRIPT)`` of 32 games at 32 simulations, each
    rank's games its rows of one process's games from the same seed, bit
    for bit, and the one-process tally on both ranks; (b) one
    ``train`` iteration at ``TRAIN``'s cuts (then the benchmark, which a
    rejected gate skips): the same losses every epoch and the same gate
    verdict on both ranks, each rank's replay file written, the
    checkpoints written by rank 0 alone."""
    import torch_world as W
    cfg = _with_dirs(flagship[0], tmp_path)
    tcfg = cfg.replace(**TRAIN)
    one = W.flagship_runs(0, _with_dirs(cfg, tmp_path / "one"), None,
                          str(FLAGSHIP), 0, 32, device="cuda")
    world = W.run_world(W.flagship_runs, 2, tmp_path, cfg, tcfg,
                        str(FLAGSHIP), 0, 32, timeout=900, device="cuda")
    assert W.world_equals_one(one, world, "play")
    assert [r["play"]["result"] for r in world] == [one["play"]["result"]] * 2
    assert one["play"]["result"]["unfinished"] == 0
    for r in world:
        for part in ("play", "train"):
            assert all(r[part]["launches"][k.name] > 0 for k in kernels.ALL
                       if k not in (kernels.SCRIPT_STEP, kernels.RANDOM_STEP))
    trains = [r["train"] for r in world]
    assert all(x["epochs"] == trains[0]["epochs"]
               and x["verdicts"] == trains[0]["verdicts"] for x in trains)
    assert len(trains[0]["epochs"]) == TRAIN["epochs"]
    assert all(np.isfinite(e["pi_loss"]) for e in trains[0]["epochs"])
    for rank, x in enumerate(trains):
        assert x["replay"] == (f"training_samples.p{rank}.npz", True)
        assert x["samples"] > 0
    assert trains[0]["writes"] and not trains[1]["writes"]
