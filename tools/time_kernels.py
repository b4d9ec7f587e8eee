"""Time the kernels and paths of one checkout of the PyTorch/CUDA port on
the card.

    python tools/time_kernels.py --root DIR --tag NAME [--parts k5,k7,...]
        [--out FILE]

The package is imported from DIR, the root of a checkout; the timing code
and the cases it times on (``tests/torch_cases.py`` beside this file) come
from this tool's own tree.  So two commits are timed by the same code on
the same inputs, in turns on one card: parent, change, change, parent.
``--parts`` picks from ``PARTS`` (default all).  Prints one JSON line, and
appends it to FILE when given.  Needs one card.

This tool times and holds nothing against anything: the card tests
(``tests/test_torch_cuda.py``) hold each kernel and path against its plain
version.  A kernel's entry has the call back to back (CUDA events, ``ms``),
the kernel alone (profiler, ``device_ms``), the plain version's call
(``plain_ms``) and the least time the card could take (``bound_ms``, by
``bound_by``: bytes at 3.35 TB/s or operations at the data sheet's peak;
each input byte read and each output byte written once).

    k1            K1 at C=256 on random int8 inputs, conv_a (q_next out) and
                  conv_b (the residual in, h and q_next out), at B = 64, 202,
                  256, 394, 512, 1,024 and 4,096, with the design each
                  launch takes; yardsticks on conv_b's input:
                  ``torch._int_mm`` on the prebuilt im2col matrix and bf16
                  ``F.conv2d``
    k2            the descent on the play tree (64 games, 32 simulations,
                  N = 34) and on 1,024 games (8 simulations, N = 10), with
                  the path depths
    k3, k6        the backup (the tree's own leaf buffers, and the caller's
                  leaf tensors) and the node write (and the root write) on
                  the play tree
    k4            K4 on features of played states at B = 64, 1,024 and
                  4,096: the stem (13 -> 256) with f32 out and with the int8
                  trunk input, conv_a (bf16 in and out) and conv_b (the
                  residual in, f32 and bf16 out) of a random 256-channel
                  block, each through ``conv3x3_bf16`` (which picks the
                  stem's design); yardstick bf16 ``F.conv2d``; and at
                  1,024 and 4,096 the stem with the int8 trunk input
                  launched on each of K4's designs the checkout has (the
                  tiled one; the stem design, ``kernels.STEM_BF16``), with
                  its share of the bytes bound
    k5            heads_eval on the folded heads of a random 1x256 net
                  (value_hidden 256) at B = 64, 128, 512, 1,024
    k7            the rules step on the first 64 and all 1,024 mixed states
                  (``torch_cases.mixed_states``); expand on the play tree
    k8            the state views on 64, 512 and 1,024 mixed states in the
                  three forms the paths launch: all three outputs, the
                  features alone, legality with status
    k9, k10       the ScriptPlayer and RandomPlayer single steps on those
                  states; for k9 also the single step on 1,024 and 64
                  mirrored games 100 Script-vs-Script steps into their
                  match, and there the multi-step entry's one launch of 64
                  iterations, Script vs Script and Script vs Random
    cards         K7's step, K9, K10 and the multi-step entry (64
                  iterations) on the 1,024 full-cards states
                  (``torch_cases.card_states``) and their first 64, under
                  the simple-cards and the full-cards rules on the same
                  inputs
    net           the stem and int8 trunk (``_trunk_out``) of a random
                  calibrated 20x256 net at B = 1,024 and 5x256 at 4,096
    slice         the play slice three times: the flagship, int8, 32
                  simulations, 32 games against the ScriptPlayer
    sr_match      ``play_match`` Script vs Random on 1,024 mirrored games
                  to the end from seed 24, three times
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FLAGSHIP = HERE.parent / "artifacts" / "params-20block-r4-best.npz"
PARTS = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8", "k9", "k10",
         "cards", "net", "slice", "sr_match")
SIMS, PLAY_GAMES = 32, 32     # the play slice
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak, data sheet
BF16_OPS_PER_S = 989e12       # dense bf16 tensor-core peak, data sheet
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores, data sheet
TABLE_BYTES = 2752            # rd::Tables, read once per rules launch
CARD_BYTES = 2 * 42 + 42      # player_cards and drawn_cards of one game
C = None    # tests/torch_cases.py, imported by main once DIR is on the path


# ------------------------------------------------------------ timing

def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn`` called back to back, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _trace(fn, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms(fn, kernel, reps: int = 20):
    """Mean device ms of one launch of the CUDA kernel whose name contains
    ``kernel`` (a name, or a tuple of names any of which may match), over
    ``reps`` calls of ``fn``, from a profiler trace.
    ``time_ms`` times the wrapper's call back to back, so for a kernel of
    a few microseconds it reads the host's call cost; this reads the
    kernel alone.  None when the trace holds no such kernel."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    rows = [e for e in _trace(fn, reps)
            if any(n in e.key for n in names)
            and e.self_device_time_total > 0]
    if not rows:
        return None
    return (sum(e.self_device_time_total for e in rows)
            / sum(e.count for e in rows) / 1e3)


def device_total_ms(fn, name: str = "", reps: int = 20) -> float:
    """Device ms a call of ``fn``: the time of every kernel it launched
    whose name contains ``name``, from a profiler trace."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in _trace(fn, reps)
               if e.device_type == DeviceType.CUDA and name in e.key
               ) / reps / 1e3


def bound_ms(nbytes: float, ops: float = 0.0, ops_rate: float = 1.0):
    """The least ms the card could take, and what bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def timed(run, kernel, nbytes, ops=0.0, ops_rate=1.0, plain=None, reps=50,
          **extra):
    """A kernel's entry: call, kernel alone, plain version, bound."""
    b, by = bound_ms(nbytes, ops, ops_rate)
    return {"ms": time_ms(run, reps), "device_ms": device_ms(run, kernel),
            "plain_ms": None if plain is None else time_ms(plain, 5, 1),
            "bound_ms": b, "bound_by": by, **extra}


def state_bytes(st, cfg):
    """Bytes of one game that the rules kernels read (and write): the 12
    fields, and under full cards the card masks."""
    from alphazero_risk_tpu_torch.env import rules
    return sum(getattr(st, name)[0].numel() * getattr(st, name).element_size()
               for name, _, _ in rules.STATE_SPEC) + (
        0 if cfg.simple_cards else CARD_BYTES)


# ------------------------------------------------------------ inputs

class Ctx:
    """What the parts share, made at first use."""

    def __init__(self, cfg, dev, root: Path):
        self.cfg, self.dev, self.root = cfg, dev, root
        self._mx = self._tree = self._states = None

    @property
    def mx(self):
        if self._mx is None:
            self._mx = C.mixed_states(self.cfg, self.dev)
        return self._mx

    @property
    def tree(self):
        """(tree, gumbel, root, cfg): 64 games grown by 32 simulations."""
        if self._tree is None:
            import torch
            from alphazero_risk_tpu_torch.mcts import search as S
            scfg = self.cfg.replace(mcts_simulations=32)
            root = C.first(self.mx, 64).state
            grow = S.draw_gumbel(torch.Generator(
                device=self.dev).manual_seed(5), scfg, 64, self.dev)
            tree = S.search(root, grow, scfg, C.heuristic_eval).tree
            self._tree = tree, grow[0], root, scfg
        return self._tree

    @property
    def states(self):
        """1,024 states 100 random steps into their games."""
        if self._states is None:
            import torch
            gen = torch.Generator(device=self.dev).manual_seed(1)
            self._states = C.random_play_states(1024, 100, gen, self.cfg,
                                                self.dev)
        return self._states

    def feats(self, b):
        """Features of ``b`` played states (the 1,024 repeated or cut)."""
        from alphazero_risk_tpu_torch.env.featurize import featurize
        f = featurize(self.states, self.cfg)
        return f.repeat(-(-b // 1024), 1, 1, 1)[:b].contiguous()


def _int8_fold(cfg, dev):
    """A calibrated int8 fold of a random net at ``cfg``'s widths."""
    import torch
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    from alphazero_risk_tpu_torch.models.resnet import build_network
    net = build_network(cfg, device=dev).eval()
    calib = FI.default_calib_feats(
        cfg, torch.Generator(device=dev).manual_seed(17), device=dev)
    return FI.fold_for_inference(net, cfg, int8=True, calib_feats=calib)


def mid_match(b, cfg, dev, kinds, warm=100, k=64):
    """``b`` mirrored games ``warm`` steps into a match of the seat
    ``kinds`` (one launch of the multi-step entry), and the draws of the
    next ``k`` steps."""
    import torch
    from alphazero_risk_tpu_torch.agents import blocks as AB
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.agents.common import BlockDraws
    gen = torch.Generator(device=dev).manual_seed(31)
    st = D.mirrored_initial_states(b, generator=gen, device=dev)
    carry = SA.init_carry(b, dev)
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)
    draws = BlockDraws(gen, b, dev)
    u, dice = draws.block(warm)
    st, carry, prev, _ = AB.agent_steps(st, carry, prev, u, dice, cfg, kinds)
    return (st, carry, prev, *draws.block(k))


# ------------------------------------------------------------ parts

def k1(ctx):
    import torch
    import torch.nn.functional as F
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    dev, c = ctx.dev, 256
    g = torch.Generator(device=dev).manual_seed(18)
    wraw = torch.randint(-127, 128, (3, 3, c, c), generator=g, device=dev,
                         dtype=torch.int8)
    w = FI.pack_trunk_wq(wraw)
    # the packed weight as the right operand of one int8 matrix product
    wmat = w.reshape(9, c, c).permute(1, 0, 2).reshape(c, 9 * c).t()
    wb = wraw.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
    ws = torch.rand(c, generator=g, device=dev) / 127
    bias = torch.randn(c, generator=g, device=dev)
    s = torch.tensor(0.01, device=dev)
    inv = torch.tensor(1 / 3.0, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for b in (64, 202, 256, 394, 512, 1024, 4096):
        m = b * 42
        q = torch.randint(-127, 128, (b, 7, 6, c), generator=g, device=dev,
                          dtype=torch.int8)
        res = torch.randn((b, 7, 6, c), generator=g, device=dev)
        ops = 2.0 * m * 9 * c * c
        wbytes = 9 * c * c + 8 * c + 8
        per, tiles = FI.conv_tile(kernels.CONV3X3_I8, b, c)
        e = {"wide": FI.k1_wide(b, c, dev), "boards_per_block": per,
             "tiles": tiles, "tiles_per_sm": tiles / sms,
             "conv_a": timed(
                 lambda: FI.conv3x3_i8(q, w, ws, bias, s, inv_s_next=inv,
                                       want_h=False),
                 "conv3x3_i8_kernel", m * c * 2 + wbytes, ops,
                 INT8_OPS_PER_S),
             "conv_b": timed(
                 lambda: FI.conv3x3_i8(q, w, ws, bias, s, residual=res,
                                       inv_s_next=inv),
                 "conv3x3_i8_kernel", m * c * (1 + 4 + 4 + 1) + wbytes, ops,
                 INT8_OPS_PER_S)}
        cols = _im2col_i8(q)
        xb = q.to(torch.bfloat16).permute(0, 3, 1, 2)
        e["int_mm_im2col_ms"] = time_ms(lambda: torch._int_mm(cols, wmat),
                                        50)
        e["bf16_conv2d_ms"] = time_ms(lambda: F.conv2d(xb, wb, padding=1),
                                      50)
        out[f"k1_b{b}"] = e
    return out


def _im2col_i8(q):
    """q [B,7,6,C] int8 -> the SAME-padded 3x3 patches [B*42, 9*C], K in
    (tap, channel) order: the left operand of K1's function as one int8
    matrix product."""
    import torch
    b, c = q.shape[0], q.shape[-1]
    qp = torch.zeros((b, 9, 8, c), dtype=q.dtype, device=q.device)
    qp[:, 1:8, 1:7] = q
    taps = [qp[:, dy:dy + 7, dx:dx + 6] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=3).reshape(b * 42, 9 * c).contiguous()


def _descent_bytes(tree, path, cfg):
    """Bytes a descent and a backup touch on these paths: per depth step
    the rows of one node, per battle edge its outcome row, per game its
    ends."""
    import torch
    from alphazero_risk_tpu_torch.config import PH_ATTACK, SKIP_ACTION
    b = tree.player.shape[0]
    dev = tree.player.device
    depth = path.depth.long()
    on_path = torch.arange(cfg.max_depth, device=dev)[None, :] < \
        depth[:, None]
    rows = torch.arange(b, device=dev)[:, None]
    battle = ((tree.states.phase[rows, path.pn.long()] == PH_ATTACK)
              & (path.pa != SKIP_ACTION) & on_path)
    steps, n_battle = int(on_path.sum()), int(battle.sum())
    per_step = 43 * (1 + 4 + 4 + 4) + 4 + 4 + 4 + 1 + 12
    k2 = (steps * per_step + n_battle * 42 * 8 + b * (4 + 1)
          + b * cfg.max_depth * 12 + b * 20 + 18 * 4)
    return k2, steps * (12 + 16) + b * 12


def k2(ctx):
    import torch
    from alphazero_risk_tpu_torch.mcts import search as S
    tree, gum, _, scfg = ctx.tree
    gcfg = ctx.cfg.replace(mcts_simulations=8)
    gen = torch.Generator(device=ctx.dev).manual_seed(5)
    big = S.search(ctx.states, S.draw_gumbel(gen, gcfg, 1024, ctx.dev), gcfg,
                   C.heuristic_eval).tree
    out = {}
    for name, t, gm, cfg in (
            ("k2_b64_n34", tree, gum, scfg),
            ("k2_b1024_n10", big, S.draw_gumbel(gen, gcfg, 1024, ctx.dev)[0],
             gcfg)):
        path = S.descend(t, gm, cfg)
        depth = path.depth.float()
        out[name] = timed(lambda: S.descend(t, gm, cfg), "mcts_descend_kernel",
                          _descent_bytes(t, path, cfg)[0],
                          plain=lambda: S._descend_plain(t, gm, cfg),
                          depth_mean=float(depth.mean()),
                          depth_max=int(depth.max()))
    return out


def k3(ctx):
    import torch
    from alphazero_risk_tpu_torch.mcts import search as S
    tree, gum, _, scfg = ctx.tree
    tree = C.clone_tree(tree)       # the backups below write its values
    b, dev = tree.player.shape[0], ctx.dev
    path = S.descend(tree, gum, scfg)
    leaf_v = torch.rand(b, generator=torch.Generator(device=dev)
                        .manual_seed(7), device=dev) * 2 - 1
    leaf_p = tree.player[torch.arange(b, device=dev), path.cur.long()]
    # the search's call: the leaf from the tree's own buffers
    pack_leaf = S._k6_pack(tree)[2]
    pack_leaf[0].copy_(leaf_v)
    pack_leaf[1].copy_(leaf_p)
    nbytes = _descent_bytes(tree, path, scfg)[1]
    e = timed(lambda: S.backup(tree, path, *pack_leaf), "mcts_backup_kernel",
              nbytes, plain=lambda: S._backup_plain(tree, path, leaf_v,
                                                    leaf_p))
    e["ms_caller"] = time_ms(lambda: S.backup(tree, path, leaf_v, leaf_p), 50)
    e["device_ms_caller"] = device_ms(
        lambda: S.backup(tree, path, leaf_v, leaf_p), "mcts_backup_kernel")
    return {"k3_b64_n34": e}


def k4(ctx):
    import torch
    folded = _int8_fold(ctx.cfg.replace(blocks=1), ctx.dev)
    inv = (1.0 / folded["act_s"]).flatten()[0]
    w, bias = folded["trunk_w"], folded["trunk_b"]
    # the plain version in full float32, as the card tests hold it
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {f"k4_b{b}": _k4_forms(ctx, folded, inv, w, bias, b)
               for b in (64, 1024, 4096)}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for b in (1024, 4096):
        out[f"k4_b{b}"]["stem_i8_designs"] = _k4_stem_designs(ctx, folded,
                                                              inv, b)
    return out


def _k4_forms(ctx, folded, inv, w, bias, b):
    """K4's four forms at batch ``b``."""
    import torch
    import torch.nn.functional as F
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    m = b * 42
    x = ctx.feats(b)
    h = FI._stem(folded, x)[0]
    hb = h.to(torch.bfloat16)
    # (args, f32 out, bf16 out, int8 out)
    forms = {
        "stem": ((x, folded["stem_w"], folded["stem_b"], None),
                 True, False, False),
        "stem_i8": ((x, folded["stem_w"], folded["stem_b"], None),
                    True, False, True),
        "conv_a": ((hb, w[0, 0], bias[0, 0], None), False, True, False),
        "conv_b": ((hb, w[0, 1], bias[0, 1], h), True, True, False)}
    e = {}
    for name, (args, f32, bf, i8) in forms.items():
        xin, wt, _, res = args
        cin, cout = xin.shape[-1], wt.shape[-1]
        nbytes = (m * cin * xin.element_size() + 9 * cin * cout * 2
                  + cout * 4 + (0 if res is None else m * cout * 4)
                  + m * cout * (4 * f32 + 2 * bf + i8))
        kw = {"want_f32": f32, "want_bf16": bf,
              "inv_s_next": inv if i8 else None}
        xl = xin.to(torch.bfloat16).permute(0, 3, 1, 2)
        wl = wt.permute(3, 2, 0, 1).contiguous()
        e[name] = timed(lambda: FI.conv3x3_bf16(*args, **kw),
                        ("conv3x3_bf16_kernel", "stem_bf16_kernel"), nbytes,
                        2.0 * m * 9 * cin * cout, BF16_OPS_PER_S,
                        plain=lambda: FI._conv3x3_bf16_plain(*args),
                        bf16_conv2d_ms=time_ms(
                            lambda: F.conv2d(xl, wl, padding=1), 50))
    return e


def _k4_stem_designs(ctx, folded, inv, b):
    """The stem with f32 and int8 out (the int8 trunk's first input) at
    batch ``b``, launched directly on each of K4's designs the checkout
    has: the tiled one, and the stem design where the package has it
    (``kernels.STEM_BF16``), each with its share of the bytes bound."""
    import torch
    from alphazero_risk_tpu_torch import kernels
    m, x = b * 42, ctx.feats(b)
    w, bias = folded["stem_w"], folded["stem_b"]
    cin, cout = x.shape[-1], w.shape[-1]
    out = torch.empty((b, 7, 6, cout), device=ctx.dev)
    out_q = torch.empty((b, 7, 6, cout), dtype=torch.int8, device=ctx.dev)
    P = kernels.ptr
    designs = {"tiled": (lambda: kernels.CONV3X3_BF16.launch(
        P(x), P(w), P(bias), None, P(inv), P(out), None, P(out_q), m, cin,
        cout, 0), "conv3x3_bf16_kernel")}
    if hasattr(kernels, "STEM_BF16"):
        designs["stem"] = (lambda: kernels.STEM_BF16.launch(
            P(x), P(w), P(bias), P(inv), P(out), None, P(out_q), m, cin,
            cout), "stem_bf16_kernel")
    nbytes = m * cin * 4 + 9 * cin * cout * 2 + cout * 4 + m * cout * 5
    e = {}
    for name, (run, kernel) in designs.items():
        e[name] = timed(run, kernel, nbytes, 2.0 * m * 9 * cin * cout,
                        BF16_OPS_PER_S)
        e[name]["share_of_bound"] = e[name]["bound_ms"] / e[name]["device_ms"]
    return e


def k5(ctx):
    import torch
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    from alphazero_risk_tpu_torch.models.resnet import build_network
    dev = ctx.dev
    torch.manual_seed(0)
    net = build_network(Config(blocks=1), device=dev).eval()
    folded = FI.fold_params(net, ctx.cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    legal = rules.legal_actions(ctx.states, ctx.cfg)
    h = torch.randn((1024, 42, 256), generator=gen, device=dev).relu()
    v = folded["val_d1_w"].shape[1]
    # the ten head tensors, each read once
    wbytes = sum(folded[k].numel() * 4 for k in FI._HEAD_SHAPES)
    out = {}
    for b in (64, 128, 512, 1024):
        hh, lg = h[:b].contiguous(), legal[:b].contiguous()
        out[f"k5_b{b}"] = timed(
            lambda: FI.heads_eval(folded, hh, lg), "heads_eval_kernel",
            hh.numel() * 4 + wbytes + lg.numel() + b * (43 * 2 + 1) * 4,
            2.0 * b * (42 * 256 * 3 + 84 * 43 + 42 * v + v), F32_OPS_PER_S,
            plain=lambda: FI._heads_eval_plain(folded, hh, lg))
    return out


def k6(ctx):
    from alphazero_risk_tpu_torch.mcts import search as S
    import torch
    tree, gum, root, scfg = ctx.tree
    tree, ref = C.clone_tree(tree), C.clone_tree(tree)
    b = tree.player.shape[0]
    path = S.descend(tree, gum, scfg)
    ins = S.expansion_inputs(tree, path, scfg, C.heuristic_eval)
    root_done = tree.terminal[torch.arange(b, device=ctx.dev),
                              tree.root.long()]
    expanding = int(((path.exp_n >= 0) & ~root_done).sum())
    # each expanding game's node read once and written once, plus the
    # indices, the link and the leaf outputs
    node = sum(t[0].numel() * t.element_size()
               for t in (*S._state_fields(ins[0]), *ins[1:]))
    e = timed(lambda: S.write_nodes(tree, *ins, path), "write_nodes_kernel",
              expanding * (2 * node + 16) + b * (4 * 4 + 1 + 16),
              plain=lambda: S._write_nodes_plain(ref, *ins, path))
    rins = S.root_inputs(root, scfg, C.heuristic_eval)
    fresh = S._empty_tree(root, scfg)
    e["ms_root"] = time_ms(lambda: S.write_nodes(fresh, *rins), 50)
    return {"k6_b64_n34": e}


def k7(ctx):
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.mcts import search as S
    out = {}
    for b in (64, 1024):
        mx = C.first(ctx.mx, b)
        st, a, dice, cfg = mx.state, mx.action, mx.dice, ctx.cfg
        out[f"k7_step_b{b}"] = timed(
            lambda: rules.step(st, a, dice, cfg), "rules_step_kernel",
            b * (2 * state_bytes(st, cfg) + 4 + 20) + TABLE_BYTES,
            plain=lambda: rules._step_plain(st, a, dice, cfg))
    tree, gum, _, scfg = ctx.tree
    path = S.descend(tree, gum, scfg)
    args = (tree.states, path.exp_n, path.exp_a, path.exp_o, scfg)
    b = tree.player.shape[0]
    node = 2 * state_bytes(C.first(ctx.mx, 1).state, scfg) + 3 * 42
    out["k7_expand_b64_n34"] = timed(
        lambda: rules.expand(*args), "rules_step_kernel",
        b * (node + 12 + 4 + 43) + TABLE_BYTES,
        plain=lambda: rules._expand_plain(*args))
    return out


def k8(ctx):
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.featurize import featurize
    cfg = ctx.cfg
    feat = featurize(C.first(ctx.mx, 1).state, cfg)[0].numel() * 4
    board = ("owner", "army", "phase", "cur_player")
    # (legal, status, features), the fields each form reads, and the bytes
    # of its outputs besides the features
    forms = {"all_three": ((True, True, True), rules.VIEW_FIELDS, 43 + 4),
             "features": ((False, False, True), board + (
                 "can_draw_card", "attacks_during_turn")
                 + (("round",) if cfg.feature_version == 3 else ()), 0),
             "legal_status": ((True, True, False),
                              board + ("round", "mob_from", "mob_to"),
                              43 + 4)}
    out = {}
    for b in (64, 512, 1024):
        st = C.first(ctx.mx, b).state
        e = {}
        for name, ((lg, stt, ft), fields, written) in forms.items():
            read = sum(getattr(st, f)[0].numel() * getattr(st, f).element_size()
                       for f in fields)
            e[name] = timed(
                lambda: rules.state_views(st, cfg, legal=lg, status=stt,
                                          features=ft),
                "state_views_kernel",
                b * (read + written + (feat if ft else 0)) + TABLE_BYTES,
                plain=lambda: rules._state_views_plain(st, cfg, lg, stt, ft))
        out[f"k8_b{b}"] = e
    return out


def _k9_k10(mx, cfg, script=True, random=True):
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    st, b = mx.state, mx.state.batch_size
    sb = state_bytes(st, cfg)
    out = {}
    if script:
        args = (st, mx.carry, mx.reset, mx.u, mx.dice, cfg)
        out["k9"] = timed(lambda: SA.script_step_recorded(*args),
                          "script_step_kernel",
                          b * (2 * sb + 2 * 9 + 1 + 16 + 20 + 5) + TABLE_BYTES,
                          plain=lambda: SA._script_step_recorded_plain(*args))
    if random:
        args = (st, mx.u, mx.dice, cfg)
        out["k10"] = timed(lambda: RA.random_step_recorded(*args),
                           "random_step_kernel",
                           b * (2 * sb + 16 + 20 + 5) + TABLE_BYTES,
                           plain=lambda: RA._random_step_recorded_plain(*args))
    return out


def _agent_steps(st, carry, prev, u, dice, cfg, kinds):
    """The multi-step entry's one launch of ``u.shape[0]`` iterations: per
    launch and per iteration, and the game-steps it took."""
    from alphazero_risk_tpu_torch.agents import blocks as AB
    args = (st, carry, prev, u, dice, cfg, kinds)
    b, k = st.batch_size, u.shape[0]
    n = int(AB.agent_steps(*args)[3].sum())
    # state, carry (9 bytes) and prev read and written once, the step
    # counts written, and the draws of the steps taken
    nbytes = b * (2 * (state_bytes(st, cfg) + 9 + 4) + 4) + n * (4 + 20) \
        + TABLE_BYTES
    e = timed(lambda: AB.agent_steps(*args), "agent_steps_kernel", nbytes,
              plain=lambda: AB._agent_steps_plain(*args), reps=20, steps=n)
    e["device_ms_per_iteration"] = (None if e["device_ms"] is None
                                    else e["device_ms"] / k)
    return e


def k9(ctx):
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    cfg, dev = ctx.cfg, ctx.dev
    out = {f"k9_b{b}": _k9_k10(C.first(ctx.mx, b), cfg, random=False)["k9"]
           for b in (64, 1024)}
    for b in (1024, 64):
        for kinds in ((1, 1), (1, 2)):
            st, carry, prev, u, dice = mid_match(b, cfg, dev, kinds)
            if kinds == (1, 1):
                reset = st.cur_player != prev
                out[f"k9_mid_b{b}_single_device_ms"] = device_ms(
                    lambda: SA.script_step_recorded(st, carry, reset, u[0],
                                                    dice[0], cfg),
                    "script_step_kernel")
            out[f"steps_b{b}_{kinds[0]}{kinds[1]}"] = _agent_steps(
                st, carry, prev, u, dice, cfg, kinds)
    return out


def k10(ctx):
    return {f"k10_b{b}": _k9_k10(C.first(ctx.mx, b), ctx.cfg,
                                 script=False)["k10"] for b in (64, 1024)}


def cards(ctx):
    """The full-cards rules' own cost: on the full-cards states, K7's step,
    K9 and K10 at B = 64 and 1,024 and the multi-step entry (one launch of
    64 iterations from the states' carries and previous movers) under the
    simple-cards and then the full-cards rules, the same inputs for
    both."""
    import torch
    from alphazero_risk_tpu_torch.agents.common import BlockDraws
    from alphazero_risk_tpu_torch.env import rules
    full = ctx.cfg.replace(simple_cards=False, max_game_steps=4096)
    cmx = C.card_states(full, ctx.dev)
    u, dice = BlockDraws(torch.Generator(device=ctx.dev).manual_seed(41),
                         cmx.state.batch_size, ctx.dev).block(64)
    out = {}
    for mode, cfg in (("simple", ctx.cfg), ("full", full)):
        for b in (64, cmx.state.batch_size):
            m = C.first(cmx, b)
            st, a, d = m.state, m.action, m.dice
            u_card = None if cfg.simple_cards else m.u[:, 3].contiguous()
            out[f"{mode}_k7_b{b}"] = timed(
                lambda: rules.step(st, a, d, cfg, u_card), "rules_step_kernel",
                b * (2 * state_bytes(st, cfg) + 4 + 20
                     + (0 if u_card is None else 4)) + TABLE_BYTES,
                plain=lambda: rules._step_plain(st, a, d, cfg, u_card))
            e = _k9_k10(m, cfg)
            out[f"{mode}_k9_b{b}"], out[f"{mode}_k10_b{b}"] = e["k9"], e["k10"]
            for kinds in ((1, 1), (1, 2)):
                out[f"{mode}_steps_b{b}_{kinds[0]}{kinds[1]}"] = _agent_steps(
                    st, m.carry, m.prev, u[:, :b].contiguous(),
                    dice[:, :b].contiguous(), cfg, kinds)
    return {"cards": out}


def net(ctx):
    """Per evaluation: the call time back to back (CUDA events), the
    host's time to enqueue it, and the device time of its kernels."""
    import torch
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    out = {}
    for blocks, b in ((20, 1024), (5, 4096)):
        folded = _int8_fold(ctx.cfg.replace(blocks=blocks), ctx.dev)
        x = ctx.feats(b)

        def fn():
            return FI._trunk_out(folded, x, True)

        call = time_ms(fn, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        host = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        out[f"net_{blocks}x256_b{b}"] = {
            "ms": call, "host_ms": host, "device_ms": device_total_ms(fn),
            "k1_device_ms": device_total_ms(fn, "conv3x3_i8_kernel")}
    return out


def _play_slice(ctx):
    """A function that plays the play slice (the flagship, int8, SIMS
    simulations, PLAY_GAMES games against the ScriptPlayer) from a fresh
    trainer of seed 0, so each call plays the same games, and returns its
    result."""
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training.checkpoints import load_params_npz
    from alphazero_risk_tpu_torch.training.trainer import Trainer
    work = ctx.root / "build" / "time_kernels"
    cfg = Config(mcts_simulations=SIMS, fast_infer=True,
                 fast_infer_int8=True, checkpoint_dir=str(work / "ckpt"),
                 data_dir=str(work / "data"), log_dir=str(work / "log"))
    net = load_params_npz(str(FLAGSHIP), cfg, device=ctx.dev)

    def play():
        t = Trainer(cfg, seed=0, device=ctx.dev)
        t.net = net
        t.folded()
        res = t.play(A.OPP_SCRIPT, PLAY_GAMES)
        return dict(res, az_decisions=t.play_stats["az_decisions"])

    return play


def play_slice(ctx, reps=3):
    """The play slice ``reps`` times: the result and each run's
    seconds."""
    import torch
    play, secs, result = _play_slice(ctx), [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = play()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"slice": {"result": result, "seconds": secs}}


def _match(ctx, agents, seed):
    import torch
    from alphazero_risk_tpu_torch.agents import driver as D
    gen = torch.Generator(device=ctx.dev).manual_seed(seed)
    st = D.mirrored_initial_states(C.MIXED, generator=gen, device=ctx.dev)
    res = D.play_match(gen, st, *agents, ctx.cfg, ctx.cfg.max_game_steps)
    return dict(D.summarize(res), steps=res.steps)


def sr_match(ctx, reps=3):
    """``play_match`` Script vs Random on 1,024 mirrored games to the end
    from seed 24 (the CLI's ``-m play --p1 sp --p2 rp``), ``reps`` times,
    each from a sync to its end."""
    import torch
    from alphazero_risk_tpu_torch.agents import driver as D
    secs, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _match(ctx, (D.AGENT_SCRIPT, D.AGENT_RANDOM), 24)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"sr_match": {"result": out, "seconds": secs}}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--tag", required=True)
    p.add_argument("--parts", default=",".join(PARTS))
    p.add_argument("--out", default=None)
    args = p.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        sys.exit(f"parts are {PARTS}")
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(HERE.parent / "tests")]
    global C
    import torch
    import alphazero_risk_tpu_torch
    import torch_cases as C
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.config import Config
    if root not in Path(alphazero_risk_tpu_torch.__file__).resolve().parents:
        sys.exit(f"the package was not imported from {root}")
    if not torch.cuda.is_available():
        sys.exit("needs a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.build_all()
    dev = torch.device("cuda")
    out = {"tag": args.tag, "root": str(root), "card": card,
           "build_s": time.perf_counter() - t0}
    ctx = Ctx(Config(), dev, root)
    for part in parts:
        if part in ("slice", "sr_match"):
            # whole paths, which run as their callers run them
            out.update((play_slice if part == "slice" else sr_match)(ctx))
        else:
            with torch.inference_mode():
                out.update(globals()[part](ctx))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
