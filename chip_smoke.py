"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each failure exits non-zero, and the last line is printed only
when all of them pass):

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the port's kernels (one nvcc per source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card,
   with times, bounds and the library yardstick.  First at the shapes of
   the main path: one search as ``Trainer.play`` runs it (64 games, 32
   sims, the flagship's int8 eval) grows a tree; K1 runs on the flagship's
   quantized block-0 weights at B=64 on that search's last leaf batch, and
   K2/K3 on the tree it leaves.  Then at larger shapes: K1 at B=1024, and
   K2/K3 on trees over 256 games grown by plain-version simulations;
4. slice: the flagship 20x256 net, int8 fast path, 32 simulations, plays
   64 mirrored games against the ScriptPlayer to the end through
   ``Trainer.play`` (the main path, launch counts read around it), checks
   the int8 and bf16 forwards against the plain network on a small input,
   then runs a short bf16 pass.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

FLAGSHIP = Path(__file__).resolve().parent / "artifacts" / \
    "params-20block-r4-best.npz"
GAMES = 64
SIMS = 32
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak, data sheet


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
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


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from alphazero_risk_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for k in kernels.ALL:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")


def random_play_states(batch, steps, gen, cfg, dev):
    """States reached by random legal play, in all phases."""
    import torch
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import new_game
    st = new_game(batch, generator=gen, device=dev)
    for _ in range(steps):
        legal = rules.legal_actions(st, cfg)
        g = torch.rand(legal.shape, generator=gen, device=dev)
        a = torch.argmax(torch.where(legal, g, -1.0), dim=-1).to(torch.int32)
        st = rules.step_key(st, a, gen, cfg)
    return st


def heuristic_eval(state, legal):
    """Uniform prior + army/land-share value: a cheap stand-in network."""
    import torch
    probs = legal.float() / legal.sum(-1, keepdim=True).clamp(min=1)
    own = state.owner == state.cur_player[:, None]
    en = state.owner == (1 - state.cur_player)[:, None]
    ta, ea = (state.army * own).sum(-1), (state.army * en).sum(-1)
    lo, le = own.sum(-1), en.sum(-1)
    v = 0.5 * (ta - ea) / (ta + ea).clamp(min=1) + 0.5 * (lo - le) / 42.0
    return probs, v.to(torch.float32)


def tree_to(tree, dev):
    import dataclasses
    from alphazero_risk_tpu_torch.env.state import GameState, tree_map
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        out[f.name] = (tree_map(lambda x: x.to(dev), v)
                       if isinstance(v, GameState) else v.to(dev))
    return type(tree)(**out)


def check_k1(folded, feats):
    """K1 against its plain version on the leaf features ``feats``: the
    first block's conv_a and conv_b.  Returns the timed entry fields."""
    import torch
    import torch.nn.functional as F
    from alphazero_risk_tpu_torch.models import fast_infer as FI

    h = FI._stem(folded, feats).contiguous()
    act_s, wq, ws, b = (folded["act_s"], folded["trunk_wq"],
                        folded["trunk_ws"], folded["trunk_b"])
    inv = 1.0 / act_s
    q = FI._quantize(h, inv[0, 0])
    B, C = q.shape[0], q.shape[-1]
    M = B * 42

    a_args = (q, wq[0, 0], ws[0, 0], b[0, 0], act_s[0, 0])
    _, q2, acc_a = FI.conv3x3_i8(*a_args, inv_s_next=inv[0, 1],
                                 want_h=False, want_acc=True)
    ref_acc_a = FI._conv_i8_plain(q, wq[0, 0])
    _, ref_q2 = FI._epilogue_plain(ref_acc_a, ws[0, 0], b[0, 0],
                                   act_s[0, 0], None, inv[0, 1])
    b_args = (ref_q2, wq[0, 1], ws[0, 1], b[0, 1], act_s[0, 1])
    hb, qb, acc_b = FI.conv3x3_i8(*b_args, residual=h,
                                  inv_s_next=inv[1, 0], want_acc=True)
    ref_acc_b = FI._conv_i8_plain(ref_q2, wq[0, 1])
    ref_hb, ref_qb = FI._epilogue_plain(ref_acc_b, ws[0, 1], b[0, 1],
                                        act_s[0, 1], h, inv[1, 0])
    torch.cuda.synchronize()
    # Tolerance: int32 accumulators exact; the float epilogue runs the same
    # operations in the same order without FMA, so h agrees to 1e-6
    # relative and the requantized int8 to +-1 (a rint tie).
    if not torch.equal(acc_a, ref_acc_a) or not torch.equal(acc_b,
                                                            ref_acc_b):
        fail(f"K1 int32 accumulators differ from the exact conv at B={B}")
    err = float((hb - ref_hb).abs().max())
    if not torch.allclose(hb, ref_hb, rtol=1e-6, atol=1e-6):
        fail(f"K1 epilogue h differs at B={B}: max abs err {err}")
    dq = max(int((q2.int() - ref_q2.int()).abs().max()),
             int((qb.int() - ref_qb.int()).abs().max()))
    if dq > 1:
        fail(f"K1 requantized output differs by {dq} at B={B}")
    log(f"K1 conv3x3_i8 B={B} C={C}: acc exact, h max abs err {err:.3g}, "
        f"q max diff {dq}, |acc| max {int(acc_b.abs().max())}")

    def run_a():
        FI.conv3x3_i8(*a_args, inv_s_next=inv[0, 1], want_h=False)

    def run_b():
        FI.conv3x3_i8(*b_args, residual=h, inv_s_next=inv[1, 0])

    def plain_b():
        acc = FI._conv_i8_plain(ref_q2, wq[0, 1])
        FI._epilogue_plain(acc, ws[0, 1], b[0, 1], act_s[0, 1], h, inv[1, 0])

    xb = ref_q2.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = wq[0, 1].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()

    def library():
        F.conv2d(xb, wb, padding=1)

    ms_a = time_ms(run_a, 50)
    ms_b = time_ms(run_b, 50)
    plain = time_ms(plain_b, 3, warmup=1)
    lib = time_ms(library, 50)
    ops = 2.0 * M * 9 * C * C
    nbytes = M * C * (1 + 4 + 4 + 1) + 9 * C * C + 8 * C + 8
    bms, by = bound_ms(nbytes, ops, INT8_OPS_PER_S)
    nbytes_a = M * C * 2 + 9 * C * C + 8 * C + 8
    bms_a, _ = bound_ms(nbytes_a, ops, INT8_OPS_PER_S)
    log(f"K1 B={B} conv_a variant: {ms_a:.4f} ms (bound {bms_a:.5f} ms); "
        f"conv_b variant: {ms_b:.4f} ms (bound {bms:.5f} ms, {by}, "
        f"{ms_b / bms:.1f}x); plain {plain:.3f} ms; bf16 F.conv2d "
        f"{lib:.4f} ms; {ops / ms_b / 1e9:.1f} TOP/s")
    return {"max_abs_err": err, "ms": ms_b, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "ms_conv_a": ms_a, "bound_ms_conv_a": bms_a,
            "shape": f"B={B} C={C}"}


def check_k2_k3(tree, gum, cfg, dev):
    """K2 and K3 against their plain versions on ``tree`` with one
    simulation's noise ``gum`` [max_depth, B, 3].  Returns the timed entry
    fields of each."""
    import torch
    from alphazero_risk_tpu_torch.config import PH_ATTACK, SKIP_ACTION
    from alphazero_risk_tpu_torch.mcts import search as S

    B, N = tree.player.shape
    shape = f"B={B} N={N} D={cfg.max_depth}"
    path = S.descend(tree, gum, cfg)
    ref = S._descend_plain(tree, gum, cfg)
    torch.cuda.synchronize()
    for name, a, r in zip(S.Descent._fields, path, ref):
        if not torch.equal(a, r):
            fail(f"K2 output {name} differs from the plain descent ({shape})")
    err2 = max(float((a - r).abs().max()) for a, r in zip(path, ref))
    depth = path.depth.long()
    log(f"K2 mcts_descend {shape}: outputs equal (max abs err {err2}); "
        f"depth mean {float(depth.float().mean()):.2f} max "
        f"{int(depth.max())}, expanding {int((path.exp_n >= 0).sum())}/{B}")

    leaf_v = torch.rand(B, generator=torch.Generator(device=dev)
                        .manual_seed(7), device=dev) * 2 - 1
    leaf_p = tree.player[torch.arange(B, device=dev), path.cur.long()]
    vk, wk = tree.visit.clone(), tree.wsum.clone()
    S.backup(tree, path, leaf_v, leaf_p)
    vis_k, ws_k = tree.visit.clone(), tree.wsum.clone()
    tree.visit.copy_(vk)
    tree.wsum.copy_(wk)
    S._backup_plain(tree, path, leaf_v, leaf_p)
    torch.cuda.synchronize()
    if not torch.equal(vis_k, tree.visit):
        fail(f"K3 visit differs from the plain backup ({shape})")
    if not torch.allclose(ws_k, tree.wsum, rtol=1e-6, atol=0):
        fail(f"K3 wsum differs from the plain backup beyond rtol 1e-6 "
             f"({shape})")
    err3 = float((ws_k - tree.wsum).abs().max())
    # sign flips on the paths: where the mover changes along an edge
    on_path = torch.arange(cfg.max_depth, device=dev)[None, :] < \
        depth[:, None]
    flips = int(((path.pp[:, 1:] != path.pp[:, :-1]) & on_path[:, 1:]).sum())
    log(f"K3 mcts_backup {shape}: visit equal, wsum max abs err {err3:.3g}; "
        f"{flips} player changes along the paths")

    # data-dependent bytes: what this descent and backup actually touch
    rows = torch.arange(B, device=dev)[:, None]
    battle = ((tree.states.phase[rows, path.pn.long()] == PH_ATTACK)
              & (path.pa != SKIP_ACTION) & on_path)
    steps, n_battle = int(on_path.sum()), int(battle.sum())
    per_step = 43 * (1 + 4 + 4 + 4) + 4 + 4 + 4 + 1 + 12
    k2_bytes = (steps * per_step + n_battle * 42 * 8 + B * (4 + 1)
                + B * cfg.max_depth * 12 + B * 20 + 18 * 4)
    k3_bytes = steps * (12 + 16) + B * 12
    k2_bound, k2_by = bound_ms(k2_bytes, 0.0, 1.0)
    k3_bound, k3_by = bound_ms(k3_bytes, 0.0, 1.0)

    ms2 = time_ms(lambda: S.descend(tree, gum, cfg), 50)
    ms3 = time_ms(lambda: S.backup(tree, path, leaf_v, leaf_p), 50)
    plain2 = time_ms(lambda: S._descend_plain(tree, gum, cfg), 5)
    plain3 = time_ms(lambda: S._backup_plain(tree, path, leaf_v, leaf_p), 20)
    log(f"K2 {shape}: {ms2:.4f} ms (bound {k2_bound:.5f} ms) plain "
        f"{plain2:.3f} ms; K3: {ms3:.4f} ms (bound {k3_bound:.5f} ms) "
        f"plain {plain3:.3f} ms")
    return ({"max_abs_err": err2, "ms": ms2, "plain_ms": plain2,
             "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
             "shape": shape},
            {"max_abs_err": err3, "ms": ms3, "plain_ms": plain3,
             "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
             "shape": shape})


def plain_grown_tree(states, cfg, dev):
    """Trees over 256 games grown by 8 plain-version (CPU) simulations
    with a cheap stand-in network."""
    import torch
    from alphazero_risk_tpu_torch.env.state import tree_map
    from alphazero_risk_tpu_torch.mcts import search as S

    scfg = cfg.replace(mcts_simulations=8)
    root = tree_map(lambda x: x[:256].cpu(), states)
    grow = S.draw_gumbel(torch.Generator().manual_seed(5), scfg, 256, "cpu")
    t0 = time.perf_counter()
    tree = S.search(root, grow, scfg, heuristic_eval).tree
    log(f"K2/K3 trees: 256 games x {scfg.mcts_simulations} plain sims on "
        f"the CPU in {time.perf_counter() - t0:.1f} s")
    return tree_to(tree, dev)


def main_path_tree(trainer, states):
    """The tree left after one search of the main path: GAMES games, the
    flagship's int8 eval, SIMS simulations, on the card."""
    import torch
    from alphazero_risk_tpu_torch.env.state import tree_map
    from alphazero_risk_tpu_torch.mcts import search as S

    cfg, dev = trainer._ecfg, trainer.device
    root = tree_map(lambda x: x[:GAMES].contiguous(), states)
    gum = S.draw_gumbel(torch.Generator(device=dev).manual_seed(8), cfg,
                        GAMES, dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        tree = S.search(root, gum, cfg, trainer._eval_fn()).tree
    torch.cuda.synchronize()
    log(f"main-path tree: {GAMES} games x {cfg.mcts_simulations} sims "
        f"(int8 flagship eval) in {time.perf_counter() - t0:.1f} s")
    return tree


def check_forward(trainer, states, cfg):
    """The repo's fast-path agreement bounds (tests/test_fast_infer.py),
    on the flagship and states from play, against the plain network."""
    import numpy as np
    import torch
    from alphazero_risk_tpu_torch.env.featurize import featurize
    from alphazero_risk_tpu_torch.models import fast_infer as FI

    x = featurize(states, cfg)[:256]
    with torch.no_grad():
        ref_l, ref_v = trainer.net(x)
        bf = FI.fold_params(trainer.net, cfg)
        l16, v16 = FI.apply_folded(bf, x)
        l8, v8 = FI.apply_folded(trainer.folded(), x, int8=True)
    for t in (ref_l, ref_v, l16, v16, l8, v8):
        if not bool(torch.isfinite(t).all()):
            fail("non-finite network output")
    agree16 = float((l16.argmax(-1) == ref_l.argmax(-1)).float().mean())
    agree8 = float((l8.argmax(-1) == ref_l.argmax(-1)).float().mean())
    dv8 = float((v8 - ref_v).abs().mean())
    corr8 = float(np.corrcoef(l8.cpu().numpy().ravel(),
                              ref_l.cpu().numpy().ravel())[0, 1])
    log(f"forward vs plain AZNet (256 states): bf16 top-1 {agree16:.3f}; "
        f"int8 top-1 {agree8:.3f}, |dv| {dv8:.4f}, logit corr {corr8:.4f}")
    if agree16 < 0.9 or agree8 < 0.85 or dv8 >= 0.1 or corr8 <= 0.99:
        fail("fast path disagrees with the plain network")


def phase_kernels(cfg, dev):
    """Load and fold the flagship, then hold each kernel against its plain
    version on the card.  Returns (trainer, kernel entries)."""
    import torch
    from alphazero_risk_tpu_torch.env.featurize import featurize
    from alphazero_risk_tpu_torch.env.state import tree_map
    from alphazero_risk_tpu_torch.mcts import search as S
    from alphazero_risk_tpu_torch.training.checkpoints import load_params_npz
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    trainer = Trainer(cfg, seed=0, device=dev)
    trainer.net = load_params_npz(str(FLAGSHIP), cfg, device=dev)
    t0 = time.perf_counter()
    folded = trainer.folded()
    torch.cuda.synchronize()
    log(f"flagship {cfg.blocks}x{cfg.filters}: fold+quantize+calibrate "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    states = random_play_states(1024, 100, gen, cfg, dev)
    log(f"random play: 1024 games x 100 steps in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # main-path shapes: K1 on the last simulation's leaf batch, K2/K3 on
    # the tree that search leaves
    mtree = main_path_tree(trainer, states)
    rows = torch.arange(GAMES, device=dev)
    leaves = tree_map(lambda x: x[rows, (mtree.next_free - 1).long()],
                      mtree.states)
    with torch.inference_mode():
        k1 = check_k1(folded, featurize(leaves, cfg))
        mgum = S.draw_gumbel(torch.Generator(device=dev).manual_seed(6),
                             cfg, GAMES, dev)[0]
        k2, k3 = check_k2_k3(mtree, mgum, cfg, dev)
        # the larger shapes: K1 at B=1024, K2/K3 over 256 games
        k1["b1024"] = check_k1(folded, featurize(states, cfg))
        gum = S.draw_gumbel(torch.Generator(device=dev).manual_seed(6), cfg,
                            256, dev)[0]
        k2["g256"], k3["g256"] = check_k2_k3(
            plain_grown_tree(states, cfg, dev), gum, cfg, dev)
    entries = [
        {"name": "conv3x3_i8", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/conv_i8.cu",
         "replaces": "alphazero_risk_tpu/models/fast_infer.py:111", **k1},
        {"name": "mcts_descend", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/mcts_descend.cu",
         "replaces": "alphazero_risk_tpu/mcts/search.py:177", **k2},
        {"name": "mcts_backup", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/mcts_backup.cu",
         "replaces": "alphazero_risk_tpu/mcts/search.py:259", **k3},
    ]
    check_forward(trainer, states, cfg)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    return trainer, entries


def profile_window(trainer, games, steps=1):
    """Device busy share and the top device kernels over a short window of
    the main path (``steps`` AZ decisions from fresh deals), traced by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    cfg = trainer.cfg.replace(actor_chunk_steps=steps, max_game_steps=steps)
    t = Trainer(cfg, seed=2, device=trainer.device)
    t.net = trainer.net
    t.folded()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.play(A.OPP_SCRIPT, games)
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    # device-side events only (the aten ops carry the same time again)
    rows = [e for e in avg if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in rows)
    host_ops = sum(e.count for e in avg if e.key.startswith("aten::"))
    log(f"profile window (first {steps} AZ steps x {games} games): wall "
        f"{wall:.2f} s, device busy {dev_us / 1e6:.3f} s "
        f"({100 * dev_us / 1e6 / wall:.1f}%), host-side aten ops "
        f"{host_ops}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.1f} ms  {e.count:7d}x  "
            f"{e.key[:70]}")


def phase_slice(trainer, entries, games=GAMES):
    """The main path (Trainer.play, int8, to the end), then a short bf16
    pass.  Fills each entry's main-path launch count."""
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    cfg, dev = trainer.cfg, trainer.device
    kernels.reset_counts()
    res = trainer.play(A.OPP_SCRIPT, games)
    counts = kernels.counts()
    st = trainer.play_stats
    dps = st["az_decisions"] / st["seconds"]
    az_wins = res["p0_wins"] / max(res["games"] - res["unfinished"], 1)
    log(f"slice int8: {json.dumps(res)}")
    log(f"slice int8: AZ win rate {az_wins:.4f} over {res['games']} games, "
        f"{st['az_decisions']} AZ decisions in {st['seconds']:.1f} s: "
        f"{dps:.2f} decisions/s, {dps * cfg.mcts_simulations:.1f} sims/s; "
        f"launches {counts}")
    if res["games"] != games or res["unfinished"] != 0:
        fail(f"slice left games unfinished: {res}")
    for k in kernels.ALL:
        if counts[k.name] <= 0:
            fail(f"kernel {k.name} was not launched on the main path")
    for e in entries:
        e["launches"] = counts[e["name"]]

    t0 = time.perf_counter()
    profile_window(trainer, games)
    log(f"profile window with trace processing: "
        f"{time.perf_counter() - t0:.1f} s")

    bcfg = cfg.replace(fast_infer_int8=False, actor_chunk_steps=8,
                       max_game_steps=24)
    bt = Trainer(bcfg, seed=1, device=dev)
    bt.net = trainer.net
    bt.folded()
    kernels.reset_counts()
    bres = bt.play(A.OPP_SCRIPT, games)
    bst = bt.play_stats
    log(f"bf16 pass (3 chunks of 8 steps): {json.dumps(bres)}; "
        f"{bst['az_decisions']} AZ decisions in {bst['seconds']:.1f} s "
        f"({bst['az_decisions'] / bst['seconds']:.2f} decisions/s); "
        f"launches {kernels.counts()}")
    if bres["games"] != games:
        fail("bf16 pass did not play its games")


def main():
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    import torch
    from alphazero_risk_tpu_torch.config import Config
    cfg = Config(mcts_simulations=SIMS, fast_infer=True, fast_infer_int8=True)
    trainer, entries = phase_kernels(cfg, torch.device("cuda"))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    phase_slice(trainer, entries)
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
