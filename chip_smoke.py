"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each failure exits non-zero, and the last line is printed only
when all of them pass):

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the port's kernels (one nvcc per source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card,
   with times, bounds and the library yardstick.  First at the shapes of
   the main paths: one search as ``run_episodes`` runs it (64 games in
   lockstep, the batch of the training phase's self-play; 32 sims, the
   flagship's int8 eval) grows a tree; K1 runs on the flagship's
   quantized block-0 weights at B=64 on that search's last leaf batch, and
   K2/K3 on the tree it leaves.  K4 runs on the same leaf batch as the
   stem (Cin=13, f32 in and out) and as the two convs of block 0 (C=256,
   bf16 in; the first bf16 out, the second with the residual, f32 and bf16
   out); K1 and K4 print their blocks, rates and yardsticks (bf16
   ``F.conv2d``; for K1 also ``torch._int_mm`` on the prebuilt im2col
   matrix, checked exact); K5 runs on that batch's trunk output with its
   legal mask (and is timed at 128, 512 and 1,024 played states); K6
   writes the node of one more simulation into that tree (also with the
   child's status drawn from running, draw and either winner: terminal
   children), and the roots of a fresh one.  Every kernel is then held again
   (comparison only) at the other batches the two paths launch (the play
   slice's 32 games, the arena's 16, the benchmark's 4 and 2:
   ``PATH_BATCHES``), on the first games of the same leaf batch, tree and
   roots; at 16, 4 and 2 games the conv kernels' last block holds fewer
   than 3 boards.  K2/K3 also at 1 and 33 games and on the main-path tree
   rewritten into ties (``tie_tree``: every legal action tied, rows with
   no legal action, attack sources with equal armies or none).  Then at
   larger shapes: K1 and K4 at B=1024, K1 also at 4,096 (self-play's
   batch; K1 prints its design and tiles per SM); K4 at the 512
   calibration features every int8 fold launches it on, in
   ``check_k4``'s three forms and in each conv of ``calibrate_trunk``
   (held against the plain conv on that conv's own inputs), and the
   activation scales that ``calibrate_trunk`` sets on K4 against those of
   the plain version; and K2/K3 on trees over 256 games grown by
   plain-version simulations and over 1,024 grown on the card (timed, with
   K2's path depths).  The rules kernels K7-K10 are held bit for bit on
   1,024 states of mixed Script/Random play (every phase, fortify ties,
   full lands, terminal games; ``mixed_states``), timed at GAMES and at
   1,024 (K8 also at the learner's batch, 512, and in its three forms:
   all three outputs, the features alone, legality and status), and
   compared at every batch of ``RULES_BATCHES`` (K7 also timed there); K7's
   expand entry on the main-path tree and its slices (timed at GAMES on
   it and on the training phase's tree).  The multi-step entry of K9 and
   K10 is timed (one launch of 64 iterations, per launch and per
   iteration) on 1,024 and 64 mirrored games 100 steps into a
   Script-vs-Script and a Script-vs-Random match, beside the single
   steps' kernels on the same states, and held on the mixed states for
   every pair of seat kinds.  K3 (visit and wsum) is held bit for bit.
   The training and data phases search at ``TRAIN``'s simulations: K2,
   K3, K6 and K7's expand are held on such a tree at each of their
   batches (``TRAIN_BATCHES``).  Under full cards (``CARDS``), K7's
   step, K9, K10 and the multi-step entry are held bit for bit on 1,024
   full-cards states (``card_states``: mixed play under full cards,
   three games in eight with hands and piles dealt anew, large hands,
   empty piles) at 64, 128 and 1,024 games, timed at 64 and 1,024, the
   multi-step entry also for every pair of seat kinds and timed 300
   steps into full-cards matches;
4. slice: the flagship 20x256 net, int8 fast path, 32 simulations, plays
   32 mirrored games against the ScriptPlayer to the end through
   ``Trainer.play`` (the first main path, launch counts read around it;
   the ScriptPlayer fast-forwards in blocks of the multi-step entry,
   whose launches, blocks and iterations per lockstep step are printed
   and a sample of whose launches is held against the plain multi-step
   function on the slice's own states), checks the int8 and bf16 forwards
   against the plain network on a small input, then runs a short bf16
   pass;
5. train: one iteration of ``Trainer.train`` from the flagship weights at
   full width (the second main path, launch counts read around it):
   self-play of 64 mirrored games with sampled moves, root noise and
   records on the int8 fast path, replay trim, learner epochs at batch
   size 512 on the 20x256 net, the gate arena with the paired eval, accept
   or revert, the benchmark matches, checkpoint and meta.  Simulations,
   game counts and the micro-step cap are cut (``TRAIN``), the width is
   not.  Then ``latest`` is reloaded and its folded evaluation compared
   with the in-memory one, and the replay npz is read back;
6. data: the supervised-bootstrap path (the third main path).  (a) One
   chunk of 128 steps of ``run_scripted_episodes``, Script vs Random, at
   B=1,024 from the mixed states, on the kernels and on the plain
   versions from the same draws: states, carries and records equal; K8
   on a learner batch of its records from the replay.  (b)
   ``play_match`` Script vs Script on 1,024 mirrored games to the end, in
   blocks of the multi-step entry (one launch per block, each held
   against the plain multi-step function; the live micro-steps are the
   sum of its step counts).
   (c) ``Trainer.train_on_data(loops=1)`` from the flagship at full
   width (``DATA``): 128 Script-vs-Script and 128 Script-vs-Random games,
   3 epochs at batch 512, the arena and the benchmark at the training
   phase's cut depth, ``temp``/``latest``/meta; launch counts read around
   it (K9 once per lockstep step of both scripted matches, K10 once per
   step of the Script-vs-Random one; the benchmark fast-forwards both
   opponents through the multi-step entry).  (d) ``play_match`` Script
   vs Random on 1,024 mirrored games to the end in blocks (the CLI's
   ``-m play --p1 sp --p2 rp``), held against the per-iteration loop on
   the plain versions from the same seed (tally, steps, rounds, live
   micro-steps).  The data path's launch counts are those of (b), (c)
   and (d);
7. cards: the full-cards paths, each held against the plain versions:
   (b) Script vs Script and (d) Script vs Random ``play_match`` on
   1,024 mirrored games to the end in blocks (against the per-iteration
   loop from the same seed: tally, steps, rounds, live micro-steps, and
   at least one trade), (a) a 128-step ``run_scripted_episodes`` chunk
   at the 1,024 full-cards states (states, carries, records equal), (e)
   400 steps of random legal play through ``rules.step_key`` on 1,024
   fresh deals (final states equal).  Its launch counts are those of
   (b), (d), (a) and (e);
8. reuse: tree reuse and the device replay ring on the flagship, int8.
   (a) One search under ``tree_reuse`` at 32 simulations (N = 66) on 64
   of phase 3's played states, each game rerooted through its played
   edge and searched again by ``search_with_reuse``: K2, K3 (visit and
   wsum), K6 and K7's expand held against their plain versions on the
   tree that search starts from, at GAMES and every batch of
   ``PATH_BATCHES``, and on the tree it leaves; the same at TRAIN's 8
   simulations (N = 18); ``reroot`` and the staleness select timed, the
   share of games reused printed.  (b) ``Trainer.play`` of PLAY_GAMES
   mirrored games against the ScriptPlayer under ``tree_reuse`` (decisions/s
   beside phase 4's, the share of searches that continued a carried
   tree).  (c) One ``Trainer.train`` iteration at TRAIN's cuts with
   ``device_replay`` and ``tree_reuse``: the ring after self-play equal
   to a host buffer fed the same records, the launch counts equal to what
   the step counts imply, ``latest`` reloaded and the replay npz read
   back by the host buffer; the ring's ingest and epochs timed beside the
   host buffer's on the same samples.  (d) ``cross_validate`` over (c)'s
   npz, 2 folds of at most 2 epochs at 20x256.  Its launch counts are
   those of (b) and (c);
9. watch: the game viewer with an AlphaZero seat on the card at B=1
   (``utils/watch.py::watch_game_az``: the plain 20x256 network restored
   from phase 5's ``latest``, one ``run_episodes`` call per micro-step).
   (a) az vs sp, every micro-step rendered, headless: at 32 simulations
   (the viewer's default) for WATCH_TIMED_STEPS micro-steps on the
   kernels, timed (seconds per AlphaZero decision); at TRAIN's 8 for
   WATCH_STEPS micro-steps (through the setup into the attack phase) once
   on the kernels and once under ``plain_versions()`` from the same seed:
   the printed boards and ``pi`` lines equal line for line.  Every run's
   launches equal what its micro-step count implies (``watch_launches``;
   none in the plain run).  (b) K2, K3, K6, K7 (step and expand), K8 (its
   three forms), K9 and K10 held against their plain versions at B=1 on
   (a)'s own roots, trees and ScriptPlayer inputs (every WATCH_HOLDS-th
   search of each run).  (c) az vs az, ``latest`` against ``best`` (the
   flagship saved as ``best`` if phase 5 left none) through the paired
   eval, WATCH_PAIRED_STEPS micro-steps.  (d) ``python -m
   alphazero_risk_tpu_torch.cli -m watch --p1 sp --p2 rp --no-pause`` as
   a subprocess: rc 0 and a final "wins in round" or "draw" line.  Its
   launch counts are those of (a) and (c);
10. world: a process world of two ranks (``parallel/distributed.py``),
   each a subprocess of this script (``--world-rank``): both on the one
   card under gloo, or one card each under NCCL where two are visible;
   the backend and devices are printed.  (a) ``Trainer.play`` of phase
   4's 32 mirrored games from phase 4's generator state (20x256, int8,
   32 simulations), 16 a rank: every game's final state and status,
   concatenated in rank order, equal phase 4's, and both ranks report
   phase 4's tally (the global draws and the fast-forward's agreement);
   (b) one ``Trainer.train`` iteration at TRAIN's cuts and the
   benchmark: the same ``pi_loss``/``v_loss`` every epoch and the same
   gate verdict on both ranks, ``training_samples.p0.npz`` and ``.p1.npz``
   written, the checkpoints written by rank 0 alone.  (a), (b), the
   fast-forward all-reduces per decision and the gradient all-reduce per
   learner step are timed.  A rank that fails or outlives WORLD_TIMEOUT
   fails the script.  Its launch counts are the two ranks' of (a) and
   (b).

The line before the card's is a JSON object with one entry per kernel:
``launches`` sums the seven main paths (play, train, data, cards, reuse,
watch, world), each also given alone (``launches_world`` both ranks'
launches in phase 10); the full-cards timings are the ``cards_*`` keys of
K7, K9, K10 and the multi-step entry.  The last line is ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

FLAGSHIP = Path(__file__).resolve().parent / "artifacts" / \
    "params-20block-r4-best.npz"
ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"      # checkpoints, replay, logs
GAMES = 64          # lockstep games of the kernel checks and of self-play
PLAY_GAMES = 32     # games of the play slice
SIMS = 32
# the training phase: depth cut, width kept
TRAIN = dict(mcts_simulations=8, train_iteration_games=GAMES, epochs=2,
             batch_size=512, compare_games=16, arena_early_stop_min_games=8,
             benchmark_games_random=2, benchmark_games_script=4,
             max_game_steps=640, actor_chunk_steps=64,
             use_dirichlet_noise=True)
# the data phase: the training phase's cuts, scripted generation as the
# reference's train-data mix cut from 5,000 + 5,000 to 128 + 128 games, a
# step cap every scripted game ends within
DATA = dict(TRAIN, data_games_ss=128, data_games_sr=128,
            env_batch_per_device=128, actor_chunk_steps=128,
            max_game_steps=2048)
MIXED = 1024        # states of the rules kernels' checks
# the full-cards part: its rules (a step cap every match's games end well
# within) and the steps of its random legal play
CARDS = dict(simple_cards=False, max_game_steps=4096)
CARD_PLAY_STEPS = 400
# every lockstep batch the two main paths launch the kernels at: self-play,
# the play slice, the arena and the two benchmark matches.  Timed at GAMES;
# the others are held against the plain versions only.
PATH_BATCHES = sorted({PLAY_GAMES, TRAIN["compare_games"],
                       TRAIN["benchmark_games_script"],
                       TRAIN["benchmark_games_random"]} - {GAMES},
                      reverse=True)
# ... and the rules kernels also at the data phase's scripted batch
RULES_BATCHES = sorted(set(PATH_BATCHES) | {DATA["env_batch_per_device"]},
                       reverse=True)
# the lockstep batches that search at TRAIN's simulations: self-play, the
# arena and the two benchmark matches of the training and data phases
TRAIN_BATCHES = sorted({GAMES, TRAIN["compare_games"],
                        TRAIN["benchmark_games_script"],
                        TRAIN["benchmark_games_random"]}, reverse=True)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak, data sheet
BF16_OPS_PER_S = 989e12       # dense bf16 tensor-core peak, data sheet
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores, data sheet


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


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time in ms of the CUDA kernel whose name contains
    ``kernel`` over ``reps`` calls of ``fn``, read from a torch.profiler
    trace.  ``time_ms`` times the wrapper's call back to back, so for a
    kernel of a few microseconds it reads the host's call cost; this reads
    the kernel alone.  None when the trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if kernel in e.key and e.self_device_time_total > 0]
    if not rows:
        return None
    return (sum(e.self_device_time_total for e in rows)
            / sum(e.count for e in rows) / 1e3)


@contextlib.contextmanager
def full_float32():
    """cuDNN's float32 convolutions without TF32 inside the block; the
    process-wide flag is put back on leaving it, so every later phase runs
    in the mode PyTorch gives the port's users."""
    import torch
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


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
            # ptxas's resources, and any wgmma it had to serialize
            if any(w in line for w in ("registers", "spill", "wgmma")):
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


def slice_tree(tree, n):
    """The first ``n`` games of ``tree`` (every array leads with the game
    axis), as contiguous copies."""
    import dataclasses
    from alphazero_risk_tpu_torch.env.state import GameState, tree_map
    return type(tree)(**{
        f.name: (tree_map(lambda x: x[:n].contiguous(), getattr(tree, f.name))
                 if isinstance(getattr(tree, f.name), GameState)
                 else getattr(tree, f.name)[:n].contiguous())
        for f in dataclasses.fields(tree)})


def tile_name(per):
    """The block shape of a K1 or K4 launch with ``per`` boards per block
    (csrc/conv_tc.cuh)."""
    return f"{per} boards ({per * 42} cells) x 64 channels"


def im2col_i8(q):
    """q [B,7,6,C] int8 -> the SAME-padded 3x3 patches [B*42, 9*C], K in
    (tap, channel) order: the left operand of K1's function as one int8
    matrix product (the library yardstick's input, built before timing)."""
    import torch
    b, c = q.shape[0], q.shape[-1]
    qp = torch.zeros((b, 9, 8, c), dtype=q.dtype, device=q.device)
    qp[:, 1:8, 1:7] = q
    taps = [qp[:, dy:dy + 7, dx:dx + 6] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=3).reshape(b * 42, 9 * c).contiguous()


def check_k1(folded, feats, timed=True):
    """K1 against its plain version on the leaf features ``feats``: the
    first block's conv_a (int8 out only) and conv_b (residual; f32 and int8
    out).  Returns the timed entry fields (conv_b's at the top, conv_a's
    under ``conv_a``), or None (the comparison alone) when ``timed`` is
    false."""
    import torch
    import torch.nn.functional as F
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.models import fast_infer as FI

    h = FI._stem(folded, feats)[0].contiguous()
    act_s, wq, ws, b = (folded["act_s"], folded["trunk_wqk"],
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
    per, tiles = FI.conv_tile(kernels.CONV3X3_I8, B, C)
    blocks = kernels.CONV3X3_I8.query("az_conv3x3_i8_blocks", B, C)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if per == 0:
        design = (f"wide design: {tiles} tiles of 64 rows x {C} channels "
                  f"on {blocks} persistent blocks ({sms} SMs), "
                  f"{tiles / sms:.2f} tiles per SM")
    else:
        design = (f"tiled design: {tiles} blocks of {tile_name(per)}, "
                  f"{tiles / sms:.2f} per SM")
    log(f"K1 conv3x3_i8 B={B} C={C}: acc exact, h max abs err {err:.3g}, "
        f"q max diff {dq}, |acc| max {int(acc_b.abs().max())}; {design}")
    if not timed:
        return None

    def run_a():
        FI.conv3x3_i8(*a_args, inv_s_next=inv[0, 1], want_h=False)

    def run_b():
        FI.conv3x3_i8(*b_args, residual=h, inv_s_next=inv[1, 0])

    def plain_b():
        acc = FI._conv_i8_plain(ref_q2, wq[0, 1])
        FI._epilogue_plain(acc, ws[0, 1], b[0, 1], act_s[0, 1], h, inv[1, 0])

    # yardsticks, neither used by the port: bf16 F.conv2d on the same
    # values, and the exact int8 product on the prebuilt im2col matrix
    xb = ref_q2.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = wq[0, 1].to(torch.bfloat16).permute(2, 3, 0, 1).contiguous()
    cols = im2col_i8(ref_q2)
    wmat = (wq[0, 1].reshape(9, C, C).permute(1, 0, 2).reshape(C, 9 * C)
            .contiguous().t())
    if not torch.equal(torch._int_mm(cols, wmat).reshape(ref_acc_b.shape),
                       ref_acc_b):
        fail("torch._int_mm on the im2col matrix is not the exact conv")

    ms_a, ms_b = time_ms(run_a, 50), time_ms(run_b, 50)
    dev_a = device_ms(run_a, "conv3x3_i8_kernel")
    dev_b = device_ms(run_b, "conv3x3_i8_kernel")
    plain = time_ms(plain_b, 3, warmup=1)
    lib = time_ms(lambda: F.conv2d(xb, wb, padding=1), 50)
    lib_int = time_ms(lambda: torch._int_mm(cols, wmat), 50)
    ops = 2.0 * M * 9 * C * C
    # bytes: q in, the residual in, h and q_next out (conv_b); q in, q_next
    # out (conv_a); the weight, scales and bias once
    nbytes = M * C * (1 + 4 + 4 + 1) + 9 * C * C + 8 * C + 8
    bms, by = bound_ms(nbytes, ops, INT8_OPS_PER_S)
    nbytes_a = M * C * 2 + 9 * C * C + 8 * C + 8
    bms_a, by_a = bound_ms(nbytes_a, ops, INT8_OPS_PER_S)

    def rate(t):
        return "not measured" if t is None else f"{ops / t / 1e9:.1f} TOP/s"

    log(f"K1 B={B} conv_a variant: {ms_a:.4f} ms, kernel alone "
        f"{fmt_ms(dev_a)} ({rate(dev_a)}; bound {bms_a:.5f} ms, {by_a}); "
        f"conv_b variant: {ms_b:.4f} ms, kernel alone {fmt_ms(dev_b)} "
        f"({rate(dev_b)}; bound {bms:.5f} ms, {by}); plain {plain:.3f} ms; "
        f"bf16 F.conv2d {lib:.4f} ms; torch._int_mm on im2col "
        f"{lib_int:.4f} ms")
    return {"max_abs_err": err, "ms": ms_b, "device_ms": dev_b,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_int, "library": "torch._int_mm (im2col)",
            "bf16_conv2d_ms": lib, "blocks": blocks, "tiles": tiles,
            "design": design, "tiles_per_sm": tiles / sms,
            "conv_a": {"ms": ms_a, "device_ms": dev_a, "bound_ms": bms_a,
                       "bound_by": by_a},
            "shape": f"B={B} C={C}"}


def check_k2_k3(tree, gum, cfg, dev, timed=True, what=""):
    """K2 and K3 against their plain versions on ``tree`` with one
    simulation's noise ``gum`` [max_depth, B, 3].  Returns the timed entry
    fields of each (with K2's path depths: its time per depth step), or
    None (the comparison alone) when ``timed`` is false."""
    import torch
    from alphazero_risk_tpu_torch.config import PH_ATTACK, SKIP_ACTION
    from alphazero_risk_tpu_torch.mcts import search as S

    B, N = tree.player.shape
    shape = f"B={B} N={N} D={cfg.max_depth}{what}"
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

    # K3 takes the leaf from the caller's tensors, or (the search's call)
    # from the tree's own leaf buffers, which it reads through the pack
    leaf_v = torch.rand(B, generator=torch.Generator(device=dev)
                        .manual_seed(7), device=dev) * 2 - 1
    leaf_p = tree.player[torch.arange(B, device=dev), path.cur.long()]
    pack_leaf = S._k6_pack(tree)[2]
    pack_leaf[0].copy_(leaf_v)
    pack_leaf[1].copy_(leaf_p)
    vk, wk = tree.visit.clone(), tree.wsum.clone()
    got = []
    for lv, lp in ((leaf_v, leaf_p), pack_leaf):
        S.backup(tree, path, lv, lp)
        got.append((tree.visit.clone(), tree.wsum.clone()))
        tree.visit.copy_(vk)
        tree.wsum.copy_(wk)
    S._backup_plain(tree, path, leaf_v, leaf_p)
    torch.cuda.synchronize()
    for vis_k, ws_k in got:
        if not torch.equal(vis_k, tree.visit):
            fail(f"K3 visit differs from the plain backup ({shape})")
        if not torch.equal(ws_k, tree.wsum):
            fail(f"K3 wsum differs from the plain backup ({shape})")
    err3 = float((ws_k - tree.wsum).abs().max())
    # sign flips on the paths: where the mover changes along an edge
    on_path = torch.arange(cfg.max_depth, device=dev)[None, :] < \
        depth[:, None]
    flips = int(((path.pp[:, 1:] != path.pp[:, :-1]) & on_path[:, 1:]).sum())
    log(f"K3 mcts_backup {shape}: visit and wsum equal; {flips} player "
        f"changes along the paths")
    if not timed:
        return None

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
    ms3 = time_ms(lambda: S.backup(tree, path, *pack_leaf), 50)
    ms3_caller = time_ms(lambda: S.backup(tree, path, leaf_v, leaf_p), 50)
    dev2 = device_ms(lambda: S.descend(tree, gum, cfg),
                     "mcts_descend_kernel")
    dev3 = device_ms(lambda: S.backup(tree, path, leaf_v, leaf_p),
                     "mcts_backup_kernel")
    plain2 = time_ms(lambda: S._descend_plain(tree, gum, cfg), 5)
    plain3 = time_ms(lambda: S._backup_plain(tree, path, leaf_v, leaf_p), 20)
    log(f"K2 {shape}: {ms2:.4f} ms (kernel alone {fmt_ms(dev2)}; bound "
        f"{k2_bound:.5f} ms) plain {plain2:.3f} ms; K3: {ms3:.4f} ms "
        f"(the caller's leaf tensors {ms3_caller:.4f} ms; kernel alone "
        f"{fmt_ms(dev3)}; bound {k3_bound:.6f} ms) plain {plain3:.3f} ms")
    return ({"max_abs_err": err2, "ms": ms2, "device_ms": dev2,
             "plain_ms": plain2,
             "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
             "shape": shape, "depth_mean": float(depth.float().mean()),
             "depth_max": int(depth.max())},
            {"max_abs_err": err3, "ms": ms3, "ms_caller": ms3_caller,
             "device_ms": dev3, "plain_ms": plain3,
             "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
             "shape": shape})


TIE_CASES = ("fresh_ties", "no_legal", "equal_armies", "no_source")


def tie_tree(tree, case):
    """A copy of ``tree`` rewritten so that K2's warp reductions meet
    ties: ``fresh_ties`` zeroes visits and values and spreads each row's
    prior evenly over its legal actions (every legal action ties in U, the
    first wins); ``no_legal`` also clears every legal row of the odd games
    (index 0 wins); ``equal_armies`` and ``no_source`` also put every node
    in the attack phase with 3 armies (the attack sources tie in army, the
    neighbour rank decides) or 1 army (no source: every land ties at -1)
    on every land."""
    import torch
    from alphazero_risk_tpu_torch.config import PH_ATTACK
    t = clone_tree(tree)
    t.visit.zero_()
    t.wsum.zero_()
    legal = t.legal.to(torch.float32)
    t.prior.copy_(legal / legal.sum(-1, keepdim=True).clamp(min=1))
    if case == "no_legal":
        t.legal[1::2] = False
    elif case in ("equal_armies", "no_source"):
        t.states.phase.fill_(PH_ATTACK)
        t.states.army.fill_(3 if case == "equal_armies" else 1)
    return t


def check_k4(folded, feats, timed=True):
    """K4 against its plain version at batch B on the leaf features
    ``feats``, in the three forms the paths launch: the stem (Cin=13, f32
    features in, f32 out), block 0's first conv (bf16 in, bf16 out only)
    and its second conv with the residual (bf16 in, f32 and bf16 out).
    Returns the timed entry fields: the stem's at the top (the shape the
    int8 main paths launch), the trunk forms under ``conv_a`` and
    ``conv_b``; or None (the comparison alone) when ``timed`` is false."""
    import torch
    import torch.nn.functional as F
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.models import fast_infer as FI

    # the plain version is a float32 cuDNN conv on bf16-valued inputs;
    # it is held and timed in full float32 (bf16 values are exact in TF32
    # too, so the flag moves its time, not its result)
    w, b = folded["trunk_w"], folded["trunk_b"]
    feats = feats.contiguous()
    with full_float32():
        h = FI._conv3x3_bf16_plain(feats, folded["stem_w"], folded["stem_b"])
        y = FI._conv3x3_bf16_plain(h, w[0, 0], b[0, 0])
    hb, yb = h.to(torch.bfloat16), y.to(torch.bfloat16)
    variants = {     # args, the outputs asked for (f32, bf16)
        "stem": ((feats, folded["stem_w"], folded["stem_b"], None),
                 (True, False)),
        "conv_a": ((hb, w[0, 0], b[0, 0], None), (False, True)),
        "conv_b": ((yb, w[0, 1], b[0, 1], h), (True, True)),
    }
    # the stem also writes the int8 trunk's first input: code for code
    # what _quantize makes of its f32 output (the same f32 product, rounded
    # half to even)
    inv = (1.0 / folded["act_s"][0, 0]) if "act_s" in folded else None
    out = {}
    for name, (args, (want_f32, want_bf16)) in variants.items():
        x, wt, bias, res = args
        full, got_bf, _ = FI.conv3x3_bf16(*args, want_bf16=True)
        if name == "stem" and inv is not None:
            _, _, got_q = FI.conv3x3_bf16(*args, want_f32=False,
                                          inv_s_next=inv)
            differ = int((got_q != FI._quantize(full, inv)).sum())
            if differ:
                fail(f"K4 stem: the int8 output differs from _quantize of "
                     f"the f32 one in {differ} codes")
        with full_float32():
            ref = FI._conv3x3_bf16_plain(*args)
        torch.cuda.synchronize()
        # Tolerance: bf16 x bf16 products are exact in float32, so kernel
        # and plain differ by the order of the float32 sums only: 1e-5 of
        # the largest output.  The bf16 output is the f32 one rounded to
        # nearest even.
        err, top = float((full - ref).abs().max()), float(ref.abs().max())
        if not err <= 1e-5 * top:
            fail(f"K4 {name} differs from the plain conv: max abs err "
                 f"{err} against max |out| {top}")
        if not torch.equal(got_bf, full.to(torch.bfloat16)):
            fail(f"K4 {name}: the bf16 output is not the f32 one rounded")
        B, cin, cout = x.shape[0], x.shape[-1], wt.shape[-1]
        m = B * 42
        per, blocks = FI.conv_tile(kernels.CONV3X3_BF16, B, cout)
        # bf16 F.conv2d on the same bf16 values, its output rounded to
        # bf16 and the epilogue in f32: the library's own error
        xl = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wl = wt.permute(3, 2, 0, 1).contiguous()

        def library():
            return F.conv2d(xl, wl, padding=1)

        lv = library().permute(0, 2, 3, 1).float() + bias
        lv = torch.relu(lv if res is None else lv + res)
        lib_err = float((lv - ref).abs().max())
        outs = "+".join(k for k, on in (("f32", want_f32),
                                         ("bf16", want_bf16)) if on)
        msg = (f"K4 conv3x3_bf16 {name} B={B} Cin={cin} Cout={cout} "
               f"({str(x.dtype)[6:]} in, {outs} out): max abs err "
               f"{err:.3g} (max |out| {top:.3g}; bf16 F.conv2d's own "
               f"{lib_err:.3g}); "
               f"{blocks} blocks of {tile_name(per)}")
        if not timed:
            log(msg)
            continue

        def run():
            FI.conv3x3_bf16(*args, want_f32=want_f32, want_bf16=want_bf16)

        ms = time_ms(run, 50)
        dev = device_ms(run, "conv3x3_bf16_kernel")
        with full_float32():
            plain = time_ms(lambda: FI._conv3x3_bf16_plain(*args), 20)
        lib = time_ms(library, 50)
        nbytes = (m * cin * x.element_size() + 9 * cin * cout * 2 + cout * 4
                  + (m * cout * 4 if res is not None else 0)
                  + m * cout * (4 * want_f32 + 2 * want_bf16))
        ops = 2.0 * m * 9 * cin * cout
        bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        rate = ("not measured" if dev is None
                else f"{ops / dev / 1e9:.2f} TFLOP/s")
        log(f"{msg}; {ms:.4f} ms, kernel alone {fmt_ms(dev)} ({rate}; bound "
            f"{bms:.5f} ms, {by}); plain {plain:.4f} ms; bf16 F.conv2d "
            f"{lib:.4f} ms")
        out[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib, "library_max_abs_err": lib_err,
                     "blocks": blocks, "tile": tile_name(per),
                     "shape": f"B={B} Cin={cin} Cout={cout}"}
        if name == "stem" and inv is not None:
            def run_q():
                FI.conv3x3_bf16(*args, inv_s_next=inv)

            ms_q = time_ms(run_q, 50)
            dev_q = device_ms(run_q, "conv3x3_bf16_kernel")
            bms_q, _ = bound_ms(nbytes + m * cout, ops, BF16_OPS_PER_S)
            log(f"K4 stem B={B} with the int8 output: {ms_q:.4f} ms, kernel "
                f"alone {fmt_ms(dev_q)} (bound {bms_q:.5f} ms)")
            out[name].update(ms_i8=ms_q, device_ms_i8=dev_q,
                             bound_ms_i8=bms_q)
    if not timed:
        return None
    return {**out["stem"], "conv_a": out["conv_a"], "conv_b": out["conv_b"]}


def check_calibration(folded, calib):
    """``calibrate_trunk`` on K4, each of its convs held against the plain
    version on the same inputs, then its activation scales against those of
    ``calibrate_trunk`` on the plain version (in full float32) from the
    same features, the scales every int8 result follows.  Returns their
    largest relative difference."""
    import torch
    from alphazero_risk_tpu_torch.models import fast_infer as FI

    def plain(x, w, bias, residual=None, want_f32=True, want_bf16=False,
              inv_s_next=None, out=None, out_q=None):
        # calibrate_trunk asks for neither the int8 output nor destinations
        v = FI._conv3x3_bf16_plain(x, w, bias, residual)
        return (v if want_f32 else None,
                v.to(torch.bfloat16) if want_bf16 else None, None)

    kernel = FI.conv3x3_bf16
    worst = [0.0]

    def held(x, w, bias, residual=None, want_f32=True, want_bf16=False,
             inv_s_next=None, out=None, out_q=None):
        # Tolerance: as in check_k4, 1e-5 of the largest output
        got, got_bf, _ = kernel(x, w, bias, residual, want_f32=True,
                                want_bf16=want_bf16)
        with full_float32():
            ref = FI._conv3x3_bf16_plain(x, w, bias, residual)
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        if not err <= 1e-5 * top:
            fail(f"K4 differs from the plain conv inside calibrate_trunk at "
                 f"B={x.shape[0]} Cin={x.shape[-1]}: max abs err {err} "
                 f"against max |out| {top}")
        worst[0] = max(worst[0], err / top)
        return (got if want_f32 else None), got_bf, None

    try:
        FI.conv3x3_bf16 = held
        got = FI.calibrate_trunk(folded, calib)["act_s"]
        FI.conv3x3_bf16 = plain
        with full_float32():
            ref = FI.calibrate_trunk(folded, calib)["act_s"]
    finally:
        FI.conv3x3_bf16 = kernel
    per = ((got - ref).abs() / ref).amax(dim=1)         # per block
    rel = float(per.max())
    log(f"calibrate_trunk on K4 ({calib.shape[0]} features, "
        f"{1 + 2 * ref.shape[0]} convs each within {worst[0]:.3g} of its "
        f"largest output of the plain conv): act_s against the plain "
        f"version's ({ref.numel()} scales), largest relative difference "
        f"{rel:.3g}, per block {[round(float(v), 7) for v in per]}")
    # Limits.  Each conv's f32 sums differ from the plain ones in the last
    # bits, so a bf16 input of a later conv can round to the other
    # neighbour (2^-8 relative); that grows with depth: 1.7e-3 on the
    # flagship, NVIDIA H100 80GB HBM3.  Block 0 reads the stem's output and
    # its bf16 copy only: 4e-7 there.  A wrong tile moves a largest
    # activation by far more than either limit.
    if not bool(torch.isfinite(got).all()):
        fail("calibrate_trunk's act_s is not finite on K4")
    if float(per[0]) > 1e-4 or rel > 1e-2:
        fail(f"calibrate_trunk's act_s on K4 moved from the plain version's "
             f"by {float(per[0]):.3g} in block 0 (limit 1e-4) and "
             f"{rel:.3g} overall (limit 1e-2)")
    return rel


def check_k5(folded, h, legal, timed=True):
    """K5 against its plain version on the trunk output ``h`` [B,42,C] of a
    leaf batch with its legal mask.  Returns the timed entry fields, or
    None (the comparison alone) when ``timed`` is false."""
    import torch
    from alphazero_risk_tpu_torch.models import fast_infer as FI

    h, legal = h.contiguous(), legal.contiguous()
    probs, value, logits = FI.heads_eval(folded, h, legal)
    rp, rv, rl = FI._heads_eval_plain(folded, h, legal)
    torch.cuda.synchronize()
    # Tolerance: float32 sums in another order and CUDA's expf and tanhf
    # against PyTorch's: 1e-5 of the largest logit (at least 1e-5) on the
    # logits, 1e-5 absolute on the value and the probabilities.
    top = max(float(rl.abs().max()), 1.0)
    e_l = float((logits - rl).abs().max())
    e_v = float((value - rv).abs().max())
    e_p = float((probs - rp).abs().max())
    if not (e_l <= 1e-5 * top and e_v <= 1e-5 and e_p <= 1e-5):
        fail(f"K5 differs from the plain heads: logits {e_l} (max |logit| "
             f"{top}), value {e_v}, probs {e_p}")
    if bool((probs[~legal] != 0).any()) or not torch.allclose(
            probs.sum(-1), torch.ones_like(value), atol=1e-5):
        fail("K5 probabilities are not a distribution over the legal moves")
    b, _, c = h.shape
    v = folded["val_d1_w"].shape[1]
    if not timed:
        log(f"K5 heads_eval B={b} C={c} V={v}: max abs err logits {e_l:.3g} "
            f"value {e_v:.3g} probs {e_p:.3g}")
        return None
    # the ten head tensors, each read once (the pack's zero padding is
    # not the function's work)
    wbytes = sum(folded[k].numel() * 4 for k in FI._HEAD_SHAPES)
    nbytes = h.numel() * 4 + wbytes + legal.numel() + b * (43 * 2 + 1) * 4
    ops = 2.0 * b * (42 * c * 3 + 84 * 43 + 42 * v + v)
    bms, by = bound_ms(nbytes, ops, F32_OPS_PER_S)
    ms = time_ms(lambda: FI.heads_eval(folded, h, legal), 50)
    dev = device_ms(lambda: FI.heads_eval(folded, h, legal),
                    "heads_eval_kernel")
    plain = time_ms(lambda: FI._heads_eval_plain(folded, h, legal), 20)
    err = max(e_l, e_v, e_p)
    log(f"K5 heads_eval B={b} C={c} V={v}: max abs err logits {e_l:.3g} "
        f"value {e_v:.3g} probs {e_p:.3g}; legal per row "
        f"{float(legal.sum(-1).float().mean()):.1f}; {ms:.4f} ms (bound "
        f"{bms:.5f} ms, {by}, {ms / bms:.1f}x; kernel alone {fmt_ms(dev)}); "
        f"plain {plain:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev,
            "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B={b} C={c} V={v}"}


def clone_tree(tree):
    import dataclasses
    import torch
    from alphazero_risk_tpu_torch.env.state import GameState, tree_map
    return type(tree)(**{
        f.name: (tree_map(torch.clone, getattr(tree, f.name))
                 if isinstance(getattr(tree, f.name), GameState)
                 else getattr(tree, f.name).clone())
        for f in dataclasses.fields(tree)})


def trees_differ(a, b):
    """Name of the first tree array (or state field) that differs."""
    import dataclasses
    import torch
    from alphazero_risk_tpu_torch.env.state import GameState
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, GameState):
            for sf in dataclasses.fields(GameState):
                if not torch.equal(getattr(x, sf.name), getattr(y, sf.name)):
                    return f"states.{sf.name}"
        elif not torch.equal(x, y):
            return f.name
    return None


def check_k6(tree, gum, root, cfg, eval_fn, timed=True):
    """K6 against its plain version: the node write of one more simulation
    on a clone of ``tree`` (the descent, child states, legality and network
    outputs of a real simulation), and the root write of a fresh tree over
    ``root``.  Pure copies: every array must be equal.  Returns the timed
    entry fields, or None (the comparison alone) when ``timed`` is false."""
    import torch
    from alphazero_risk_tpu_torch.mcts import search as S

    tree, ref = clone_tree(tree), clone_tree(tree)
    b, n = tree.player.shape
    path = S.descend(tree, gum, cfg)
    ins = S.expansion_inputs(tree, path, cfg, eval_fn)
    lv, lp = S.write_nodes(tree, *ins, path)
    rv, rp = S._write_nodes_plain(ref, *ins, path)
    torch.cuda.synchronize()
    if not (torch.equal(lv, rv) and torch.equal(lp, rp)):
        fail("K6 leaf value or player differs from the plain write")
    bad = trees_differ(tree, ref)
    if bad:
        fail(f"K6 tree array {bad} differs from the plain write")
    # terminal children: the same write with the child's status drawn from
    # running, draw and either winner (the node value K6 selects)
    status = torch.tensor([-1, -2, 0, 1], dtype=torch.int32,
                          device=lv.device)[torch.randint(
                              0, 4, (b,), device=lv.device,
                              generator=torch.Generator(device=lv.device)
                              .manual_seed(b))]
    tins = (ins[0], status, *ins[2:])
    kt, pt = clone_tree(ref), clone_tree(ref)
    tv, tp = S.write_nodes(kt, *tins, path)
    rv, rp = S._write_nodes_plain(pt, *tins, path)
    torch.cuda.synchronize()
    bad = trees_differ(kt, pt) or (
        None if torch.equal(tv, rv) and torch.equal(tp, rp) else "leaf")
    if bad:
        fail(f"K6 with terminal children: {bad} differs from the plain "
             f"write")
    root_done = tree.terminal[torch.arange(b, device=lv.device),
                              tree.root.long()]
    expanding = int(((path.exp_n >= 0) & ~root_done).sum())
    rins = S.root_inputs(root, cfg, eval_fn)
    kt, pt = S._empty_tree(root, cfg), S._empty_tree(root, cfg)
    S.write_nodes(kt, *rins)
    S._write_nodes_plain(pt, *rins, None)
    torch.cuda.synchronize()
    bad = trees_differ(kt, pt)
    if bad:
        fail(f"K6 root write: tree array {bad} differs from the plain write")
    if not timed:
        log(f"K6 write_nodes B={b} N={n}: all arrays equal (the expansion "
            f"write, {expanding}/{b} games expanding, with terminal "
            f"children, and the root write)")
        return None
    # bytes of the games that expand: each input read once and written
    # once into the node, plus the indices, the link and the leaf outputs
    node_bytes = sum(t[0].numel() * t.element_size()
                     for t in (*S._state_fields(ins[0]), *ins[1:]))
    nbytes = expanding * (2 * node_bytes + 8 + 4 + 4) + b * (4 * 4 + 1 + 8 + 8)
    bms, by = bound_ms(nbytes, 0.0, 1.0)
    ms = time_ms(lambda: S.write_nodes(tree, *ins, path), 50)
    plain = time_ms(lambda: S._write_nodes_plain(ref, *ins, path), 10)
    ms_root = time_ms(lambda: S.write_nodes(kt, *rins), 50)
    dev = device_ms(lambda: S.write_nodes(tree, *ins, path),
                    "write_nodes_kernel")
    log(f"K6 write_nodes B={b} N={n}: all arrays equal (the expansion "
        f"write, {expanding}/{b} games expanding, with terminal children, "
        f"and the root write); "
        f"{ms:.4f} ms (bound {bms:.6f} ms, {by}; kernel alone "
        f"{fmt_ms(dev)}); plain {plain:.3f} ms; root write {ms_root:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": dev,
            "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "ms_root": ms_root, "shape": f"B={b} N={n}"}


@contextlib.contextmanager
def plain_versions():
    """Inside the block the agents' single steps (K9, K10), the rules
    (K7's step, step_with_outcome and expand; K8's views, and with them
    legality, status and features) and the search's node write, descent
    and backup (K6, K2, K3) run their plain versions on the card: what the
    kernels are held against over a whole ``run_scripted_episodes`` chunk
    and a whole game of the viewer.  (The folded network's K1, K4, K5 and
    the multi-step entry keep their kernels.)"""
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.mcts import search as S

    def state_views(st, cfg, *, legal=False, status=False, features=False):
        return rules._state_views_plain(st, cfg, legal, status, features)

    def write_nodes(tree, src, status, value, legal, probs, path=None):
        return S._write_nodes_plain(tree, src, status, value, legal, probs,
                                    path)

    swaps = [(SA, "script_step_recorded", SA._script_step_recorded_plain),
             (RA, "random_step_recorded", RA._random_step_recorded_plain),
             (rules, "game_status", rules._game_status_plain),
             (rules, "legal_actions", rules._legal_actions_plain),
             (rules, "state_views", state_views),
             (rules, "step", rules._step_plain),
             (rules, "step_with_outcome", rules._step_with_outcome_plain),
             (rules, "expand", rules._expand_plain),
             (S, "descend", S._descend_plain),
             (S, "backup", S._backup_plain),
             (S, "write_nodes", write_nodes)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def first(mx, n):
    """The first ``n`` games of the mixed states ``mx``, as contiguous
    copies."""
    return mx.apply(lambda x: x[:n].contiguous())


def mixed_states(cfg, dev):
    """MIXED states drawn from every step of 128 games of mixed play on the
    card (``driver.mixed_play``, 600 steps), each with its step's script
    carry, previous mover, draws and a random legal action.  The pick keeps
    the states whose random action is a fortify move with a tie the DFS
    breaks (up to 160), with a full land (96) and terminal (96), and fills
    the rest evenly over the six phases; the order is shuffled, so every
    prefix is a mix."""
    import torch
    from alphazero_risk_tpu_torch.agents.driver import mixed_play
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import tree_map

    gen = torch.Generator(device=dev).manual_seed(12)
    b, steps = 128, 600
    pool = mixed_play(b, steps, cfg, gen)
    allst = pool.state
    n = allst.batch_size
    ties = torch.cat([rules.fortify_needs_rank(
        tree_map(lambda x: x[i:i + 8192], allst), pool.action[i:i + 8192],
        cfg) for i in range(0, n, 8192)])
    full = (allst.army >= cfg.land_army_max).any(-1)
    ended = rules._game_status_plain(allst, cfg) != -1
    key = torch.rand(n, generator=gen, device=dev)
    chosen = torch.zeros(n, dtype=torch.bool, device=dev)
    for flag, k in ((ties, 160), (full, 96), (ended, 96)):
        pick = torch.where(flag & ~chosen, key, 2.0).argsort()[:k]
        chosen[pick[flag[pick]]] = True
    live = ~ended
    for ph in range(6):
        want = (MIXED - int(chosen.sum())) // (6 - ph)
        flag = live & (allst.phase == ph) & ~chosen
        pick = torch.where(flag, key, 2.0).argsort()[:want]
        chosen[pick[flag[pick]]] = True
    idx = chosen.nonzero().ravel()
    idx = idx[torch.randperm(idx.numel(), generator=gen, device=dev)]
    mx = pool.apply(lambda x: x[idx].contiguous())
    st = mx.state
    phases = torch.bincount(st.phase.long(), minlength=6).tolist()
    n_ended = int((rules._game_status_plain(st, cfg) != -1).sum())
    n_full = int((st.army >= cfg.land_army_max).any(-1).sum())
    n_ties = int(rules.fortify_needs_rank(st, mx.action, cfg).sum())
    log(f"mixed states: {st.batch_size} of {n} ({steps} steps x {b} games), "
        f"per phase {phases}, terminal {n_ended}, with a full land {n_full}, "
        f"fortify ties under the random action {n_ties}")
    if st.batch_size != MIXED or min(phases) == 0 or not (
            n_ended and n_full and n_ties):
        fail("the mixed states do not cover every case")
    return mx


def card_states(cfg, dev):
    """MIXED full-cards states: ``mixed_states`` under ``cfg`` (full
    cards), then three games in eight with their card fields dealt anew by
    ``driver.force_card_cases`` (hands of 0-12 cards, piles empty, nearly
    empty or full, bonus lands at land_army_max - 1 and - 2), one of those
    three moved to the reinforcement phase (the trade) and one to the
    fortify phase (the draw)."""
    import numpy as np
    import torch
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.config import PH_FORTIFY, PH_REINFORCEMENT
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import tree_select
    mx = mixed_states(cfg, dev)
    st = mx.state
    n = st.batch_size
    slot = torch.arange(n, device=dev) % 8
    forced = D.force_card_cases(st, np.random.default_rng(5), cfg)
    forced = forced.replace(phase=torch.where(
        slot == 1, PH_REINFORCEMENT,
        torch.where(slot == 2, PH_FORTIFY, forced.phase)).to(torch.int32))
    st = tree_select(slot < 3, forced, st)
    mx = mx._replace(state=st)
    hand = rules._hand(st).sum(-1)
    empty = st.drawn_cards.all(-1)
    earning = int((empty & st.can_draw_card).sum())
    log(f"card states: {n} full-cards states, {int((slot < 3).sum())} "
        f"dealt anew; mover's hand > 3 cards in {int((hand > 3).sum())}, "
        f"empty pile in {int(empty.sum())} ({earning} earning a card), "
        f"reinforcement {int((st.phase == PH_REINFORCEMENT).sum())}, "
        f"fortify {int((st.phase == PH_FORTIFY).sum())}")
    return mx


def states_differ(a, b):
    """Name of the first GameState field that differs, or None."""
    import dataclasses
    import torch
    from alphazero_risk_tpu_torch.env.state import GameState
    for f in dataclasses.fields(GameState):
        if not torch.equal(getattr(a, f.name), getattr(b, f.name)):
            return f.name
    return None


def state_bytes(st):
    """Bytes of one game of the 12 fields the rules kernels read."""
    from alphazero_risk_tpu_torch.env import rules
    return sum(getattr(st, name)[0].numel() * getattr(st, name).element_size()
               for name, _, _ in rules.STATE_SPEC)


CARD_BYTES = 2 * 42 + 42    # player_cards and drawn_cards of one game


def game_bytes(st, cfg):
    """Bytes of one game that K7's step, K9, K10 and the multi-step entry
    read (and write): the 12 fields, and under full cards the card
    masks."""
    return state_bytes(st) + (0 if cfg.simple_cards else CARD_BYTES)


TABLE_BYTES = 2752      # rd::Tables, read once per call


def timed_entry(run, plain, kernel, nbytes, n, err=0.0, reps=50):
    """Call time, kernel-alone time and plain time of one kernel at batch
    ``n``, with its bytes bound (these kernels are bound by latency; the
    bound counts each input byte read and each output byte written once)."""
    ms = time_ms(run, reps)
    dev = device_ms(run, kernel)
    pl = time_ms(plain, 5, warmup=1)
    bms, by = bound_ms(nbytes, 0.0, 1.0)
    return {"max_abs_err": err, "ms": ms, "device_ms": dev, "plain_ms": pl,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B={n}"}


def check_k7(mx, cfg, timed=True):
    """K7 against its plain version: ``step`` with the dice (under full
    cards with the card uniform u[:, 3]) and, under simple cards,
    ``step_with_outcome`` with a battle outcome (the first die mod 3), on
    the random legal action."""
    import torch
    from alphazero_risk_tpu_torch.env import rules
    st, a, dice = mx.state, mx.action, mx.dice
    u_card = None if cfg.simple_cards else mx.u[:, 3].contiguous()
    o = dice[:, 0] % 3
    n = st.batch_size
    cases = [("step", lambda: rules.step(st, a, dice, cfg, u_card),
              lambda: rules._step_plain(st, a, dice, cfg, u_card))]
    if cfg.simple_cards:
        cases.append(("step_with_outcome",
                      lambda: rules.step_with_outcome(st, a, o, cfg),
                      lambda: rules._step_with_outcome_plain(st, a, o,
                                                             cfg)))
    for name, run, plain in cases:
        got, ref = run(), plain()
        torch.cuda.synchronize()
        bad = states_differ(got, ref)
        if bad:
            fail(f"K7 {name} field {bad} differs from the plain version at "
                 f"B={n}{'' if cfg.simple_cards else ' (full cards)'}")
    msg = (f"K7 rules_step B={n}: step and step_with_outcome equal"
           if cfg.simple_cards else
           f"K7 rules_step B={n}, full cards: step equal")
    if not timed:
        log(msg)
        return None
    e = timed_entry(cases[0][1], cases[0][2], "rules_step_kernel",
                    n * (2 * game_bytes(st, cfg) + 4 + 20
                         + (0 if u_card is None else 4)) + TABLE_BYTES, n)
    log(f"{msg}; {e['ms']:.4f} ms (kernel alone {fmt_ms(e['device_ms'])}; "
        f"bound {e['bound_ms']:.6f} ms) plain {e['plain_ms']:.3f} ms")
    return e


def check_k7_expand(tree, gum, cfg, timed=True):
    """K7's expand entry on ``tree`` (the node each game expands in the
    simulation with noise ``gum``): child state, status and legality."""
    import torch
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.mcts import search as S
    path = S.descend(tree, gum, cfg)
    args = (tree.states, path.exp_n, path.exp_a, path.exp_o, cfg)
    got, ref = rules.expand(*args), rules._expand_plain(*args)
    torch.cuda.synchronize()
    b, n = tree.player.shape
    bad = states_differ(got[0], ref[0])
    if bad or not (torch.equal(got[1], ref[1]) and torch.equal(got[2],
                                                               ref[2])):
        fail(f"K7 expand differs from the plain version (B={b} N={n}): "
             f"{bad or 'status or legal'}")
    msg = (f"K7 rules_step expand B={b} N={n}: child, status and legal "
           f"equal ({int((path.exp_n >= 0).sum())}/{b} expanding)")
    if not timed:
        log(msg)
        return None
    node = 2 * state_bytes(got[0]) + 3 * 42
    e = timed_entry(lambda: rules.expand(*args),
                    lambda: rules._expand_plain(*args), "rules_step_kernel",
                    b * (node + 12 + 4 + 43) + TABLE_BYTES, b)
    e["shape"] = f"B={b} N={n}"
    log(f"{msg}; {e['ms']:.4f} ms (kernel alone {fmt_ms(e['device_ms'])}; "
        f"bound {e['bound_ms']:.6f} ms) plain {e['plain_ms']:.3f} ms")
    return e


def check_k8(st, cfg, timed=True, what=""):
    """K8 against its plain versions on the states ``st``: each output
    alone, all three from one launch, and legality with status (features
    bit for bit, NaN where a share is 0/0)."""
    import torch
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.featurize import (_featurize_plain,
                                                        featurize)
    n = st.batch_size
    want = (rules._legal_actions_plain(st, cfg),
            rules._game_status_plain(st, cfg), _featurize_plain(st, cfg))
    alone = (rules.legal_actions(st, cfg), rules.game_status(st, cfg),
             featurize(st, cfg))
    both = rules.state_views(st, cfg, legal=True, status=True, features=True)
    pair = rules.state_views(st, cfg, legal=True, status=True)
    torch.cuda.synchronize()
    for got in (alone, both, pair):
        for name, g, w in zip(("legal", "status", "features"), got, want):
            if not (torch.equal(torch.isnan(g), torch.isnan(w))
                    and torch.equal(g.nan_to_num(), w.nan_to_num())):
                fail(f"K8 {name} differs from the plain version at B={n}")
    nan_games = int(torch.isnan(want[2]).flatten(1).any(-1).sum())
    msg = (f"K8 state_views B={n}{what}: legal, status and features equal, "
           f"alone, all three together and legal with status ({nan_games} "
           f"games with a 0/0 share)")
    log(msg)
    if not timed:
        return None

    def read(names):
        return sum(getattr(st, f)[0].numel() * getattr(st, f).element_size()
                   for f in names)

    # the three forms the paths launch: each reads its fields and writes
    # its outputs once per game, and the board tables once
    feat = want[2][0].numel() * 4
    board = ("owner", "army", "phase", "cur_player")
    forms = (
        ("all three", (True, True, True), rules.VIEW_FIELDS, 43 + 4 + feat),
        ("features", (False, False, True), board + (
            "can_draw_card", "attacks_during_turn")
            + (("round",) if cfg.feature_version == 3 else ()), feat),
        ("legal and status", (True, True, False),
         board + ("round", "mob_from", "mob_to"), 43 + 4))
    out = {}
    for name, (lg, stt, ft), fields, written in forms:
        e = timed_entry(
            lambda: rules.state_views(st, cfg, legal=lg, status=stt,
                                      features=ft),
            lambda: rules._state_views_plain(st, cfg, lg, stt, ft),
            "state_views_kernel", n * (read(fields) + written) + TABLE_BYTES,
            n)
        log(f"K8 B={n} {name}: {e['ms']:.4f} ms (kernel alone "
            f"{fmt_ms(e['device_ms'])}; bound {e['bound_ms']:.6f} ms) plain "
            f"{e['plain_ms']:.3f} ms")
        out[name] = e
    e = out.pop("all three")
    e["features"], e["legal_status"] = out["features"], out["legal and status"]
    return e


def check_k9_k10(mx, cfg, timed=True):
    """K9 and K10 against their plain versions on the mixed states with
    their carries, resets and draws."""
    import dataclasses
    import torch
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    st, n = mx.state, mx.state.batch_size
    args9 = (st, mx.carry, mx.reset, mx.u, mx.dice, cfg)
    s9, c9, r9 = SA.script_step_recorded(*args9)
    p9, pc9, pr9 = SA._script_step_recorded_plain(*args9)
    s10, r10 = RA.random_step_recorded(st, mx.u, mx.dice, cfg)
    p10, pr10 = RA._random_step_recorded_plain(st, mx.u, mx.dice, cfg)
    torch.cuda.synchronize()
    bad9 = states_differ(s9, p9) or next(
        (f.name for f in dataclasses.fields(SA.ScriptCarry)
         if not torch.equal(getattr(c9, f.name), getattr(pc9, f.name))),
        None) or ("action/record" if not all(
            torch.equal(x, y) for x, y in zip(r9, pr9)) else None)
    if bad9:
        fail(f"K9 script_step {bad9} differs from the plain version at B={n}")
    bad10 = states_differ(s10, p10) or ("action/record" if not all(
        torch.equal(x, y) for x, y in zip(r10, pr10)) else None)
    if bad10:
        fail(f"K10 random_step {bad10} differs from the plain version at "
             f"B={n}")
    msg = (f"K9 script_step / K10 random_step B={n}"
           f"{'' if cfg.simple_cards else ', full cards'}: state, carry, "
           f"action and record equal")
    if not timed:
        log(msg)
        return None
    sb = game_bytes(st, cfg)
    e9 = timed_entry(lambda: SA.script_step_recorded(*args9),
                     lambda: SA._script_step_recorded_plain(*args9),
                     "script_step_kernel",
                     n * (2 * sb + 2 * 9 + 1 + 16 + 20 + 5) + TABLE_BYTES, n)
    e10 = timed_entry(lambda: RA.random_step_recorded(st, mx.u, mx.dice, cfg),
                      lambda: RA._random_step_recorded_plain(st, mx.u,
                                                             mx.dice, cfg),
                      "random_step_kernel",
                      n * (2 * sb + 16 + 20 + 5) + TABLE_BYTES, n)
    log(f"{msg}; K9 {e9['ms']:.4f} ms (kernel alone "
        f"{fmt_ms(e9['device_ms'])}; bound {e9['bound_ms']:.6f} ms) plain "
        f"{e9['plain_ms']:.3f} ms; K10 {e10['ms']:.4f} ms (kernel alone "
        f"{fmt_ms(e10['device_ms'])}; bound {e10['bound_ms']:.6f} ms) "
        f"plain {e10['plain_ms']:.3f} ms")
    return e9, e10


@contextlib.contextmanager
def watched_blocks(keep=0, every=1):
    """Inside the block every call of the multi-step entry
    (``blocks.agent_steps``) and of the block loop around it
    (``run_agent_blocks``) is counted: the loops' iterations and blocks
    in ``w["iterations"]`` and ``w["blocks"]``, each loop's iterations in
    ``w["lengths"]``, the entry's step counts summed on the card in
    ``w["steps"]`` (the live micro-steps), and every ``every``-th call of
    the entry, up to ``keep``, with its inputs and outputs in
    ``w["calls"]`` (for ``hold_agent_steps``; held after the run, by the
    plain version alone, so no launch is added)."""
    from alphazero_risk_tpu_torch.agents import blocks as AB
    w = {"iterations": 0, "blocks": 0, "runs": 0, "steps": 0, "calls": [],
         "n": 0, "lengths": []}
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
        w["lengths"].append(out[3])
        w["blocks"] += out[4]
        w["runs"] += 1
        return out

    AB.agent_steps, AB.run_agent_blocks = steps, run
    try:
        yield w
    finally:
        AB.agent_steps, AB.run_agent_blocks = steps_fn, run_fn


def kinds_name(kinds):
    return "-".join(("AZ", "Script", "Random")[k] for k in kinds)


def hold_agent_steps(calls, what):
    """The multi-step entry's outputs of ``calls`` (from
    ``watched_blocks``) against the plain multi-step function on the same
    inputs: state, carry, prev and step counts bit for bit."""
    import dataclasses
    import torch
    from alphazero_risk_tpu_torch.agents import blocks as AB
    from alphazero_risk_tpu_torch.agents.script_agent import ScriptCarry
    games = steps = 0
    for a, kw, out in calls:
        ref = AB._agent_steps_plain(*a, **kw)
        torch.cuda.synchronize()
        bad = states_differ(out[0], ref[0]) or next(
            (f"carry {f.name}" for f in dataclasses.fields(ScriptCarry)
             if not torch.equal(getattr(out[1], f.name),
                                getattr(ref[1], f.name))), None) or (
            None if torch.equal(out[2], ref[2]) and torch.equal(out[3],
                                                               ref[3])
            else "prev or n")
        if bad:
            fail(f"agent_steps {what}: {bad} differs from the plain "
                 f"multi-step function (k={a[3].shape[0]}, "
                 f"B={out[3].numel()}, kinds {kinds_name(a[6])})")
        games += out[3].numel()
        steps += int(out[3].sum())
    log(f"agent_steps {what}: {len(calls)} launches held against the "
        f"plain multi-step function ({games} games, {steps} steps): state, "
        f"carry, prev and step counts equal")


def check_agent_steps(cfg, dev, b=MIXED, k=64, warm=100, kinds=(1, 1)):
    """The multi-step entry timed on ``b`` mirrored games ``warm`` steps
    into a match of the seat ``kinds`` (data (b)'s start for two
    ScriptPlayers, the CLI's ``--p1 sp --p2 rp`` for (1, 2)), one launch
    of ``k`` iterations, against the plain multi-step function on the
    same inputs: the call, the kernel alone, per launch and per iteration,
    beside the single steps' kernels alone on the same states (the
    per-iteration cost of the loop it replaces)."""
    import torch
    from alphazero_risk_tpu_torch.agents import blocks as AB
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.agents.common import BlockDraws
    gen = torch.Generator(device=dev).manual_seed(31)
    st = D.mirrored_initial_states(b, generator=gen, device=dev)
    carry = SA.init_carry(b, dev)
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)
    draws = BlockDraws(gen, b, dev)
    u, dice = draws.block(warm)
    st, carry, prev, _ = AB.agent_steps(st, carry, prev, u, dice, cfg, kinds)
    u, dice = draws.block(k)
    args = (st, carry, prev, u, dice, cfg, kinds)
    out = AB.agent_steps(*args)
    name = kinds_name(kinds) + ("" if cfg.simple_cards else " full cards")
    hold_agent_steps([(args, {}, out)], f"B={b} k={k} {name}")
    n = int(out[3].sum())
    sb = game_bytes(st, cfg)
    # state, carry (9 bytes) and prev read and written once, the step
    # counts written, and the draws of the steps taken (at least u[0] and
    # the 5 dice)
    nbytes = b * (2 * (sb + 9 + 4) + 4) + n * (4 + 20) + TABLE_BYTES
    e = timed_entry(lambda: AB.agent_steps(*args),
                    lambda: AB._agent_steps_plain(*args),
                    "agent_steps_kernel", nbytes, b, reps=20)
    reset = st.cur_player != prev
    singles = {}
    if 1 in kinds:
        singles["script"] = device_ms(lambda: SA.script_step_recorded(
            st, carry, reset, u[0], dice[0], cfg), "script_step_kernel")
    if 2 in kinds:
        singles["random"] = device_ms(lambda: RA.random_step_recorded(
            st, u[0], dice[0], cfg), "random_step_kernel")
    e.update(shape=f"B={b} k={k} {name}", steps=n,
             device_ms_per_iteration=(None if e["device_ms"] is None
                                      else e["device_ms"] / k),
             single_step_device_ms=singles)
    log(f"agent_steps B={b} k={k} {name} ({n} game-steps): "
        f"{e['ms']:.4f} ms per launch (kernel alone {fmt_ms(e['device_ms'])}"
        f", {fmt_ms(e['device_ms_per_iteration'])} per iteration; the "
        f"single steps alone "
        f"{ {a: fmt_ms(t) for a, t in singles.items()} }); bound "
        f"{e['bound_ms']:.6f} ms; plain {e['plain_ms']:.3f} ms")
    return e


def hold_agent_steps_mixed(mx, cfg, k=16):
    """The multi-step entry on the mixed states with their carries and
    previous movers, for every pair of seat kinds (an AlphaZero seat
    beside either agent, two agents), against the plain multi-step
    function: comparison only."""
    import torch
    from alphazero_risk_tpu_torch.agents import blocks as AB
    from alphazero_risk_tpu_torch.agents.common import BlockDraws
    dev = mx.prev.device
    b = mx.state.batch_size
    u, dice = BlockDraws(torch.Generator(device=dev).manual_seed(33), b,
                         dev).block(k)
    calls = []
    for kinds in ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0), (1, 2), (2, 1),
                  (2, 2)):
        args = (mx.state, mx.carry, mx.prev, u, dice, cfg, kinds)
        calls.append((args, {}, AB.agent_steps(*args)))
    hold_agent_steps(calls, f"on the {b} mixed states, every pair of seat "
                            f"kinds, k={k}")


def match_by_iteration(gen, state, agents, cfg, max_steps):
    """The per-iteration ``play_match`` loop the blocks replace, on the
    plain versions: every iteration draws, both seats' agents step every
    game, each game keeps its mover's state and carry, and the status
    check at the top of each iteration syncs once and counts the live
    micro-steps.  Returns (final state, steps, live micro-steps)."""
    import torch
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.agents.common import draw_step_randoms
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import tree_select
    b, dev = state.batch_size, state.phase.device
    carry = SA.init_carry(b, dev)
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)

    def agent_step(kind, state, carry, reset, u, dice):
        if kind == D.AGENT_SCRIPT:
            return SA._script_step_recorded_plain(state, carry, reset, u,
                                                  dice, cfg)[:2]
        return RA._random_step_recorded_plain(state, u, dice, cfg)[0], carry

    t = live = 0
    while t < max_steps:
        alive = int((rules._game_status_plain(state, cfg) == -1).sum())
        if not alive:
            break
        live += alive
        u, dice = draw_step_randoms(gen, b, dev)
        reset = state.cur_player != prev
        s0, c0 = agent_step(agents[0], state, carry, reset, u, dice)
        s1, c1 = (s0, c0) if agents[1] == agents[0] else agent_step(
            agents[1], state, carry, reset, u, dice)
        mover0 = state.cur_player == 0
        prev = state.cur_player
        state = tree_select(mover0, s0, s1)
        carry = tree_select(mover0, c0, c1)
        t += 1
    return state, t, live


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


def card_grown_tree(states, cfg, dev):
    """Trees over every game of ``states`` grown on the card by 8
    simulations (the kernels) with the stand-in network."""
    import torch
    from alphazero_risk_tpu_torch.mcts import search as S

    scfg, b = cfg.replace(mcts_simulations=8), states.batch_size
    grow = S.draw_gumbel(torch.Generator(device=dev).manual_seed(5), scfg,
                         b, dev)
    t0 = time.perf_counter()
    tree = S.search(states, grow, scfg, heuristic_eval).tree
    torch.cuda.synchronize()
    log(f"K2/K3 trees: {b} games x {scfg.mcts_simulations} sims on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    return tree


def main_path_tree(trainer, states, cfg):
    """The tree left after one search of a main path: GAMES games, the
    flagship's int8 eval, ``cfg``'s simulations, on the card."""
    import torch
    from alphazero_risk_tpu_torch.env.state import tree_map
    from alphazero_risk_tpu_torch.mcts import search as S

    dev = trainer.device
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


def check_train_trees(trainer, states, dev):
    """The training and data phases search at TRAIN's simulations: K7's
    expand, K2, K3 and K6 held on such a tree (N = sims + 2) at each of
    their lockstep batches (``TRAIN_BATCHES``), comparison only but K7's
    expand at GAMES, whose timed entry is returned."""
    import torch
    from alphazero_risk_tpu_torch.env.state import tree_map
    from alphazero_risk_tpu_torch.mcts import search as S

    cfg = trainer._ecfg.replace(**{k: v for k, v in TRAIN.items()
                                   if k != "use_dirichlet_noise"})
    tree = main_path_tree(trainer, states, cfg)
    gum = S.draw_gumbel(torch.Generator(device=dev).manual_seed(10), cfg,
                        GAMES, dev)[0]
    timed = None
    for nb in TRAIN_BATCHES:
        ntree, ngum = slice_tree(tree, nb), gum[:, :nb].contiguous()
        e = check_k7_expand(ntree, ngum, cfg, timed=nb == GAMES)
        timed = e or timed
        check_k2_k3(clone_tree(ntree), ngum, cfg, dev, timed=False)
        check_k6(ntree, ngum, tree_map(lambda x: x[:nb].contiguous(), states),
                 cfg, trainer._eval_fn(), timed=False)
    return timed


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
    version on the card.  Returns (trainer, kernel entries, the mixed
    states of the rules kernels' checks, the full-cards states, and the
    1,024 random-play states that phase 8 roots its rerooted trees in)."""
    import torch
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.featurize import featurize
    from alphazero_risk_tpu_torch.env.state import tree_map
    from alphazero_risk_tpu_torch.mcts import search as S
    from alphazero_risk_tpu_torch.models import fast_infer as FI
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
    mtree = main_path_tree(trainer, states, trainer._ecfg)
    rows = torch.arange(GAMES, device=dev)
    leaves = tree_map(lambda x: x[rows, (mtree.next_free - 1).long()],
                      mtree.states)
    with torch.inference_mode():
        lfeats = featurize(leaves, cfg)
        k1 = check_k1(folded, lfeats)
        mgum = S.draw_gumbel(torch.Generator(device=dev).manual_seed(6),
                             cfg, GAMES, dev)[0]
        k2, k3 = check_k2_k3(mtree, mgum, cfg, dev)
        k4 = check_k4(folded, lfeats)
        llegal = rules.legal_actions(leaves, cfg)
        k5 = check_k5(folded, FI._trunk_out(folded, lfeats, True), llegal)
        k6 = check_k6(mtree, mgum, tree_map(
            lambda x: x[:GAMES].contiguous(), states), cfg,
            trainer._eval_fn())
        # the other batches the main paths launch: the first nb games of
        # the same leaf batch, tree and roots, comparison only
        for nb in PATH_BATCHES:
            nfeats = lfeats[:nb].contiguous()
            ngum = mgum[:, :nb].contiguous()
            check_k1(folded, nfeats, timed=False)
            check_k2_k3(slice_tree(mtree, nb), ngum, cfg, dev, timed=False)
            check_k4(folded, nfeats, timed=False)
            check_k5(folded, FI._trunk_out(folded, nfeats, True),
                     llegal[:nb], timed=False)
            check_k6(slice_tree(mtree, nb), ngum, tree_map(
                lambda x: x[:nb].contiguous(), states), cfg,
                trainer._eval_fn(), timed=False)
        # K2 also at ragged batches (one game; a warp past a block of
        # four) and on the main-path tree rewritten into ties
        for nb in (1, GAMES // 2 + 1):
            check_k2_k3(slice_tree(mtree, nb), mgum[:, :nb].contiguous(),
                        cfg, dev, timed=False)
        for case in TIE_CASES:
            check_k2_k3(tie_tree(mtree, case), mgum, cfg, dev, timed=False,
                        what=f" {case}")
        # the larger shapes: K1 and K4 at B=1024, K1 at self-play's 4,096
        # (the played states four times), K2/K3 over 256 games
        feats1024 = featurize(states, cfg)
        k1["b1024"] = check_k1(folded, feats1024)
        k1["b4096"] = check_k1(folded,
                               feats1024.repeat(4, 1, 1, 1).contiguous())
        k4["b1024"] = check_k4(folded, feats1024)
        # K5 at the data phase's batch (128), the calibration batch (512)
        # and 1,024, on the trunk output of played states
        legal1024 = rules.legal_actions(states, cfg)
        for nb in (DATA["env_batch_per_device"], 512, 1024):
            k5[f"b{nb}"] = check_k5(
                folded, FI._trunk_out(folded, feats1024[:nb].contiguous(),
                                      True), legal1024[:nb])
        # the int8 scales K4 sets, from the trainer's calibration features,
        # the batch every int8 fold launches K4 at (512)
        calib = FI.default_calib_feats(
            cfg, torch.Generator(device=dev).manual_seed(17), device=dev)
        check_k4(folded, calib, timed=False)
        k4["act_s_max_rel_diff"] = check_calibration(folded, calib)
        gum = S.draw_gumbel(torch.Generator(device=dev).manual_seed(6), cfg,
                            256, dev)[0]
        k2["g256"], k3["g256"] = check_k2_k3(
            plain_grown_tree(states, cfg, dev), gum, cfg, dev)
        gum = S.draw_gumbel(torch.Generator(device=dev).manual_seed(6), cfg,
                            states.batch_size, dev)[0]
        k2["g1024"], k3["g1024"] = check_k2_k3(
            card_grown_tree(states, cfg, dev), gum, cfg, dev)
        # the rules kernels: timed at GAMES and at MIXED, K7's expand entry
        # on the main-path tree, then held at every other path batch
        mx = mixed_states(cfg, dev)
        k7 = check_k7(first(mx, GAMES), cfg)
        k7["b1024"] = check_k7(mx, cfg)
        k7["expand"] = check_k7_expand(mtree, mgum, cfg)
        k8 = check_k8(first(mx, GAMES).state, cfg)
        k8["b1024"] = check_k8(mx.state, cfg)
        k9, k10 = check_k9_k10(first(mx, GAMES), cfg)
        k9["b1024"], k10["b1024"] = check_k9_k10(mx, cfg)
        ks = check_agent_steps(cfg, dev)
        ks["b64"] = check_agent_steps(cfg, dev, b=GAMES)
        ks["script_random"] = check_agent_steps(cfg, dev, kinds=(1, 2))
        ks["script_random_b64"] = check_agent_steps(cfg, dev, b=GAMES,
                                                    kinds=(1, 2))
        hold_agent_steps_mixed(mx, cfg)
        hold_agent_steps_mixed(first(mx, GAMES), cfg)
        for nb in RULES_BATCHES:
            k7[f"b{nb}"] = check_k7(first(mx, nb), cfg)
            check_k8(first(mx, nb).state, cfg, timed=False)
            check_k9_k10(first(mx, nb), cfg, timed=False)
            if nb < GAMES:
                check_k7_expand(slice_tree(mtree, nb),
                                mgum[:, :nb].contiguous(), cfg, timed=False)
        # K8 at the learner's batch (on its real input in the data phase)
        k8["b512"] = check_k8(first(mx, TRAIN["batch_size"]).state, cfg)
        k7["expand_train"] = check_train_trees(trainer, states, dev)
        # the full-cards rules on their own states
        ccfg = cfg.replace(**CARDS)
        cmx = card_states(ccfg, dev)
        cards = check_cards_kernels(cmx, ccfg)
        for k, timings in ((k7, cards["rules_step"]),
                           (k9, cards["script_step"]),
                           (k10, cards["random_step"]),
                           (ks, cards["agent_steps"])):
            k.update(timings)
    entries = [
        {"name": "conv3x3_i8", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/conv_i8.cu",
         "replaces": "alphazero_risk_tpu/models/fast_infer.py:111", **k1},
        {"name": "mcts_descend", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/mcts_descend.cu",
         "replaces": "alphazero_risk_tpu/mcts/search.py:177", **k2},
        {"name": "mcts_backup", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/mcts_backup.cu",
         "replaces": "alphazero_risk_tpu/mcts/search.py:264", **k3},
        {"name": "conv3x3_bf16", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/conv_bf16.cu",
         "replaces": "alphazero_risk_tpu/models/fast_infer.py:101", **k4},
        {"name": "heads_eval", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/heads_softmax.cu",
         "replaces": "alphazero_risk_tpu/models/fast_infer.py:215", **k5},
        {"name": "write_nodes", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/tree_write.cu",
         "replaces": "alphazero_risk_tpu/mcts/search.py:221", **k6},
        {"name": "rules_step", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/rules_step.cu",
         "replaces": "alphazero_risk_tpu/env/rules.py:735", **k7},
        {"name": "state_views", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/state_views.cu",
         "replaces": "alphazero_risk_tpu/env/rules.py:160", **k8},
        {"name": "script_step", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/script_step.cu",
         "replaces": "alphazero_risk_tpu/agents/script_agent.py:106", **k9},
        {"name": "random_step", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/random_step.cu",
         "replaces": "alphazero_risk_tpu/agents/random_agent.py:41", **k10},
        {"name": "agent_steps", "route": "cuda",
         "source": "alphazero_risk_tpu_torch/csrc/agent_steps.cu",
         "replaces": "alphazero_risk_tpu/training/actor.py:204", **ks},
    ]
    check_forward(trainer, states, cfg)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    return trainer, entries, mx, cmx, states


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


def phase_slice(trainer, entries, games=PLAY_GAMES):
    """The main path (Trainer.play, int8, to the end), then a short bf16
    pass.  Fills each entry's main-path launch count.  Returns the
    decisions/s and what phase 10 holds its world against: the generator's
    state the play started from, its tally and every game's final state
    and status (``WORK/world/slice.pt``)."""
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    cfg, dev = trainer.cfg, trainer.device
    steps0 = trainer.play_stats["steps"]
    gen_state = trainer.gen.get_state()
    waves = recorded_waves(trainer)
    with watched_blocks(keep=24, every=12) as ff:
        kernels.reset_counts()
        res = trainer.play(A.OPP_SCRIPT, games)
        counts = kernels.counts()
    del trainer._episode_loop
    (WORK / "world").mkdir(parents=True, exist_ok=True)
    torch.save({"gen_state": gen_state, "tally": res, "waves": waves},
               WORK / "world" / "slice.pt")
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
    # every kernel but the agents' single steps: the ScriptPlayer only
    # fast-forwards, through the multi-step entry
    for k in kernels.ALL:
        if k not in (kernels.RANDOM_STEP, kernels.SCRIPT_STEP) and \
                counts[k.name] <= 0:
            fail(f"kernel {k.name} was not launched on the main path")
    lock = st["steps"] - steps0
    log(f"slice int8: K9 launches: single step {counts['script_step']}, "
        f"multi-step {counts['agent_steps']} in {ff['runs']} "
        f"fast-forwards over {lock} lockstep steps; {ff['iterations']} "
        f"fast-forward iterations ({ff['iterations'] / lock:.2f} per "
        f"lockstep step), {ff['blocks']} blocks "
        f"({ff['blocks'] / lock:.2f} per lockstep step), "
        f"{int(ff['steps'])} live game-steps")
    lens = sorted(ff["lengths"])
    log(f"slice int8: iterations of one fast-forward: "
        f"{[lens[int(q * (len(lens) - 1))] for q in (0, .1, .5, .9, 1)]} "
        f"(min, 10th, 50th, 90th percentile, max), "
        f"{sum(n == 0 for n in lens)} of {len(lens)} none, "
        f"{sum(n > A.FF_BLOCK for n in lens)} above the first block "
        f"({A.FF_BLOCK})")
    if counts["agent_steps"] != ff["blocks"]:
        fail(f"the multi-step entry launched {counts['agent_steps']} "
             f"times for {ff['blocks']} blocks")
    hold_agent_steps(ff["calls"], "on the slice's fast-forward states")
    for e in entries:
        e["launches_play"] = counts[e["name"]]

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
    return dps


def recorded_waves(trainer):
    """Record every wave ``trainer._episode_loop`` drives, on the CPU: its
    final state, statuses and starters (in the list returned; ``del
    trainer._episode_loop`` ends it)."""
    import dataclasses
    waves = []
    loop = trainer._episode_loop

    def recorded(chunk_call, state0, *a, **kw):
        out = loop(chunk_call, state0, *a, **kw)
        waves.append({"status": out.status.cpu(),
                      "started": state0.cur_player.cpu(),
                      "state": {f.name: getattr(out.state, f.name).cpu()
                                for f in dataclasses.fields(out.state)}})
        return out
    trainer._episode_loop = recorded
    return waves


def expected_launches(st, sims, blocks):
    """Launches of the search kernels, the network kernels and K7 implied
    by the lockstep searches (``steps``, of which ``paired_steps`` ran two
    nets) and the folds of a run: each search evaluates its root and one
    node per simulation, expands (K7) once per simulation, and its move is
    one more K7 launch.  K8 (statuses, features of every evaluation and of
    the learner's batches) and the opponents' K9/K10 depend on the run."""
    evals = (st["steps"] + st["paired_steps"]) * (sims + 1)
    blocks2 = 2 * blocks
    return {"conv3x3_bf16": evals + st["folds"] * (1 + blocks2),
            "heads_eval": evals, "conv3x3_i8": evals * blocks2,
            "write_nodes": st["steps"] * (sims + 1),
            "mcts_descend": st["steps"] * sims,
            "mcts_backup": st["steps"] * sims,
            "rules_step": st["steps"] * (sims + 1)}


def phase_train(base, entries):
    """One iteration of ``Trainer.train`` at full width from the flagship
    weights, then the reload and read-back checks.  Fills each entry's
    ``launches_train``."""
    import numpy as np
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    dev = base.device
    cfg = base.cfg.replace(**TRAIN)
    sims = cfg.mcts_simulations
    log(f"train: {json.dumps(TRAIN)} at {cfg.blocks}x{cfg.filters}, "
        f"value_hidden {cfg.value_hidden}")
    trainer = Trainer(cfg, seed=3, device=dev)
    trainer.load_weights(base.net)
    trainer.folded()
    stats0 = {k: v.clone() for k, v in
              trainer.train_state.net.state_dict().items()}

    # per-phase seconds, launch counts and step counts, read around the
    # trainer's own phase methods
    phases, trained = {}, [None]

    def watch(name):
        fn = getattr(trainer, name)

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            c0, s0 = kernels.counts(), dict(trainer.play_stats)
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            p = phases.setdefault(name, {"seconds": 0.0, "launches": {},
                                         "stats": {}})
            p["seconds"] += time.perf_counter() - t0
            for k, v in kernels.counts().items():
                p["launches"][k] = p["launches"].get(k, 0) + v - c0[k]
            for k in ("steps", "paired_steps", "folds", "az_decisions"):
                p["stats"][k] = (p["stats"].get(k, 0)
                                 + trainer.play_stats[k] - s0[k])
            p["result"] = out
            if name == "train_epochs":
                trained[0] = {k: v.clone() for k, v in
                              trainer.train_state.net.state_dict().items()}
            return out

        setattr(trainer, name, wrapped)

    for name in ("generate_selfplay", "train_epochs", "gate", "benchmark"):
        watch(name)

    # every record the actors hand to the replay buffer
    valid_seen, added = [0], [0]
    extend = trainer.replay.extend_from_actor

    def counted(samples, status, final_round=None):
        n = extend(samples, status, final_round=final_round)
        valid_seen[0] += int(samples.valid.sum())
        added[0] += n
        return n

    trainer.replay.extend_from_actor = counted

    kernels.reset_counts()
    t0 = time.perf_counter()
    trainer.train(iterations=1, resume=False)
    if "benchmark" not in phases:
        # the gate rejected the candidate: train() skips the benchmark
        # then, so run it here on the reverted weights
        log("train: gate rejected the candidate; benchmark run directly")
        trainer.benchmark()
    torch.cuda.synchronize()
    counts = kernels.counts()
    log(f"train: one iteration (with the benchmark) in "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    for name, p in phases.items():
        log(f"train phase {name}: {p['seconds']:.1f} s, steps "
            f"{p['stats']}, launches {p['launches']}")

    with open(WORK / "log" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    sp = next(e for e in events if e["kind"] == "selfplay")
    imp = next(e for e in events if e["kind"] == "improvement")
    bench = next(e for e in events if e["kind"] == "benchmark")
    accepted = bool(phases["gate"]["result"])
    log(f"train: self-play {sp['games']} games, {sp['finished']} ended "
        f"inside {cfg.max_game_steps} micro-steps, {sp['samples']} "
        f"records; arena new {imp['new_wins']} old {imp['old_wins']} draws "
        f"{imp['draws']} -> {'accepted' if accepted else 'reverted'}; "
        f"benchmark vs random {json.dumps(bench['vs_random'])} vs script "
        f"{json.dumps(bench['vs_script'])}")
    if sp["games"] != cfg.train_iteration_games:
        fail("self-play did not play its games")
    if 2 * sp["finished"] < sp["games"]:
        fail(f"fewer than half of the self-play games ended: {sp}")

    # records: every valid record was stored, nothing else
    n = len(trainer.replay)
    if not (n == added[0] == valid_seen[0] and n >= sp["samples"] > 0):
        fail(f"replay holds {n} samples, actors handed over {added[0]}, "
             f"valid records {valid_seen[0]}")
    z = trainer.replay.data["value"]
    log(f"train: replay {n} samples, z=+1 {int((z > 0).sum())} z=-1 "
        f"{int((z < 0).sum())} z=0 {int((z == 0).sum())}")
    if not ((z > 0).any() and (z < 0).any()):
        fail("no decided game among the records")

    # learner: finite losses, policy loss below the first batch's
    log(f"train: epochs {json.dumps(trainer.epoch_log)}")
    ep = trainer.epoch_log
    if len(ep) != cfg.epochs or not all(
            np.isfinite(e["pi_loss"]) and np.isfinite(e["v_loss"])
            for e in ep):
        fail(f"epoch losses: {ep}")
    if not ep[-1]["pi_loss"] < ep[0]["first_pi_loss"]:
        fail(f"policy loss did not fall: first batch "
             f"{ep[0]['first_pi_loss']}, last epoch {ep[-1]['pi_loss']}")
    if trainer.train_state.step != cfg.epochs * (
            sp["samples"] // cfg.batch_size):
        fail(f"learner took {trainer.train_state.step} steps over "
             f"{sp['samples']} samples")
    # the learner's weights as the epochs left them (a rejected gate
    # reverts the live ones afterwards)
    sd = trained[0]
    if not all(bool(torch.isfinite(v).all()) for v in sd.values()):
        fail("non-finite parameter after training")
    moved = [k for k, v in sd.items() if "running" in k
             and not torch.equal(v, stats0[k])]
    if len(moved) != 2 * (3 + 2 * cfg.blocks):
        fail(f"running statistics moved in {len(moved)} places only")
    if any(torch.equal(v, stats0[k]) for k, v in sd.items()
           if k.endswith("conv.weight") or "conv_" in k):
        fail("training left a conv kernel unchanged")

    # launch counts against the step and simulation counts
    st = {k: sum(p["stats"].get(k, 0) for p in phases.values())
          for k in ("steps", "paired_steps", "folds")}
    want = expected_launches(st, sims, cfg.blocks)
    log(f"train: {st['steps']} lockstep searches ({st['paired_steps']} "
        f"paired), {st['folds']} folds; expected launches {want}")
    if want != {k: counts[k] for k in want}:
        fail(f"launch counts {counts} differ from the expected {want}")
    # both opponents only fast-forward here (the benchmark): the
    # multi-step entry, not their single steps
    for k in kernels.ALL:
        if k in (kernels.SCRIPT_STEP, kernels.RANDOM_STEP):
            if counts[k.name]:
                fail(f"the single step {k.name} was launched by the "
                     f"training phase")
        elif counts[k.name] <= 0:
            fail(f"kernel {k.name} was not launched by the training phase")
    log(f"train: single steps K9 {counts['script_step']}, K10 "
        f"{counts['random_step']}; multi-step {counts['agent_steps']}")
    for e in entries:
        e["launches_train"] = counts[e["name"]]

    check_reload(trainer, cfg, accepted, trainer.replay.data, "train")
    return phases


def check_reload(trainer, cfg, accepted, arrays, what):
    """The files of one ``train`` iteration: ``latest`` and the meta
    written, ``best`` as the gate decided; ``latest`` reloaded into a fresh
    trainer folds to the same evaluation as the in-memory learner, with its
    step count; the replay npz read back by the host buffer equals
    ``arrays`` (the buffer's logical contents)."""
    import numpy as np
    import torch
    from alphazero_risk_tpu_torch.env.featurize import featurize
    from alphazero_risk_tpu_torch.env.state import new_game
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    from alphazero_risk_tpu_torch.training.replay import FIELDS, ReplayBuffer
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    dev = trainer.device
    meta = trainer.ckpt.load_meta()
    if not (trainer.ckpt.exists("latest") and meta
            and meta["iteration"] == 1
            and trainer.ckpt.exists("best") == accepted):
        fail(f"{what}: checkpoints or meta missing: meta {meta}")
    fresh = Trainer(cfg.replace(device_replay=False), seed=4, device=dev)
    fresh.train_state = fresh.ckpt.restore("latest", fresh.train_state)
    states = new_game(64, generator=torch.Generator(device=dev)
                      .manual_seed(9), device=dev)
    x = featurize(states, cfg)
    la, va = FI.apply_folded(trainer._fold(trainer.train_state.net), x,
                             int8=True)
    lb, vb = FI.apply_folded(fresh._fold(fresh.train_state.net), x,
                             int8=True)
    torch.cuda.synchronize()
    if not (torch.equal(la, lb) and torch.equal(va, vb)
            and bool(torch.isfinite(la).all())):
        fail(f"{what}: the reloaded 'latest' evaluates differently from "
             f"the in-memory learner")
    if fresh.train_state.step != trainer.train_state.step:
        fail(f"{what}: the reloaded 'latest' lost its step count")
    n = len(arrays["value"])
    back = ReplayBuffer(cfg)
    if not back.load(trainer._replay_path()) or len(back) != n or any(
            not np.array_equal(back.data[k], arrays[k])
            or back.data[k].dtype != arrays[k].dtype for k in FIELDS):
        fail(f"{what}: the replay npz does not read back equal")
    log(f"{what}: latest reloaded (step {fresh.train_state.step}) and "
        f"evaluates equal on 64 states; replay npz read back equal by the "
        f"host buffer ({n} samples)")


def profile_scripted(mx, cfg, steps=16):
    """Device busy share and host-side aten ops per step of
    ``run_scripted_episodes`` (Script vs Random) at the data phase's batch,
    from the first mixed states, traced by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from alphazero_risk_tpu_torch.training import actor as A
    b = DATA["env_batch_per_device"]
    m = first(mx, b)
    dev = m.prev.device
    draws = A.GeneratorDraws(torch.Generator(device=dev).manual_seed(23),
                             cfg, b, dev)
    kinds = (A.OPP_SCRIPT, A.OPP_RANDOM)
    A.run_scripted_episodes(m.state, draws, cfg, 2, kinds, carry_in=m.carry,
                            prev_in=m.prev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        A.run_scripted_episodes(m.state, draws, cfg, steps, kinds,
                                carry_in=m.carry, prev_in=m.prev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    rows = [e for e in avg if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in rows)
    host_ops = sum(e.count for e in avg if e.key.startswith("aten::"))
    log(f"profile window (run_scripted_episodes, {steps} steps x {b} games, "
        f"Script vs Random): wall {wall:.3f} s, {1e3 * wall / steps:.2f} ms "
        f"per step, device busy {dev_us / 1e6:.4f} s "
        f"({100 * dev_us / 1e6 / wall:.1f}%), host-side aten ops "
        f"{host_ops / steps:.0f} per step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d}x  "
            f"{e.key[:70]}")


def phase_data(base, mx, entries):
    """The supervised-bootstrap path: (a) a scripted chunk on the kernels
    and on the plain versions, (b) ``play_match`` Script vs Script to the
    end, (c) one loop of ``Trainer.train_on_data`` from the flagship at
    full width, (d) ``play_match`` Script vs Random to the end
    (``phase_match_sr``).  Fills each entry's ``launches_data``."""
    import numpy as np
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training.replay import ReplayBuffer
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    dev = base.device
    cfg = base.cfg.replace(**DATA)
    sr = (A.OPP_SCRIPT, A.OPP_RANDOM)
    log(f"data: {json.dumps(DATA)} at {cfg.blocks}x{cfg.filters}")

    # (a) one chunk, kernels against the plain versions, the same draws
    got, _ = held_chunk(cfg, mx, 21, "data (a)")
    # K8 on the learner's real input: a batch of these records from the
    # replay, rebuilt as states (no cards, no mobilization pair) as
    # train_epochs featurizes them
    rb = ReplayBuffer(cfg)
    rb.extend_from_actor(got.samples, got.status, final_round=got.state.round)
    arrays = rb.sample_arrays()
    pick = np.random.default_rng(0).permutation(len(rb))[:cfg.batch_size]
    sub = {k: torch.from_numpy(v[pick]).to(dev) for k, v in arrays.items()}
    check_k8(A.state_of_samples(A.SampleBatch(valid=None, **sub), cfg), cfg,
             timed=False, what=" (learner batch of replay records)")
    profile_scripted(mx, cfg)

    # (b) play_match Script vs Script to the end, in blocks of the
    # multi-step entry; the live micro-steps are the sum of its step
    # counts.  The data path's launches are (b)'s, counted from here to
    # the end of play_match, plus (c)'s, counted over train_on_data
    # alone, plus (d)'s, counted over its play_match alone: the holds,
    # the references and the set-up fold between them stay out.
    gen = torch.Generator(device=dev).manual_seed(22)
    state0 = D.mirrored_initial_states(MIXED, generator=gen, device=dev)
    torch.cuda.synchronize()
    kernels.reset_counts()
    with watched_blocks(keep=64) as mb:
        t0 = time.perf_counter()
        res = D.play_match(gen, state0, D.AGENT_SCRIPT, D.AGENT_SCRIPT, cfg,
                           cfg.max_game_steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    live = int(mb["steps"])
    tally = D.summarize(res)
    cb = kernels.counts()
    log(f"data (b): play_match Script vs Script, {json.dumps(tally)}; "
        f"{res.steps} lockstep steps, {live} live micro-steps in "
        f"{secs:.2f} s: {live / secs:.0f} live micro-steps/s "
        f"({1e3 * secs / res.steps:.3f} ms per lockstep step); "
        f"launches: multi-step {cb['agent_steps']} ({mb['blocks']} blocks), "
        f"K9 single step {cb['script_step']}")
    if tally["unfinished"] != 0 or cb["agent_steps"] != mb["blocks"] or \
            mb["iterations"] != res.steps or cb["script_step"]:
        fail(f"data (b): {tally['unfinished']} games unfinished, the "
             f"multi-step entry launched {cb['agent_steps']} times for "
             f"{mb['blocks']} blocks of {mb['iterations']} iterations over "
             f"{res.steps} steps, K9's single step {cb['script_step']} times")
    hold_agent_steps(mb["calls"], f"on data (b)'s {MIXED} games")

    # (c) Trainer.train_on_data from the flagship weights
    trainer = Trainer(cfg, seed=5, device=dev)
    trainer.load_weights(base.net)
    trainer.folded()
    parts = {}
    gen_waves = {sr: [], (A.OPP_SCRIPT, A.OPP_SCRIPT): []}
    seen, reverts = {}, []

    def timed(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), kernels.counts()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            p = parts.setdefault(name, {"seconds": 0.0, "launches": {}})
            p["seconds"] += time.perf_counter() - t0
            p["result"] = out
            for k, v in kernels.counts().items():
                p["launches"][k] = p["launches"].get(k, 0) + v - c0[k]
            return out
        return wrapped

    real_call = trainer._scripted_call

    def scripted_call(kinds):
        call = real_call(kinds)

        def run(state, carry, prev):
            out = call(state, carry, prev)
            waves = gen_waves[tuple(kinds)]
            if carry is None:
                waves.append({"steps": 0, "records": 0})
            waves[-1]["steps"] += cfg.actor_chunk_steps
            waves[-1]["records"] += int(out.samples.valid.sum())
            waves[-1]["status"] = out.status
            return out
        name = "generate " + ("script-random" if kinds[1] == A.OPP_RANDOM
                              else "script-script")
        return timed(name, run)

    real_epochs = trainer.train_epochs

    def epochs(*a, **kw):
        seen["n"] = len(trainer.replay)
        seen["step0"] = trainer.train_state.step
        return real_epochs(*a, **kw)

    trainer._scripted_call = scripted_call
    trainer.train_epochs = timed("epochs", epochs)
    trainer.gate = timed("gate", trainer.gate)
    trainer.benchmark = timed("benchmark", trainer.benchmark)
    trainer._revert = lambda: reverts.append(1)
    s0 = dict(trainer.play_stats)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    trainer.train_on_data(loops=1)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = kernels.counts()
    log(f"data (c): train_on_data(loops=1) in {total:.1f} s; launches "
        f"{counts}")
    for name, p in parts.items():
        log(f"data (c) {name}: {p['seconds']:.1f} s, launches "
            f"{ {k: v for k, v in p['launches'].items() if v} }")
    steps = {k: sum(w["steps"] for w in v) for k, v in gen_waves.items()}
    named = {("script-random" if k == sr else "script-script"): v
             for k, v in steps.items()}
    recs = sum(w["records"] for v in gen_waves.values() for w in v)
    unfinished = sum(int((w["status"] == -1).sum())
                     for v in gen_waves.values() for w in v)
    games = sum(int(w["status"].numel()) for v in gen_waves.values()
                for w in v)
    log(f"data (c): scripted games {games}, unfinished {unfinished}, "
        f"lockstep steps {named}, "
        f"records {recs}, replay before the epochs {seen.get('n')}, "
        f"learner steps {trainer.train_state.step - seen.get('step0', 0)}; "
        f"epochs {json.dumps(trainer.epoch_log)}")
    if games != cfg.data_games_ss + cfg.data_games_sr or unfinished:
        fail(f"data (c): {games} scripted games, {unfinished} unfinished")
    if seen.get("n") != recs or trainer.train_state.step - seen["step0"] \
            != 3 * (recs // cfg.batch_size):
        fail("data (c): the fresh replay or the learner's steps do not "
             "match the scripted records")
    gen_launch = {k: sum(p["launches"].get(k, 0) for n, p in parts.items()
                         if n.startswith("generate"))
                  for k in ("script_step", "random_step")}
    want_gen = {"script_step": sum(steps.values()),
                "random_step": steps[sr]}
    if gen_launch != want_gen:
        fail(f"data (c): generation launched {gen_launch}, expected "
             f"{want_gen}")
    # the trainer counts the scripted chunks' lockstep steps too; they
    # search nothing
    st = {k: trainer.play_stats[k] - s0[k]
          for k in ("steps", "paired_steps", "folds")}
    st["steps"] -= sum(steps.values())
    want = expected_launches(st, cfg.mcts_simulations, cfg.blocks)
    if want != {k: counts[k] for k in want}:
        fail(f"data (c): launch counts {counts} differ from the expected "
             f"{want}")
    if counts["random_step"] != want_gen["random_step"]:
        fail(f"data (c): K10's single step launched {counts['random_step']} "
             f"times, the generation's {want_gen['random_step']} only "
             f"expected (the benchmark fast-forwards)")
    if reverts or not all(trainer.ckpt.exists(r) for r in ("temp",
                                                           "latest")) \
            or trainer.ckpt.load_meta()["iteration"] != 1:
        fail("data (c): a revert, or temp/latest/meta missing")
    if not all(np.isfinite(e["pi_loss"]) for e in trainer.epoch_log):
        fail("data (c): non-finite loss")
    verdict = "accepted" if parts["gate"]["result"] else "rejected"
    bench = "run" if "benchmark" in parts else "skipped"
    log(f"data (c): gate {verdict} (no revert), benchmark {bench}; "
        f"expected launches {want} and generation {want_gen} held; temp, "
        f"latest and meta written")
    cd = phase_match_sr(cfg, dev)
    path_counts = {k: cb[k] + v + cd[k] for k, v in counts.items()}
    for k in kernels.ALL:
        if path_counts[k.name] <= 0:
            fail(f"kernel {k.name} was not launched by the data phase")
    log(f"data: launches over (b), (c) and (d): single steps K9 "
        f"{path_counts['script_step']}, K10 {path_counts['random_step']}; "
        f"multi-step {path_counts['agent_steps']}")
    for e in entries:
        e["launches_data"] = path_counts[e["name"]]


def held_chunk(cfg, mx, seed, what):
    """One chunk of 128 steps of ``run_scripted_episodes``, Script vs
    Random, at the games of ``mx`` from their carries and previous movers,
    on the kernels (after a warm-up chunk) and on the plain versions from
    the same draws: states, carries, prev, status and records equal.
    Returns (the kernels' output, their launch counts)."""
    import dataclasses
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.agents.script_agent import ScriptCarry
    from alphazero_risk_tpu_torch.training import actor as A
    dev, b = mx.prev.device, mx.prev.numel()
    sr = (A.OPP_SCRIPT, A.OPP_RANDOM)

    def chunk():
        draws = A.GeneratorDraws(
            torch.Generator(device=dev).manual_seed(seed), cfg, b, dev)
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = A.run_scripted_episodes(mx.state, draws, cfg, 128, sr,
                                      carry_in=mx.carry, prev_in=mx.prev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, kernels.counts()

    chunk()                                     # warm-up
    got, t_k, counts = chunk()
    with plain_versions():
        ref, t_p, _ = chunk()
    bad = states_differ(got.state, ref.state) or next(
        (f"carry {f.name}" for f in dataclasses.fields(ScriptCarry)
         if not torch.equal(getattr(got.carry, f.name),
                            getattr(ref.carry, f.name))), None) or next(
        (f"samples {f}" for f in A.SampleBatch._fields
         if not torch.equal(getattr(got.samples, f),
                            getattr(ref.samples, f))), None)
    if bad or not (torch.equal(got.prev_player, ref.prev_player)
                   and torch.equal(got.status, ref.status)):
        fail(f"{what}: the kernel chunk differs from the plain one: "
             f"{bad or 'prev_player or status'}")
    recs = int(got.samples.valid.sum())
    trades = int((got.state.card_sets_played
                  - mx.state.card_sets_played).sum())
    log(f"{what}: 128 steps x {b} games Script vs Random equal on the "
        f"kernels and the plain versions (states, carries, {recs} records, "
        f"{trades} trades); kernels {t_k:.3f} s ({1e3 * t_k / 128:.2f} ms "
        f"per step), plain {t_p:.3f} s ({1e3 * t_p / 128:.2f} ms per step)")
    return got, counts


def held_match(cfg, dev, agents, seed, what, keep=16):
    """``play_match`` of the seats ``agents`` on MIXED mirrored games from
    ``seed`` to the end in blocks, launch counts read around it alone and
    a sample of the blocks held against the plain multi-step function,
    then against the per-iteration loop on the plain versions from the
    same seed: tally, steps, final rounds and live micro-steps.  Fails
    unless every game ended, the multi-step entry launched once per block
    and no single step launched.  Returns (its launch counts, its result,
    the live micro-steps, its seconds)."""
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.env import rules

    def start():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return gen, D.mirrored_initial_states(MIXED, generator=gen,
                                              device=dev)

    gen, state0 = start()
    torch.cuda.synchronize()
    kernels.reset_counts()
    with watched_blocks(keep=keep) as mb:
        t0 = time.perf_counter()
        res = D.play_match(gen, state0, *agents, cfg, cfg.max_game_steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    cd = kernels.counts()
    live = int(mb["steps"])
    tally = D.summarize(res)
    name = "Script vs " + ("Script" if agents[1] == D.AGENT_SCRIPT
                           else "Random")
    log(f"{what}: play_match {name}, {json.dumps(tally)}; "
        f"{res.steps} lockstep steps, {live} live micro-steps in "
        f"{secs:.3f} s: {live / secs:.0f} live micro-steps/s "
        f"({1e3 * secs / res.steps:.3f} ms per lockstep step) in "
        f"{mb['blocks']} blocks; launches: multi-step {cd['agent_steps']}, "
        f"single steps K9 {cd['script_step']}, K10 {cd['random_step']}")
    if tally["unfinished"] != 0 or cd["agent_steps"] != mb["blocks"] or \
            mb["iterations"] != res.steps or cd["script_step"] or \
            cd["random_step"]:
        fail(f"{what}: {tally['unfinished']} games unfinished, the "
             f"multi-step entry launched {cd['agent_steps']} times for "
             f"{mb['blocks']} blocks of {mb['iterations']} iterations over "
             f"{res.steps} steps, the single steps {cd['script_step']} and "
             f"{cd['random_step']} times")
    hold_agent_steps(mb["calls"], f"on {what}'s {MIXED} games")
    gen, state0 = start()
    t0 = time.perf_counter()
    ref, ref_t, ref_live = match_by_iteration(gen, state0, agents, cfg,
                                              cfg.max_game_steps)
    torch.cuda.synchronize()
    ref_secs = time.perf_counter() - t0
    ref_tally = D.summarize(D.MatchResult(
        status=rules._game_status_plain(ref, cfg), rounds=ref.round,
        steps=ref_t, started_by=state0.cur_player))
    trades = int(ref.card_sets_played.sum())
    log(f"{what}: the per-iteration loop on the plain versions: "
        f"{json.dumps(ref_tally)}; {ref_t} steps, {ref_live} live "
        f"micro-steps in {ref_secs:.2f} s; {trades} card sets traded")
    if (ref_tally, ref_t, ref_live) != (tally, res.steps, live) or \
            not torch.equal(ref.round, res.rounds):
        fail(f"{what}: the match in blocks differs from the per-iteration "
             f"loop on the plain versions")
    if not cfg.simple_cards and not trades:
        fail(f"{what}: no full-cards trade in the whole match")
    return cd, res, live, secs


def legal_play(gen, st, cfg, steps, plain=False):
    """``steps`` lockstep steps of random legal moves (a uniform argmax
    over the legal mask) through ``rules.step_key``, the library's
    transition with its own dice and card uniforms: K8's legality and K7's
    step, or with ``plain`` the plain versions on the same draws."""
    import torch
    from alphazero_risk_tpu_torch.env import rules
    dev, b = st.phase.device, st.batch_size
    for _ in range(steps):
        legal = (rules._legal_actions_plain if plain
                 else rules.legal_actions)(st, cfg)
        g = torch.rand(legal.shape, generator=gen, device=dev)
        a = torch.argmax(torch.where(legal, g, -1.0), -1).to(torch.int32)
        if not plain:
            st = rules.step_key(st, a, gen, cfg)
            continue
        dice = rules.roll_dice(gen, b)
        u_card = None if cfg.simple_cards else torch.rand(
            (b,), generator=gen, device=dev)
        st = rules._step_plain(st, a, dice, cfg, u_card)
    return st


def held_legal_play(cfg, dev, seed, steps, what):
    """``legal_play`` on MIXED fresh deals from ``seed``, on the kernels
    (launch counts read around it alone) and on the plain versions from
    the same seed: the final states equal.  Returns the launch counts."""
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import new_game

    def start():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return gen, new_game(MIXED, generator=gen, device=dev)

    gen, st = start()
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    got = legal_play(gen, st, cfg, steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.counts()
    gen, st = start()
    t0 = time.perf_counter()
    ref = legal_play(gen, st, cfg, steps, plain=True)
    torch.cuda.synchronize()
    ref_secs = time.perf_counter() - t0
    bad = states_differ(got, ref)
    if bad:
        fail(f"{what}: field {bad} of the kernels' play differs from the "
             f"plain versions'")
    ended = int((rules._game_status_plain(ref, cfg) != -1).sum())
    log(f"{what}: {steps} steps of random legal play through step_key on "
        f"{MIXED} games equal on the kernels ({secs:.3f} s, "
        f"{1e3 * secs / steps:.3f} ms per step; K7 {counts['rules_step']}, "
        f"K8 {counts['state_views']} launches) and the plain versions "
        f"({ref_secs:.2f} s); {int(ref.card_sets_played.sum())} trades, "
        f"{int(ref.drawn_cards.sum())} cards drawn, {ended} games ended")
    return counts


def check_cards_kernels(cmx, cfg):
    """The full-cards rules (``cfg``, ``simple_cards=False``): K7's step,
    K9, K10 and the multi-step entry held bit for bit on the MIXED
    full-cards states ``cmx`` (``card_states``) and timed at GAMES and
    MIXED games, held at 128 (mixed play's batch), the multi-step entry
    for every pair of seat kinds and timed mid-match.  Returns the timings
    by kernel name."""
    dev = cmx.prev.device
    k7 = {"cards_b64": check_k7(first(cmx, GAMES), cfg),
          "cards_b1024": check_k7(cmx, cfg)}
    k9, k10 = {}, {}
    k9["cards_b64"], k10["cards_b64"] = check_k9_k10(first(cmx, GAMES), cfg)
    k9["cards_b1024"], k10["cards_b1024"] = check_k9_k10(cmx, cfg)
    check_k7(first(cmx, 128), cfg, timed=False)
    check_k9_k10(first(cmx, 128), cfg, timed=False)
    hold_agent_steps_mixed(cmx, cfg)
    hold_agent_steps_mixed(first(cmx, GAMES), cfg)
    ks = {}
    for key, b, kinds in (("cards", MIXED, (1, 1)),
                          ("cards_b64", GAMES, (1, 1)),
                          ("cards_script_random", MIXED, (1, 2)),
                          ("cards_script_random_b64", GAMES, (1, 2))):
        ks[key] = check_agent_steps(cfg, dev, b=b, warm=300, kinds=kinds)
    return {"rules_step": k7, "script_step": k9, "random_step": k10,
            "agent_steps": ks}


def phase_cards(entries, cmx, cfg, card):
    """The full-cards paths (``cfg``, ``simple_cards=False``), launch
    counts read around each alone and each held against the plain
    versions: (b) Script vs Script and (d) Script vs Random ``play_match``
    on MIXED mirrored games to the end, (a) a 128-step
    ``run_scripted_episodes`` chunk at the MIXED full-cards states ``cmx``,
    (e) random legal play through ``step_key``.  Fills each entry's
    ``launches_cards``."""
    from alphazero_risk_tpu_torch.agents import driver as D
    t0 = time.perf_counter()
    dev = cmx.prev.device
    ss, sr = (D.AGENT_SCRIPT, D.AGENT_SCRIPT), (D.AGENT_SCRIPT,
                                                 D.AGENT_RANDOM)
    cb = held_match(cfg, dev, ss, 25, "cards (b)", keep=64)[0]
    cd = held_match(cfg, dev, sr, 26, "cards (d)")[0]
    ca = held_chunk(cfg, cmx, 27, "cards (a)")[1]
    ce = held_legal_play(cfg, dev, 28, CARD_PLAY_STEPS, "cards (e)")
    path = {k: cb[k] + cd[k] + ca[k] + ce[k] for k in cb}
    for name in ("rules_step", "state_views", "script_step", "random_step",
                 "agent_steps"):
        if path[name] <= 0:
            fail(f"kernel {name} was not launched by the full-cards paths")
    log(f"cards: launches over (b), (d), (a) and (e): "
        f"{ {k: v for k, v in path.items() if v} }; "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    for e in entries:
        e["launches_cards"] = path[e["name"]]


def phase_match_sr(cfg, dev):
    """Data (d): ``play_match`` Script vs Random on MIXED mirrored games to
    the end through the blocks (the CLI's ``-m play --p1 sp --p2 rp``),
    held as ``held_match`` holds it.  Returns its launch counts."""
    from alphazero_risk_tpu_torch.agents import driver as D
    return held_match(cfg, dev, (D.AGENT_SCRIPT, D.AGENT_RANDOM), 24,
                      "data (d)")[0]


def reused_trees(trainer, cfg, root, seed, what):
    """One search under ``tree_reuse`` at ``cfg``'s simulations on
    ``root``'s games (the flagship's int8 eval, N = 2 S + 2 nodes), the
    played moves (argmax, dice from ``seed``) rerooting each game's tree
    through its played edge, then ``search_with_reuse`` from the rerooted
    trees at the next states.  Prints the time per call of ``reroot`` and
    of the staleness select, and the share of games reused.  Returns
    the tree that search starts from, the tree it leaves and the next
    states."""
    import torch
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.mcts import search as S
    from alphazero_risk_tpu_torch.training import actor as A

    dev, b = trainer.device, root.batch_size
    efn = trainer._eval_fn()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        res = S.search(root, S.draw_gumbel(gen, cfg, b, dev), cfg, efn)
        action = S.pick_move(res, root, cfg, sample=False)
        dice = rules.roll_dice(gen, b)
        outcome = A.realised_outcome(root, action, dice)
        nxt = rules.step(root, action, dice, cfg)
        tree, reused = S.reroot(res.tree, action, outcome, cfg)
        fresh = S.init_tree(nxt, cfg, efn)
        same = reused & S.carried_roots_match(tree, nxt)
        start = S._select_tree(same, tree, fresh)
        ms_reroot = time_ms(lambda: S.reroot(res.tree, action, outcome, cfg),
                            20)
        ms_select = time_ms(lambda: S._select_tree(
            reused & S.carried_roots_match(tree, nxt), tree, fresh), 20)
        after = S.search_with_reuse(nxt, S.draw_gumbel(gen, cfg, b, dev),
                                    cfg, efn, tree, reused).tree
    torch.cuda.synchronize()
    n_keep = tree.next_free[same].float()
    battle = int(((outcome > 0) & same).sum())
    log(f"reuse {what}: B={b} N={cfg.num_nodes}: {int(same.sum())}/{b} "
        f"games reused ({int(reused.sum())} with an expanded child, "
        f"{battle} through a battle outcome > 0), kept nodes mean "
        f"{float(n_keep.mean()) if len(n_keep) else 0.0:.2f} max "
        f"{int(n_keep.max()) if len(n_keep) else 0}; reroot "
        f"{ms_reroot:.4f} ms, staleness select {ms_select:.4f} ms per call; "
        f"after search_with_reuse next_free mean "
        f"{float(after.next_free.float().mean()):.2f}")
    if not bool(same.any()):
        fail(f"reuse {what}: no game continued its tree")
    return start, after, nxt


def check_reused_trees(trainer, states, sims, seed, what):
    """K7's expand, K2, K3 and K6 held against their plain versions on
    rerooted trees (``reused_trees``) at GAMES and at every batch of
    ``PATH_BATCHES``: the tree a reusing search starts from, and at GAMES
    the tree it leaves."""
    import torch
    from alphazero_risk_tpu_torch.env.state import tree_map
    from alphazero_risk_tpu_torch.mcts import search as S

    dev = trainer.device
    cfg = trainer._ecfg.replace(mcts_simulations=sims, tree_reuse=True)
    root = tree_map(lambda x: x[:GAMES].contiguous(), states)
    start, after, nxt = reused_trees(trainer, cfg, root, seed, what)
    gum = S.draw_gumbel(torch.Generator(device=dev).manual_seed(seed + 1),
                        cfg, GAMES, dev)[0]
    with torch.inference_mode():
        for nb in [GAMES] + PATH_BATCHES:
            tree, ngum = slice_tree(start, nb), gum[:, :nb].contiguous()
            check_k7_expand(tree, ngum, cfg, timed=False)
            check_k2_k3(clone_tree(tree), ngum, cfg, dev, timed=False,
                        what=f" rerooted {what}")
            check_k6(tree, ngum, tree_map(lambda x: x[:nb].contiguous(), nxt),
                     cfg, trainer._eval_fn(), timed=False)
        check_k7_expand(after, gum, cfg, timed=False)
        check_k2_k3(clone_tree(after), gum, cfg, dev, timed=False,
                    what=f" after search_with_reuse {what}")
        check_k6(after, gum, nxt, cfg, trainer._eval_fn(), timed=False)


def phase_reuse(base, states, entries, play_dps, card):
    """Phase 8, tree reuse and the device ring on the flagship, int8:
    (a) the kernels on rerooted trees (N = 66 at 32 simulations, N = 18 at
    TRAIN's 8); (b) ``Trainer.play`` of PLAY_GAMES mirrored games against
    the ScriptPlayer under ``tree_reuse``; (c) one ``Trainer.train``
    iteration at TRAIN's cuts with ``device_replay`` and ``tree_reuse``,
    the ring held against a host buffer fed the same records, and the
    ring's ingest and epochs timed beside the host buffer's on the same
    samples; (d) ``cross_validate`` over (c)'s replay npz.  The launches
    of (b) and (c) are each entry's ``launches_reuse``."""
    import numpy as np
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.mcts import search as S
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training.analysis import cross_validate
    from alphazero_risk_tpu_torch.training.device_replay import DeviceReplay
    from alphazero_risk_tpu_torch.training.replay import FIELDS, ReplayBuffer
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    dev = base.device
    # (a) the kernels on rerooted trees
    check_reused_trees(base, states, SIMS, 30, "play")
    check_reused_trees(base, states, TRAIN["mcts_simulations"], 31, "train")
    log(f"reuse (a): {time.perf_counter() - t_phase:.1f} s")

    # (b) play under tree_reuse; the share of searches that continue a
    # carried tree, counted on the device
    t0 = time.perf_counter()
    rt = Trainer(base.cfg.replace(tree_reuse=True), seed=0, device=dev)
    rt.net = base.net
    rt.folded()
    share = [torch.zeros((), dtype=torch.int64, device=dev), 0]
    select = S._select_tree

    def counted(pred, a, b):
        share[0] += pred.sum()
        share[1] += pred.numel()
        return select(pred, a, b)

    S._select_tree = counted
    try:
        kernels.reset_counts()
        res = rt.play(A.OPP_SCRIPT, PLAY_GAMES)
        counts_b = kernels.counts()
    finally:
        S._select_tree = select
    st = rt.play_stats
    dps = st["az_decisions"] / st["seconds"]
    # a finished game's root is terminal and has no child to carry, and
    # after the fast-forward every live game is at an AZ turn: the carried
    # searches are live AZ decisions
    log(f"reuse (b) play: {json.dumps(res)}; {st['az_decisions']} AZ "
        f"decisions in {st['seconds']:.1f} s: {dps:.2f} decisions/s (phase "
        f"4 without reuse {play_dps:.2f}); {int(share[0])} of them "
        f"({int(share[0]) / max(st['az_decisions'], 1):.3f}) continued a "
        f"carried tree, of {share[1]} game-searches in all; launches "
        f"{counts_b}")
    if res["games"] != PLAY_GAMES or res["unfinished"] != 0:
        fail(f"reuse (b): games unfinished: {res}")
    for k in kernels.ALL:
        if k not in (kernels.RANDOM_STEP, kernels.SCRIPT_STEP) and \
                counts_b[k.name] <= 0:
            fail(f"kernel {k.name} was not launched by reuse (b)")
    if int(share[0]) <= 0:
        fail("reuse (b): no search continued a carried tree")
    log(f"reuse (b): {time.perf_counter() - t0:.1f} s")

    # (c) one training iteration on the ring, with tree reuse
    t0 = time.perf_counter()
    ring_dir = WORK / "ring"
    cfg = base.cfg.replace(**TRAIN, device_replay=True, tree_reuse=True,
                           checkpoint_dir=str(ring_dir / "checkpoints"),
                           data_dir=str(ring_dir / "data"),
                           log_dir=str(ring_dir / "log"))
    trainer = Trainer(cfg, seed=3, device=dev)
    trainer.load_weights(base.net)
    trainer.folded()
    ring = trainer.replay
    if not isinstance(ring, DeviceReplay) or ring.cap != \
            cfg.samples_storage_max:
        fail("reuse (c): the trainer did not build the device ring")
    mirror = ReplayBuffer(cfg)
    ingest = {"ring": 0.0, "host": 0.0, "calls": 0}
    extend = ring.extend_from_actor

    def both(samples, status, final_round=None):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = extend(samples, status, final_round=final_round)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        m = mirror.extend_from_actor(samples, status,
                                     final_round=final_round)
        ingest["ring"] += t2 - t1
        ingest["host"] += time.perf_counter() - t2
        ingest["calls"] += 1
        if n != m:
            fail(f"reuse (c): the ring took {n} records, the host {m}")
        return n

    ring.extend_from_actor = both
    snap, ring_secs = {}, [0.0]
    selfplay, epochs = trainer.generate_selfplay, trainer.train_epochs

    def watched_selfplay():
        n = selfplay()
        got = ring.sample_arrays()
        bad = [k for k in FIELDS
               if not (np.array_equal(got[k], mirror.data[k])
                       and got[k].dtype == mirror.data[k].dtype)]
        if bad or not len(ring) == len(mirror) == n:
            fail(f"reuse (c): after self-play the ring differs from the "
                 f"host buffer fed the same records: {bad}")
        snap.update(got)
        return n

    def watched_epochs(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = epochs(*a, **kw)
        torch.cuda.synchronize()
        ring_secs[0] = time.perf_counter() - t1
        return out

    trainer.generate_selfplay = watched_selfplay
    trainer.train_epochs = watched_epochs
    s0 = dict(trainer.play_stats)
    kernels.reset_counts()
    trainer.train(iterations=1, resume=False)
    accepted = trainer.ckpt.exists("best")
    if not accepted:
        log("reuse (c): gate rejected the candidate; benchmark run directly")
        trainer.benchmark()
    torch.cuda.synchronize()
    counts_c = kernels.counts()
    st = {k: trainer.play_stats[k] - s0[k]
          for k in ("steps", "paired_steps", "folds")}
    want = expected_launches(st, cfg.mcts_simulations, cfg.blocks)
    if want != {k: counts_c[k] for k in want}:
        fail(f"reuse (c): launch counts {counts_c} differ from the "
             f"expected {want}")
    for k in kernels.ALL:
        if k not in (kernels.RANDOM_STEP, kernels.SCRIPT_STEP) and \
                counts_c[k.name] <= 0:
            fail(f"kernel {k.name} was not launched by reuse (c)")
    ep = trainer.epoch_log
    n_sp = len(snap["value"])
    if len(ep) != cfg.epochs or not all(
            np.isfinite(e["pi_loss"]) and np.isfinite(e["v_loss"])
            for e in ep) or trainer.train_state.step != cfg.epochs * (
                n_sp // cfg.batch_size):
        fail(f"reuse (c): ring epochs {ep}, step {trainer.train_state.step} "
             f"over {n_sp} samples")
    verdict = "accepted" if accepted else "reverted"
    log(f"reuse (c): one iteration (ring, tree reuse) in "
        f"{time.perf_counter() - t0:.1f} s, {verdict}; self-play {n_sp} "
        f"records, ring {len(ring)} of {ring.cap} slots; "
        f"epochs {json.dumps(ep)}; launches {counts_c}")
    check_reload(trainer, cfg, accepted, ring.sample_arrays(), "reuse (c)")
    # the epochs on the same self-play samples, warm, in turns: one
    # trainer (another seed, the flagship's weights) on a host buffer
    # (which uploads them each call) and on a ring, host, ring, ring, host
    host = Trainer(cfg.replace(device_replay=False, tree_reuse=False,
                               log_dir=str(ring_dir / "log_host")),
                   seed=5, device=dev)
    host.load_weights(base.net)
    bufs = {"host": ReplayBuffer(cfg), "ring": DeviceReplay(cfg, dev)}
    for b in bufs.values():
        b.extend(snap)
    turns = []
    for name in ("host", "ring", "ring", "host"):
        host.replay = bufs[name]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host.train_epochs()
        torch.cuda.synchronize()
        turns.append(f"{name} {time.perf_counter() - t1:.2f}")
    log(f"reuse (c): ingest of {ingest['calls']} chunk batches: ring "
        f"{ingest['ring']:.3f} s, host buffer {ingest['host']:.3f} s; "
        f"{cfg.epochs} epochs over the {n_sp} self-play samples: in the "
        f"iteration (the process's first epochs) ring {ring_secs[0]:.2f} "
        f"s; then in turns {', '.join(turns)} s; {card}")
    for e in entries:
        e["launches_reuse"] = counts_b[e["name"]] + counts_c[e["name"]]

    # (d) k-fold analysis over (c)'s replay file at full width
    t0 = time.perf_counter()
    report = cross_validate(cfg, trainer._replay_path(), folds=2,
                            max_epochs=2, seed=0, device=dev)
    torch.cuda.synchronize()
    cv = time.perf_counter() - t0
    folds = report.get("folds", [])
    if len(folds) != 2 or not all(
            1 <= f["epochs"] <= 2 and np.isfinite(f["best_val"])
            for f in folds):
        fail(f"reuse (d): cross_validate report {report}")
    brief = [{k: f[k] for k in ("fold", "epochs", "best_val")}
             for f in folds]
    log(f"reuse (d): cross_validate over {report['samples']} samples, 2 "
        f"folds at {cfg.blocks}x{cfg.filters}: {cv:.1f} s "
        f"({cv / 2:.1f} s per fold); {json.dumps(brief)}")
    log(f"reuse: {time.perf_counter() - t_phase:.1f} s on {card}")


# Phase 9, the AlphaZero viewer at B=1: a micro-step is one search of the
# plain 20x256 network, 0.53 s at 32 simulations on the kernels and 1.64 s
# on the plain versions (NVIDIA H100 80GB HBM3, 700.00 W; a whole game
# held at 32 simulations took this script past its time limit), so the
# held run searches at TRAIN's simulations over the setup (about 50
# micro-steps) into the battle phases, and 32 simulations, the viewer's
# default, run on the kernels alone.
WATCH_TIMED_STEPS = 30    # (a) at SIMS, kernels only
WATCH_STEPS = 90          # (a) at TRAIN's simulations, kernels and plain
WATCH_PAIRED_STEPS = 10   # (c) az vs az at TRAIN's simulations
WATCH_HOLDS = 30          # (b) holds every 30th search's tree and states


@contextlib.contextmanager
def quiet():
    """Inside the block ``log`` collects its lines instead of printing
    them (the B=1 holds of phase 9 print one summary)."""
    global log
    saved, lines = log, []
    log = lambda *a: lines.append(" ".join(str(x) for x in a))  # noqa: E731
    try:
        yield lines
    finally:
        log = saved


def watch_launches(steps, sims, opponent):
    """The launches ``steps`` micro-steps of the AlphaZero viewer imply, and
    its final status: every step searches (``record_all``, or the paired
    eval): K8 for the step's status, the root's legality and status, the
    root's and each simulation's features and the chunk's closing status;
    K6 for the root and each simulation; K2, K7's expand and K3 per
    simulation, K7 for the move; the opponent's single step (K9 or K10)
    once a step.  The plain network launches no K1, K4 or K5."""
    want = {"mcts_descend": steps * sims, "mcts_backup": steps * sims,
            "write_nodes": steps * (sims + 1),
            "rules_step": steps * (sims + 1),
            "state_views": steps * (sims + 4) + 1,
            "script_step": steps if opponent == "sp" else 0,
            "random_step": steps if opponent == "rp" else 0,
            "conv3x3_i8": 0, "conv3x3_bf16": 0, "heads_eval": 0,
            "agent_steps": 0}
    return want


def run_watch(p1, p2, cfg, max_steps, capture=None, plain=False):
    """``watch_game_az`` on the card from ``WORK/checkpoints``'s latest and
    best, seed 0, ``micro``, headless, on the kernels or (``plain``) under
    ``plain_versions()``.  Fails unless the launches are those its
    micro-steps imply (none when ``plain``).  Returns (stdout, seconds,
    launch counts, micro-steps, AlphaZero moves).  ``capture`` (a list)
    collects every ``WATCH_HOLDS``-th search's (root, noise, eval_fn,
    tree) and the ScriptPlayer's inputs of the same step."""
    import io
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.mcts import search as S
    from alphazero_risk_tpu_torch.utils.watch import watch_game_az

    search, script = S.search, SA.script_step_recorded
    n = [0, 0]

    def captured_search(root, gumbel, c, eval_fn, noise_u=None):
        res = search(root, gumbel, c, eval_fn, noise_u=noise_u)
        if n[0] % WATCH_HOLDS == 0:
            capture.append({"root": root, "gum": gumbel, "eval_fn": eval_fn,
                            "tree": res.tree, "cfg": c})
        n[0] += 1
        return res

    def captured_script(st, carry, reset, u, dice, c):
        if n[1] % WATCH_HOLDS == 0:
            capture[-1]["k9"] = (st, carry, reset, u, dice)
        n[1] += 1
        return script(st, carry, reset, u, dice, c)

    if capture is not None:
        S.search, SA.script_step_recorded = captured_search, captured_script
    out = io.StringIO()
    try:
        with plain_versions() if plain else contextlib.nullcontext():
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                watch_game_az(p1, p2, seed=0, cfg=cfg,
                              ckpt_dir=str(WORK / "checkpoints"),
                              roles=("latest", "best"), micro=True,
                              pause=False, max_steps=max_steps,
                              device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = kernels.counts()
    finally:
        S.search, SA.script_step_recorded = search, script
    text = out.getvalue()
    steps = text.count("[micro-step")
    want = watch_launches(steps, cfg.mcts_simulations, p2)
    if plain:
        want = {k: 0 for k in want}
    if counts != want:
        fail(f"watch {p1} vs {p2}{' (plain)' if plain else ''}: launches "
             f"{counts} differ from the expected {want} for {steps} "
             f"micro-steps")
    if steps == 0 or "pi: " not in text:
        fail(f"watch {p1} vs {p2}: no micro-step printed")
    return text, secs, counts, steps, text.count("last mover: player 0 (az)")


def hold_watch_kernels(capture):
    """Phase 9 (b): the kernels of the viewer's path held against their
    plain versions at B=1 on its own captured states and trees."""
    import types
    import torch
    from alphazero_risk_tpu_torch.env import rules
    held = 0
    for c in capture:
        tree, root, gum, cfg = c["tree"], c["root"], c["gum"], c["cfg"]
        if tree.player.shape[0] != 1:
            fail("watch (b): the viewer's tree is not a batch of one")
        check_k2_k3(tree, gum[0], cfg, root.device, timed=False,
                    what=" (watch)")
        check_k6(tree, gum[1], root, cfg, c["eval_fn"], timed=False)
        check_k7_expand(tree, gum[-1], cfg, timed=False)
        check_k8(root, cfg, timed=False, what=" (watch)")
        gen = torch.Generator(device=root.device).manual_seed(held)
        legal = rules._legal_actions_plain(root, cfg)
        pick = torch.rand(legal.shape, generator=gen, device=root.device)
        action = torch.argmax(torch.where(legal, pick, -1.0), -1).to(
            torch.int32)
        st, carry, reset, u, dice = c["k9"]
        check_k7(types.SimpleNamespace(state=root, action=action, dice=dice,
                                       u=u), cfg, timed=False)
        check_k9_k10(types.SimpleNamespace(state=st, carry=carry,
                                           reset=reset, u=u, dice=dice),
                     cfg, timed=False)
        held += 1
    return held


def phase_watch(base, entries, card):
    """Phase 9, the game viewer with AlphaZero seats on the card at B=1
    (``utils/watch.py::watch_game_az``, the plain 20x256 network) from
    phase 5's ``latest``: (a) az vs sp, micro, headless: at SIMS
    simulations (the viewer's default) for WATCH_TIMED_STEPS micro-steps
    on the kernels, timed; at TRAIN's simulations for WATCH_STEPS
    micro-steps on the kernels and under ``plain_versions()`` from the
    same seed (printed boards and ``pi`` lines equal); launches equal to
    what the micro-steps imply; (b) K2, K3, K6, K7 (step and expand), K8
    (three forms), K9 and K10 held at B=1 on the captured states and trees
    of (a); (c) az vs az (``latest`` against ``best``, the paired eval)
    for WATCH_PAIRED_STEPS micro-steps; (d) the CLI's heuristic viewer as
    a subprocess.  The launches of (a) and (c) are each entry's
    ``launches_watch``."""
    import copy
    from alphazero_risk_tpu_torch.training.checkpoints import (
        CheckpointManager)
    from alphazero_risk_tpu_torch.training.learner import train_state_of

    t_phase = time.perf_counter()
    cfg = base.cfg.replace(mcts_simulations=SIMS)
    held_cfg = cfg.replace(mcts_simulations=TRAIN["mcts_simulations"])
    mgr = CheckpointManager(cfg, str(WORK / "checkpoints"))
    if not mgr.exists("latest"):
        fail("watch: phase 5 left no 'latest' checkpoint")
    # (a) az vs sp: timed at SIMS on the kernels; held at TRAIN's
    # simulations, kernels against the plain versions
    capture = []
    out_t, secs_t, counts_t, steps_t, az_t = run_watch(
        "az", "sp", cfg, WATCH_TIMED_STEPS, capture=capture)
    log(f"watch (a) az vs sp, B=1, {SIMS} simulations, {cfg.blocks}x"
        f"{cfg.filters} plain net, on the kernels: {steps_t} micro-steps "
        f"({az_t} AlphaZero moves) in {secs_t:.1f} s: "
        f"{secs_t / steps_t:.4f} s per micro-step (one search each), "
        f"{secs_t / max(az_t, 1):.4f} s per AlphaZero decision; launches "
        f"as implied {counts_t}; {card}")
    out_k, secs_k, counts_k, steps, az = run_watch(
        "az", "sp", held_cfg, WATCH_STEPS, capture=capture)
    out_p, secs_p, _, _, _ = run_watch("az", "sp", held_cfg, WATCH_STEPS,
                                       plain=True)
    lines_k, lines_p = out_k.splitlines(), out_p.splitlines()
    if lines_k != lines_p:
        bad = next((i for i, (a, b) in enumerate(zip(lines_k, lines_p))
                    if a != b), min(len(lines_k), len(lines_p)))
        fail(f"watch (a): the kernel and plain viewers differ at line {bad}: "
             f"{lines_k[bad:bad + 1]} against {lines_p[bad:bad + 1]}")
    if "  ATTACK  " not in out_k:
        fail(f"watch (a): {steps} micro-steps reached no attack phase")
    log(f"watch (a) az vs sp, B=1, {held_cfg.mcts_simulations} simulations: "
        f"{steps} micro-steps ({az} AlphaZero moves), {lines_k[-1]}; the "
        f"kernel and plain viewers print equal boards and pi lines "
        f"({len(lines_k)} lines); kernels {secs_k:.1f} s "
        f"({secs_k / steps:.4f} s per micro-step, "
        f"{secs_k / max(az, 1):.4f} s per AlphaZero decision), plain "
        f"versions {secs_p:.1f} s ({secs_p / steps:.4f} s per micro-step); "
        f"launches as implied {counts_k}; {card}")

    # (b) the kernels at B=1 on the viewer's own states and trees
    with quiet() as held_lines:
        held = hold_watch_kernels(capture)
    if held < 4:
        fail(f"watch (b): only {held} captured searches")
    log(f"watch (b): K2, K3, K6, K7 (step and expand), K8 (three forms), "
        f"K9 and K10 equal to their plain versions at B=1 on {held} of "
        f"(a)'s searches (N = {cfg.num_nodes} and {held_cfg.num_nodes}), "
        f"their roots and the ScriptPlayer's inputs "
        f"({len(held_lines)} holds)")

    # (c) az vs az through the paired eval, latest against best
    if not mgr.exists("best"):
        mgr.save("best", train_state_of(copy.deepcopy(base.net), cfg))
        log("watch (c): saved the flagship as 'best'")
    out_c, secs_c, counts_c, steps_c, _ = run_watch(
        "az", "az", held_cfg, WATCH_PAIRED_STEPS)
    log(f"watch (c) az vs az (latest vs best, paired eval), "
        f"{held_cfg.mcts_simulations} simulations: {steps_c} micro-steps "
        f"in {secs_c:.1f} s ({secs_c / steps_c:.4f} s per decision); "
        f"{out_c.splitlines()[-1]}; launches as implied")
    for e in entries:
        e["launches_watch"] = sum(c[e["name"]] for c in
                                  (counts_t, counts_k, counts_c))

    # (d) the CLI's heuristic viewer, headless, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "alphazero_risk_tpu_torch.cli", "-m",
         "watch", "--p1", "sp", "--p2", "rp", "--no-pause"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        stdin=subprocess.DEVNULL)
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or not ("wins in round" in last
                                    or "draw" in last):
        fail(f"watch (d): rc {proc.returncode}, last line {last!r}, "
             f"stderr {proc.stderr[-2000:]}")
    log(f"watch (d): -m watch --p1 sp --p2 rp --no-pause rc 0 in "
        f"{time.perf_counter() - t0:.1f} s: {last}")
    log(f"watch: {time.perf_counter() - t_phase:.1f} s on {card}")


WORLD = 2                   # ranks of phase 10
WORLD_TIMEOUT = 420         # seconds a rank may take


def world_rank(rank: int, port: int, backend: str):
    """One rank of phase 10 (``python chip_smoke.py --world-rank R
    --world-port P --world-backend gloo|nccl``, started by
    ``phase_world``): (a) ``Trainer.play`` of phase 4's games from phase
    4's generator state, (b) one ``Trainer.train`` iteration at TRAIN's
    cuts and the benchmark; the launch counts read around each.  Writes
    its results to
    ``WORK/world/rank{R}.json``."""
    import torch
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.parallel import distributed as D
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training import checkpoints as C
    from alphazero_risk_tpu_torch.training import learner as L
    from alphazero_risk_tpu_torch.training.trainer import Trainer

    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORLD))
    dev = D.initialize(f"127.0.0.1:{port}", WORLD, rank,
                       cpu_collectives=None if backend == "nccl" else backend)
    wdir = WORK / "world"
    cfg = Config(mcts_simulations=SIMS, fast_infer=True,
                 fast_infer_int8=True,
                 checkpoint_dir=str(wdir / "checkpoints"),
                 data_dir=str(wdir / "data"), log_dir=str(wdir / f"log{rank}"))
    out = {"rank": rank, "device": str(dev),
           "backend": torch.distributed.get_backend()}
    net = C.load_params_npz(str(FLAGSHIP), cfg, device=dev)

    # the fast-forward's agreements and the gradient all-reduces, timed
    ff = {"calls": 0, "seconds": 0.0}
    agree = A.WorldDraws.ff_agree

    def timed_agree(self, iterations):
        t0 = time.perf_counter()
        agree(self, iterations)
        ff["calls"] += 1
        ff["seconds"] += time.perf_counter() - t0
    A.WorldDraws.ff_agree = timed_agree
    grads = {"calls": 0, "seconds": 0.0}
    world_mean = L._world_mean_

    def timed_mean(params, metrics):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = world_mean(params, metrics)
        torch.cuda.synchronize()
        grads["calls"] += 1
        grads["seconds"] += time.perf_counter() - t0
        return res
    L._world_mean_ = timed_mean

    # (a) phase 4's games, this rank's rows of them
    ref = torch.load(wdir / "slice.pt", weights_only=False)
    t = Trainer(cfg, seed=0, device=dev)
    t.net = net
    t.folded()
    t.gen.set_state(ref["gen_state"])
    waves = recorded_waves(t)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out["play"] = t.play(A.OPP_SCRIPT, PLAY_GAMES)
    torch.cuda.synchronize()
    out["play_seconds"] = time.perf_counter() - t0
    out["play_launches"] = kernels.counts()
    out["play_decisions"] = t.play_stats["az_decisions"]
    out["play_ff"] = dict(ff)
    torch.save(waves, wdir / f"waves{rank}.pt")

    # (b) one training iteration at TRAIN's cuts (and the benchmark), in
    # a shared directory
    tcfg = cfg.replace(**TRAIN)
    t = Trainer(tcfg, seed=3, device=dev)
    t.load_weights(net)
    t.folded()
    verdicts = []
    gate = t.gate

    def recorded_gate(*a, **kw):
        verdicts.append(bool(gate(*a, **kw)))
        return verdicts[-1]
    t.gate = recorded_gate
    writes = []
    save = C.torch.save

    def recorded_save(obj, path):
        writes.append(str(path))
        save(obj, path)
    C.torch.save = recorded_save
    ff.update(calls=0, seconds=0.0)
    decisions0 = t.play_stats["az_decisions"]
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    t.train(iterations=1, resume=False)
    if not verdicts[-1]:
        # the gate rejected the candidate: train() skips the benchmark
        # then, so run it here on the reverted weights, as phase 5 does
        t.benchmark()
    torch.cuda.synchronize()
    out["train_seconds"] = time.perf_counter() - t0
    out["train_launches"] = kernels.counts()
    C.torch.save = save
    out["train_decisions"] = t.play_stats["az_decisions"] - decisions0
    out["train_ff"] = dict(ff)
    out["grad_allreduce"] = grads
    out["epochs"] = [{k: e[k] for k in ("epoch", "pi_loss", "v_loss",
                                        "first_pi_loss")}
                     for e in t.epoch_log]
    out["verdicts"] = verdicts
    out["writes"] = [Path(w).name for w in writes]
    out["replay"] = {"path": Path(t._replay_path()).name,
                     "samples": len(t.replay),
                     "written": Path(t._replay_path()).exists()}
    out["steps"] = t.train_state.step
    D.shutdown()
    (wdir / f"rank{rank}.json").write_text(json.dumps(out))


def phase_world(entries, card):
    """Phase 10, a process world of WORLD ranks on the card(s) through
    ``parallel/distributed.py`` (every rank on ``cuda:0`` under gloo with
    one card; one card a rank under NCCL with more): (a) ``Trainer.play``
    of phase 4's 32 mirrored games from phase 4's generator state, every
    game's final state and status, concatenated in rank order, equal to
    phase 4's and the same tally on every rank; (b) one ``Trainer.train``
    iteration at TRAIN's cuts and the benchmark, the same losses every
    epoch and the same gate verdict on every rank, each rank's replay file
    written, the checkpoints written by rank 0 alone.  The ranks' launch
    counts of (a) and (b) are each entry's ``launches_world``."""
    import socket
    import torch
    from alphazero_risk_tpu_torch import kernels

    t_phase = time.perf_counter()
    wdir = WORK / "world"
    backend = "nccl" if torch.cuda.device_count() >= WORLD else "gloo"
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    logs = [wdir / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    for r in range(WORLD):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--world-rank", str(r), "--world-port", str(port),
                 "--world-backend", backend], cwd=str(ROOT), stdout=f,
                stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
    deadline = time.time() + WORLD_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                fail(f"world: rank {r} still running after {WORLD_TIMEOUT} "
                     f"s; {logs[r].read_text()[-3000:]}")
            if p.returncode != 0:
                fail(f"world: rank {r} rc {p.returncode}: "
                     f"{logs[r].read_text()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [json.loads((wdir / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    log(f"world: {WORLD} ranks, backend {ranks[0]['backend']}, devices "
        f"{[x['device'] for x in ranks]}, {card}")

    # (a) the games of phase 4, rank by rank
    ref = torch.load(wdir / "slice.pt", weights_only=False)
    mine = [torch.load(wdir / f"waves{r}.pt", weights_only=False)
            for r in range(WORLD)]
    if any(len(w) != len(ref["waves"]) for w in mine):
        fail(f"world (a): {[len(w) for w in mine]} waves against phase 4's "
             f"{len(ref['waves'])}")
    for i, full in enumerate(ref["waves"]):
        got = {k: torch.cat([w[i][k] for w in mine])
               for k in ("status", "started")}
        for k in got:
            if not torch.equal(got[k], full[k]):
                fail(f"world (a): wave {i} {k} {got[k].tolist()} against "
                     f"phase 4's {full[k].tolist()}")
        for f, v in full["state"].items():
            if not torch.equal(torch.cat([w[i]["state"][f] for w in mine]),
                               v):
                fail(f"world (a): wave {i}: the final {f} differs from "
                     f"phase 4's")
    for x in ranks:
        if x["play"] != ref["tally"]:
            fail(f"world (a): rank {x['rank']} tallied {x['play']}, phase 4 "
                 f"{ref['tally']}")
    dec = sum(x["play_decisions"] for x in ranks)
    ffa = ranks[0]["play_ff"]
    log(f"world (a): Trainer.play of {PLAY_GAMES} games, {WORLD} ranks of "
        f"{PLAY_GAMES // WORLD}: every game's final state and status equal "
        f"phase 4's; tally {json.dumps(ranks[0]['play'])} on every rank; "
        f"{max(x['play_seconds'] for x in ranks):.1f} s "
        f"({dec / max(x['play_seconds'] for x in ranks):.2f} decisions/s "
        f"over the world); fast-forward all-reduces {ffa['calls']} for "
        f"{ranks[0]['play_decisions']} rank-0 decisions, "
        f"{1e3 * ffa['seconds'] / max(ffa['calls'], 1):.3f} ms each, "
        f"{1e3 * ffa['seconds'] / max(ranks[0]['play_decisions'], 1):.3f} "
        f"ms per decision; {card}")

    # (b) one training iteration
    e0 = ranks[0]["epochs"]
    for x in ranks:
        if x["epochs"] != e0 or x["verdicts"] != ranks[0]["verdicts"]:
            fail(f"world (b): ranks disagree: "
                 f"{[(y['epochs'], y['verdicts']) for y in ranks]}")
        if not (x["replay"]["written"] and x["replay"]["path"]
                == f"training_samples.p{x['rank']}.npz"
                and x["replay"]["samples"] > 0):
            fail(f"world (b): rank {x['rank']} replay {x['replay']}")
    if ranks[0]["writes"] == [] or any(x["writes"] for x in ranks[1:]):
        fail(f"world (b): checkpoint writes {[x['writes'] for x in ranks]}")
    if len(e0) != TRAIN["epochs"] or not all(
            e["pi_loss"] == e["pi_loss"] for e in e0):
        fail(f"world (b): epochs {e0}")
    g = ranks[0]["grad_allreduce"]
    ffb = ranks[0]["train_ff"]
    log(f"world (b): Trainer.train(1) at TRAIN's cuts in "
        f"{max(x['train_seconds'] for x in ranks):.1f} s; epochs {e0} and "
        f"gate {ranks[0]['verdicts']} equal on every rank; replay "
        f"{[x['replay']['samples'] for x in ranks]} samples in "
        f"{[x['replay']['path'] for x in ranks]}; checkpoints written by "
        f"rank 0 only ({ranks[0]['writes']}); {ranks[0]['steps']} learner "
        f"steps; gradient all-reduce {g['calls']} calls, "
        f"{1e3 * g['seconds'] / max(g['calls'], 1):.2f} ms each "
        f"({ranks[0]['backend']}); fast-forward all-reduces {ffb['calls']} "
        f"for {ranks[0]['train_decisions']} rank-0 decisions, "
        f"{1e3 * ffb['seconds'] / max(ffb['calls'], 1):.3f} ms each; {card}")

    for x in ranks:
        for part in ("play_launches", "train_launches"):
            for k in kernels.ALL:
                if k not in (kernels.SCRIPT_STEP, kernels.RANDOM_STEP) and \
                        x[part][k.name] <= 0:
                    fail(f"world: rank {x['rank']} did not launch {k.name} "
                         f"in {part[:-9]}")
    for e in entries:
        e["launches_world"] = sum(x[p][e["name"]] for x in ranks
                                  for p in ("play_launches",
                                            "train_launches"))
    log(f"world: launches (a) {[x['play_launches'] for x in ranks]}, (b) "
        f"{[x['train_launches'] for x in ranks]}")
    log(f"world: {time.perf_counter() - t_phase:.1f} s on {card}")


def main():
    if "--world-rank" in sys.argv:
        a = sys.argv
        world_rank(int(a[a.index("--world-rank") + 1]),
                   int(a[a.index("--world-port") + 1]),
                   a[a.index("--world-backend") + 1])
        return
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    import torch
    from alphazero_risk_tpu_torch.config import Config
    import shutil
    shutil.rmtree(WORK, ignore_errors=True)
    cfg = Config(mcts_simulations=SIMS, fast_infer=True, fast_infer_int8=True,
                 checkpoint_dir=str(WORK / "checkpoints"),
                 data_dir=str(WORK / "data"), log_dir=str(WORK / "log"))
    trainer, entries, mx, cmx, states = phase_kernels(cfg,
                                                      torch.device("cuda"))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    play_dps = phase_slice(trainer, entries)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    phase_train(trainer, entries)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    phase_data(trainer, mx, entries)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    phase_cards(entries, cmx, cfg.replace(**CARDS), card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    phase_reuse(trainer, states, entries, play_dps, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    phase_watch(trainer, entries, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    phase_world(entries, card)
    for e in entries:
        e["launches"] = sum(e[f"launches_{p}"] for p in
                            ("play", "train", "data", "cards", "reuse",
                             "watch", "world"))
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
