"""Time kernels of one checkout of the PyTorch/CUDA port on the card, with
that checkout's own chip_smoke.py checks (each compares the kernel with its
plain version, then times the call with CUDA events and the kernel alone
from a profiler trace), the block rules of the agents' multi-step entry on
the two paths that launch it, and the Script-vs-Random match.

    python tools/time_kernels.py --root DIR --tag NAME [--parts k5,k7,...]
        [--out FILE]

DIR is the root of a checkout (the package and chip_smoke.py are imported
from there, so two commits can be timed in turns on one card: parent,
change, change, parent).  ``--parts`` picks from ``PARTS`` (default all);
a part the checkout lacks is reported as missing.  Prints one JSON line,
and appends it to FILE when given.  Needs one card.

    k5            heads_eval on the folded heads of a random 1x256 net
                  (value_hidden 256) at B = 64, 128, 512, 1,024, on
                  rectified Gaussian trunk outputs with played legal masks
    k7            the rules step on the first 64 and all 1,024 of
                  chip_smoke's mixed states; expand on the grown tree
    k9, k10       the ScriptPlayer and RandomPlayer steps on those states;
                  for k9 also the single step, kernel alone, on 1,024 and
                  64 mirrored games 100 Script-vs-Script steps into their
                  match, and there the multi-step entry's one launch of 64
                  iterations on the same states and draws (where the
                  checkout has it; with the RandomPlayer too where its
                  entry takes seat kinds)
    k6, k3        the node write (call, kernel alone, root write) and the
                  backup on the grown tree: 64 games, 32 simulations
                  (N = 34)
    ff_blocks     chip_smoke's play slice once per first-block rule of the
                  ScriptPlayer fast-forward (see ``ff_blocks``)
    match_blocks  data (b)'s Script-vs-Script play_match once per
                  first-block rule (see ``match_blocks``)
    sr_match      play_match Script vs Random on 1,024 mirrored games to
                  the end from seed 24, as the checkout runs it (see
                  ``sr_match``)
    slice         chip_smoke's play slice three times (see ``play_slice``)
    k4            K4 as the stem (13 -> 256 channels) at B = 1,024 and 4,096
                  on features of played states: alone (f32 out), followed
                  by the int8 trunk input's ``_quantize`` (four ATen
                  kernels), and with the int8 output from its own epilogue
                  where the checkout's K4 has one (see ``k4``)
    net           the network's stem and int8 trunk (``_trunk_out``) of a
                  random calibrated 20x256 net at B = 1,024 and 5x256 at
                  4,096, as the checkout runs it (see ``net``)
    cards         K7's step, K9, K10 and the multi-step entry (64
                  iterations, Script vs Script and Script vs Random) on
                  chip_smoke's 1,024 full-cards states and their first 64,
                  each held against its plain version and timed under both
                  card modes on the same inputs (see ``cards``)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PARTS = ("k5", "k7", "k9", "k10", "k6", "k3", "ff_blocks", "match_blocks",
         "sr_match", "slice", "cards", "k4", "net")


def keep(e):
    return {k: e.get(k) for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "max_abs_err", "ms_root", "ms_caller",
                                  "device_ms_per_iteration", "steps")
            if e.get(k) is not None}


def mid_match(b, dev, cfg, warm=100):
    """``b`` mirrored games ``warm`` Script-vs-Script steps in, stepped one
    launch per step (what every checkout of the port has), with the
    generator that drew their steps."""
    import torch
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.agents.common import draw_step_randoms
    gen = torch.Generator(device=dev).manual_seed(31)
    st = D.mirrored_initial_states(b, generator=gen, device=dev)
    carry = SA.init_carry(b, dev)
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)
    for _ in range(warm):
        u, dice = draw_step_randoms(gen, b, dev)
        reset = st.cur_player != prev
        prev = st.cur_player
        st, carry, _ = SA.script_step_recorded(st, carry, reset, u, dice, cfg)
    return st, carry, prev, gen


class Ctx:
    """What the parts share, made at first use."""

    def __init__(self, CS, cfg, dev):
        self.CS, self.cfg, self.dev = CS, cfg, dev
        self._mx = self._tree = self._k9k10 = None

    @property
    def mx(self):
        if self._mx is None:
            self._mx = self.CS.mixed_states(self.cfg, self.dev)
        return self._mx

    @property
    def tree(self):
        """(tree, gumbel, root, cfg): 64 games grown by 32 simulations."""
        if self._tree is None:
            import torch
            from alphazero_risk_tpu_torch.mcts import search as S
            scfg = self.cfg.replace(mcts_simulations=32)
            root = self.CS.first(self.mx, 64).state
            grow = S.draw_gumbel(torch.Generator(
                device=self.dev).manual_seed(5), scfg, 64, self.dev)
            tree = S.search(root, grow, scfg, self.CS.heuristic_eval).tree
            self._tree = tree, grow[0], root, scfg
        return self._tree

    @property
    def k9k10(self):
        if self._k9k10 is None:
            CS = self.CS
            b64 = CS.check_k9_k10(CS.first(self.mx, 64), self.cfg)
            b1024 = CS.check_k9_k10(self.mx, self.cfg)
            self._k9k10 = {"k9_b64": keep(b64[0]), "k10_b64": keep(b64[1]),
                           "k9_b1024": keep(b1024[0]),
                           "k10_b1024": keep(b1024[1])}
        return self._k9k10


def k5(ctx):
    import torch
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    from alphazero_risk_tpu_torch.models.resnet import build_network
    CS, dev = ctx.CS, ctx.dev
    torch.manual_seed(0)
    net = build_network(Config(blocks=1), device=dev).eval()
    folded = FI.fold_params(net, ctx.cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    states = CS.random_play_states(1024, 100, gen, ctx.cfg, dev)
    legal = rules.legal_actions(states, ctx.cfg)
    h = torch.randn((1024, 42, 256), generator=gen, device=dev).relu()
    return {f"k5_b{b}": keep(CS.check_k5(folded, h[:b].contiguous(),
                                         legal[:b].contiguous()))
            for b in (64, 128, 512, 1024)}


def _device_total_ms(fn, reps=20, name=""):
    """Device ms a call of ``fn``: the time of every kernel it launched
    whose name contains ``name``, from a profiler trace over ``reps``
    calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key
               ) / reps / 1e3


def _int8_fold(cfg, dev):
    """A calibrated int8 fold of a random net at ``cfg``'s widths."""
    import torch
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    from alphazero_risk_tpu_torch.models.resnet import build_network
    net = build_network(cfg, device=dev).eval()
    calib = FI.default_calib_feats(
        cfg, torch.Generator(device=dev).manual_seed(17), device=dev)
    return FI.fold_for_inference(net, cfg, int8=True, calib_feats=calib)


def _played_feats(ctx, b):
    """Features of ``b`` states 100 random steps into their games (the
    first 1,024 repeated)."""
    import torch
    from alphazero_risk_tpu_torch.env.featurize import featurize
    gen = torch.Generator(device=ctx.dev).manual_seed(1)
    states = ctx.CS.random_play_states(1024, 100, gen, ctx.cfg, ctx.dev)
    f = featurize(states, ctx.cfg)
    return f.repeat(b // 1024, 1, 1, 1).contiguous()


def k4(ctx):
    import inspect
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    CS = ctx.CS
    folded = _int8_fold(ctx.cfg.replace(blocks=1), ctx.dev)
    inv = (1.0 / folded["act_s"]).flatten()[0]
    fused = "inv_s_next" in inspect.signature(FI.conv3x3_bf16).parameters
    out = {}
    for b in (1024, 4096):
        x = _played_feats(ctx, b)
        forms = {"stem": lambda: FI._stem(folded, x),
                 "stem_quantize": lambda: FI._quantize(
                     FI._stem(folded, x)[0], inv)}
        if fused:
            forms["stem_i8"] = lambda: FI._stem(folded, x, inv_s=inv)
        e = {}
        for name, fn in forms.items():
            e[f"{name}_ms"] = CS.time_ms(fn, 50)
            e[f"{name}_device_ms"] = _device_total_ms(fn)
            e[f"{name}_k4_device_ms"] = _device_total_ms(
                fn, name="conv3x3_bf16_kernel")
        e["quantize_device_ms"] = _device_total_ms(
            forms["stem_quantize"], name="elementwise")
        out[f"k4_b{b}"] = e
    return out


def net(ctx):
    """Per evaluation: the call time back to back (CUDA events), the
    host's time to enqueue it, and the device time of its kernels."""
    import torch
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    out = {}
    for blocks, b in ((20, 1024), (5, 4096)):
        folded = _int8_fold(ctx.cfg.replace(blocks=blocks), ctx.dev)
        x = _played_feats(ctx, b)

        def fn():
            return FI._trunk_out(folded, x, True)

        call = ctx.CS.time_ms(fn, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        host = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        out[f"net_{blocks}x256_b{b}"] = {
            "ms": call, "host_ms": host, "device_ms": _device_total_ms(fn),
            "k1_device_ms": _device_total_ms(fn, name="conv3x3_i8_kernel")}
    return out


def k7(ctx):
    CS = ctx.CS
    tree, gum, _, scfg = ctx.tree
    return {"k7_step_b64": keep(CS.check_k7(CS.first(ctx.mx, 64), ctx.cfg)),
            "k7_step_b1024": keep(CS.check_k7(ctx.mx, ctx.cfg)),
            "k7_expand_b64_n34": keep(CS.check_k7_expand(tree, gum, scfg))}


def k9(ctx):
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.agents.common import draw_step_randoms
    CS, cfg, dev = ctx.CS, ctx.cfg, ctx.dev
    out = {k: v for k, v in ctx.k9k10.items() if k.startswith("k9")}
    for b in (1024, 64):
        st, carry, prev, gen = mid_match(b, dev, cfg)
        u, dice = draw_step_randoms(gen, b, dev)
        reset = st.cur_player != prev
        out[f"k9_mid_b{b}_single_device_ms"] = CS.device_ms(
            lambda: SA.script_step_recorded(st, carry, reset, u, dice, cfg),
            "script_step_kernel")
        if hasattr(CS, "check_agent_steps"):
            for kinds in ((1, 1), (1, 2)):
                out[f"steps_b{b}_{kinds[0]}{kinds[1]}"] = keep(
                    CS.check_agent_steps(cfg, dev, b=b, kinds=kinds))
        elif hasattr(CS, "check_k9_steps"):
            out[f"k9_steps_b{b}"] = keep(CS.check_k9_steps(cfg, dev, b=b))
    return out


def k10(ctx):
    return {k: v for k, v in ctx.k9k10.items() if k.startswith("k10")}


def k6(ctx):
    tree, gum, root, scfg = ctx.tree
    return {"k6_b64_n34": keep(ctx.CS.check_k6(tree, gum, root, scfg,
                                               ctx.CS.heuristic_eval))}


def k3(ctx):
    tree, gum, _, scfg = ctx.tree
    _, e = ctx.CS.check_k2_k3(tree, gum, scfg, ctx.dev)
    return {"k3_b64_n34": keep(e)}


def _block_loop():
    """The checkout's block loop: (module, name) of ``run_agent_blocks``
    or of its earlier form ``run_script_blocks``, or None."""
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    try:
        from alphazero_risk_tpu_torch.agents import blocks
        return blocks, "run_agent_blocks"
    except ImportError:
        return (SA, "run_script_blocks") if hasattr(
            SA, "run_script_blocks") else None


def _rule_runs(ctx, rules, play, is_ours):
    """``play()`` once per rule of ``rules`` ((name, first block or None
    for the committed rule)), then again in reverse order.  A rule with a
    first block replaces the ``k`` of each block-loop call for which
    ``is_ours(kwargs)`` holds; the later blocks still double.  Each such
    call is timed from a sync to its end (its last block's sync).
    Returns per rule the runs' seconds, and of the first run the result,
    the calls' iterations and blocks; raises if two runs' results
    differ."""
    import torch
    mod, fn_name = _block_loop()
    real = getattr(mod, fn_name)
    seen, out = None, {}
    for name, first in rules + rules[::-1]:
        rec = {"calls_s": 0.0, "iterations": [], "blocks": 0}

        def run(*a, **kw):
            if first is not None and is_ours(kw):
                kw["k"] = first
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real(*a, **kw)
            rec["calls_s"] += time.perf_counter() - t0
            if is_ours(kw):
                rec["iterations"].append(res[3])
                rec["blocks"] += res[4]
            return res

        setattr(mod, fn_name, run)
        try:
            t0 = time.perf_counter()
            result = play()
            wall = time.perf_counter() - t0
        finally:
            setattr(mod, fn_name, real)
        key = (json.dumps(result, sort_keys=True), rec["iterations"])
        if seen is not None and key != seen:
            raise RuntimeError(f"block rule {name} changed the result")
        seen = key
        r = out.setdefault(name, {"wall_s": [], "calls_s": [],
                                  "blocks": rec["blocks"],
                                  "calls": len(rec["iterations"])})
        r["wall_s"].append(wall)
        r["calls_s"].append(rec["calls_s"])
    its = sorted(seen[1])
    pick = [its[min(len(its) - 1, int(q * len(its)))]
            for q in (0.1, 0.5, 0.9, 0.99)]
    return {"result": json.loads(seen[0]), "rules": out,
            "iterations_total": sum(its),
            "iterations_p10_p50_p90_p99_max": pick + [its[-1]],
            "iterations_histogram": {str(v): its.count(v)
                                     for v in sorted(set(its))}}


def _play_slice(ctx):
    """A function that plays chip_smoke's play slice (the flagship, int8,
    ``PLAY_GAMES`` games against the ScriptPlayer, 256 lockstep steps)
    from a fresh trainer of seed 0, so each call plays the same games, and
    returns its result."""
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training.checkpoints import load_params_npz
    from alphazero_risk_tpu_torch.training.trainer import Trainer
    CS, dev = ctx.CS, ctx.dev
    work = CS.ROOT / "build" / "time_kernels"
    cfg = Config(mcts_simulations=CS.SIMS, fast_infer=True,
                 fast_infer_int8=True, checkpoint_dir=str(work / "ckpt"),
                 data_dir=str(work / "data"), log_dir=str(work / "log"))
    net = load_params_npz(str(CS.FLAGSHIP), cfg, device=dev)

    def play():
        t = Trainer(cfg, seed=0, device=dev)
        t.net = net
        t.folded()
        res = t.play(A.OPP_SCRIPT, CS.PLAY_GAMES)
        return dict(res, az_decisions=t.play_stats["az_decisions"])

    return play


def play_slice(ctx, reps=3):
    """The play slice ``reps`` times in this process, away from
    chip_smoke's other phases: the result and each run's seconds."""
    import torch
    play, secs, result = _play_slice(ctx), [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = play()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"slice": {"result": result, "seconds": secs}}


def ff_blocks(ctx):
    """chip_smoke's play slice once per first-block rule of the
    ScriptPlayer fast-forward: the committed one, and a first block fixed
    at 16, 32 and 64 iterations.  ``calls_s`` is the fast-forwards' time
    (each from a sync to its end), ``wall_s`` the slice's;
    ``iterations_*`` is the distribution of one fast-forward's iterations
    (the most of its games' turns)."""
    play = _play_slice(ctx)
    return {"ff_blocks": _rule_runs(
        ctx, [("committed", None), ("first 16", 16), ("first 32", 32),
              ("first 64", 64)], play,
        lambda kw: kw.get("limit") is None)}


def match_blocks(ctx, reps=3):
    """Data (b)'s ``play_match``: 1,024 mirrored games Script vs Script to
    the end from seed 22, ``reps`` times per first-block rule: the
    committed one, and a first block of 128 and of 512 (the largest)."""
    import torch
    from alphazero_risk_tpu_torch.agents import driver as D
    CS, cfg, dev = ctx.CS, ctx.cfg, ctx.dev

    def play():
        out = None
        for _ in range(reps):
            gen = torch.Generator(device=dev).manual_seed(22)
            st = D.mirrored_initial_states(CS.MIXED, generator=gen,
                                           device=dev)
            res = D.play_match(gen, st, D.AGENT_SCRIPT, D.AGENT_SCRIPT, cfg,
                               cfg.max_game_steps)
            out = dict(D.summarize(res), steps=res.steps)
        return out

    return {"match_blocks": _rule_runs(
        ctx, [("committed", None), ("first 128", 128), ("first 512", 512)],
        play, lambda kw: kw.get("limit") is not None)}


def sr_match(ctx, reps=3):
    """``play_match`` Script vs Random on ``MIXED`` mirrored games to the
    end from seed 24 (chip_smoke's data (d), the CLI's ``-m play --p1 sp
    --p2 rp``), ``reps`` times, each from a sync to its end; then the
    per-iteration loop on the checkout's single-step kernels (the parent's
    form of the match), which counts the live micro-steps at its status
    check and must end in the same tally and steps."""
    import torch
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.agents.common import draw_step_randoms
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import tree_select
    CS, cfg, dev = ctx.CS, ctx.cfg, ctx.dev

    def start():
        gen = torch.Generator(device=dev).manual_seed(24)
        return gen, D.mirrored_initial_states(CS.MIXED, generator=gen,
                                              device=dev)

    secs, out = [], None
    for _ in range(reps):
        gen, st = start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = D.play_match(gen, st, D.AGENT_SCRIPT, D.AGENT_RANDOM, cfg,
                           cfg.max_game_steps)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out = dict(D.summarize(res), steps=res.steps)
    gen, st = start()
    b = st.batch_size
    carry = SA.init_carry(b, dev)
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)
    t = live = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while t < cfg.max_game_steps:
        alive = int((rules.game_status(st, cfg) == -1).sum())
        if not alive:
            break
        live += alive
        u, dice = draw_step_randoms(gen, b, dev)
        s0, c0, _ = SA.script_step_recorded(st, carry, st.cur_player != prev,
                                            u, dice, cfg)
        s1, _ = RA.random_step_recorded(st, u, dice, cfg)
        mover0 = st.cur_player == 0
        prev = st.cur_player
        st = tree_select(mover0, s0, s1)
        carry = tree_select(mover0, c0, carry)
        t += 1
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    by_iteration = dict(D.summarize(D.MatchResult(
        status=rules.game_status(st, cfg), rounds=st.round, steps=t,
        started_by=start()[1].cur_player)), steps=t)
    if by_iteration != out:
        raise RuntimeError(f"sr_match: {out} in blocks, {by_iteration} by "
                           f"iteration")
    return {"sr_match": {"result": out, "seconds": secs,
                         "live_micro_steps": live,
                         "live_micro_steps_per_s": [live / x for x in secs],
                         "by_iteration_s": loop_s}}


def cards(ctx):
    """The full-cards rules' own cost: on chip_smoke's full-cards states
    (``card_states``), K7's step, K9 and K10 at B = 64 and 1,024 and the
    multi-step entry (one launch of 64 iterations from the states' carries
    and previous movers) under the simple-cards and then the full-cards
    rules, the same inputs for both; each held against its plain version
    before it is timed."""
    import torch
    from alphazero_risk_tpu_torch.agents import blocks as AB
    from alphazero_risk_tpu_torch.agents.common import BlockDraws
    CS, dev = ctx.CS, ctx.dev
    if not hasattr(CS, "card_states"):
        return {"cards": "missing"}
    full = ctx.cfg.replace(**CS.CARDS)
    cmx = CS.card_states(full, dev)
    u, dice = BlockDraws(torch.Generator(device=dev).manual_seed(41),
                         cmx.state.batch_size, dev).block(64)
    out = {}
    for mode, cfg in (("simple", ctx.cfg), ("full", full)):
        for b in (64, cmx.state.batch_size):
            m = CS.first(cmx, b)
            out[f"{mode}_k7_b{b}"] = keep(CS.check_k7(m, cfg))
            e9, e10 = CS.check_k9_k10(m, cfg)
            out[f"{mode}_k9_b{b}"], out[f"{mode}_k10_b{b}"] = (keep(e9),
                                                               keep(e10))
            for kinds in ((1, 1), (1, 2)):
                args = (m.state, m.carry, m.prev, u[:, :b].contiguous(),
                        dice[:, :b].contiguous(), cfg, kinds)
                res = AB.agent_steps(*args)
                CS.hold_agent_steps([(args, {}, res)],
                                    f"{mode} cards B={b} {kinds}")
                out[f"{mode}_steps_b{b}_{kinds[0]}{kinds[1]}"] = {
                    "device_ms": CS.device_ms(lambda: AB.agent_steps(*args),
                                              "agent_steps_kernel"),
                    "steps": int(res[3].sum())}
    return {"cards": out}


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
    sys.path.insert(0, args.root)
    import torch
    import chip_smoke as CS
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.config import Config

    if not torch.cuda.is_available():
        sys.exit("needs a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.build_all()
    dev = torch.device("cuda")
    out = {"tag": args.tag, "root": args.root, "card": card,
           "build_s": time.perf_counter() - t0}
    ctx = Ctx(CS, Config(), dev)
    for part in parts:
        if part.endswith("_blocks"):
            # whole paths, which run as their callers run them
            out.update(globals()[part](ctx) if _block_loop()
                       else {part: "missing"})
        elif part == "sr_match":
            out.update(sr_match(ctx))
        elif part == "slice":
            out.update(play_slice(ctx))
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
