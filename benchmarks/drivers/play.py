"""Play traffic: lockstep AlphaZero games through the trainer's chunk call.

The traffic file sets the games in one lockstep wave, the opponent
(``script``: the arena against the ScriptPlayer, argmax moves, the
opponent fast-forwarded; ``az``: self-play, both seats searched, sampled
moves, records made), and the micro-steps of a chunk.  Set-up builds the
kernels, loads the configuration's weights into the program's trainer
(which folds, quantizes and calibrates them), and runs one chunk of a
warm-up wave at the cell's shapes.  The window deals a fresh wave from
the seed and drives the chunk call, one host check of the statuses a
chunk as the trainer makes it, until ``--seconds`` have passed (a wave
that ends is followed by the next; a window too short to reach every
sampled micro-step runs on until it has).  ``decisions_per_s`` is the
AlphaZero decisions searched for live movers over the window's whole
time.

At micro-steps drawn from the seed the benchmark keeps what the program
was given and gave: the search's root state and chance noise, the root
prior, value and visit counts, the move, its dice and the next state, the
opponent's fast-forward with the draws it was handed, and self-play's
record.  After the window the plain reference checks each (see
``reference/play.py``), and the deal.
"""

from __future__ import annotations

import random
import time

import torch

from benchmarks.reference import params as ref_params
from benchmarks.reference import play as ref_play
from benchmarks.reference.config import Config as RefConfig
from benchmarks.reference.models import fast_infer as ref_fast
from benchmarks import harness, trace as tr

# Limits of the compared numbers (PERF.md gives the readings they were set
# from).  Exact comparisons have the limit 0.
LIMITS = {"net_gap_max": 0.6, "net_gap_p99": 0.05, "visit_gap": 0.01,
          "pick_mismatch": 0, "rules_mismatch": 0, "ff_mismatch": 0,
          "record_mismatch": 0, "deal_mismatch": 0}
SPANS = ("net", "search", "chunk")       # innermost first


def program_config(s: dict, work_dir):
    from alphazero_risk_tpu_torch.config import Config
    return Config(
        blocks=s["blocks"], filters=s["filters"],
        value_hidden=s["value_hidden"], feature_version=s["feature_version"],
        mcts_simulations=s["mcts_simulations"], cpuct=s["cpuct"],
        noise_value=s["noise_value"], noise_eps=s["noise_eps"],
        simple_cards=s["simple_cards"], mirror_games=s["mirror_games"],
        fast_infer=True, fast_infer_int8=True,
        env_batch_per_device=s["games"], actor_chunk_steps=s["chunk_steps"],
        checkpoint_dir=str(work_dir / "checkpoints"),
        data_dir=str(work_dir / "data"), log_dir=str(work_dir / "log"))


def reference_config(s: dict) -> RefConfig:
    return RefConfig(
        blocks=s["blocks"], filters=s["filters"],
        value_hidden=s["value_hidden"], feature_version=s["feature_version"],
        mcts_simulations=s["mcts_simulations"], cpuct=s["cpuct"],
        noise_value=s["noise_value"], noise_eps=s["noise_eps"],
        simple_cards=s["simple_cards"], mirror_games=s["mirror_games"])


def weights(s: dict, seed: int, device) -> dict:
    """The configuration's weights as a state dict: the raw npz, or drawn
    from the seed."""
    if s["weights"] == "seeded":
        return ref_params.seeded_state_dict(reference_config(s), seed,
                                            device)
    return ref_params.state_dict_of_npz(str(harness.ROOT / s["weights"]))


class Capture:
    """Wrappers around the program's search, move pick, rules step and
    fast-forward (module attributes the actor calls through) that keep
    what they took and gave at the sampled micro-steps.  With ``spans``
    the search also runs inside a ``search`` profiler span."""

    def __init__(self, want, spans: bool):
        from alphazero_risk_tpu_torch.agents import blocks
        from alphazero_risk_tpu_torch.env import rules
        from alphazero_risk_tpu_torch.mcts import search
        self.want, self.spans = set(want), spans
        self.step = -1
        self.caps, self.ff = {}, {}
        self._sites = [(search, "search", self._search),
                       (search, "pick_move", self._pick),
                       (rules, "step", self._rules_step),
                       (blocks, "run_agent_blocks", self._ff)]
        self._orig = {}

    def __enter__(self):
        for mod, name, wrap in self._sites:
            self._orig[name] = getattr(mod, name)
            setattr(mod, name, wrap(self._orig[name]))
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self._sites:
            setattr(mod, name, self._orig[name])
        return False

    def _search(self, orig):
        def search(root, gumbel, cfg, eval_fn, noise_u=None):
            self.step += 1
            if self.spans:
                with torch.profiler.record_function("search"):
                    res = orig(root, gumbel, cfg, eval_fn, noise_u=noise_u)
            else:
                res = orig(root, gumbel, cfg, eval_fn, noise_u=noise_u)
            if self.step in self.want:
                rows = torch.arange(root.batch_size, device=gumbel.device)
                r = res.tree.root.long()
                self.caps[self.step] = {
                    "state": ref_play.state_fields(root),
                    "gumbel": gumbel.clone(),
                    "prior": res.tree.prior[rows, r].clone(),
                    "value": res.root_value.clone(),
                    "visits": res.visit_counts.clone()}
            return res
        return search

    def _pick(self, orig):
        def pick_move(result, state, cfg, sample, gumbel=None):
            a = orig(result, state, cfg, sample, gumbel)
            cap = self.caps.get(self.step)
            if cap is not None and "action" not in cap:
                cap["action"] = a.clone()
                cap["pick_noise"] = None if gumbel is None else gumbel.clone()
            return a
        return pick_move

    def _rules_step(self, orig):
        def step(state, action, dice, cfg, u_card=None):
            s = orig(state, action, dice, cfg, u_card)
            cap = self.caps.get(self.step)
            if cap is not None and "next" not in cap:
                cap["dice"] = dice.clone()
                cap["next"] = ref_play.state_fields(s)
            return s
        return step

    def _ff(self, orig):
        def run_agent_blocks(state, carry, prev, cfg, block, rewind, *,
                             kinds, k, k_max, limit=None):
            upcoming = self.step + 1
            if upcoming not in self.want or upcoming in self.ff:
                return orig(state, carry, prev, cfg, block, rewind,
                            kinds=kinds, k=k, k_max=k_max, limit=limit)
            handed = []

            def keep(kk):
                u, dice = block(kk)
                handed.append((u.clone(), dice.clone()))
                return u, dice

            cap = {"state": ref_play.state_fields(state),
                   "prev": prev.clone(),
                   "carry": tuple(t.clone() for t in (
                       carry.attack_to, carry.attack_from, carry.mode_b)),
                   "k": k, "k_max": k_max, "kinds": tuple(kinds)}
            out = orig(state, carry, prev, cfg, keep, rewind, kinds=kinds,
                       k=k, k_max=k_max, limit=limit)
            st, c2, p2 = out[:3]
            cap.update(blocks=handed,
                       out_state=ref_play.state_fields(st),
                       out_prev=p2.clone(),
                       out_carry=tuple(t.clone() for t in (
                           c2.attack_to, c2.attack_from, c2.mode_b)))
            self.ff[upcoming] = cap
            return out
        return run_agent_blocks


def _spanned_eval_factory(make):
    """``make_fast_eval_fn`` whose eval function runs in a ``net`` span."""
    def factory(*a, **kw):
        fast = make(*a, **kw)

        def eval_fn(*args):
            with torch.profiler.record_function("net"):
                return fast(*args)
        return eval_fn
    return factory


def run(ctx) -> dict:
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.agents.blocks import OPP_SCRIPT
    from alphazero_risk_tpu_torch.config import STATUS_NOT_ENDED
    from alphazero_risk_tpu_torch.models.resnet import AZNet
    from alphazero_risk_tpu_torch.training import trainer as T

    s = {**ctx["cell"].config, **ctx["cell"].traffic, **ctx["overrides"]}
    dev, seed, traced = ctx["device"], ctx["seed"], ctx["trace"]
    phases = harness.Phases(ctx["t_start"])
    phases.mark("start and imports")
    if dev.type == "cuda":
        kernels.build_all()
    phases.mark("kernels")
    cfg = program_config(s, ctx["work_dir"])
    trainer = T.Trainer(cfg, seed=seed, device=dev,
                        log_dir=str(ctx["work_dir"] / "log"))
    phases.mark("trainer")
    with torch.device(dev):
        net = AZNet(cfg.blocks, cfg.filters, cfg.value_hidden,
                    cfg.num_features)
    sd = weights(s, seed, dev)
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v)
    net.load_state_dict(sd, strict=True)
    trainer.load_weights(net)
    phases.mark("weights")
    versus = s["opponent"] == "script"
    make_eval = T.make_fast_eval_fn
    if traced:
        T.make_fast_eval_fn = _spanned_eval_factory(make_eval)
    try:
        if versus:
            call = trainer._versus_call(trainer.net, OPP_SCRIPT,
                                        record=False)
        else:
            call = trainer._selfplay_call()
    finally:
        T.make_fast_eval_fn = make_eval
    phases.mark("fold and calibration")
    b, chunk = s["games"], s["chunk_steps"]
    with torch.inference_mode():
        call(trainer._initial_states(b), None, None)       # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases.mark("warm-up chunk")
    phases.report()

    rng = random.Random(seed)
    want = sorted(rng.sample(range(s["check_span"]), s["check_steps"]))
    records = {}
    trace_file = ctx["work_dir"] / "trace.json"
    win = None
    counts = {"decisions": 0, "steps": 0, "chunks": 0}
    with Capture(want, traced) as cap, torch.inference_mode():
        t0 = time.perf_counter()
        setup_s = t0 - ctx["t_start"]
        deal_gen = trainer.gen.get_state()
        state = trainer._initial_states(b)
        deal = ref_play.state_fields(state)
        carry = prev = None
        decisions = steps = chunks = 0
        while True:
            tracing = traced and dev.type == "cuda" and chunks == 1
            if tracing:
                win = tr.Window(trace_file).__enter__()
                before = (decisions, steps)
            with torch.profiler.record_function("chunk"):
                out = call(state, carry, prev)
            state, carry, prev = out.state, out.carry, out.prev_player
            decisions += int(out.az_decisions)
            live = int((out.status == STATUS_NOT_ENDED).sum())
            for w in want:
                if steps <= w < steps + chunk and s["record"]:
                    j = w - steps
                    records[w] = {k: getattr(out.samples, k)[j].clone()
                                  for k in out.samples._fields
                                  if k != "value"}
            steps += chunk
            chunks += 1
            if tracing:
                win.__exit__(None, None, None)
                counts.update(decisions=decisions - before[0],
                              steps=steps - before[1], chunks=1)
            # the window also runs on until every sampled micro-step was
            # played, which a window of the cell's length always does
            if time.perf_counter() - t0 >= ctx["seconds"] \
                    and steps > want[-1]:
                break
            if live == 0:
                state = trainer._initial_states(b)
                carry = prev = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    caps, ffs = cap.caps, cap.ff
    del trainer, call, out, state, carry, prev, net
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    summary = tr.reduce(trace_file, SPANS) if win is not None else None
    checks = check(s, seed, dev, caps, ffs, records, deal_gen, deal, versus)
    control = control_checks(s, seed, dev, caps) if ctx.get("control") \
        else None
    work_counts = dict(counts, games=b, sims=s["mcts_simulations"],
                       window_decisions=decisions, window_steps=steps)
    return {"e2e": {"decisions_per_s": decisions / elapsed,
                    "setup_s": setup_s},
            "counts": work_counts, "trace": summary, "checks": checks,
            "attempted": decisions, "failed": 0,
            "memory_peak_bytes": peak, "config": s, "control": control}


def control_checks(s, seed, dev, caps) -> list:
    """The control: the reference with an int4 trunk in the program's
    place, held to the int8 reference on the same captured micro-steps."""
    rcfg = reference_config(s)
    net = ref_params.load_net(weights(s, seed, dev), rcfg, dev)
    ref8 = ref_fast.prepare(net, rcfg, s["calib_seed"], dev, qmax=127)
    ref4 = ref_fast.prepare(net, rcfg, s["calib_seed"], dev, qmax=7)
    worst = {"net_gap_max": 0.0, "net_gap_p99": 0.0, "visit_gap": 0.0}
    for step, cap in sorted(caps.items()):
        if "next" not in cap:
            continue
        r = ref_play.check_step(ref_play.control_outputs(cap, ref4, rcfg),
                                ref8, rcfg)
        for k in worst:
            worst[k] = max(worst[k], r[k])
    return [harness.check(k, v, LIMITS[k]) for k, v in worst.items()]


def check(s, seed, dev, caps, ffs, records, deal_gen, deal,
          versus) -> list:
    """The reference's checks of the captured micro-steps and the deal."""
    rcfg = reference_config(s)
    net = ref_params.load_net(weights(s, seed, dev), rcfg, dev)
    folded = ref_fast.prepare(net, rcfg, s["calib_seed"], dev)
    worst = {"net_gap_max": 0.0, "net_gap_p99": 0.0, "visit_gap": 0.0,
             "pick_mismatch": 0, "rules_mismatch": 0}
    if s["record"]:
        worst["record_mismatch"] = 0
    if versus:
        worst["ff_mismatch"] = 0
    seen = 0
    for step, cap in sorted(caps.items()):
        if "next" not in cap:
            continue
        if s["record"]:
            cap["record"] = records.get(step)
        r = ref_play.check_step(cap, folded, rcfg)
        for k in worst:
            if k in r:
                worst[k] = max(worst[k], r[k])
        if versus:
            worst["ff_mismatch"] = max(
                worst["ff_mismatch"],
                ref_play.check_fast_forward(ffs[step], rcfg,
                                            ffs[step]["kinds"])
                if step in ffs else s["games"])
        seen += 1
    worst["deal_mismatch"] = ref_play.check_deal(s["games"], deal_gen, dev,
                                                 deal)
    out = [harness.check(k, v, LIMITS[k]) for k, v in worst.items()]
    out.append(harness.check("steps_checked", seen, s["check_steps"],
                             ok=seen == s["check_steps"]))
    return out
