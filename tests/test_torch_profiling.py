"""The port's span and counter recorder (``utils/profiling.py``) on the CPU.

- Without a profiler ``span`` returns one shared object and nothing is
  recorded.
- Under ``torch.profiler.profile`` nested spans report their counts, host
  and self times and parents, and the counters their sums; device seconds
  are None without CUDA.  A second session starts from an empty record.
- ``trace`` writes a Chrome trace whose ``user_annotation`` ranges hold
  the spans, nested as they ran.
- A tiny ``run_episodes`` (the arena with the opponent fast-forwarded, and
  self-play) gives bit-equal outputs with the profiler on and off, and
  records one ``actor.step`` a micro-step, ``sims + 1`` ``net.eval`` a
  search, one ``net.trunk`` and its boards an evaluation, and a
  ``host.sync`` for each fast-forward block.
- ``net.boards_wide`` adds the boards of each int8 trunk pass whose K1
  launches take the wide design, once a pass, and only under the
  profiler: without it the design is not even asked for.
"""

import dataclasses
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alphazero_risk_tpu_torch.agents import blocks
from alphazero_risk_tpu_torch.agents.blocks import OPP_SCRIPT
from alphazero_risk_tpu_torch.agents.driver import mirrored_initial_states
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.models import fast_infer as TF
from alphazero_risk_tpu_torch.models.resnet import AZNet
from alphazero_risk_tpu_torch.training import actor as TA
from alphazero_risk_tpu_torch.utils import profiling as P

torch.set_num_threads(1)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _session(body):
    """Run ``body`` under the profiler and return the record's report."""
    with _cpu_profile():
        body()
    return P.report()


def test_span_without_profiler_is_shared_and_records_nothing():
    rep = _session(lambda: _one("kept"))
    assert set(rep["spans"]) == {"kept"}
    a, b = P.span("x"), P.span("y")
    assert a is b and a is P._NO_SPAN
    with P.span("x"):
        P.count("c", 3)
    with P.span("y"):
        pass
    rep = P.report()
    assert set(rep["spans"]) == {"kept"} and rep["counters"] == {}


def _one(name):
    with P.span(name):
        pass


def test_nested_spans_report_counts_times_parents_counters():
    def body():
        with P.span("outer"):
            for _ in range(2):
                with P.span("inner"):
                    time.sleep(0.02)
                    P.count("rows", 5)
                    with P.span("leaf"):
                        time.sleep(0.01)
            time.sleep(0.01)
        P.count("rows", 1)

    rep = _session(body)
    s = rep["spans"]
    assert {k: v["count"] for k, v in s.items()} == {"outer": 1, "inner": 2,
                                                     "leaf": 2}
    assert s["outer"]["parents"] == [None]
    assert s["inner"]["parents"] == ["outer"]
    assert s["leaf"]["parents"] == ["inner"]
    assert all(v["device_s"] is None for v in s.values())
    assert rep["counters"] == {"rows": 11}
    assert s["leaf"]["host_s"] >= 0.02
    assert s["inner"]["host_s"] >= 0.06
    assert s["outer"]["host_s"] >= 0.07
    for name, child in (("outer", "inner"), ("inner", "leaf")):
        self_s = s[name]["host_s"] - s[child]["host_s"]
        assert s[name]["host_self_s"] == pytest.approx(self_s, abs=1e-9)
    assert s["leaf"]["host_self_s"] == pytest.approx(s["leaf"]["host_s"])
    assert s["inner"]["host_self_s"] >= 0.04
    assert s["outer"]["host_self_s"] >= 0.01


def test_second_session_starts_empty():
    def first():
        with P.span("a"):
            P.count("n", 2)

    def second():
        with P.span("b"):
            pass

    assert set(_session(first)["spans"]) == {"a"}
    rep = _session(second)
    assert set(rep["spans"]) == {"b"} and rep["counters"] == {}
    # a session read with the profiler off is over, though no span ran
    # between the two sessions
    assert P.report() == rep
    rep = _session(first)
    assert set(rep["spans"]) == {"a"} and rep["counters"] == {"n": 2}


def test_trace_writes_the_spans_nested(tmp_path):
    with P.trace(str(tmp_path)):
        with P.span("outer"):
            with P.span("inner"):
                x = torch.ones(32, 32)
                (x @ x).sum()
            with P.span("inner"):
                pass
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert len(ranges["outer"]) == 1 and len(ranges["inner"]) == 2
    (o0, o1), = ranges["outer"]
    for a, b in ranges["inner"]:
        assert o0 <= a <= b <= o1
    assert P.report()["spans"]["inner"]["count"] == 2


SIMS, STEPS, GAMES = 2, 4, 4


def _eval_fn(cfg):
    torch.manual_seed(3)
    net = AZNet(cfg.blocks, cfg.filters, cfg.value_hidden,
                cfg.num_features).eval()
    feats = TF.default_calib_feats(cfg, torch.Generator().manual_seed(5),
                                   batch=8, device="cpu")
    folded = TF.fold_for_inference(net, cfg, int8=True, calib_feats=feats)
    fast = TF.make_fast_eval_fn(cfg, int8=True)
    return lambda s, m: fast(folded, s, m)


def _episodes(cfg, efn, mode):
    gen = torch.Generator().manual_seed(11)
    state0 = mirrored_initial_states(GAMES, generator=gen, device="cpu")
    draws = TA.GeneratorDraws(gen, cfg, GAMES, "cpu")
    if mode == "arena":
        return TA.run_episodes(efn, state0, draws, cfg, STEPS,
                               opponent=OPP_SCRIPT, az_seats=(True, False),
                               sample_moves=False, record_all=False)
    return TA.run_episodes(efn, state0, draws, cfg, STEPS)


def _flat(out):
    fields = [getattr(part, f.name) for part in (out.state, out.carry)
              for f in dataclasses.fields(part)]
    return fields + list(out.samples) + [out.status, out.prev_player,
                                         out.az_decisions]


@pytest.mark.parametrize("mode", ["arena", "selfplay"])
def test_run_episodes_spans_change_nothing_and_count(mode, monkeypatch):
    cfg = Config(blocks=1, filters=16, value_hidden=8,
                 mcts_simulations=SIMS, max_depth=12)
    efn = _eval_fn(cfg)
    off = _episodes(cfg, efn, mode)
    ff_blocks, ff_iters = [], []
    run_blocks = blocks.run_agent_blocks

    def counted(*a, **kw):
        out = run_blocks(*a, **kw)
        ff_iters.append(out[3])
        ff_blocks.append(out[4])
        return out

    monkeypatch.setattr(blocks, "run_agent_blocks", counted)
    with _cpu_profile():
        on = _episodes(cfg, efn, mode)
    rep = P.report()
    for a, b in zip(_flat(off), _flat(on), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    s = rep["spans"]
    evals = STEPS * (SIMS + 1)
    assert s["actor.step"]["count"] == STEPS
    assert s["search.run"]["count"] == STEPS
    assert s["search.run"]["parents"] == ["actor.step"]
    assert s["net.eval"]["count"] == evals
    assert s["net.eval"]["parents"] == ["search.run"]
    assert s["net.trunk"]["count"] == evals
    assert s["net.trunk"]["parents"] == ["net.eval"]
    # off the card no board takes K1's wide design
    assert rep["counters"] == {"net.boards": evals * GAMES,
                               "net.boards_wide": 0}
    if mode == "arena":
        assert len(ff_blocks) == STEPS and sum(ff_iters) > 0
        assert s["actor.ff"]["count"] == STEPS
        assert s["actor.ff"]["parents"] == ["actor.step"]
        assert s["host.sync"]["count"] >= sum(ff_blocks)
        assert s["host.sync"]["parents"] == ["actor.ff"]
    else:
        assert ff_blocks == [] and "actor.ff" not in s
    for v in s.values():
        assert v["device_s"] is None
        assert 0.0 <= v["host_self_s"] <= v["host_s"]


def test_wide_boards_counted_once_a_trunk_pass_under_the_profiler(
        monkeypatch):
    """The wide design's answer stands in for the card's (off the card
    none is wide): every other trunk pass takes it.  The count is asked
    once a pass (not once a conv: two blocks, four convs), only while the
    profiler runs, and the episodes stay bit-equal."""
    cfg = Config(blocks=2, filters=16, value_hidden=8,
                 mcts_simulations=SIMS, max_depth=12)
    efn = _eval_fn(cfg)
    asked = []

    def wide(boards, cout, device):
        asked.append((boards, cout, device.type))
        return len(asked) % 2 == 1

    monkeypatch.setattr(TF, "k1_wide", wide)
    off = _episodes(cfg, efn, "selfplay")
    assert asked == []
    with _cpu_profile():
        on = _episodes(cfg, efn, "selfplay")
    rep = P.report()
    for a, b in zip(_flat(off), _flat(on), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    evals = STEPS * (SIMS + 1)
    assert asked == [(GAMES, cfg.filters, "cpu")] * evals
    assert rep["counters"] == {"net.boards": evals * GAMES,
                               "net.boards_wide": (evals + 1) // 2 * GAMES}
