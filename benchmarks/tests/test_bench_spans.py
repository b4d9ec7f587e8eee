"""The per-layer metrics that read the program's own spans
(``benchmarks/spans.py``): nothing without a profiler window or without the
program's recorder, and the expected number from a hand-built record."""

import pytest

from benchmarks import harness, work
from alphazero_risk_tpu_torch.utils import profiling

CONFIG = {"blocks": 20, "filters": 256, "infer_precision":
          "int8 trunk (per-output-channel weight scales), bfloat16 stem"}
STEPS = 16


def _span(count, host, self_, device):
    return {"count": count, "host_s": host, "host_self_s": self_,
            "device_s": device, "parents": [None]}


REPORT = {
    "spans": {
        "actor.step": _span(16, 2.4, 0.3, 2.6),
        "actor.ff": _span(16, 0.2, 0.05, 0.01),
        "host.sync": _span(20, 0.15, 0.15, 0.001),
        "search.run": _span(16, 1.9, 0.4, 2.5),
        "net.eval": _span(528, 1.5, 0.9, 2.45),
        "net.trunk": _span(528, 0.6, 0.6, 2.33),
    },
    "counters": {"net.boards": 528 * 1024},
}

EXPECTED = {
    "trunk_roofline.play": 100.0 * 528 * 1024 * work.trunk_flops(CONFIG)
    / work.PEAK["int8_ops"] / 2.33,
    "net_nontrunk_ms_per_step.play": 1e3 * (2.45 - 2.33) / STEPS,
    "net_host_ms_per_step.play": 1e3 * 1.5 / STEPS,
    "search_host_ms_per_step.play": 1e3 * 0.4 / STEPS,
    "actor_host_ms_per_step.play": 1e3 * 0.3 / STEPS,
    "ff_host_ms_per_step.play": 1e3 * 0.05 / STEPS,
    "sync_wait_ms_per_step.play": 1e3 * 0.15 / STEPS,
}


def _metric(name):
    spec = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    assert spec[name]["source"] == "program_span"
    assert spec[name]["moves"] == "decisions_per_s"
    return harness.load_file(
        harness.ROOT / "benchmarks" / "metrics" / f"{name}.py",
        "bench_metric_" + name.replace(".", "_"))


def _ctx(trace=True, config=CONFIG):
    return {"trace": {"window_s": 2.7, "busy_s": 2.5} if trace else {},
            "counts": {"steps": STEPS}, "config": config}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_metric_reads_the_record(name, monkeypatch):
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    m = _metric(name)
    assert m.read(_ctx(trace=False)) is None
    assert m.read(_ctx()) == pytest.approx(EXPECTED[name], rel=1e-12)
    # a program without the recorder reads as nothing, and so does a
    # record without the span
    monkeypatch.delattr(profiling, "report")
    assert m.read(_ctx()) is None
    monkeypatch.setattr(profiling, "report",
                        lambda: {"spans": {}, "counters": {}}, raising=False)
    assert m.read(_ctx()) is None


def test_trunk_roofline_needs_an_int8_trunk(monkeypatch):
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    m = _metric("trunk_roofline.play")
    bf16 = dict(CONFIG, infer_precision="bfloat16 trunk and stem")
    assert m.read(_ctx(config=bf16)) is None


def test_span_metrics_none_without_a_card(monkeypatch):
    """On the CPU the record has no device seconds: the device metrics
    read nothing, the host ones read the host seconds."""
    cpu = {"spans": {k: dict(v, device_s=None)
                     for k, v in REPORT["spans"].items()},
           "counters": REPORT["counters"]}
    monkeypatch.setattr(profiling, "report", lambda: cpu)
    for name in ("trunk_roofline.play", "net_nontrunk_ms_per_step.play"):
        assert _metric(name).read(_ctx()) is None
    assert _metric("net_host_ms_per_step.play").read(_ctx()) == \
        pytest.approx(EXPECTED["net_host_ms_per_step.play"])
