"""The comparisons that decide ``correct`` fail where they must: the
control (the reference with an int4 trunk, in the program's place) fails a
number, and each fault a cell can have, planted under a tiny run on the
CPU, turns ``correct`` false."""

import time

import pytest
import torch

from benchmarks import faults, harness
from benchmarks.tests.test_bench_dry import TINY, dry_run

CPU = torch.device("cpu")
PLAY = ("az20.arena.b1024", "az5.selfplay.b4096")


def _run(name, overrides, control=False):
    cell = harness.Cell(harness.load_spec(), name)
    ov = dict(TINY[cell.traffic["driver"]], **overrides)
    return harness.driver(cell).run(harness.context(
        cell, 21, 0.2, False, CPU, time.perf_counter(), ov, control))


def _trained():
    """The 5-block play weights: random weights at a tiny width give
    near-uniform priors, which hide a wrong evaluation."""
    cell = harness.Cell(harness.load_spec(), "az5.selfplay.b4096")
    return {k: cell.config[k] for k in ("blocks", "filters", "value_hidden",
                                        "weights")}


def test_play_control_fails():
    """The int4 trunk in the program's place, on the 5-block play weights
    at a tiny batch."""
    out = _run("az5.selfplay.b4096", _trained(), control=True)
    assert all(c["ok"] for c in out["checks"])
    assert not all(c["ok"] for c in out["control"])


@pytest.mark.parametrize("cell", PLAY)
@pytest.mark.parametrize("fault", faults.names("play"))
def test_play_fault_turns_correct_false(cell, fault):
    with faults.planted("play", fault):
        result, _ = dry_run(cell, overrides=_trained())
    assert result["correct"] is False



def test_one_game_dropped_fails_the_widest_gap_alone():
    """Over 128 games one wrong evaluation lies beyond the 99th percentile:
    only the widest gap over the games sees it."""
    with faults.planted("play", "one_eval_dropped"):
        out = _run("az5.selfplay.b4096",
                   dict(_trained(), games=128, check_steps=1, check_span=2))
    checks = {c["name"]: c for c in out["checks"]}
    assert checks["net_gap_p99"]["ok"] and checks["visit_gap"]["ok"]
    assert not checks["net_gap_max"]["ok"]
