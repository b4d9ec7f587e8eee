"""Tiny dry runs of each traffic driver on the CPU (the program's plain
versions), and the measuring path without a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmarks import harness

TINY_PLAY = {"blocks": 1, "filters": 64, "value_hidden": 8, "games": 4,
             "mcts_simulations": 2, "chunk_steps": 2, "check_steps": 2,
             "check_span": 6, "weights": "seeded"}
TINY = {"play": TINY_PLAY}


def dry_run(name, trace=False, seed=11, overrides=None, capsys=None):
    spec = harness.load_spec()
    cell = harness.Cell(spec, name)
    ov = dict(TINY[cell.traffic["driver"]], **(overrides or {}))
    return harness.run_cell(cell, seed, 0.2, trace, torch.device("cpu"),
                            time.perf_counter(), ov)


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_spec()
                                  ["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_prints_result_line(cell, trace, capsys):
    result, checks = dry_run(cell, trace)
    harness.emit(result, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["device"]["platform"] == "cpu"
    if not trace:
        names = {m["name"] for m in harness.Cell(harness.load_spec(), cell)
                 .end_to_end}
        assert set(line["metrics"]) == names
    assert err.strip().splitlines()[-1].startswith("check ")


def test_measuring_path_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "az20.arena.b1024", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_harness_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copy(harness.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.ROOT / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "az20.arena.b1024", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
