"""What every cell shares: finding a cell's files by name, the device's
description, the import check, the per-layer readers and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``, a ``run(ctx)`` function).  A per-layer metric is
``metrics/<name>.py``, whose ``read(ctx)`` returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPEC = ROOT / "BENCHMARK.json"
# Build and work files of a run, inside the checkout, at fixed paths.
WORK = ROOT / "build" / "bench"

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "alphazero_risk_tpu")


def forbidden_loaded(names=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole: ``alphazero_risk_tpu_torch`` is
    not ``alphazero_risk_tpu``."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_spec(path: Path = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One cell of the spec with its configuration, traffic, driver and
    per-layer metrics, each found by name under ``root``."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = _read_json(root / configs[self.entry["config"]]["file"])
        bench = root / "benchmarks"
        self.traffic = _read_json(bench / "traffic"
                                  / f"{self.entry['traffic']}.json")
        self.driver_file = bench / "drivers" / f"{self.traffic['driver']}.py"
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", (name,))]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", ())
                          or ("workloads" not in m
                              and m["moves"] in reported)]
        self.metric_files = {m["name"]: bench / "metrics" / f"{m['name']}.py"
                             for m in self.per_layer}


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """A module from a file of ``paths`` (a metric's name has dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    """The traffic's driver module, found by its file."""
    return load_file(cell.driver_file,
                     "bench_driver_" + cell.traffic["driver"])


def read_metrics(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric's reader over ``ctx``; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        mod = load_file(cell.metric_files[m["name"]],
                        "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(device, count: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": power_limit()}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not read"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def checks_text(checks: list) -> list:
    """One line per compared number: name, value, limit, held or not."""
    return [f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}, "
            f"{'held' if c['ok'] else 'FAILED'})" for c in checks]


def emit(result: dict, checks: list) -> None:
    """The checks as the last lines on standard error, then the result
    line, with the checks under the last key, as the last line on
    standard output."""
    for line in checks_text(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    print(json.dumps(line), flush=True)


class Phases:
    """Seconds of each set-up phase, printed to standard error (before the
    checks) so that set-up's cost can be read apart."""

    def __init__(self, t_start: float):
        self.last, self.parts = t_start, []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.last:.3f} s")
        self.last = now

    def report(self) -> None:
        print("set-up: " + ", ".join(self.parts), file=sys.stderr)


def check(name: str, value, limit, ok: bool | None = None) -> dict:
    """A compared number beside its limit; held when ``value <= limit``
    unless ``ok`` says otherwise."""
    return {"name": name, "value": value, "limit": limit,
            "ok": bool(value <= limit) if ok is None else bool(ok)}


def context(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, overrides: dict | None = None,
            control: bool = False) -> dict:
    """What a driver's ``run`` takes.  ``overrides`` replace settings of the
    configuration and traffic (tests run tiny sizes on the CPU);
    ``control`` also runs the control (``control.py``)."""
    return {"cell": cell, "seed": int(seed), "seconds": float(seconds),
            "trace": bool(trace), "device": device, "t_start": t_start,
            "work_dir": WORK / cell.name, "overrides": overrides or {},
            "control": control}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: dict | None = None):
    """Run one cell once on ``device`` and return ``(result, checks)``:
    the result line's keys (its metrics the cell's end-to-end ones, or with
    ``trace`` its per-layer ones) and the compared numbers."""
    out = driver(cell).run(context(cell, seed, seconds, trace, device,
                                   t_start, overrides))
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    if trace:
        summary = out.get("trace") or {}
        metrics = read_metrics(cell, {"trace": summary,
                                      "counts": out["counts"],
                                      "config": out["config"]})
        if summary:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = out["checks"]
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    if trace and out.get("trace"):
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
    return result, checks
