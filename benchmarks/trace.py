"""The profiler window of a ``--trace 1`` run and its reduction.

``Window`` runs ``torch.profiler`` (CPU and CUDA activities) around a
stretch of the run, inside a ``window`` span that starts and ends with the
device idle, and writes the Chrome trace to a fixed file inside the
checkout.  ``reduce`` reads it back into the numbers the per-layer
metrics take:

- ``window_s``: the ``window`` span's length;
- ``busy_s``: the union of the device operations' intervals inside it;
- ``span_device_s``: for each span name, the device time of the operations
  whose launching call lies inside a span of that name (kernels are never
  attributed by their own name);
- ``host_ops``: the CPU-side ``aten::`` operations recorded;
- ``device_ops`` and ``idle_gaps``: the ten device operations that took
  most time, and the idle time of the device grouped by what the host was
  doing (its innermost span and call), the ten largest.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Window:
    """``with Window(path): ...`` profiles the block."""

    def __init__(self, path: Path):
        self.path = Path(path)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = record_function("window")
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
        return False


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(merged, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


def reduce(path: Path, spans=()) -> dict:
    """The numbers of one trace file (see the module's docstring); the
    file is deleted once read."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == "window" and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    launch_ts = {}
    device, annotations, host = [], defaultdict(list), []
    host_ops = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", "?"),
                           e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
            host.append((ts, ts + dur, e.get("name", "?")))
        elif cat == "user_annotation":
            annotations[e["name"]].append((ts, ts + dur))
        elif cat == "cpu_op":
            if w0 <= ts <= w1 and e.get("name", "").startswith("aten::"):
                host_ops += 1
            host.append((ts, ts + dur, e.get("name", "?")))
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    busy = _merge((max(a, w0), min(b, w1)) for a, b, _, _ in device)
    busy_us = sum(b - a for a, b in busy)
    by_name = defaultdict(float)
    for a, b, name, _ in device:
        by_name[name] += (b - a) * 1e-6
    span_s = {}
    for name in spans:
        merged = _merge(annotations.get(name, ()))
        starts = [a for a, _ in merged]
        span_s[name] = sum(
            (b - a) * 1e-6 for a, b, _, corr in device
            if corr in launch_ts and _inside(merged, starts,
                                             launch_ts[corr]))
    gaps = defaultdict(float)
    if busy:
        edges = [(w0, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                      for i in range(len(busy) - 1)]
        edges.append((busy[-1][1], w1))
    else:
        edges = [(w0, w1)]
    host.sort()
    host_starts = [h[0] for h in host]
    nested = []
    for name in spans:
        merged = _merge(annotations.get(name, ()))
        nested.append((name, merged, [a for a, _ in merged]))
    for a, b in edges:
        if b > a:
            gaps[_doing(a, host, host_starts, nested)] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "span_device_s": span_s, "host_ops": host_ops,
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


def _doing(t, host, host_starts, nested) -> str:
    """What the host was doing at time ``t``: the innermost of the spans
    (``nested``, innermost first) and the innermost call running then."""
    call = "-"
    i = bisect.bisect_right(host_starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        a, b, n = host[j]
        if a <= t <= b:
            call = n
            break
    span = next((name for name, merged, starts in nested
                 if _inside(merged, starts, t)), "-")
    return f"{span}: {call}"
