"""Profiling and tracing hooks.

Replaces the reference's compile-time LOG_PERFORMANCE probes: a
``torch.profiler`` trace for kernel-level analysis and a light wall-clock
phase timer feeding the JSONL event log.

The port's counterpart of ``alphazero_risk_tpu/utils/profiling.py``:
``trace`` records CPU activity and, when a card is present, CUDA activity,
and writes a Chrome trace (open it in Perfetto or ``chrome://tracing``);
``PhaseTimer`` is the same timer, writing the same ``phase_time`` events.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str = "log/traces"):
    """Profile the block with ``torch.profiler``; on exit write
    ``{log_dir}/trace-<pid>-<ns>.json`` (a Chrome trace).  Yields the
    profiler, whose ``key_averages()`` the caller may read after the
    block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class PhaseTimer:
    """Wall-clock timing per named phase, mirrored into a Logs JSONL."""

    def __init__(self, logs=None):
        self.logs = logs
        self.totals = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            if self.logs is not None:
                self.logs.event("phase_time", phase=name, seconds=dt)
