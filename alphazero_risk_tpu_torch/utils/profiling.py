"""Spans, counters and the profiler trace.

The port's counterpart of ``alphazero_risk_tpu/utils/profiling.py``, and
the recorder of the play path's layers.  ``span(name)`` marks a stretch of
host code (a layer: the actor's micro-step, the search, the network, the
trunk, a blocking read); ``count(name, n)`` adds to a counter.  Both record
only while a ``torch.profiler`` session runs, and cost one check of the
profiler's flag otherwise: ``span`` then returns one shared object that
does nothing.  ``trace`` runs such a session around a block and writes its
Chrome trace, in which every span is a ``user_annotation`` range on the
clock of the operators and kernels it launched.

While the profiler runs, each span also keeps its host interval
(``time.perf_counter_ns``) and, when CUDA is in use, a pair of timing
events on the current stream around the work it enqueued: their distance
is the stream's time from the span's first operation to its last, busy or
idle.  A recording session starts at the first span that finds the
profiler on after one found it off (or after ``report`` read the last
session with the profiler off): the recorder then empties its record.
``report`` sums the record by span name.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import _profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str = "log/traces"):
    """Profile the block with ``torch.profiler``; on exit write
    ``{log_dir}/trace-<pid>-<ns>.json`` (a Chrome trace).  Yields the
    profiler, whose ``key_averages()`` the caller may read after the
    block."""
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


class _NoSpan:
    """The span of a run without the profiler: enters and exits, nothing
    else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Recorder:
    """One recording session: its spans in the order they opened, the
    open ones and the counters."""

    def __init__(self):
        self.on = False
        self.session = 0
        self.spans = []          # [name, parent index, t0, t1, e0, e1]
        #                          t1 None while open, e0/e1 None on a CPU
        self.stack = []          # indices of the open spans' entries
        self.counters = {}
        self.events = []         # timing events, reused across sessions
        self.used = 0
        self.cuda = False        # whether spans record timing events

    def start(self) -> None:
        self.on = True
        self.session += 1
        self.spans, self.stack, self.counters, self.used = [], [], {}, 0
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()

    def event(self):
        if self.used == len(self.events):
            self.events.append(torch.cuda.Event(enable_timing=True))
        self.used += 1
        return self.events[self.used - 1]


_REC = _Recorder()


def _recording() -> bool:
    """Whether the profiler runs; starts a session when it has just been
    switched on."""
    if not _profiler_enabled():
        _REC.on = False
        return False
    if not _REC.on:
        _REC.start()
    return True


class _Span:
    __slots__ = ("name", "session", "rf", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        self.session = rec.session
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        parent = rec.stack[-1] if rec.stack else None
        t0, e0 = time.perf_counter_ns(), None
        if rec.cuda:
            e0 = rec.event()
            e0.record()
        self.entry = [self.name, parent, t0, None, e0, None]
        rec.spans.append(self.entry)
        rec.stack.append(len(rec.spans) - 1)
        return None

    def __exit__(self, *exc):
        rec = _REC
        if self.session == rec.session:
            entry = self.entry
            if entry[4] is not None:
                entry[5] = rec.event()
                entry[5].record()
            entry[3] = time.perf_counter_ns()
            rec.stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking one stretch of a layer's host code under
    ``name``: a ``record_function`` range and an entry of the record while
    the profiler runs, the shared do-nothing object otherwise."""
    return _Span(name) if _recording() else _NO_SPAN


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name`` while the
    profiler runs."""
    if _recording():
        _REC.counters[name] = _REC.counters.get(name, 0) + int(n)


def report() -> dict:
    """The last session's record summed by span name: ``{"spans": {name:
    {"count", "host_s", "host_self_s", "device_s", "parents"}},
    "counters": {name: n}}``.  ``host_self_s`` leaves out the host time of
    the span's child spans, ``device_s`` is the sum of the time between
    each span's two events (None without CUDA), and ``parents`` the names
    of the spans it opened in (None at the top).  With the profiler off,
    the session counts as read: the next span that finds the profiler on
    starts a new one."""
    if not _profiler_enabled():
        _REC.on = False
    if _REC.cuda and _REC.spans:
        torch.cuda.synchronize()
    child_s = [0] * len(_REC.spans)
    for s in _REC.spans:
        if s[1] is not None and s[3] is not None:
            child_s[s[1]] += s[3] - s[2]
    out = {}
    for i, (name, parent, t0, t1, e0, e1) in enumerate(_REC.spans):
        if t1 is None:
            continue
        r = out.setdefault(name, {"count": 0, "host_s": 0.0,
                                  "host_self_s": 0.0,
                                  "device_s": None if e0 is None else 0.0,
                                  "parents": []})
        r["count"] += 1
        r["host_s"] += (t1 - t0) * 1e-9
        r["host_self_s"] += (t1 - t0 - child_s[i]) * 1e-9
        if e0 is not None:
            r["device_s"] += e0.elapsed_time(e1) * 1e-3
        p = None if parent is None else _REC.spans[parent][0]
        if p not in r["parents"]:
            r["parents"].append(p)
    return {"spans": out, "counters": dict(_REC.counters)}
