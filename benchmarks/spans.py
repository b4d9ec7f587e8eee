"""The program's own spans of a traced window, as the per-layer metrics
that read them take them.

A ``--trace 1`` run profiles one chunk (``trace.Window``); inside it the
program records its spans and counters
(``alphazero_risk_tpu_torch.utils.profiling``), and its ``report()`` sums
them by name once the window has closed.  A program without that recorder
gives nothing to read, and its metrics are left out of the result line.
"""

from __future__ import annotations


def report(ctx):
    """The program's record of the traced window, or None: without a
    profiler window, without traced micro-steps, or without the
    recorder."""
    if not ctx.get("trace") or not ctx["counts"].get("steps"):
        return None
    from alphazero_risk_tpu_torch.utils import profiling
    read = getattr(profiling, "report", None)
    return None if read is None else read()


def total(ctx, name: str, key: str):
    """``key`` (``host_s``, ``host_self_s``, ``device_s``, ``count``) of
    the spans named ``name`` in the traced window, or None."""
    r = report(ctx)
    s = None if r is None else r["spans"].get(name)
    return None if s is None else s[key]


def ms_per_step(ctx, seconds):
    """Milliseconds a traced micro-step, or None."""
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["counts"]["steps"]
