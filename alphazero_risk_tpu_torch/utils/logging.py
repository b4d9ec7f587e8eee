"""Metrics logging: the reference's five append-mode log files and the
console progress bar (reference ``log.h:11-91``), kept format-compatible
enough for the reference's chart tooling style, plus a JSONL mirror for
programmatic use.

The port's own copy of ``alphazero_risk_tpu/utils/logging.py`` (the port
imports nothing of the JAX package): same files, same line formats.
"""

from __future__ import annotations

import json
import os
import sys
import time


class LogFile:
    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def write(self, line: str) -> None:
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a")
        self._fh.write(line.rstrip("\n") + "\n")
        self._fh.flush()


class Logs:
    """improvement / benchmark / nn-training / nn-performance /
    mcts-performance logs (reference log.h:39-82) and the JSONL event
    mirror."""

    def __init__(self, log_dir: str = "log"):
        self.dir = log_dir
        self.improvement = LogFile(f"{log_dir}/azr-improvement-log.txt")
        self.benchmark = LogFile(f"{log_dir}/azr-benchmark-log.txt")
        self.nn_training = LogFile(f"{log_dir}/azr-nn-log.txt")
        self.nn_performance = LogFile(f"{log_dir}/nn-performance-log.txt")
        self.mcts_performance = LogFile(
            f"{log_dir}/mcts-performance-log.txt")
        self.jsonl = LogFile(f"{log_dir}/events.jsonl")

    def event(self, kind: str, **kw) -> None:
        self.jsonl.write(json.dumps({"ts": time.time(), "kind": kind, **kw}))

    def log_improvement(self, iteration: int, draws: int, new_wins: int,
                        new_started: int, old_wins: int,
                        old_started: int) -> None:
        # reference format: iter,draws, new/started, old/started
        self.improvement.write(
            f"{iteration},{draws}, {new_wins}/{new_started}, "
            f"{old_wins}/{old_started}")
        self.event("improvement", iteration=iteration, draws=draws,
                   new_wins=new_wins, old_wins=old_wins)

    def log_benchmark(self, iteration: int, random_summary, script_summary
                      ) -> None:
        r, s = random_summary, script_summary
        self.benchmark.write(
            f"{iteration},{r['draws']}, {r['p0_wins']}/"
            f"{r['p0_win_started']}, {r['p1_wins']}/{r['p1_win_started']}, "
            f"{s['draws']}, {s['p0_wins']}/{s['p0_win_started']}, "
            f"{s['p1_wins']}/{s['p1_win_started']}")
        self.event("benchmark", iteration=iteration, vs_random=r,
                   vs_script=s)

    def log_nn_epoch(self, iteration: int, epoch: int, pi_loss: float,
                     v_loss: float) -> None:
        self.nn_training.write(
            f"{iteration},{epoch},{pi_loss:.6f},{v_loss:.6f}")
        self.event("nn_epoch", iteration=iteration, epoch=epoch,
                   pi_loss=pi_loss, v_loss=v_loss)


def print_progress(i: int, total: int, width: int = 40) -> None:
    """Console progress bar (reference UtilityFormat::printProgress,
    log.h:11-21)."""
    frac = i / max(total, 1)
    bar = "#" * int(frac * width)
    sys.stdout.write(f"\r[{bar:<{width}}] {i}/{total}")
    sys.stdout.flush()
    if i >= total:
        sys.stdout.write("\n")
