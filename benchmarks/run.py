"""Run one cell of the benchmark once.

    python benchmarks/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``.  The run needs as many CUDA
cards as the cell asks for and exits with code 2, printing no result,
without them.  It builds the program's kernels into ``build/kernels/``
inside the checkout (only a checkout's first run compiles), sets the cell
up from the seed, measures for ``--seconds`` seconds, checks what the
timed path produced against the plain reference, and prints the compared
numbers as the last lines on standard error and one JSON result as the
last line on standard output.  With ``--trace 1`` the result holds the
cell's per-layer metrics, read from a profiler window, instead of its
end-to-end metrics.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of a run at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    sys.path.insert(0, ROOT)
    from benchmarks import harness

    cell = harness.Cell(harness.load_spec(), args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); {cards} "
              "visible", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
