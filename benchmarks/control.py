"""The readings that the limits of a cell's compared numbers are set from.

    python benchmarks/control.py --workload <name> --first-seed <n> \
        --seeds 12 --control-seeds 3 [--seconds 1]

In one process, runs the cell on ``--seeds`` consecutive seeds from
``--first-seed`` (the program's readings: the lower ends) and, on the first
``--control-seeds`` of them, also the control (the reference in the
nearest precision below the configuration's, in the program's place: the
upper ends).  With ``--fault`` every run has that fault planted under the
timed path (``faults.py``).  Prints one JSON line per seed and then the
largest program reading and the smallest control reading of each number.
Needs the card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", default=None,
                   help="plant this fault (faults.py) under every run")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import contextlib

    from benchmarks import faults, harness
    import torch
    cell = harness.Cell(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("the control needs a CUDA card", file=sys.stderr)
        return 2
    drv = harness.driver(cell)
    dev = torch.device("cuda", 0)
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + i
        plant = (faults.planted(cell.traffic["driver"], args.fault)
                 if args.fault else contextlib.nullcontext())
        with plant:
            out = drv.run(harness.context(
                cell, seed, args.seconds, False, dev, time.perf_counter(),
                control=i < args.control_seeds))
        prog = {c["name"]: c["value"] for c in out["checks"]}
        ctl = {c["name"]: c["value"] for c in out["control"] or ()}
        for k, v in prog.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in ctl.items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"seed": seed, "program": prog, "control": ctl,
                          "correct": all(c["ok"] for c in out["checks"]),
                          "e2e": out["e2e"]}), flush=True)
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": upper,
                      "card": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
