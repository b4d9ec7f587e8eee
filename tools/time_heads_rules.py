"""Time K5 (heads_eval) and K7 (rules step and expand) of one checkout of
the PyTorch/CUDA port on the card, with that checkout's own chip_smoke.py
checks (each compares the kernel with its plain version, then times the
call with CUDA events and the kernel alone from a profiler trace).

    python tools/time_heads_rules.py --root DIR --tag NAME [--out FILE]

DIR is the root of a checkout (the package and chip_smoke.py are imported
from there, so two commits can be timed in turns on one card: parent,
change, change, parent).  Prints one JSON line, and appends
it to FILE when given.  K5 runs on the folded heads of a random 1x256 net
(value_hidden 256) at B = 64, 128, 512 and 1,024, on rectified Gaussian
trunk outputs with the legal masks of played states; K7 steps the first 64
and all 1,024 of chip_smoke's mixed states, and expands a 64-game tree
grown by 32 simulations (N = 34).  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--tag", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, args.root)
    import torch
    import chip_smoke as CS
    from alphazero_risk_tpu_torch import kernels
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.mcts import search as S
    from alphazero_risk_tpu_torch.models import fast_infer as FI
    from alphazero_risk_tpu_torch.models.resnet import build_network

    if not torch.cuda.is_available():
        sys.exit("needs a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.build_all()
    dev = torch.device("cuda")
    cfg = Config()
    out = {"tag": args.tag, "root": args.root, "card": card,
           "build_s": time.perf_counter() - t0}

    def keep(e):
        return {k: e[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "max_abs_err")}

    with torch.inference_mode():
        torch.manual_seed(0)
        net = build_network(Config(blocks=1), device=dev).eval()
        folded = FI.fold_params(net, cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        states = CS.random_play_states(1024, 100, gen, cfg, dev)
        legal = rules.legal_actions(states, cfg)
        h = torch.randn((1024, 42, 256), generator=gen, device=dev).relu()
        for b in (64, 128, 512, 1024):
            out[f"k5_b{b}"] = keep(CS.check_k5(
                folded, h[:b].contiguous(), legal[:b].contiguous()))
        mx = CS.mixed_states(cfg, dev)
        out["k7_step_b64"] = keep(CS.check_k7(CS.first(mx, 64), cfg))
        out["k7_step_b1024"] = keep(CS.check_k7(mx, cfg))
        scfg = cfg.replace(mcts_simulations=32)
        root = CS.first(mx, 64).state
        grow = S.draw_gumbel(torch.Generator(device=dev).manual_seed(5),
                             scfg, 64, dev)
        tree = S.search(root, grow, scfg, CS.heuristic_eval).tree
        out["k7_expand_b64_n34"] = keep(CS.check_k7_expand(tree, grow[0],
                                                           scfg))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
