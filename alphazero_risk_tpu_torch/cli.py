"""Command-line entry point of the port.

Port of the ``play`` mode of ``alphazero_risk_tpu/cli.py``: AlphaZero
(``--p1 az``) against the ScriptPlayer (``--p2 sp``) in mirrored pairs,
with argmax moves, optionally on the BN-folded bf16 (``--fast``) or int8
(``--fast --int8``) inference path.  Runs on the card unless ``--cpu`` is
given.

Usage:
  python -m alphazero_risk_tpu_torch.cli -m play --p1 az --p2 sp \\
      --games 64 --mcts 32 --fast --int8 \\
      --c1 artifacts/params-20block-r4-best.npz
"""

from __future__ import annotations

import argparse
import json

from .config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alphazero_risk_tpu_torch",
        description="AlphaZero for the game Risk (PyTorch/CUDA port)")
    p.add_argument("-m", "--mode", default="play", choices=["play"],
                   help="only play is ported so far")
    p.add_argument("--p1", default="az", choices=["az"],
                   help="player 1 (the port plays AlphaZero in seat 0)")
    p.add_argument("--p2", default="sp", choices=["sp"],
                   help="opponent: the ScriptPlayer")
    p.add_argument("--c1", default=None,
                   help="params npz of player 1 in the save_params_npz "
                        "format (the port has no orbax checkpoints yet); "
                        "random weights from --seed when omitted")
    p.add_argument("--games", "--cg", type=int, default=1000,
                   help="games to play (rounded up to mirrored pairs)")
    p.add_argument("--mcts", type=int, default=None,
                   help="MCTS simulations per move")
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--env-batch", type=int, default=None,
                   help="lockstep games per wave")
    p.add_argument("--max-steps", type=int, default=None,
                   help="AlphaZero micro-step cap per wave")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fast", action="store_true",
                   help="BN-folded fast inference")
    p.add_argument("--int8", action="store_true",
                   help="with --fast: int8-quantized trunk")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def config_from_args(args) -> Config:
    over = {}
    for arg, field in (("mcts", "mcts_simulations"), ("blocks", "blocks"),
                       ("env_batch", "env_batch_per_device"),
                       ("max_steps", "max_game_steps")):
        v = getattr(args, arg, None)
        if v is not None:
            over[field] = v
    over["fast_infer"] = bool(args.fast)
    over["fast_infer_int8"] = bool(args.fast and args.int8)
    return Config().replace(**over)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = "cpu" if args.cpu else "cuda"

    from .training import actor as A
    from .training.checkpoints import load_params_npz
    from .training.trainer import Trainer

    trainer = Trainer(cfg, seed=args.seed, device=device)
    if args.c1 is not None:
        trainer.net = load_params_npz(args.c1, cfg, device=device)
    res = trainer.play(A.OPP_SCRIPT, args.games)
    print(json.dumps({"mode": "play", "p2": args.p2, **res}))


if __name__ == "__main__":
    main()
