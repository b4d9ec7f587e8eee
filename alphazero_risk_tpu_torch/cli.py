"""Command-line entry point of the port.

Port of the ``play`` and ``train`` modes of ``alphazero_risk_tpu/cli.py``.
``play``: AlphaZero (``--p1 az``) against the ScriptPlayer (``--p2 sp``) or
the RandomPlayer (``--p2 rp``) in mirrored pairs, with argmax moves.
``train``: the AlphaZero loop (self-play, epochs, gating arena, benchmark,
checkpoints), resuming from ``checkpoints/`` when it holds a ``latest``.
Both optionally on the BN-folded bf16 (``--fast``) or int8 (``--fast
--int8``) inference path.  Runs on the card unless ``--cpu`` is given.

Usage:
  python -m alphazero_risk_tpu_torch.cli -m play --p1 az --p2 sp \\
      --games 64 --mcts 32 --fast --int8 \\
      --c1 artifacts/params-20block-r4-best.npz
  python -m alphazero_risk_tpu_torch.cli -m train --cpu --blocks 2 \\
      --filters 32 --mcts 4 --ti 1 --tg 4 --games 4 --e 1 --bs 32 \\
      --env-batch 4 --max-steps 256 --bench-random 2 --bench-script 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from .config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alphazero_risk_tpu_torch",
        description="AlphaZero for the game Risk (PyTorch/CUDA port)")
    p.add_argument("-m", "--mode", default="play", choices=["play", "train"],
                   help="play and train are ported so far")
    p.add_argument("--p1", default="az", choices=["az"],
                   help="player 1 (the port plays AlphaZero in seat 0)")
    p.add_argument("--p2", default="sp", choices=["sp", "rp"],
                   help="opponent in play mode: ScriptPlayer or RandomPlayer")
    p.add_argument("--c1", default=None,
                   help="weights of player 1 (play) or to start training "
                        "from (train): a checkpoint role (latest, best, "
                        "iter-N) or a params npz in the save_params_npz "
                        "format; random weights from --seed when omitted")
    p.add_argument("--games", "--cg", type=int, default=1000,
                   help="games for play/compare (rounded up to mirrored "
                        "pairs)")
    p.add_argument("--mcts", type=int, default=None,
                   help="MCTS simulations per move")
    p.add_argument("--t", "--temp", dest="temp", type=int, default=None,
                   help="temperature threshold round")
    p.add_argument("--ti", type=int, default=None, help="train iterations")
    p.add_argument("--tg", type=int, default=None,
                   help="games per train iteration")
    p.add_argument("--e", dest="epochs", type=int, default=None)
    p.add_argument("--bs", dest="batch_size", type=int, default=None)
    p.add_argument("--ct", dest="compare_threshold", type=float,
                   default=None)
    p.add_argument("--hp", dest="cpuct", type=float, default=None)
    p.add_argument("--dnv", dest="noise_value", type=float, default=None)
    p.add_argument("--dne", dest="noise_eps", type=float, default=None)
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--filters", type=int, default=None)
    p.add_argument("--value-hidden", type=int, default=None)
    p.add_argument("--bench-random", type=int, default=None,
                   help="benchmark games against the RandomPlayer after an "
                        "accepted gate")
    p.add_argument("--bench-script", type=int, default=None,
                   help="benchmark games against the ScriptPlayer after an "
                        "accepted gate")
    p.add_argument("--allow-yield", type=int, default=None)
    p.add_argument("--limit-reinforcement", type=int, default=None)
    p.add_argument("--limit-attack", type=int, default=None)
    p.add_argument("--mirror-games", type=int, default=None)
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
    mapping = {
        "mcts": "mcts_simulations", "temp": "temperature_threshold",
        "ti": "train_iterations", "tg": "train_iteration_games",
        "epochs": "epochs", "batch_size": "batch_size",
        "compare_threshold": "compare_threshold", "cpuct": "cpuct",
        "noise_value": "noise_value", "noise_eps": "noise_eps",
        "blocks": "blocks", "filters": "filters",
        "value_hidden": "value_hidden",
        "bench_random": "benchmark_games_random",
        "bench_script": "benchmark_games_script",
        "env_batch": "env_batch_per_device", "max_steps": "max_game_steps",
    }
    for arg, field in mapping.items():
        v = getattr(args, arg, None)
        if v is not None:
            over[field] = v
    for arg, field in (("allow_yield", "allow_yield"),
                       ("limit_reinforcement", "limit_reinforcement_moves"),
                       ("limit_attack", "limit_attack_moves"),
                       ("mirror_games", "mirror_games")):
        v = getattr(args, arg, None)
        if v is not None:
            over[field] = bool(v)
    over["compare_games"] = args.games
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

    if args.mode == "train":
        # Dump effective settings like the reference (settings.h:198-210).
        os.makedirs(cfg.log_dir, exist_ok=True)
        with open(f"{cfg.log_dir}/settings.txt", "w") as f:
            for field in dataclasses.fields(cfg):
                f.write(f"{field.name}={getattr(cfg, field.name)}\n")

    trainer = Trainer(cfg, seed=args.seed, device=device)
    if args.c1 is not None:
        if args.c1.endswith(".npz"):
            trainer.load_weights(load_params_npz(args.c1, cfg, device=device))
        else:
            trainer.train_state = trainer.ckpt.restore(args.c1,
                                                       trainer.train_state)
            trainer.load_weights(trainer.train_state.net)
    if args.mode == "play":
        opp = {"sp": A.OPP_SCRIPT, "rp": A.OPP_RANDOM}[args.p2]
        res = trainer.play(opp, args.games)
        print(json.dumps({"mode": "play", "p2": args.p2, **res}))
    else:
        trainer.train(iterations=args.ti)
        last = trainer.epoch_log[-1] if trainer.epoch_log else {}
        print(json.dumps({"mode": "train", "iteration": trainer.iteration,
                          "samples": len(trainer.replay), **last}))


if __name__ == "__main__":
    main()
