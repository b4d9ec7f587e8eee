"""Command-line entry point of the port.

Port of the ``play``, ``train``, ``train-script``, ``train-data``,
``analysis`` and ``watch`` modes of ``alphazero_risk_tpu/cli.py``.
``play``: AlphaZero (``--p1 az``, the weights of ``--c1``, by default the
checkpoint role ``latest``) against the ScriptPlayer (``--p2 sp``),
the RandomPlayer (``--p2 rp``) or another checkpoint role (``--p2 az
--c2 ROLE``) in mirrored pairs, with argmax moves; or two heuristic players
(``--p1 sp|rp --p2 sp|rp``): with ``--cpu`` on the native C++ engine
(``native.py``) when its library loads, as the JAX CLI plays them, and
otherwise through ``agents.driver.play_match``.
``train``: the AlphaZero loop (self-play, epochs, gating arena, benchmark,
checkpoints), resuming from ``checkpoints/`` when it holds a ``latest``.
``train-script``: the same loop on games against the ScriptPlayer.
``train-data``: the supervised bootstrap on ``--dgss`` Script-vs-Script and
``--dgsr`` Script-vs-Random games per loop, ``--dtl`` loops.
``analysis``: 5-fold cross-validation of fresh networks on
``{data_dir}/training_samples.npz`` (the replay file the train modes
write), printed as one JSON line.
``watch``: the game viewer (``utils/watch.py``), one game rendered turn by
turn (``--micro``: every micro-decision; ``--no-pause``: without waiting
for Enter).  Heuristic seats play on the scalar oracle; a game with an
AlphaZero seat (``--c1``/``--c2`` roles, plain network) steps the batched
engine and search at B=1.
Every mode but ``watch`` first writes the effective settings to
``{log_dir}/settings.txt``.
The network paths optionally run the BN-folded bf16 (``--fast``) or int8
(``--fast --int8``) inference.  Runs on the card unless ``--cpu`` is given.

A process world (``parallel/distributed.py``): one process per card, each
started with ``--coordinator HOST:PORT --nprocs N --procid I`` (rank I takes
card ``I % cards``; NCCL between the cards).  ``--cpu-collectives gloo``
runs the collectives on gloo: two ranks on one card need it, and so does a
``--cpu`` world.  The train modes then play and learn as one process with
the same seed would, each rank keeping its replay in
``{data_dir}/training_samples.p{I}.npz``; rank 0 writes the checkpoints.

Usage:
  python -m alphazero_risk_tpu_torch.cli -m play --p1 az --p2 sp \\
      --games 64 --mcts 32 --fast --int8 \\
      --c1 artifacts/params-20block-r4-best.npz
  python -m alphazero_risk_tpu_torch.cli -m train --cpu --blocks 2 \\
      --filters 32 --mcts 4 --ti 1 --tg 4 --games 4 --e 1 --bs 32 \\
      --env-batch 4 --max-steps 256 --bench-random 2 --bench-script 2
  python -m alphazero_risk_tpu_torch.cli -m train-data --dtl 1 \\
      --dgss 128 --dgsr 128 --fast --int8 \\
      --c1 artifacts/params-20block-r4-best.npz
  python -m alphazero_risk_tpu_torch.cli -m play --p1 sp --p2 rp --games 64
  python -m alphazero_risk_tpu_torch.cli -m analysis --cpu --blocks 2 \\
      --filters 32 --value-hidden 16 --bs 32
  python -m alphazero_risk_tpu_torch.cli -m watch --p1 az --p2 sp --mcts 32
  python -m alphazero_risk_tpu_torch.cli -m watch --p1 sp --p2 rp --no-pause
  python -m alphazero_risk_tpu_torch.cli -m train --cpu \\
      --cpu-collectives gloo --coordinator 127.0.0.1:29500 --nprocs 2 \\
      --procid 0    # and --procid 1 in a second shell
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
    p.add_argument("-m", "--mode", default="play",
                   choices=["play", "train", "train-script", "train-data",
                            "analysis", "watch"])
    p.add_argument("--micro", action="store_true",
                   help="watch mode: pause every micro-decision, not turn")
    p.add_argument("--no-pause", action="store_true",
                   help="watch mode: dump all turns without waiting")
    p.add_argument("--p1", default="az", choices=["az", "sp", "rp"],
                   help="player 1 in play mode (AlphaZero, ScriptPlayer or "
                        "RandomPlayer)")
    p.add_argument("--p2", default="sp", choices=["sp", "rp", "az"],
                   help="opponent in play mode: ScriptPlayer, RandomPlayer "
                        "or AlphaZero from --c2")
    p.add_argument("--c1", default=None,
                   help="weights of player 1 (play; the role latest when "
                        "omitted, fresh weights from --seed when it does "
                        "not exist) or to start training from (train "
                        "modes; only when given): a checkpoint role "
                        "(latest, best, iter-N) or a params npz in the "
                        "save_params_npz format")
    p.add_argument("--c2", default="best",
                   help="checkpoint role of player 2 (play and watch with "
                        "--p2 az)")
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
    p.add_argument("--dgss", type=int, default=None,
                   help="train-data: Script-vs-Script games per loop")
    p.add_argument("--dgsr", type=int, default=None,
                   help="train-data: Script-vs-Random games per loop")
    p.add_argument("--dtl", type=int, default=None,
                   help="train-data: loops")
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
    # multi-host launch (one process per card; see parallel/distributed.py)
    p.add_argument("--coordinator", default=None,
                   help="multi-host: coordinator address host:port")
    p.add_argument("--nprocs", type=int, default=None,
                   help="multi-host: total number of processes")
    p.add_argument("--procid", type=int, default=None,
                   help="multi-host: this process's id")
    p.add_argument("--cpu-collectives", default=None,
                   choices=["gloo", "mpi"],
                   help="multi-host on CPU processes: collectives impl")
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
        "dgss": "data_games_ss", "dgsr": "data_games_sr",
        "dtl": "data_train_loops",
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
    # as the JAX CLI sets it: --int8 takes effect only with --fast
    over["fast_infer_int8"] = bool(args.int8)
    return Config().replace(**over)


def play_heuristic(args, cfg: Config, device) -> dict:
    """``-m play --p1 sp|rp --p2 sp|rp``: two heuristic players in
    mirrored pairs to the end through ``play_match`` (no network)."""
    import torch

    from .agents.driver import (AGENT_RANDOM, AGENT_SCRIPT,
                                mirrored_initial_states, play_match,
                                summarize)
    from .device import resolve_device
    dev = resolve_device(device)
    kinds = {"sp": AGENT_SCRIPT, "rp": AGENT_RANDOM}
    deal = torch.Generator(device=dev).manual_seed(args.seed)
    state0 = mirrored_initial_states(args.games + args.games % 2,
                                     generator=deal, device=dev)
    res = play_match(torch.Generator(device=dev).manual_seed(args.seed + 1),
                     state0, kinds[args.p1], kinds[args.p2], cfg,
                     cfg.max_game_steps)
    return {"mode": "play", "p1": args.p1, "p2": args.p2,
            "engine": "torch", "micro_steps": res.steps, **summarize(res)}


def play_native(args, cfg: Config):
    """``-m play --p1 sp|rp --p2 sp|rp --cpu`` on the native C++ engine, as
    the JAX CLI plays it; None when the library does not load."""
    from .native import NativeEngine, available
    if not available():
        return None
    res, _, steps = NativeEngine(cfg).play_games(args.p1, args.p2,
                                                 args.games, args.seed)
    return {"mode": "play", "p1": args.p1, "p2": args.p2,
            "engine": "native", "games": int(res.shape[0]),
            "p0_wins": int((res == 0).sum()),
            "p1_wins": int((res == 1).sum()),
            "draws": int((res == -2).sum()), "micro_steps": steps}


def watch(args, cfg: Config, device) -> None:
    """``-m watch``: AlphaZero seats go to ``watch_game_az`` (on the card
    unless ``--cpu``), heuristic pairs to the oracle viewer."""
    if "az" in (args.p1, args.p2):
        from .utils.watch import watch_game_az
        watch_game_az(args.p1, args.p2, seed=args.seed, cfg=cfg,
                      ckpt_dir=Config().checkpoint_dir,
                      roles=(args.c1 or "latest", args.c2),
                      micro=args.micro, pause=not args.no_pause,
                      device=device)
    else:
        from .utils.watch import watch_game
        watch_game(args.p1, args.p2, seed=args.seed, cfg=cfg,
                   micro=args.micro, pause=not args.no_pause)


def write_settings(cfg: Config) -> None:
    """Dump the effective settings like the reference
    (settings.h:198-210)."""
    os.makedirs(cfg.log_dir, exist_ok=True)
    with open(f"{cfg.log_dir}/settings.txt", "w") as f:
        for field in dataclasses.fields(cfg):
            f.write(f"{field.name}={getattr(cfg, field.name)}\n")


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = "cpu" if args.cpu else "cuda"
    from .parallel import distributed as D
    if args.coordinator is not None or args.nprocs is not None:
        # before any trainer is built: the world gives this rank its card
        device = D.initialize(args.coordinator, args.nprocs, args.procid,
                              cpu_collectives=args.cpu_collectives,
                              device=device)
    try:
        run(args, cfg, device)
    finally:
        D.shutdown()


def run(args, cfg: Config, device) -> None:
    """Run the mode of the parsed ``args``."""
    if args.mode == "watch":
        watch(args, cfg, device)
        return
    write_settings(cfg)

    if args.mode == "play" and args.p1 != "az":
        if args.p2 == "az":
            raise SystemExit("put the az player in --p1")
        res = play_native(args, cfg) if args.cpu else None
        print(json.dumps(res or play_heuristic(args, cfg, device)))
        return

    if args.mode == "analysis":
        from .training.analysis import cross_validate
        print(json.dumps(cross_validate(
            cfg, f"{cfg.data_dir}/training_samples.npz", seed=args.seed,
            device=device)))
        return

    from .training import actor as A
    from .training.checkpoints import load_params_npz
    from .training.trainer import Trainer

    trainer = Trainer(cfg, seed=args.seed, device=device)
    # play restores the role latest by default, as the JAX CLI does; the
    # train modes resume by themselves and start from --c1 only if given
    c1 = args.c1 or ("latest" if args.mode == "play" else None)
    if c1 is not None:
        if c1.endswith(".npz"):
            trainer.load_weights(load_params_npz(c1, cfg, device=device))
        else:
            trainer.train_state = trainer.ckpt.restore(c1,
                                                       trainer.train_state)
            trainer.load_weights(trainer.train_state.net)
    if args.mode == "play":
        if args.p2 == "az":
            res = trainer.play_az_vs_az(args.c2, args.games)
        else:
            opp = {"sp": A.OPP_SCRIPT, "rp": A.OPP_RANDOM}[args.p2]
            res = trainer.play(opp, args.games)
        print(json.dumps({"mode": "play", "p2": args.p2, **res}))
        return
    if args.mode == "train":
        trainer.train(iterations=args.ti)
    elif args.mode == "train-script":
        trainer.train_on_script(iterations=args.ti)
    else:
        trainer.train_on_data(loops=args.dtl)
    last = trainer.epoch_log[-1] if trainer.epoch_log else {}
    print(json.dumps({"mode": args.mode, "iteration": trainer.iteration,
                      "samples": len(trainer.replay), **last}))


if __name__ == "__main__":
    main()
