"""A real multi-process run of the port's process world.

Port of ``tools/multihost_smoke.py``: launches N worker processes that form
one ``torch.distributed`` world (``parallel/distributed.py``; NCCL between
cards, one card a rank, or gloo on the CPU with ``--cpu``) and runs

  * world learner updates on per-rank different data: the losses are equal
    on every rank only if the gradients were all-reduced;
  * random legal play on this rank's rows of a global batch of deals, the
    army sum all-reduced;
  * ``allgather_metrics`` of ``pid + 1`` (the world's sum N(N+1)/2);
  * without ``--trim``, a tiny ``Trainer`` in a shared checkpoint directory:
    ``train_on_data(loops=1)``, ``train_epochs``, ``generate_selfplay`` and
    ``gate``, whose losses and verdict must agree on every rank.

Each worker prints one ``MHJSON`` line; the launcher checks them against
each other and prints one JSON summary line (``"ok": true``).  A worker
that fails or outlives ``--timeout`` fails the run.  Work files go to
``build/parallel_smoke/`` beside the package.

Usage:
  python -m alphazero_risk_tpu_torch.parallel.smoke --nprocs 4
  python -m alphazero_risk_tpu_torch.parallel.smoke --nprocs 4 --trim --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

WORK = Path(__file__).resolve().parent.parent.parent / "build" / \
    "parallel_smoke"


def worker(args) -> None:
    import numpy as np
    import torch

    from ..config import Config
    from ..env import rules
    from ..env.state import new_game
    from ..training import learner as L
    from ..training.trainer import Trainer
    from . import distributed as D
    from .mesh import make_mesh, replicate, shard_batch

    if args.cpu:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.nprocs))
    dev = D.initialize(f"127.0.0.1:{args.port}", args.nprocs, args.worker,
                       cpu_collectives="gloo" if args.cpu else None,
                       device="cpu" if args.cpu else "cuda")
    pid = D.rank()
    if D.world() != args.nprocs:
        raise RuntimeError(f"world size {D.world()} != {args.nprocs}")
    mesh = make_mesh()

    # ---- world learner updates on per-rank different data ----
    cfg = Config(blocks=1, filters=32, value_hidden=32, batch_size=16)
    state = L.create_train_state(cfg, 0, dev)
    replicate(mesh, state.net, check=True)
    r = np.random.default_rng(100 + pid)
    n = cfg.batch_size // D.world()
    batch = {
        "features": torch.from_numpy(r.uniform(size=(
            n, 7, 6, cfg.num_features)).astype(np.float32)).to(dev),
        "policy": torch.full((n, 43), 1.0 / 43, device=dev),
        "value": torch.from_numpy(r.uniform(-1, 1, size=(n,)).astype(
            np.float32)).to(dev),
    }
    losses = []
    for _ in range(D.world()):
        state, m = L.update(state, cfg, batch)
        losses.append(float(m["loss"]))

    # ---- random legal play on this rank's rows of a global batch ----
    gb = 16 * D.world()
    gen = torch.Generator(device=dev).manual_seed(1000)
    games = shard_batch(mesh, new_game(gb, generator=gen, device=dev))
    steps = 64
    t0 = time.perf_counter()
    for _ in range(steps):
        legal = rules.legal_actions(games, cfg)
        g = torch.rand((gb, 43), generator=gen, device=dev)[
            D.host_local_batch(gb)]
        action = torch.argmax(torch.where(legal, g, -1.0), -1).to(
            torch.int32)
        dice = rules.roll_dice(gen, gb)[D.host_local_batch(gb)].to(dev)
        games = rules.step(games, action, dice.contiguous(), cfg)
    army = D.allgather_metrics({"army": int(games.army.sum())})["army"]
    env_dt = time.perf_counter() - t0
    agg = D.allgather_metrics({"contrib": pid + 1, "one": 1})
    out = {"pid": pid, "world": D.world(), "device": str(dev),
           "backend": torch.distributed.get_backend(),
           "losses": losses, "army_sum": army,
           "env_steps_per_s": gb // D.world() * steps / env_dt,
           "metrics": agg}

    if not args.trim:
        # ---- a tiny Trainer in a shared checkpoint directory ----
        run = WORK / str(args.port)
        tcfg = Config(
            blocks=1, filters=16, value_hidden=16, mcts_simulations=2,
            max_depth=6, batch_size=32, env_batch_per_device=4,
            data_games_ss=4, data_games_sr=0,
            samples_storage_min_batches=1, samples_storage_max_batches=64,
            compare_games=4, epochs=1, max_game_steps=384,
            actor_chunk_steps=48, train_iteration_games=4,
            checkpoint_dir=str(run / "checkpoints"),
            data_dir=str(run / f"data{pid}"), log_dir=str(run / f"log{pid}"))
        t = Trainer(tcfg, seed=5, device=dev)
        t.train_on_data(loops=1, do_benchmark=False)
        pi0, v0 = t.train_epochs(epochs=1)
        t.generate_selfplay(4)
        t.replay.trim()
        pi1, v1 = t.train_epochs(epochs=1)
        improved = t.gate()
        out["trainer"] = {
            "buffer_local": len(t.replay), "pi_loss": [pi0, pi1],
            "v_loss": [v0, v1], "gate_improved": bool(improved),
            "ckpt_best": t.ckpt.exists("best") or not improved}
    D.shutdown()
    print("MHJSON " + json.dumps(out), flush=True)


def check(results, args) -> dict:
    """The ranks' lines against each other; the summary."""
    if len(results) != args.nprocs:
        raise SystemExit(f"{len(results)} of {args.nprocs} workers "
                         f"reported")
    r0 = results[0]
    expect = args.nprocs * (args.nprocs + 1) // 2
    for r in results:
        if r["world"] != args.nprocs or r["losses"] != r0["losses"] or \
                r["army_sum"] != r0["army_sum"] or \
                r["metrics"] != {"contrib": expect, "one": args.nprocs}:
            raise SystemExit(f"ranks disagree: {results}")
        if not args.trim:
            a, b = r["trainer"], r0["trainer"]
            if (a["pi_loss"], a["v_loss"], a["gate_improved"]) != (
                    b["pi_loss"], b["v_loss"], b["gate_improved"]) or \
                    a["buffer_local"] <= 0 or not a["ckpt_best"]:
                raise SystemExit(f"trainers disagree: {results}")
    summary = {"ok": True, "nprocs": args.nprocs,
               "backend": r0["backend"],
               "devices": [r["device"] for r in results],
               "losses": r0["losses"],
               "env_steps_per_s": r0["env_steps_per_s"]}
    if not args.trim:
        summary["trainer"] = r0["trainer"]
    return summary


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m alphazero_risk_tpu_torch.parallel.smoke")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=None,
                    help="the coordinator's port (default: a free one)")
    ap.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--trim", action="store_true",
                    help="updates, env and collectives only (no Trainer)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (gloo)")
    args = ap.parse_args(argv)
    if args.worker >= 0:
        worker(args)
        return
    if args.port is None:
        args.port = _free_port()
    logs = WORK / f"logs-{args.port}"
    shutil.rmtree(WORK / str(args.port), ignore_errors=True)
    logs.mkdir(parents=True, exist_ok=True)
    extra = (["--trim"] if args.trim else []) + (
        ["--cpu"] if args.cpu else [])
    files = [logs / f"w{i}.log" for i in range(args.nprocs)]
    procs = []
    for i in range(args.nprocs):
        with open(files[i], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __spec__.name, "--worker", str(i),
                 "--nprocs", str(args.nprocs), "--port", str(args.port),
                 *extra], stdout=f, stderr=subprocess.STDOUT,
                cwd=os.getcwd()))
    deadline = time.time() + args.timeout
    results = []
    try:
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                raise SystemExit(f"worker {i} timed out; logs in {logs}")
            text = files[i].read_text()
            if p.returncode != 0:
                print(text, file=sys.stderr)
                raise SystemExit(f"worker {i} failed rc={p.returncode}")
            results += [json.loads(line[len("MHJSON "):])
                        for line in text.splitlines()
                        if line.startswith("MHJSON ")]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(json.dumps(check(results, args)))


if __name__ == "__main__":
    main()
