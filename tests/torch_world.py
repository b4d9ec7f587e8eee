"""Helpers of the port's process-world tests: run a function on every rank
of a gloo world of CPU processes and collect what each rank returns.

Kept apart from the test files so that the worker processes import torch
and the port only, never JAX.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import socket
import sys
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def free_port() -> int:
    """A currently free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, nprocs, port, args, out, device):
    sys.path.insert(0, HERE)
    torch.set_num_threads(1)
    try:
        from alphazero_risk_tpu_torch.parallel import distributed as D
        D.initialize(f"127.0.0.1:{port}", nprocs, rank,
                     cpu_collectives="gloo", device=device)
        try:
            res = fn(rank, *args)
        finally:
            D.shutdown()
        torch.save({"ok": res}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def run_world(fn, nprocs: int, tmp_path, *args, timeout: float = 120,
              device="cpu"):
    """``fn(rank, *args)`` on each rank of an ``nprocs``-process gloo world
    on ``device`` (the CPU, or every rank on the card ``cuda:0`` with
    ``'cuda'`` and one card).  Returns the ranks' results in rank order;
    raises with the failing rank's traceback, or when a rank outlives
    ``timeout`` seconds (every process is then killed)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(str(tmp_path), f"rank{r}.pt")
            for r in range(nprocs)]
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, nprocs, port, args, outs[r], device))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    try:
        for r, p in enumerate(procs):
            p.join(timeout)
            if p.is_alive():
                raise TimeoutError(f"rank {r} still running after "
                                   f"{timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        blob = torch.load(out, weights_only=False) \
            if os.path.exists(out) else None
        if blob is None or "error" in blob:
            msg = blob["error"] if blob else f"exit code {p.exitcode}"
            raise RuntimeError(f"rank {r} failed:\n{msg}")
        results.append(blob["ok"])
    return results


# ------------------------------------------------------------ rank workers

def learner_update(rank, cfg, start_path, batch_path, precision, local_bn):
    """One world update of the state at ``start_path`` on this rank's rows
    of the global minibatch at ``batch_path``; ``local_bn``: BatchNorm with
    this rank's statistics (the negative case).  Returns the parameters
    and buffers, Adam's moments and the step's metrics."""
    from alphazero_risk_tpu_torch.models import resnet
    from alphazero_risk_tpu_torch.parallel import distributed as D
    from alphazero_risk_tpu_torch.training import learner
    if precision == "float32":
        resnet._bf16 = lambda x: x
    if local_bn:
        resnet._global_moments = resnet._local_moments
    state = torch.load(start_path, weights_only=False)
    batch = torch.load(batch_path, weights_only=False)
    rows = D.host_local_batch(batch["value"].shape[0])
    state, m = learner.update(state, cfg,
                              {k: v[rows] for k, v in batch.items()})
    return {"sd": {k: v.clone() for k, v in state.net.state_dict().items()},
            "adam": {n: {k: v.clone() for k, v in state.opt.state[p].items()}
                     for n, p in state.net.named_parameters()},
            "metrics": {k: float(v) for k, v in m.items()}}


def capture_waves(trainer):
    """Record every wave's ``_episode_loop`` output (its samples, status
    and final rounds, on the CPU) in a list the function returns."""
    waves = []
    loop = trainer._episode_loop

    def recorded(*a, **kw):
        out = loop(*a, **kw)
        waves.append({"samples": out.samples, "status": out.status,
                      "state": out.state, "started": a[1].cur_player})
        return out
    trainer._episode_loop = recorded
    return waves


def trainer_runs(rank, cfg, seed, games, agree=True,
                 paths=("selfplay", "play", "gate"), device="cpu"):
    """Fresh ``Trainer``s from ``seed`` for each of ``paths`` on the rank's
    device (``device`` outside a world):
    ``generate_selfplay(games)``, ``play(OPP_SCRIPT, games)`` and
    ``gate()``.  Returns for each its
    replay rows, every wave's ``_episode_loop`` output and the tally or
    verdict.  ``agree=False`` leaves out the fast-forward's agreement of
    ``WorldDraws`` (the negative case)."""
    from alphazero_risk_tpu_torch.parallel import distributed as D
    from alphazero_risk_tpu_torch.training import actor as A
    from alphazero_risk_tpu_torch.training.trainer import Trainer
    device = D.device() or device
    if not agree:
        A.WorldDraws.ff_agree = lambda self, iterations: None
    out = {}
    for what in paths:
        t = Trainer(cfg, seed=seed, device=device)
        waves = capture_waves(t)
        res = None
        if what == "selfplay":
            t.generate_selfplay(games)
        elif what == "play":
            res = t.play(A.OPP_SCRIPT, games)
        else:
            res = t.gate()
        out[what] = {"replay": dict(t.replay.data), "result": res,
                     "waves": [{k: _cpu(v) for k, v in w.items()}
                               for w in waves],
                     "path": t._replay_path()}
    return out


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _cpu(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return type(x)(*(_cpu(v) for v in x))          # a NamedTuple


def world_equals_one(one, world, what):
    """Whether every rank's waves of ``trainer_runs``'s ``what`` are its
    rows of the one-process waves: the starters, the statuses and the
    final states."""
    waves = one[what]["waves"]
    for r, rank in enumerate(world):
        if len(rank[what]["waves"]) != len(waves):
            return False
        for mine, full in zip(rank[what]["waves"], waves):
            n = full["status"].shape[0] // len(world)
            rows = slice(r * n, (r + 1) * n)
            if not (torch.equal(mine["started"], full["started"][rows])
                    and torch.equal(mine["status"], full["status"][rows])
                    and all(torch.equal(getattr(mine["state"], f.name),
                                        getattr(full["state"], f.name)[rows])
                            for f in dataclasses.fields(mine["state"]))):
                return False
    return True


def collectives(rank):
    """The collectives of a world: min, max and metric sums, this rank's
    rows of global batches, ``replicate`` of a network built from this
    rank's own seed, and the gradient of the differentiable sum."""
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.models.resnet import build_network
    from alphazero_risk_tpu_torch.parallel import distributed as D
    from alphazero_risk_tpu_torch.parallel import mesh as M
    out = {"world": D.world(), "rank": D.rank(),
           "min": D.allgather_min(rank + 3), "max": D.allgather_max(rank + 3),
           "metrics": D.allgather_metrics({"contrib": rank + 1, "one": 1}),
           "rows": {b: D.host_local_batch(b) for b in (4, 12, 1024)}}
    try:
        D.host_local_batch(10)
    except ValueError as e:
        out["uneven"] = str(e)
    mesh = M.make_mesh()
    out["mesh"] = (mesh.size, mesh.rank, str(mesh.device), mesh.axis)
    out["shard"] = M.shard_batch(mesh, {
        "x": torch.arange(8), "y": [torch.arange(16).reshape(8, 2)]})
    cfg = Config(blocks=1, filters=8, value_hidden=4)
    net = build_network(cfg, device="cpu", seed=rank)
    try:
        M.replicate(mesh, net, check=True)
    except ValueError as e:
        out["replicate_check"] = str(e)
    M.replicate(mesh, net)
    out["replicated"] = {k: v.clone() for k, v in net.state_dict().items()}
    M.replicate(mesh, net, check=True)          # now equal: no raise
    t = torch.full((3,), float(rank + 1), requires_grad=True)
    s = D.all_reduce_sum(t * (rank + 1))
    s.sum().backward()
    out["sum"], out["grad"] = s.detach(), t.grad.clone()
    return out


def guards(rank, tmp):
    """What a world refuses, and who writes the checkpoints: a role on one
    rank's directory only, the device ring, a batch size that does not
    split; ``save`` and ``save_meta`` into a shared directory."""
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.training import checkpoints as C
    from alphazero_risk_tpu_torch.training.learner import create_train_state
    from alphazero_risk_tpu_torch.training.trainer import Trainer
    cfg = Config(blocks=1, filters=8, value_hidden=4,
                 samples_storage_max_batches=1)
    out = {}
    own = C.CheckpointManager(cfg, os.path.join(tmp, f"own{rank}"))
    if rank == 0:
        open(own._path("best"), "w").close()
    try:
        own.exists("best")
    except RuntimeError as e:
        out["exists"] = str(e)
    try:
        Trainer(cfg.replace(device_replay=True,
                            checkpoint_dir=os.path.join(tmp, "ring")),
                device="cpu")
    except ValueError as e:
        out["device_replay"] = str(e)
    t = Trainer(cfg.replace(batch_size=33, checkpoint_dir=os.path.join(
        tmp, "shared"), data_dir=os.path.join(tmp, f"data{rank}"),
        log_dir=os.path.join(tmp, f"log{rank}")), device="cpu")
    try:
        t.train_epochs()
    except ValueError as e:
        out["batch_size"] = str(e)
    writes = []
    save = C.torch.save
    C.torch.save = lambda obj, path: (writes.append(path), save(obj, path))
    try:
        t.ckpt.save("latest", create_train_state(cfg, 0, "cpu"))
        t.ckpt.save_meta({"iteration": 1})
    finally:
        C.torch.save = save
    out["writes"] = writes
    out["shared"] = sorted(os.listdir(os.path.join(tmp, "shared")))
    out["exists_shared"] = t.ckpt.exists("latest")
    return out
