"""Multi-process runtime: initialization and cross-process data plumbing.

Port of ``alphazero_risk_tpu/parallel/distributed.py``.  The JAX package
scales out as SPMD over one global ``dp`` mesh: every process builds the
same global batch, steps only its shard, and XLA inserts the collectives.
The port keeps those semantics with one process per card over
``torch.distributed``:

  * ``initialize`` once per process (NCCL between cards; gloo where asked,
    and on the CPU);
  * every process draws the same global batch (deals and random draws) and
    keeps its rows ``[r * B / W, (r + 1) * B / W)`` (``host_local_batch``);
  * the learner all-reduces its gradients and the BatchNorm batch sums
    (``training/learner.py``, ``models/resnet.py``);
  * win and sample tallies are world sums (``allgather_metrics``).

A world of one passes everything through unchanged, as in JAX.

The collectives run on the backend's device: the rank's card under NCCL,
the CPU under gloo and MPI (gloo cannot gather CUDA tensors, NCCL takes no
CPU tensors).
"""

from __future__ import annotations

import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

_DEVICE: Optional[torch.device] = None      # the rank's device


def check_placement(backend: str, placements) -> None:
    """Raise when NCCL would put two ranks on one card.  ``placements`` is
    one ``(host, device)`` pair per rank.  NCCL refuses a card that two
    ranks share, late and sometimes by hanging; gloo does not mind."""
    if backend != "nccl":
        return
    seen = {}
    for r, p in enumerate(placements):
        if p in seen:
            raise ValueError(
                f"ranks {seen[p]} and {r} share the card {p[1]} of host "
                f"{p[0]}: NCCL needs one card per rank; run two ranks on "
                f"one card with --cpu-collectives gloo")
        seen[p] = r


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               cpu_collectives: Optional[str] = None,
               device="cuda") -> Optional[torch.device]:
    """Bring up the process world and return this rank's device: the card
    ``process_id % torch.cuda.device_count()``, or the CPU when ``device``
    is ``'cpu'``.  Does nothing (returns None) when ``num_processes`` and
    ``coordinator_address`` are both None.

    ``cpu_collectives`` ('gloo' or 'mpi') picks the backend, else NCCL.  A
    CPU world of more than one process must name it; a CPU world of one
    runs gloo.  The coordinator is ``host:port``, where rank 0 listens."""
    global _DEVICE
    if num_processes is None and coordinator_address is None:
        return None
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("a process world needs --coordinator, --nprocs and "
                         "--procid")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of "
                         f"{num_processes}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        if cpu_collectives is None and num_processes > 1:
            raise ValueError("a CPU world of more than one process needs "
                             "--cpu-collectives gloo")
        backend = cpu_collectives or "gloo"
    else:
        backend = cpu_collectives or "nccl"
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend == "mpi" and not dist.is_mpi_available():
        raise ValueError("--cpu-collectives mpi: this PyTorch was built "
                         "without MPI; use gloo")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _DEVICE = dev
    if backend == "nccl":
        # one gloo exchange of the placements: every rank raises together
        # instead of NCCL failing or hanging at its first collective
        side = dist.new_group(backend="gloo")
        placements = [None] * num_processes
        dist.all_gather_object(placements,
                               (socket.gethostname(), dev.index), group=side)
        dist.destroy_process_group(side)
        try:
            check_placement(backend, placements)
        except ValueError:
            shutdown()
            raise
    return dev


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def device() -> Optional[torch.device]:
    """The device ``initialize`` gave this rank (None outside a world)."""
    return _DEVICE


def comm_device() -> torch.device:
    """Where the backend's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return _DEVICE
    return torch.device("cpu")


def host_local_batch(global_batch: int) -> slice:
    """This rank's rows ``[r * B / W, (r + 1) * B / W)`` of a global batch
    of ``B`` rows."""
    w = world()
    if global_batch % w:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {w} processes")
    n = global_batch // w
    return slice(rank() * n, (rank() + 1) * n)


def local_shards(tree):
    """A rank holds only its own rows: the identity, so that callers keep
    the JAX package's shape of code."""
    return tree


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` on the backend's device (``t`` itself
    in a world of one)."""
    if world() == 1:
        return t
    dev = comm_device()
    if t.device == dev:
        dist.all_reduce(t, op=op)
    else:
        buf = t.to(dev)
        dist.all_reduce(buf, op=op)
        t.copy_(buf)
    return t


def allgather_min(value) -> int:
    """Minimum of a per-process integer across the world."""
    if world() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=comm_device())
    return int(all_reduce_(t, dist.ReduceOp.MIN).item())


def allgather_max(value) -> int:
    """Maximum of a per-process integer across the world."""
    return -allgather_min(-int(value))


def allgather_metrics(values: dict) -> dict:
    """Sum scalar metrics across processes (win tallies, sample counts):
    floats under the sorted keys."""
    if world() == 1:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                     device=comm_device())
    all_reduce_(t)
    return {k: float(v) for k, v in zip(keys, t.tolist())}


class _AllReduceSum(torch.autograd.Function):
    """A world sum whose gradient is the world sum of the incoming
    gradients: every rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable world sum of ``t``."""
    return _AllReduceSum.apply(t)


def barrier() -> None:
    if world() > 1:
        dist.barrier()
