"""The data-parallel mesh of the process world.

Port of ``alphazero_risk_tpu/parallel/mesh.py``.  In the JAX package the
mesh is a 1-D ``dp`` axis over every device: game batches and replay
minibatches are sharded over it, parameters replicated, and XLA inserts
the gradient ``psum``.  In the port the mesh is the process world of
``parallel/distributed.py``, one card per rank: a rank holds its rows of
each global batch, and the parameters are the same on every rank.

A single process driving several cards (JAX's ``Trainer(use_mesh=True)``
on local devices) has no counterpart: its counterpart is a world of one
process per card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from . import distributed as D


class Mesh(NamedTuple):
    size: int                 # processes, one card each
    rank: int
    device: torch.device      # this rank's
    axis: str = "dp"


def make_mesh(num_devices: Optional[int] = None, axis: str = "dp",
              device="cuda") -> Mesh:
    """The world as a mesh.  ``num_devices`` must be None or the world's
    size: a rank drives one card."""
    w = D.world()
    if num_devices is not None and num_devices != w:
        raise ValueError(f"a mesh of {num_devices} devices in a world of "
                         f"{w} processes: the port runs one process per "
                         f"card")
    dev = D.device() or resolve_device(device)
    return Mesh(size=w, rank=D.rank(), device=dev, axis=axis)


def global_mesh(axis: str = "dp") -> Mesh:
    return make_mesh(axis=axis)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a tree of global ``[B, ...]`` tensors."""
    return _map(lambda x: x[D.host_local_batch(x.shape[0])], tree)


def replicate(mesh: Mesh, module: torch.nn.Module,
              check: bool = False) -> torch.nn.Module:
    """Broadcast a module's parameters and buffers from rank 0, in place.
    Every rank builds them from the same seed, so with ``check`` every rank
    raises (after the broadcast) when some rank's were not already equal
    to rank 0's."""
    if mesh.size == 1:
        return module
    import torch.distributed as dist
    dev = D.comm_device()
    differ = []
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            buf = t.detach().to(dev).clone()
            dist.broadcast(buf, src=0)
            buf = buf.to(t.device)
            if check and not torch.equal(buf, t):
                differ.append(name)
            t.copy_(buf)
    if check and D.allgather_max(len(differ)):
        raise ValueError(f"parameters and buffers differ from rank 0's "
                         f"({', '.join(differ) or 'on another rank'})")
    return module
