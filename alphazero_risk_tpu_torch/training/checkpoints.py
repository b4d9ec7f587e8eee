"""Checkpoint management and parameter files.

Port of ``alphazero_risk_tpu/training/checkpoints.py``.

``CheckpointManager`` keeps the roles latest / best / iter-N / temp and a
meta sidecar (iteration and the generator's state) for resume.  In a
process world (``parallel/distributed.py``) the checkpoint directory must
be shared: rank 0 alone writes each file, the others wait for it, every
rank restores, and a role's existence is agreed across the world.  Role files
are the port's own: one ``torch.save`` of the step, the network's
``state_dict`` and the Adam state per role (the JAX package uses orbax
there; the two are not interchangeable).

The params npz is the interchange format, identical in both packages
(``save_params_npz`` / ``load_params_npz``): float16 arrays under the keys
``p/<module>/kernel|bias|scale`` (parameters) and ``b/<bn>/mean|var``
(BatchNorm statistics), conv kernels in HWIO and dense kernels as
[in, out].  ``params_from_jax`` and ``params_to_jax`` convert between that
flat layout and the ``state_dict`` of the port's ``AZNet``;
``train_state_from_jax`` also carries the Adam moments across.
"""

from __future__ import annotations

import copy
import json
import os
import re
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.fast_infer import pack_heads, pack_trunk_wq, trunk_convs
from ..models.resnet import AZNet, build_network
from ..parallel import distributed as D
from .learner import TrainState, train_state_of

_CONV = re.compile(r"(stem_conv|policy_conv|value_conv|block_\d+/conv_[ab])$")
_BN = re.compile(r"(stem_bn|policy_bn|value_bn|block_\d+/bn_[ab])$")
_BN_KEYS = {"p/scale": "weight", "p/bias": "bias", "b/mean": "running_mean",
            "b/var": "running_var"}


def _module_name(path: str) -> str:
    """JAX module path ('block_3/conv_a') -> port name ('blocks.3.conv_a')."""
    return re.sub(r"block_(\d+)", r"blocks.\1", path).replace("/", ".")


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX parameters (``save_params_npz`` keys, numpy arrays of any
    float dtype) -> a float32 ``state_dict`` of the port's ``AZNet``."""
    out = {}
    for key, arr in flat.items():
        kind, rest = key.split("/", 1)
        mod, leaf = rest.rsplit("/", 1)
        a = torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())
        name = _module_name(mod)
        if _CONV.search(mod) and kind == "p" and leaf == "kernel":
            out[f"{name}.weight"] = a.permute(3, 2, 0, 1).contiguous()
        elif _BN.search(mod) and f"{kind}/{leaf}" in _BN_KEYS:
            out[f"{name}.{_BN_KEYS[kind + '/' + leaf]}"] = a
        elif kind == "p" and leaf == "kernel":        # dense [in, out]
            out[f"{name}.weight"] = a.T.contiguous()
        elif kind == "p" and leaf == "bias":
            out[f"{name}.bias"] = a
        else:
            raise KeyError(f"unexpected parameter key {key!r}")
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]
                  ) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``: an ``AZNet`` ``state_dict`` ->
    flat float32 numpy arrays under the ``save_params_npz`` keys."""
    out = {}
    for key, t in state_dict.items():
        name, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        mod = re.sub(r"blocks\.(\d+)", r"block_\1", name).replace(".", "/")
        a = t.detach().to("cpu", torch.float32)
        if _CONV.search(mod) and leaf == "weight":
            out[f"p/{mod}/kernel"] = a.permute(2, 3, 1, 0).contiguous().numpy()
        elif _BN.search(mod):
            kind, jleaf = {v: k for k, v in _BN_KEYS.items()}[leaf].split("/")
            out[f"{kind}/{mod}/{jleaf}"] = a.numpy().copy()
        elif leaf == "weight":                        # dense [in, out]
            out[f"p/{mod}/kernel"] = a.T.contiguous().numpy()
        elif leaf == "bias":
            out[f"p/{mod}/bias"] = a.numpy().copy()
        else:
            raise KeyError(f"unexpected state_dict key {key!r}")
    return out


def _load_flat(net: AZNet, flat: Dict[str, np.ndarray]) -> None:
    sd = params_from_jax(flat)
    # BatchNorm2d keeps a step counter that the JAX file has no use for.
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    net.load_state_dict(sd, strict=True)


def train_state_from_jax(cfg: Config, flat: Dict[str, np.ndarray],
                         mu: Dict[str, np.ndarray],
                         nu: Dict[str, np.ndarray], count: int,
                         step: int = 0, device="cuda") -> TrainState:
    """A JAX learner's state in the port: ``flat`` holds the parameters and
    BatchNorm statistics under the ``save_params_npz`` keys, ``mu`` and
    ``nu`` Adam's first and second moments under the same ``p/...`` keys,
    ``count`` Adam's step count."""
    dev = resolve_device(device)
    net = build_network(cfg, device="cpu")
    _load_flat(net, flat)
    state = train_state_of(net.to(dev), cfg, step=step)
    m, v = params_from_jax(mu), params_from_jax(nu)
    for name, p in state.net.named_parameters():
        state.opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": m[name].to(dev),
            "exp_avg_sq": v[name].to(dev),
        }
    return state


def save_params_npz(path: str, net: AZNet) -> None:
    """Write the network's parameters and BatchNorm statistics as a float16
    params npz that either package loads."""
    flat = {k: v.astype(np.float16)
            for k, v in params_to_jax(net.state_dict()).items()}
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)


def load_params_npz(path: str, cfg: Config, device="cuda") -> AZNet:
    """An ``AZNet`` at the config's widths holding the weights of a
    ``save_params_npz`` file (float16 storage upcast to float32)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = dict(z)
    net = build_network(cfg, device="cpu")
    _load_flat(net, flat)
    return net.to(dev)


def folded_from_jax(folded: Dict[str, np.ndarray],
                    device="cuda") -> Dict[str, torch.Tensor]:
    """An already folded (and possibly quantized and calibrated) JAX
    inference pytree -> the port's folded dict, value for value: bf16 stays
    bf16, int8 stays int8, float32 stays float32.  A quantized trunk also
    gets its weights packed for kernel K1 (``trunk_wqk``), and the heads
    theirs for kernel K5 (``heads_pack``)."""
    dev = resolve_device(device)
    out = {}
    for k, v in folded.items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[k] = t.to(dev)
    if "trunk_wq" in out:
        out["trunk_wqk"] = pack_trunk_wq(out["trunk_wq"])
        out["trunk_convs"] = trunk_convs(out)
    out["heads_pack"] = pack_heads(out)
    return out


class CheckpointManager:
    def __init__(self, cfg: Config, base_dir: Optional[str] = None):
        self.cfg = cfg
        self.dir = os.path.abspath(base_dir or cfg.checkpoint_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, role: str) -> str:
        return os.path.join(self.dir, role + ".pt")

    def save(self, role: str, train_state: TrainState) -> None:
        """role: 'latest', 'best', 'iter-<n>', 'temp' (settings.h:25-27).
        In a process world rank 0 writes it (every rank holds the same
        state) and the others wait."""
        if D.rank() == 0:
            tmp = self._path(role) + ".tmp"
            torch.save({"step": train_state.step,
                        "net": train_state.net.state_dict(),
                        "opt": train_state.opt.state_dict()}, tmp)
            os.replace(tmp, self._path(role))
        D.barrier()

    def restore(self, role: str, target: TrainState) -> TrainState:
        """A new train state shaped like ``target`` holding the role's
        weights and Adam state; ``target`` itself when the checkpoint does
        not exist (the reference inits fresh weights then,
        alphazero_nn.cpp:197-202)."""
        if not self.exists(role):
            print(f"[checkpoints] no '{role}' checkpoint at "
                  f"{self._path(role)}; using fresh weights",
                  file=sys.stderr)
            return target
        dev = next(target.net.parameters()).device
        blob = torch.load(self._path(role), map_location=dev,
                          weights_only=True)
        net = copy.deepcopy(target.net)
        net.load_state_dict(blob["net"], strict=True)
        state = train_state_of(net, self.cfg, step=int(blob["step"]))
        state.opt.load_state_dict(blob["opt"])
        return state

    def exists(self, role: str) -> bool:
        """Whether the role exists, agreed across the process world: with a
        directory that is not shared some ranks would restore and others
        start fresh, so a role present on some ranks only raises."""
        local = os.path.exists(self._path(role))
        if D.world() == 1:
            return local
        lo, hi = D.allgather_min(int(local)), D.allgather_max(int(local))
        if lo != hi:
            raise RuntimeError(
                f"checkpoint '{role}' exists on some processes but not "
                f"others: checkpoint_dir must be a shared filesystem")
        return bool(lo)

    # ---- sidecar metadata: {iteration, generator state} so resume
    # continues numbering and does not replay identical game deals ----
    def save_meta(self, meta: dict) -> None:
        """Write the sidecar (rank 0 of a process world; the others
        wait)."""
        if D.rank() == 0:
            tmp = os.path.join(self.dir, "meta.json.tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(self.dir, "meta.json"))
        D.barrier()

    def load_meta(self) -> Optional[dict]:
        path = os.path.join(self.dir, "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)
