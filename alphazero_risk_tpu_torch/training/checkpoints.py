"""Parameter files: the JAX package's params npz, read into the port.

Port of the ``save_params_npz`` format of
``alphazero_risk_tpu/training/checkpoints.py`` (``load_params_npz``,
``:88-111``): one npz with float16 arrays under the keys
``p/<module>/kernel|bias|scale`` (parameters) and ``b/<bn>/mean|var``
(BatchNorm statistics), conv kernels in HWIO and dense kernels as
[in, out].  The port has no orbax checkpoints; these files are its only
weight format so far.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.resnet import AZNet, build_network

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


def load_params_npz(path: str, cfg: Config, device="cuda") -> AZNet:
    """An ``AZNet`` at the config's widths holding the weights of a
    ``save_params_npz`` file (float16 storage upcast to float32)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = dict(z)
    net = build_network(cfg, device="cpu")
    sd = params_from_jax(flat)
    # BatchNorm2d keeps a step counter that the JAX file has no use for.
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    net.load_state_dict(sd, strict=True)
    return net.to(dev)


def folded_from_jax(folded: Dict[str, np.ndarray],
                    device="cuda") -> Dict[str, torch.Tensor]:
    """An already folded (and possibly quantized and calibrated) JAX
    inference pytree -> the port's folded dict, value for value: bf16 stays
    bf16, int8 stays int8, float32 stays float32."""
    dev = resolve_device(device)
    out = {}
    for k, v in folded.items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[k] = t.to(dev)
    return out
