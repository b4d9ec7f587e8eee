"""Weights for both sides: a params npz read from its raw file, or fresh
weights drawn on the device from a seed.

The npz layout is the interchange format of the repository's committed
weights: float16 arrays under ``p/<module>/kernel|bias|scale`` and
``b/<bn>/mean|var``, conv kernels HWIO, dense kernels [in, out].
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

from .config import Config
from .models.resnet import AZNet

_CONV = re.compile(r"(stem_conv|policy_conv|value_conv|block_\d+/conv_[ab])$")
_BN = re.compile(r"(stem_bn|policy_bn|value_bn|block_\d+/bn_[ab])$")
_BN_KEYS = {"p/scale": "weight", "p/bias": "bias", "b/mean": "running_mean",
            "b/var": "running_var"}


def state_dict_of_npz(path: str) -> Dict[str, torch.Tensor]:
    """The float32 ``AZNet`` state dict held in a params npz."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            kind, rest = key.split("/", 1)
            mod, leaf = rest.rsplit("/", 1)
            a = torch.from_numpy(np.asarray(z[key], dtype=np.float32).copy())
            name = re.sub(r"block_(\d+)", r"blocks.\1", mod).replace("/", ".")
            if _CONV.search(mod) and kind == "p" and leaf == "kernel":
                out[f"{name}.weight"] = a.permute(3, 2, 0, 1).contiguous()
            elif _BN.search(mod) and f"{kind}/{leaf}" in _BN_KEYS:
                out[f"{name}.{_BN_KEYS[kind + '/' + leaf]}"] = a
            elif kind == "p" and leaf == "kernel":
                out[f"{name}.weight"] = a.T.contiguous()
            elif kind == "p" and leaf == "bias":
                out[f"{name}.bias"] = a
            else:
                raise KeyError(f"unexpected parameter key {key!r}")
    return out


def new_net(cfg: Config, device) -> AZNet:
    """An ``AZNet`` at the configuration's widths, made on ``device``."""
    with torch.device(device):
        return AZNet(cfg.blocks, cfg.filters, cfg.value_hidden,
                     cfg.num_features).eval()


def load_net(state_dict: Dict[str, torch.Tensor], cfg: Config,
             device) -> AZNet:
    net = new_net(cfg, device)
    sd = {k: v for k, v in net.state_dict().items()}
    for k, v in state_dict.items():
        sd[k] = v.to(device)
    net.load_state_dict(sd, strict=True)
    return net


def seeded_state_dict(cfg: Config, seed: int, device
                      ) -> Dict[str, torch.Tensor]:
    """Fresh weights from ``seed``, drawn on ``device`` in one call: every
    conv and dense kernel and dense bias uniform in +-1/sqrt(fan_in) (the
    bound of PyTorch's default initialisation), BatchNorm scales 1, shifts
    0, running means 0 and variances 1."""
    shapes = {k: tuple(v.shape)
              for k, v in new_net(cfg, "meta").state_dict().items()}
    drawn = [k for k in shapes if k.endswith((".weight", ".bias"))
             and "bn" not in k]
    total = sum(math.prod(shapes[k]) for k in drawn)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    out, i = {}, 0
    for k in drawn:
        n = math.prod(shapes[k])
        wkey = k[:-len("bias")] + "weight" if k.endswith(".bias") else k
        fan_in = math.prod(shapes[wkey][1:])
        out[k] = (flat[i:i + n] / math.sqrt(fan_in)).view(shapes[k])
        i += n
    for k, shape in shapes.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith(("running_var", ".weight")):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out
