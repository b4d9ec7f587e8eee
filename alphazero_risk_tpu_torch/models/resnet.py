"""AlphaZero residual network for the 7x6 Risk board image.

Port of ``alphazero_risk_tpu/models/resnet.py``: a 3x3 conv + BN + ReLU
stem, N residual blocks [conv-BN-ReLU-conv-BN-add-ReLU], a 2-filter policy
head to 43 logits and a 1-filter value head through a dense hidden layer to
tanh.  BatchNorm has Flax's semantics, by hand (eps 1e-3, momentum 0.99):
in ``eval()`` mode it uses its running statistics; in ``train()`` mode it
normalizes with the batch mean and the biased batch variance, computed in
float32 as ``E[x^2] - E[x]^2``, and updates the running statistics in place
as ``0.99 * old + 0.01 * batch`` (Flax keeps the biased variance there too;
``nn.BatchNorm2d`` would store the unbiased one).  In a process world
(``parallel/distributed.py``) the batch is the global one, as under JAX's
GSPMD: the per-channel sums of ``x`` and ``x^2`` are all-reduced (one
differentiable all-reduce a layer), so the normalization, its gradient and
the running statistics are those of the concatenated batch.  The
``nn.BatchNorm2d`` modules only hold the parameters and buffers; their own
forward is not used.  The forward is differentiable in both modes.

Layout at the public boundary is the JAX package's: ``forward`` takes NHWC
``[B, 7, 6, F]`` features and the policy and value heads flatten their
``[7, 6, K]`` maps in (position, channel) order.  Inside, the convolutions
run NCHW in ``channels_last`` memory, which is the same bytes.

Flax runs this net with ``dtype=bfloat16``: every conv and dense layer
takes bf16-rounded inputs and weights and rounds its output to bf16, and
BatchNorm computes in float32 and rounds its output to bf16.  The port
emulates that with float32 arithmetic on bf16-rounded values (``_bf16``),
so the CPU and the card compute the same function (a float32 conv on
bf16-valued inputs is exact up to summation order, also under TF32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, NUM_ACTIONS
from ..device import resolve_device
from ..parallel import distributed as D


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, keep float32 storage."""
    return x.to(torch.bfloat16).to(torch.float32)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    w = _bf16(conv.weight)
    return _bf16(F.conv2d(_bf16(x), w, padding=conv.padding))


BN_MOMENTUM = 0.99
_DIMS = (0, 2, 3)


def _local_moments(x: torch.Tensor):
    """Per-channel E[x] and E[x^2] over this process's batch."""
    return x.mean(dim=_DIMS), (x * x).mean(dim=_DIMS)


def _global_moments(x: torch.Tensor):
    """Per-channel E[x] and E[x^2] over the world's batch: one
    differentiable all-reduce of both sums."""
    n = x.shape[0] * x.shape[2] * x.shape[3] * D.world()
    s = D.all_reduce_sum(torch.stack([x.sum(dim=_DIMS),
                                      (x * x).sum(dim=_DIMS)]))
    return s[0] / n, s[1] / n


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor,
        training: bool | None = None) -> torch.Tensor:
    """Flax BatchNorm: (x - mean) * (rsqrt(var + eps) * scale) + bias, in
    float32, rounded to bf16.  In training mode (``training``, or the
    module's own mode when it is None) mean and var are the batch's (the
    world's in a process world), and the running statistics are updated in
    place."""
    shape = (1, -1, 1, 1)
    if bn.training if training is None else training:
        moments = _global_moments if D.world() > 1 else _local_moments
        mean, ex2 = moments(x)
        var = (ex2 - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                                  + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                                 + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return _bf16(y)


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    y = _bf16(_bf16(x) @ _bf16(lin.weight).T)
    return _bf16(y + _bf16(lin.bias))


class ResBlock(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.conv_a = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn_a = nn.BatchNorm2d(filters, eps=1e-3, momentum=0.01)
        self.conv_b = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn_b = nn.BatchNorm2d(filters, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor,
                training: bool | None = None) -> torch.Tensor:
        y = torch.relu(_bn(self.bn_a, _conv(self.conv_a, x), training))
        y = _bn(self.bn_b, _conv(self.conv_b, y), training)
        return torch.relu(_bf16(y + x))


class AZNet(nn.Module):
    """Policy/value network. ``forward`` returns (policy_logits, value)."""

    def __init__(self, blocks: int = 20, filters: int = 256,
                 value_hidden: int = 256, num_features: int = 13):
        super().__init__()
        self.stem_conv = nn.Conv2d(num_features, filters, 3, padding=1,
                                   bias=False)
        self.stem_bn = nn.BatchNorm2d(filters, eps=1e-3, momentum=0.01)
        self.blocks = nn.ModuleList(ResBlock(filters) for _ in range(blocks))
        self.policy_conv = nn.Conv2d(filters, 2, 1, bias=False)
        self.policy_bn = nn.BatchNorm2d(2, eps=1e-3, momentum=0.01)
        self.policy_dense = nn.Linear(2 * 42, NUM_ACTIONS)
        self.value_conv = nn.Conv2d(filters, 1, 1, bias=False)
        self.value_bn = nn.BatchNorm2d(1, eps=1e-3, momentum=0.01)
        self.value_dense1 = nn.Linear(42, value_hidden)
        self.value_dense2 = nn.Linear(value_hidden, 1)
        self.eval()

    def forward(self, x: torch.Tensor, training: bool | None = None):
        """x [B, 7, 6, F] NHWC -> (logits [B, 43] f32, value [B] f32).
        ``training`` picks the BatchNorm mode for this call (None: the
        module's own ``train()``/``eval()`` mode)."""
        x = _bf16(x).permute(0, 3, 1, 2)               # NCHW view of NHWC
        x = torch.relu(_bn(self.stem_bn, _conv(self.stem_conv, x), training))
        for blk in self.blocks:
            x = blk(x, training)

        def head(conv, bn):
            h = torch.relu(_bn(bn, _conv(conv, x), training))
            return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # (pos, ch)

        logits = _dense(self.policy_dense, head(self.policy_conv,
                                                self.policy_bn))
        v = torch.relu(_dense(self.value_dense1, head(self.value_conv,
                                                      self.value_bn)))
        v = _dense(self.value_dense2, v)
        return logits, torch.tanh(v).squeeze(-1)


def build_network(cfg: Config, device="cuda", seed: int = 0) -> AZNet:
    """AZNet at the config's widths on ``device``, with PyTorch's default
    initialization drawn from ``seed`` (random weights; the global RNG is
    left as it was)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = AZNet(cfg.blocks, cfg.filters, cfg.value_hidden,
                    cfg.num_features)
    return net.to(dev)
