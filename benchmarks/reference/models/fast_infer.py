"""The inference network of the play cells, worked out from the raw weights.

Plain PyTorch: each BatchNorm folded into its conv, the stem in bfloat16
(bf16-rounded inputs and weights, float32 sums, TF32 off), the residual
trunk quantized to signed integers with per-output-channel weight scales
and static per-conv activation scales calibrated on a seeded feature batch,
and the heads in float32.  The integer convs are exact: on the card an
im2col matrix through ``torch._int_mm`` (int32 sums), on the CPU a float64
conv, which holds every partial sum.

``qmax`` sets the integer range: 127 is the int8 trunk the configuration
states; 7 (int4) is the control, the nearest precision below it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config import Config
from ..env.featurize import featurize
from ..env.state import new_game
from .resnet import AZNet

BOARD = 42
F32, BF16 = torch.float32, torch.bfloat16


def _hwio(conv) -> torch.Tensor:
    return conv.weight.detach().permute(2, 3, 1, 0).to(F32)


def _fold(kernel: torch.Tensor, bn):
    s = bn.weight.detach() / torch.sqrt(bn.running_var + 1e-3)
    return kernel * s, bn.bias.detach() - bn.running_mean * s


@torch.no_grad()
def fold(net: AZNet) -> Dict[str, torch.Tensor]:
    """BatchNorm folded into each conv; trunk kernels [L, 2, 3, 3, C, C]
    rounded to bf16, as the configuration's inference path keeps them."""
    stem_w, stem_b = _fold(_hwio(net.stem_conv), net.stem_bn)
    tw, tb = [], []
    for blk in net.blocks:
        wa, ba = _fold(_hwio(blk.conv_a), blk.bn_a)
        wb, bb = _fold(_hwio(blk.conv_b), blk.bn_b)
        tw.append(torch.stack([wa, wb]))
        tb.append(torch.stack([ba, bb]))
    pol_w, pol_b = _fold(_hwio(net.policy_conv), net.policy_bn)
    val_w, val_b = _fold(_hwio(net.value_conv), net.value_bn)
    return {
        "stem_w": stem_w.to(BF16), "stem_b": stem_b.to(F32),
        "trunk_w": torch.stack(tw).to(BF16), "trunk_b": torch.stack(tb),
        "pol_w": pol_w[0, 0], "pol_b": pol_b,
        "pol_dense_w": net.policy_dense.weight.detach().T.to(F32),
        "pol_dense_b": net.policy_dense.bias.detach().to(F32),
        "val_w": val_w[0, 0], "val_b": val_b,
        "val_d1_w": net.value_dense1.weight.detach().T.to(F32),
        "val_d1_b": net.value_dense1.bias.detach().to(F32),
        "val_d2_w": net.value_dense2.weight.detach().T.to(F32),
        "val_d2_b": net.value_dense2.bias.detach().to(F32),
    }


def conv_bf16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """relu(conv3x3(bf16(x), w) + bias [+ residual]), NHWC float32."""
    xc = x.to(BF16).to(F32).permute(0, 3, 1, 2)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).to(F32), padding=1)
    v = y.permute(0, 2, 3, 1) + bias
    if residual is not None:
        v = v + residual
    return torch.relu(v)


def quantize(folded, qmax: int = 127) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel integer trunk weights."""
    w = folded["trunk_w"].to(F32)
    ws = (w.abs().amax(dim=(2, 3, 4)) / float(qmax)).clamp(min=1e-12)
    wq = torch.round(w / ws[:, :, None, None, None, :]).clamp(-qmax, qmax)
    return {**folded, "trunk_wq": wq.to(torch.int8), "trunk_ws": ws,
            "qmax": qmax}


def calib_features(cfg: Config, generator: torch.Generator,
                   batch: int = 256) -> torch.Tensor:
    """The calibration batch: features of fresh deals, then uniform noise
    over the feature cube, both from ``generator``."""
    dev = generator.device
    f1 = featurize(new_game(batch, generator=generator, device=dev), cfg)
    f2 = torch.rand(f1.shape, generator=generator, device=dev)
    return torch.cat([f1, f2], 0)


@torch.no_grad()
def calibrate(folded, feats: torch.Tensor, margin: float = 1.25):
    """Static activation scales: max-abs of each trunk conv's input over
    the bf16 forward of ``feats``, times ``margin``, over ``qmax``."""
    w, b = folded["trunk_w"], folded["trunk_b"]
    h = conv_bf16(feats, folded["stem_w"], folded["stem_b"])
    scales = []
    for l in range(w.shape[0]):
        x = h
        scales.append(x.abs().amax())
        y = conv_bf16(h, w[l, 0], b[l, 0])
        scales.append(y.abs().amax())
        h = conv_bf16(y, w[l, 1], b[l, 1], residual=x)
    act = torch.stack(scales).reshape(-1, 2)
    qmax = float(folded["qmax"])
    return {**folded, "act_s": torch.clamp(act * margin, min=1e-6) / qmax}


def int_conv(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer 3x3 SAME conv: q [B,7,6,C] int8, wq [3,3,C,Cout]
    int8 (HWIO) -> int32 [B,7,6,Cout]."""
    b, hh, ww, c = q.shape
    if q.is_cuda:
        p = F.pad(q.to(torch.int16), (0, 0, 1, 1, 1, 1)).to(torch.int8)
        cols = torch.stack([p[:, dy:dy + hh, dx:dx + ww]
                            for dy in range(3) for dx in range(3)], dim=3)
        a = cols.reshape(b * hh * ww, 9 * c)
        acc = torch._int_mm(a, wq.reshape(9 * c, -1).contiguous())
        return acc.reshape(b, hh, ww, -1)
    x = q.to(torch.float64).permute(0, 3, 1, 2)
    k = wq.to(torch.float64).permute(3, 2, 0, 1)
    y = F.conv2d(x, k, padding=1)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)


def _q(h: torch.Tensor, inv_s: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.round(h * inv_s).clamp(-qmax, qmax).to(torch.int8)


def trunk(folded, h: torch.Tensor) -> torch.Tensor:
    """The integer residual trunk on static scales: h [B,7,6,C] float32
    (the stem's output) -> float32."""
    wq, ws, b = folded["trunk_wq"], folded["trunk_ws"], folded["trunk_b"]
    act_s, qmax = folded["act_s"], folded["qmax"]
    inv = 1.0 / act_s
    q = _q(h, inv[0, 0], qmax)
    for l in range(wq.shape[0]):
        x = h
        acc = int_conv(q, wq[l, 0])
        y = torch.relu(acc.to(F32) * (act_s[l, 0] * ws[l, 0]) + b[l, 0])
        q2 = _q(y, inv[l, 1], qmax)
        acc = int_conv(q2, wq[l, 1])
        h = acc.to(F32) * (act_s[l, 1] * ws[l, 1]) + b[l, 1] + x
        h = torch.relu(h)
        if l + 1 < wq.shape[0]:
            q = _q(h, inv[l + 1, 0], qmax)
    return h


def heads(folded, h: torch.Tensor):
    """h [B,42,C] -> (logits [B,43], value [B]), float32."""
    p = torch.relu(h @ folded["pol_w"] + folded["pol_b"])
    logits = p.reshape(p.shape[0], -1) @ folded["pol_dense_w"] \
        + folded["pol_dense_b"]
    v = torch.relu(h @ folded["val_w"] + folded["val_b"])
    v = torch.relu(v.reshape(v.shape[0], -1) @ folded["val_d1_w"]
                   + folded["val_d1_b"])
    v = v @ folded["val_d2_w"] + folded["val_d2_b"]
    return logits, torch.tanh(v).squeeze(-1)


def prepare(net: AZNet, cfg: Config, calib_seed: int, device,
            qmax: int = 127):
    """Fold, quantize and calibrate ``net`` on the calibration batch that
    a generator on ``device`` seeded with ``calib_seed`` gives."""
    g = torch.Generator(device=device)
    g.manual_seed(calib_seed)
    folded = quantize(fold(net), qmax)
    return calibrate(folded, calib_features(cfg, g))


@torch.no_grad()
def evaluate(folded, cfg: Config, state, legal: torch.Tensor):
    """(legal-masked softmax [B,43], value [B]) of ``state``."""
    x = featurize(state, cfg)
    h = conv_bf16(x, folded["stem_w"], folded["stem_b"])
    h = trunk(folded, h)
    logits, value = heads(folded, h.reshape(h.shape[0], BOARD, -1))
    logits = torch.where(legal, logits, torch.tensor(float("-inf"),
                                                     device=logits.device))
    return torch.softmax(logits, dim=-1), value


def make_eval_fn(folded, cfg: Config):
    return lambda state, legal: evaluate(folded, cfg, state, legal)
