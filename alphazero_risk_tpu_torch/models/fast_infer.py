"""Fast inference path: BN-folded bf16 / int8 forward for the actors.

Port of ``alphazero_risk_tpu/models/fast_infer.py``.  Each BatchNorm is
folded into its preceding conv, and the residual trunk runs either in bf16
or quantized to int8 (per-output-channel weight scales, static calibrated
or dynamic per-tensor activation scales).  The folded dict keeps the JAX
package's keys and layouts: HWIO conv kernels, ``trunk_w`` stacked as
``[L, 2, 3, 3, C, C]``, dense kernels as ``[in, out]``, activations NHWC.

The int8 trunk runs on kernel K1 (``csrc/conv_i8.cu``): an int8 x int8 ->
int32 3x3 conv with the dequantize / bias / residual / ReLU / requantize
epilogue fused (``conv3x3_i8``).  On CPU tensors ``conv3x3_i8`` computes the
same function in plain PyTorch: the conv exactly in float64, the epilogue
in float32 in the JAX order.

The bf16 stem and trunk convs stay ``F.conv2d``: a float32 conv on
bf16-rounded inputs and weights, which is what JAX computes with
``preferred_element_type=float32`` (a bf16 cuDNN conv would round its
output to bf16 instead).  The heads run in float32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .. import kernels
from ..config import Config
from ..env.featurize import featurize
from ..env.state import new_game
from .resnet import AZNet

BOARD = 42
I8, I32, F32, BF16 = torch.int8, torch.int32, torch.float32, torch.bfloat16


def _hwio(conv) -> torch.Tensor:
    return conv.weight.detach().permute(2, 3, 1, 0).to(F32)


def _fold_conv_bn(kernel: torch.Tensor, bn) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Fold BN(scale, bias, mean, var) into a conv kernel [..., Cout]."""
    s = bn.weight.detach() / torch.sqrt(bn.running_var + 1e-3)
    return kernel * s, bn.bias.detach() - bn.running_mean * s


@torch.no_grad()
def fold_params(net: AZNet, cfg: Config) -> Dict[str, torch.Tensor]:
    """Fold an ``AZNet``'s weights and BatchNorm statistics into the
    inference dict.  Trunk kernels are stacked as [L, 2, 3, 3, C, C]."""
    stem_w, stem_b = _fold_conv_bn(_hwio(net.stem_conv), net.stem_bn)
    trunk_w, trunk_b = [], []
    for blk in net.blocks:
        wa, ba = _fold_conv_bn(_hwio(blk.conv_a), blk.bn_a)
        wb, bb = _fold_conv_bn(_hwio(blk.conv_b), blk.bn_b)
        trunk_w.append(torch.stack([wa, wb]))
        trunk_b.append(torch.stack([ba, bb]))
    pol_w, pol_b = _fold_conv_bn(_hwio(net.policy_conv), net.policy_bn)
    val_w, val_b = _fold_conv_bn(_hwio(net.value_conv), net.value_bn)

    def dense(lin):
        return (lin.weight.detach().T.contiguous().to(F32),
                lin.bias.detach().to(F32))

    pd_w, pd_b = dense(net.policy_dense)
    d1_w, d1_b = dense(net.value_dense1)
    d2_w, d2_b = dense(net.value_dense2)
    return {
        "stem_w": stem_w.to(BF16),
        "stem_b": stem_b.to(F32),
        "trunk_w": torch.stack(trunk_w).to(BF16),
        "trunk_b": torch.stack(trunk_b).to(F32),
        "pol_w": pol_w[0, 0].contiguous(),     # [C, 2]
        "pol_b": pol_b.to(F32),
        "pol_dense_w": pd_w, "pol_dense_b": pd_b,
        "val_w": val_w[0, 0].contiguous(),     # [C, 1]
        "val_b": val_b.to(F32),
        "val_d1_w": d1_w, "val_d1_b": d1_b,
        "val_d2_w": d2_w, "val_d2_b": d2_b,
    }


def quantize_trunk(folded: Dict[str, Any]) -> Dict[str, Any]:
    """Add int8 trunk weights: per-output-channel symmetric scales."""
    w = folded["trunk_w"].to(F32)                      # [L,2,3,3,C,C]
    ws = w.abs().amax(dim=(2, 3, 4)) / 127.0           # [L,2,C]
    ws = ws.clamp(min=1e-12)
    wq = torch.round(w / ws[:, :, None, None, None, :]).clamp(-127, 127)
    return {**folded, "trunk_wq": wq.to(I8).contiguous(),
            "trunk_ws": ws.to(F32).contiguous()}


def _conv_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, NHWC f32 x HWIO bf16 -> NHWC f32, on bf16-rounded
    inputs with float32 accumulation."""
    xc = x.to(BF16).to(F32).permute(0, 3, 1, 2)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).to(F32), padding=1)
    return y.permute(0, 2, 3, 1)


def _stem(folded, x):
    """x [B,7,6,F] -> [B,7,6,C] f32 (post-ReLU)."""
    return torch.relu(_conv_bf16(x, folded["stem_w"]) + folded["stem_b"])


def _conv_i8_plain(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 3x3 SAME conv, exact: float64 holds every
    partial sum (|acc| <= 127*127*9*C < 2^53) without rounding."""
    x = q.to(torch.float64).permute(0, 3, 1, 2)
    k = w.to(torch.float64).permute(3, 2, 0, 1)
    y = F.conv2d(x, k, padding=1)
    return torch.round(y).to(I32).permute(0, 2, 3, 1).contiguous()


def _quantize(h: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """clip(rint(h * (1/s)), -127, 127) as int8."""
    return torch.round(h * inv_s).clamp(-127, 127).to(I8)


def _epilogue_plain(acc, ws, bias, s, residual, inv_s_next):
    v = acc.to(F32) * (s * ws) + bias
    if residual is not None:
        v = v + residual
    v = torch.clamp(v, min=0.0)
    q = None if inv_s_next is None else _quantize(v, inv_s_next)
    return v, q


def conv3x3_i8(q: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
               bias: torch.Tensor, s: torch.Tensor,
               residual: torch.Tensor | None = None,
               inv_s_next: torch.Tensor | None = None,
               want_h: bool = True, want_acc: bool = False):
    """One int8 trunk conv with its fused epilogue (kernel K1).

    q [B,7,6,C] int8 NHWC, w [3,3,C,C] int8 HWIO, ws and bias [C] f32, s
    the 0-d f32 activation scale of q.  Computes
    ``h = relu(acc * (s * ws) + bias [+ residual])`` and, given
    ``inv_s_next`` (0-d f32), the next conv's input
    ``clip(rint(h * inv_s_next), -127, 127)``.  Returns
    ``(h or None, q_next or None, acc or None)``.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (no fallback).
    """
    if q.device.type == "cpu":
        acc = _conv_i8_plain(q, w)
        h, qn = _epilogue_plain(acc, ws, bias, s, residual, inv_s_next)
        return (h if want_h else None, qn, acc if want_acc else None)
    extra = [t for t in (residual, inv_s_next) if t is not None]
    kernels.require_cuda(q, w, ws, bias, s, *extra)
    b, c = q.shape[0], q.shape[-1]
    if q.dtype != I8 or w.dtype != I8 or tuple(w.shape) != (3, 3, c, c):
        raise ValueError("conv3x3_i8 takes int8 NHWC q and int8 HWIO w")
    if tuple(q.shape[1:3]) != (7, 6) or c % 64:
        raise ValueError("conv3x3_i8 takes a 7x6 board and C % 64 == 0")
    m = b * BOARD
    h = torch.empty(q.shape, dtype=F32, device=q.device) if want_h else None
    qn = (torch.empty(q.shape, dtype=I8, device=q.device)
          if inv_s_next is not None else None)
    acc = (torch.empty(q.shape, dtype=I32, device=q.device)
           if want_acc else None)
    P = kernels.ptr
    kernels.CONV3X3_I8.launch(P(q), P(w), P(ws), P(bias), P(s), P(residual),
                              P(inv_s_next), P(h), P(qn), P(acc), m, c)
    return h, qn, acc


def _quant_dyn(h):
    """Dynamic per-tensor symmetric quantization."""
    s = torch.clamp(h.abs().amax(), min=1e-6) / 127.0
    return _quantize(h, 1.0 / s), s


def _trunk_xla_bf16(folded, h):
    """BN-folded bf16 residual trunk.  h [B,7,6,C] f32."""
    w, b = folded["trunk_w"], folded["trunk_b"]
    for l in range(w.shape[0]):
        x = h
        y = torch.relu(_conv_bf16(x, w[l, 0]) + b[l, 0])
        h = torch.relu(_conv_bf16(y, w[l, 1]) + b[l, 1] + x)
    return h


def _trunk_xla_int8(folded, h):
    """int8 residual trunk on K1.  h [B,7,6,C] f32 -> same.

    Static per-conv activation scales when ``act_s`` was calibrated into
    the folded dict: each conv then also emits the next conv's int8 input.
    Dynamic per-tensor scales otherwise."""
    w, ws, b = folded["trunk_wq"], folded["trunk_ws"], folded["trunk_b"]
    L = w.shape[0]
    act_s = folded.get("act_s")          # [L, 2] f32 or None
    h = h.contiguous()
    if act_s is None:
        for l in range(L):
            x = h
            q, s = _quant_dyn(x)
            y, _, _ = conv3x3_i8(q, w[l, 0], ws[l, 0], b[l, 0], s)
            q2, s2 = _quant_dyn(y)
            h, _, _ = conv3x3_i8(q2, w[l, 1], ws[l, 1], b[l, 1], s2,
                                 residual=x)
        return h
    inv = 1.0 / act_s
    q = _quantize(h, inv[0, 0])
    for l in range(L):
        x = h
        _, q2, _ = conv3x3_i8(q, w[l, 0], ws[l, 0], b[l, 0], act_s[l, 0],
                              inv_s_next=inv[l, 1], want_h=False)
        nxt = inv[l + 1, 0] if l + 1 < L else None
        h, q, _ = conv3x3_i8(q2, w[l, 1], ws[l, 1], b[l, 1], act_s[l, 1],
                             residual=x, inv_s_next=nxt)
    return h


@torch.no_grad()
def calibrate_trunk(folded: Dict[str, Any], feats: torch.Tensor,
                    margin: float = 1.25) -> Dict[str, Any]:
    """Record static per-conv activation scales (max-abs over ``feats``, a
    representative [B,7,6,F] feature batch, times ``margin``) into the
    folded dict."""
    w, b = folded["trunk_w"], folded["trunk_b"]
    h = _stem(folded, feats)
    scales = []
    for l in range(w.shape[0]):
        x = h
        scales.append(x.abs().amax())
        y = torch.relu(_conv_bf16(x, w[l, 0]) + b[l, 0])
        scales.append(y.abs().amax())
        h = torch.relu(_conv_bf16(y, w[l, 1]) + b[l, 1] + x)
    act_max = torch.stack(scales).reshape(-1, 2)
    act_s = torch.clamp(act_max * margin, min=1e-6) / 127.0
    return {**folded, "act_s": act_s.to(F32)}


def _heads(folded, h):
    """h [B,42,C] -> (logits [B,43] f32, value [B] f32)."""
    hf = h.to(F32)
    p = torch.relu(hf @ folded["pol_w"] + folded["pol_b"])
    p = p.reshape(p.shape[0], -1)                      # [B, 84] (pos, ch)
    logits = p @ folded["pol_dense_w"] + folded["pol_dense_b"]
    v = torch.relu(hf @ folded["val_w"] + folded["val_b"])
    v = v.reshape(v.shape[0], -1)                      # [B, 42]
    v = torch.relu(v @ folded["val_d1_w"] + folded["val_d1_b"])
    v = v @ folded["val_d2_w"] + folded["val_d2_b"]
    return logits, torch.tanh(v).squeeze(-1)


@torch.no_grad()
def apply_folded(folded: Dict[str, Any], x: torch.Tensor, *,
                 int8: bool = False):
    """Forward pass on folded params.  x [B,7,6,F] -> (logits, value)."""
    h = _stem(folded, x)
    h = _trunk_xla_int8(folded, h) if int8 else _trunk_xla_bf16(folded, h)
    h = h.reshape(h.shape[0], BOARD, -1)
    return _heads(folded, h)


def make_fast_eval_fn(cfg: Config, *, int8: bool = False):
    """MCTS eval_fn over folded params: ``eval_fn(folded, state, legal) ->
    (probs [B,43] legal-masked softmax, value [B])``."""

    def eval_fn(folded, state, legal):
        logits, value = apply_folded(folded, featurize(state, cfg), int8=int8)
        neg_inf = torch.tensor(float("-inf"), device=logits.device)
        probs = torch.softmax(torch.where(legal, logits, neg_inf), dim=-1)
        return probs, value

    return eval_fn


def default_calib_feats(cfg: Config, generator: torch.Generator,
                        batch: int = 256, device="cuda") -> torch.Tensor:
    """Representative feature batch for int8 activation calibration:
    featurized fresh initial states plus uniform noise over the feature
    cube, drawn from ``generator``."""
    st = new_game(batch, generator=generator, device=device)
    f1 = featurize(st, cfg)
    f2 = torch.rand(f1.shape, generator=generator,
                    device=generator.device).to(f1.device)
    return torch.cat([f1, f2], 0)


def fold_for_inference(net: AZNet, cfg: Config, *, int8: bool = False,
                       calib_feats: torch.Tensor | None = None
                       ) -> Dict[str, Any]:
    """One-call fold (+ optional int8 trunk quantization and activation
    calibration) of a network into the inference dict."""
    folded = fold_params(net, cfg)
    if int8:
        folded = quantize_trunk(folded)
        if calib_feats is not None:
            folded = calibrate_trunk(folded, calib_feats)
    return folded
