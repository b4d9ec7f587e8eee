"""Fast inference path: BN-folded bf16 / int8 forward for the actors.

Port of ``alphazero_risk_tpu/models/fast_infer.py``.  Each BatchNorm is
folded into its preceding conv, and the residual trunk runs either in bf16
or quantized to int8 (per-output-channel weight scales, static calibrated
or dynamic per-tensor activation scales).  The folded dict keeps the JAX
package's keys and layouts: HWIO conv kernels, ``trunk_w`` stacked as
``[L, 2, 3, 3, C, C]``, dense kernels as ``[in, out]``, activations NHWC.

The int8 trunk runs on kernel K1 (``csrc/conv_i8.cu``): an int8 x int8 ->
int32 3x3 conv on the tensor cores with the dequantize / bias / residual /
ReLU / requantize epilogue fused (``conv3x3_i8``).  It takes the trunk
weight packed K-major, ``[L, 2, 3, 3, Cout, Cin]`` (``trunk_wqk``, made
once by ``pack_trunk_wq`` wherever ``trunk_wq`` is made or loaded); the
HWIO ``trunk_wq`` stays as JAX has it.  On CPU tensors ``conv3x3_i8``
computes the same function in plain PyTorch: the conv exactly in float64,
the epilogue in float32 in the JAX order.

The bf16 stem and trunk convs run on kernel K4 (``csrc/conv_bf16.cu``,
``conv3x3_bf16``), also on the tensor cores: bf16-rounded inputs and
weights, float32 accumulation (what JAX computes with
``preferred_element_type=float32``), with the bias, the residual add and the
ReLU fused.  K4 writes its output as f32, as bf16 (the next conv's input,
which JAX rounds to bf16), as int8 codes at a given scale, or several of
them, so the bf16 trunk hands bf16 from conv to conv, and the stem hands
the int8 trunk its first input as K1 hands each conv the next one's.  The
heads and the legal-masked softmax run on kernel K5
(``csrc/heads_softmax.cu``, ``heads_eval``), in float32, on the ten head
tensors packed once at fold time into one buffer (``pack_heads``,
``heads_pack`` of the folded dict).  On CPU tensors
the wrappers compute the same functions in plain PyTorch (``_conv_bf16``
with its elementwise epilogue; ``_heads`` and ``torch.softmax``).

On the card the int8 trunk with calibrated scales runs as one replay of a
CUDA graph of its 2 x blocks K1 launches, captured once per batch size and
kept in the folded dict (``trunk_graphs``, beside ``trunk_convs``): the
stem writes straight into the graph's inputs, and the host launches one
graph where it launched 2 x blocks kernels (``_trunk_out``).

Under the profiler (``utils.profiling``) each evaluation of the eval
functions is a ``net.eval`` span, each trunk pass's conv launches (or its
graph's replay) a ``net.trunk`` span, and the counter ``net.boards`` adds
the rows of every trunk pass; ``net.boards_wide`` adds those of the int8
trunk passes whose K1 launches take its wide design (``k1_wide``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .. import kernels
from ..config import Config
from ..env.featurize import featurize
from ..env.state import new_game
from ..utils import profiling
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
    folded = {
        "stem_w": stem_w.to(BF16).contiguous(),
        "stem_b": stem_b.to(F32),
        "trunk_w": torch.stack(trunk_w).to(BF16).contiguous(),
        "trunk_b": torch.stack(trunk_b).to(F32),
        "pol_w": pol_w[0, 0].contiguous(),     # [C, 2]
        "pol_b": pol_b.to(F32),
        "pol_dense_w": pd_w, "pol_dense_b": pd_b,
        "val_w": val_w[0, 0].contiguous(),     # [C, 1]
        "val_b": val_b.to(F32),
        "val_d1_w": d1_w, "val_d1_b": d1_b,
        "val_d2_w": d2_w, "val_d2_b": d2_b,
    }
    return {**folded, "heads_pack": pack_heads(folded)}


@functools.lru_cache(maxsize=None)
def heads_layout(c: int, v: int) -> dict:
    """Offsets, in floats, of the sections of K5's packed head weights for
    C channels and V value-hidden units (``csrc/heads_softmax.cu`` computes
    the same): ``conv`` [C, 4] the three 1x1-conv columns per channel
    (pol_w[:, 0], pol_w[:, 1], val_w[:, 0], 0); ``bias`` [4] pol_b[0],
    pol_b[1], val_b[0], val_d2_b[0]; ``pol_dense_w`` [43, 84] transposed;
    ``pol_dense_b`` [44]; ``val_d1_w`` [42, Vp]; ``val_d1_b`` and
    ``val_d2_w`` [Vp] (Vp: V rounded up to 4, zeros past V).  The policy
    part [pol_dense_w, val_d1_w) and the value part [val_d1_w, end) each
    start on a 16-byte boundary.  (Cached: callers do not modify it.)"""
    vp = -(-v // 4) * 4
    o = {"conv": 0, "bias": 4 * c}
    o["pol_dense_w"] = o["bias"] + 4
    o["pol_dense_b"] = o["pol_dense_w"] + 43 * 2 * BOARD
    o["val_d1_w"] = o["pol_dense_b"] + 44
    o["val_d1_b"] = o["val_d1_w"] + BOARD * vp
    o["val_d2_w"] = o["val_d1_b"] + vp
    o["end"] = o["val_d2_w"] + vp
    return o


_HEAD_SHAPES = {"pol_w": ("c", 2), "pol_b": (2,),
                "pol_dense_w": (2 * BOARD, 43), "pol_dense_b": (43,),
                "val_w": ("c", 1), "val_b": (1,), "val_d1_w": (BOARD, "v"),
                "val_d1_b": ("v",), "val_d2_w": ("v", 1), "val_d2_b": (1,)}


@torch.no_grad()
def pack_heads(folded: Dict[str, Any]) -> torch.Tensor:
    """The ten head tensors of ``folded`` packed once into one f32 buffer
    in K5's layout (``heads_layout``), on their device.  Raises unless
    they are f32 of the shapes ``_heads`` takes."""
    c, v = folded["pol_w"].shape[0], folded["val_d1_w"].shape[-1]
    for k, shape in _HEAD_SHAPES.items():
        want = tuple({"c": c, "v": v}.get(d, d) for d in shape)
        t = folded[k]
        if t.dtype != F32 or tuple(t.shape) != want:
            raise ValueError(f"pack_heads: {k} must be f32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    lay = heads_layout(c, v)
    vp = (lay["end"] - lay["val_d1_w"]) // (BOARD + 2)
    buf = torch.zeros(lay["end"], dtype=F32, device=folded["pol_w"].device)
    conv = buf[:4 * c].view(c, 4)
    conv[:, :2] = folded["pol_w"]
    conv[:, 2] = folded["val_w"][:, 0]
    b = lay["bias"]
    buf[b:b + 2] = folded["pol_b"]
    buf[b + 2] = folded["val_b"][0]
    buf[b + 3] = folded["val_d2_b"][0]
    o = lay["pol_dense_w"]
    buf[o:o + 43 * 2 * BOARD].view(43, 2 * BOARD).copy_(
        folded["pol_dense_w"].T)
    o = lay["pol_dense_b"]
    buf[o:o + 43] = folded["pol_dense_b"]
    o = lay["val_d1_w"]
    buf[o:o + BOARD * vp].view(BOARD, vp)[:, :v] = folded["val_d1_w"]
    o = lay["val_d1_b"]
    buf[o:o + v] = folded["val_d1_b"]
    o = lay["val_d2_w"]
    buf[o:o + v] = folded["val_d2_w"][:, 0]
    return buf


def pack_trunk_wq(wq: torch.Tensor) -> torch.Tensor:
    """The int8 trunk weight [..., 3, 3, Cin, Cout] (HWIO) as K1 takes it:
    [..., 3, 3, Cout, Cin], each output channel's input channels
    contiguous (the K-major operand of the int8 tensor cores)."""
    return wq.transpose(-1, -2).contiguous()


def quantize_trunk(folded: Dict[str, Any]) -> Dict[str, Any]:
    """Add int8 trunk weights: per-output-channel symmetric scales, and
    the weights packed for K1 (``trunk_wqk``)."""
    w = folded["trunk_w"].to(F32)                      # [L,2,3,3,C,C]
    ws = w.abs().amax(dim=(2, 3, 4)) / 127.0           # [L,2,C]
    ws = ws.clamp(min=1e-12)
    wq = torch.round(w / ws[:, :, None, None, None, :]).clamp(-127, 127)
    wq = wq.to(I8).contiguous()
    out = {**folded, "trunk_wq": wq, "trunk_wqk": pack_trunk_wq(wq),
           "trunk_ws": ws.to(F32).contiguous()}
    return {**out, "trunk_convs": trunk_convs(out)}


def trunk_convs(folded: Dict[str, Any]) -> tuple:
    """K1's operands for each conv k = 2l + i of the int8 trunk, ``(w, ws,
    bias, s, inv_s)``: views into ``trunk_wqk``, ``trunk_ws``, ``trunk_b``
    and the calibrated ``act_s`` (the conv's input scale and its inverse;
    None without ``act_s``).  Made once a fold (``quantize_trunk``,
    ``calibrate_trunk`` and ``folded_from_jax`` keep them as the folded
    dict's ``trunk_convs``), so that a trunk pass only launches K1."""
    w, ws, b = (folded[k].flatten(0, 1).unbind()
                for k in ("trunk_wqk", "trunk_ws", "trunk_b"))
    act_s = folded.get("act_s")
    if act_s is None:
        s = inv = (None,) * len(w)
    else:
        s = act_s.flatten().unbind()
        inv = (1.0 / act_s).flatten().unbind()
    return tuple(zip(w, ws, b, s, inv))


def conv_tile(kernel: kernels.Kernel, boards: int, cout: int
              ) -> tuple[int, int]:
    """(boards per tile, tiles) of a K1 or K4 launch (``kernel``) over
    ``boards`` boards and ``cout`` output channels on the current card, as
    the kernel's library chooses them.  A tile is ``per`` boards x 64
    output channels, one block each (``csrc/conv_tc.cuh``), or in K1's wide
    design (``k1_wide``; ``per`` 0) 64 rows x all 256 channels, walked by
    persistent blocks (``csrc/conv_i8_wide.cuh``)."""
    per = kernel.query(kernel.symbol + "_boards", boards, cout)
    if per == 0:
        return 0, -(-boards * BOARD // 64)
    return per, -(-boards // per) * (cout // 64)


def k1_wide(boards: int, cout: int, device: torch.device) -> bool:
    """Whether K1 runs a launch over ``boards`` boards and ``cout``
    channels on ``device`` in its wide design (whole-Cout tiles on
    persistent blocks: C=256 and a tile of 64 rows for every SM of the
    card), as its library chooses.  False off the card, where the plain
    version runs."""
    if device.type != "cuda":
        return False
    with torch.cuda.device(device):
        return bool(kernels.CONV3X3_I8.query("az_conv3x3_i8_wide", boards,
                                             cout))


def _conv_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, NHWC f32 x HWIO bf16 -> NHWC f32, on bf16-rounded
    inputs with float32 accumulation."""
    xc = x.to(BF16).to(F32).permute(0, 3, 1, 2)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).to(F32), padding=1)
    return y.permute(0, 2, 3, 1)


def _conv3x3_bf16_plain(x, w, bias, residual=None):
    v = _conv_bf16(x, w) + bias
    if residual is not None:
        v = v + residual
    return torch.relu(v)


def conv3x3_bf16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 residual: torch.Tensor | None = None, want_f32: bool = True,
                 want_bf16: bool = False,
                 inv_s_next: torch.Tensor | None = None,
                 out: torch.Tensor | None = None,
                 out_q: torch.Tensor | None = None):
    """One bf16 conv with its fused epilogue (kernel K4).

    x [B,7,6,Cin] NHWC, f32 (rounded to bf16 inside) or bf16 (Cin % 8 == 0
    on the card), w [3,3,Cin,Cout] bf16 HWIO, bias [Cout] f32, residual
    [B,7,6,Cout] f32 or None.  Computes
    ``v = relu(conv(x, w) + bias [+ residual])`` and returns
    ``(v as f32 or None, v.to(bfloat16) or None, q or None)``: the f32 and
    bf16 outputs as ``want_f32`` and ``want_bf16`` ask, and, given
    ``inv_s_next`` (0-d f32), the int8 trunk's first input
    ``q = clip(rint(v * inv_s_next), -127, 127)`` (``_quantize``; what K1
    writes for the conv after it).  ``out`` (f32) and ``out_q`` (int8),
    contiguous [B,7,6,Cout], receive the f32 output (asked for by giving
    ``out``) and q in place of new tensors.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (no fallback).
    """
    want_f32 = want_f32 or out is not None
    if not (want_f32 or want_bf16 or inv_s_next is not None):
        raise ValueError("conv3x3_bf16: ask for at least one output")
    if out_q is not None and inv_s_next is None:
        raise ValueError("conv3x3_bf16: out_q needs inv_s_next")
    shape = (x.shape[0], 7, 6, w.shape[-1])
    for t, dt in ((out, F32), (out_q, I8)):
        if t is not None and (t.dtype != dt or tuple(t.shape) != shape
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"conv3x3_bf16: out and out_q must be "
                             f"contiguous {shape} f32 and int8 on x's "
                             f"device")
    if x.device.type == "cpu":
        v = _conv3x3_bf16_plain(x, w, bias, residual)
        q = None if inv_s_next is None else _quantize(v, inv_s_next)
        if out is not None:
            v = out.copy_(v)
        if out_q is not None:
            q = out_q.copy_(q)
        return (v if want_f32 else None, v.to(BF16) if want_bf16 else None,
                q)
    extra = [t for t in (residual, inv_s_next) if t is not None]
    kernels.require_cuda(x, w, bias, *extra)
    b, cin, cout = x.shape[0], x.shape[-1], w.shape[-1]
    if x.dtype not in (F32, BF16) or w.dtype != BF16 or bias.dtype != F32 \
            or tuple(w.shape) != (3, 3, cin, cout) \
            or tuple(bias.shape) != (cout,):
        raise ValueError("conv3x3_bf16 takes f32 or bf16 NHWC x, bf16 HWIO "
                         "w and f32 bias")
    if tuple(x.shape[1:3]) != (7, 6) or cout % 64 or (x.dtype == BF16
                                                      and cin % 8):
        raise ValueError("conv3x3_bf16 takes a 7x6 board, Cout % 64 == 0 "
                         "and, for bf16 x, Cin % 8 == 0")
    if residual is not None and (residual.dtype != F32
                                 or tuple(residual.shape) != shape):
        raise ValueError("conv3x3_bf16 residual must be f32 [B,7,6,Cout]")
    if inv_s_next is not None and (inv_s_next.dtype != F32
                                   or inv_s_next.dim() != 0):
        raise ValueError("conv3x3_bf16 inv_s_next must be 0-d f32")
    if want_f32 and out is None:
        out = torch.empty(shape, dtype=F32, device=x.device)
    outb = (torch.empty(shape, dtype=BF16, device=x.device) if want_bf16
            else None)
    if inv_s_next is not None and out_q is None:
        out_q = torch.empty(shape, dtype=I8, device=x.device)
    kernels.require_aligned(x, w, *(t for t in (out, out_q)
                                    if t is not None))
    P = kernels.ptr
    kernels.CONV3X3_BF16.launch(P(x), P(w), P(bias), P(residual),
                                P(inv_s_next), P(out), P(outb), P(out_q),
                                b * BOARD, cin, cout, int(x.dtype == BF16))
    return out, outb, out_q


def _stem(folded, x, want_bf16=False, inv_s=None, out=None, out_q=None):
    """x [B,7,6,F] -> ([B,7,6,C] f32 post-ReLU, its bf16 copy or None, its
    int8 codes at the inverse scale ``inv_s`` or None); ``out`` and
    ``out_q`` as ``conv3x3_bf16`` takes them."""
    return conv3x3_bf16(x.contiguous(), folded["stem_w"], folded["stem_b"],
                        want_bf16=want_bf16, inv_s_next=inv_s, out=out,
                        out_q=out_q)


def _conv_i8_plain(q: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 3x3 SAME conv of q [B,7,6,Cin] with the packed
    weight wk [3,3,Cout,Cin], exact: float64 holds every partial sum
    (|acc| <= 127*127*9*C < 2^53) without rounding."""
    x = q.to(torch.float64).permute(0, 3, 1, 2)
    k = wk.to(torch.float64).permute(2, 3, 0, 1)
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

    q [B,7,6,C] int8 NHWC, w [3,3,Cout,Cin] int8 packed K-major
    (``pack_trunk_wq``; ``trunk_wqk`` of the folded dict), ws and bias [C]
    f32, s the 0-d f32 activation scale of q.  Computes
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
        raise ValueError("conv3x3_i8 takes int8 NHWC q and the int8 packed "
                         "w [3,3,Cout,Cin]")
    if tuple(q.shape[1:3]) != (7, 6) or c % 64:
        raise ValueError("conv3x3_i8 takes a 7x6 board and C % 64 == 0")
    m = b * BOARD
    h = torch.empty(q.shape, dtype=F32, device=q.device) if want_h else None
    qn = (torch.empty(q.shape, dtype=I8, device=q.device)
          if inv_s_next is not None else None)
    acc = (torch.empty(q.shape, dtype=I32, device=q.device)
           if want_acc else None)
    kernels.require_aligned(q, w)
    P = kernels.ptr
    kernels.CONV3X3_I8.launch(P(q), P(w), P(ws), P(bias), P(s), P(residual),
                              P(inv_s_next), P(h), P(qn), P(acc), m, c)
    return h, qn, acc


def _quant_dyn(h):
    """Dynamic per-tensor symmetric quantization."""
    s = torch.clamp(h.abs().amax(), min=1e-6) / 127.0
    return _quantize(h, 1.0 / s), s


def _trunk_xla_bf16(folded, h, hb):
    """BN-folded bf16 residual trunk.  h [B,7,6,C] f32, hb its bf16 copy.
    Each conv hands the next one its output as bf16: conv_a writes bf16
    only, conv_b f32 (the next residual) and bf16 (the next conv_a's
    input), the last block f32 only."""
    # conv k = 2l + i indexes the flattened [2L, ...] stacks once
    w, b = (folded[k].flatten(0, 1) for k in ("trunk_w", "trunk_b"))
    n = w.shape[0]
    profiling.count("net.boards", h.shape[0])
    with profiling.span("net.trunk"):
        for k in range(0, n, 2):
            x = h
            _, y, _ = conv3x3_bf16(hb, w[k], b[k], want_f32=False,
                                   want_bf16=True)
            h, hb, _ = conv3x3_bf16(y, w[k + 1], b[k + 1], residual=x,
                                    want_bf16=k + 2 < n)
    return h


def _count_int8_trunk(h: torch.Tensor) -> None:
    """The counters of one int8 trunk pass over h [B,7,6,C]."""
    boards = h.shape[0]
    profiling.count("net.boards", boards)
    if profiling.recording():
        wide = k1_wide(boards, h.shape[-1], h.device)
        profiling.count("net.boards_wide", boards if wide else 0)


def _trunk_launches(convs: tuple, h: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """The static-scale int8 trunk's 2 x blocks K1 launches on h [B,7,6,C]
    f32 and its int8 codes q at the first conv's scale, each conv writing
    the next one's int8 input: what a captured trunk replays."""
    n = len(convs)
    for k in range(0, n, 2):
        (wa, wsa, ba, sa, _), (wb, wsb, bb, sb, invb) = convs[k:k + 2]
        nxt = convs[k + 2][4] if k + 2 < n else None
        x = h
        _, q2, _ = conv3x3_i8(q, wa, wsa, ba, sa, inv_s_next=invb,
                              want_h=False)
        h, q, _ = conv3x3_i8(q2, wb, wsb, bb, sb, residual=x, inv_s_next=nxt)
    return h


def _trunk_xla_int8(folded, h, q=None):
    """int8 residual trunk on K1, launched conv by conv.  h [B,7,6,C] f32
    -> same.

    Static per-conv activation scales when ``act_s`` was calibrated into
    the folded dict: q is h's int8 codes at the first conv's scale (the
    stem's int8 output; quantized here when None), each conv also emits
    the next conv's int8 input, and the ``net.trunk`` span holds the conv
    launches alone.  Dynamic per-tensor scales otherwise, quantized between
    the convs inside the span.  The convs' operands are the fold's
    ``trunk_convs``.  On the card ``_trunk_out`` replays the static-scale
    trunk as one graph instead (``_trunk_replay``)."""
    convs = folded["trunk_convs"]
    n = len(convs)
    h = h.contiguous()
    _count_int8_trunk(h)
    if convs[0][3] is None:
        with profiling.span("net.trunk"):
            for k in range(0, n, 2):
                (wa, wsa, ba, _, _), (wb, wsb, bb, _, _) = convs[k:k + 2]
                x = h
                q, s = _quant_dyn(x)
                y, _, _ = conv3x3_i8(q, wa, wsa, ba, s)
                q2, s2 = _quant_dyn(y)
                h, _, _ = conv3x3_i8(q2, wb, wsb, bb, s2, residual=x)
        return h
    if q is None:
        q = _quantize(h, convs[0][4])
    with profiling.span("net.trunk"):
        return _trunk_launches(convs, h, q)


class _TrunkGraphs:
    """The captured int8 trunks of one fold (the folded dict's
    ``trunk_graphs``), by batch size, on one memory pool.  Made for the
    fold's ``trunk_convs``, whose tensors the graphs read and which it
    keeps alive."""

    __slots__ = ("convs", "pool", "by_boards")

    def __init__(self, convs: tuple):
        self.convs, self.pool, self.by_boards = convs, None, {}


class _TrunkGraph:
    """The int8 trunk of one fold at one batch size as a CUDA graph: the
    static inputs ``h0`` (f32, block 0's residual) and ``q0`` (its int8
    codes), which the stem writes, and the output ``out``, which every
    replay overwrites.  ``graph`` is None until a first pass has run
    eagerly: K1's launcher sets its function attributes and asks the
    card's cluster occupancy once, at its first launch of a shape, which a
    capture must not be."""

    __slots__ = ("graphs", "h0", "q0", "graph", "out")

    def __init__(self, graphs: _TrunkGraphs, h0: torch.Tensor,
                 q0: torch.Tensor):
        self.graphs, self.h0, self.q0 = graphs, h0, q0
        self.graph = self.out = None

    def capture(self) -> None:
        graphs = self.graphs
        with torch.cuda.device(self.h0.device):
            if graphs.pool is None:
                graphs.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            launches = kernels.CONV3X3_I8.launches
            try:
                with torch.cuda.graph(graph, pool=graphs.pool,
                                      capture_error_mode="thread_local"):
                    out = _trunk_launches(graphs.convs, self.h0, self.q0)
            finally:
                # a capture runs nothing: only replays count
                kernels.CONV3X3_I8.launches = launches
        self.graph, self.out = graph, out


def _trunk_graph(folded, boards: int, device: torch.device) -> _TrunkGraph:
    """The fold's captured trunk at ``boards`` boards, made (not yet
    captured) at its first use.  The graphs belong to the fold's
    ``trunk_convs``: a fold whose operands were made anew (a re-fold, or
    ``trunk_convs`` remade by hand) drops the graphs it was copied with
    and gets new ones."""
    convs = folded["trunk_convs"]
    graphs = folded.get("trunk_graphs")
    if graphs is None or graphs.convs is not convs:
        graphs = folded["trunk_graphs"] = _TrunkGraphs(convs)
    g = graphs.by_boards.get(boards)
    if g is None:
        shape = (boards, 7, 6, convs[0][2].shape[0])
        g = graphs.by_boards[boards] = _TrunkGraph(
            graphs, torch.empty(shape, dtype=F32, device=device),
            torch.empty(shape, dtype=I8, device=device))
    return g


def _trunk_replay(g: _TrunkGraph) -> torch.Tensor:
    """The trunk on ``g``'s inputs as written: one replay of its graph,
    whose launches count as K1's; the first time, the launches run eagerly
    and the graph is captured after them.  The ``net.trunk`` span holds
    the replay (or the eager launches) alone."""
    _count_int8_trunk(g.h0)
    with profiling.span("net.trunk"):
        if g.graph is not None:
            g.graph.replay()
            kernels.CONV3X3_I8.launches += len(g.graphs.convs)
            return g.out
        h = _trunk_launches(g.graphs.convs, g.h0, g.q0)
    g.capture()
    return h


@torch.no_grad()
def calibrate_trunk(folded: Dict[str, Any], feats: torch.Tensor,
                    margin: float = 1.25) -> Dict[str, Any]:
    """Record static per-conv activation scales (max-abs over ``feats``, a
    representative [B,7,6,F] feature batch, times ``margin``) into the
    folded dict."""
    w, b = folded["trunk_w"], folded["trunk_b"]
    h, hb, _ = _stem(folded, feats, want_bf16=True)
    scales = []
    for l in range(w.shape[0]):
        x = h
        scales.append(x.abs().amax())
        # conv_a's f32 output sets its scale; its bf16 copy feeds conv_b
        y, yb, _ = conv3x3_bf16(hb, w[l, 0], b[l, 0], want_bf16=True)
        scales.append(y.abs().amax())
        h, hb, _ = conv3x3_bf16(yb, w[l, 1], b[l, 1], residual=x,
                                want_bf16=True)
    act_max = torch.stack(scales).reshape(-1, 2)
    act_s = torch.clamp(act_max * margin, min=1e-6) / 127.0
    out = {**folded, "act_s": act_s.to(F32)}
    if "trunk_wqk" in out:
        out["trunk_convs"] = trunk_convs(out)
    return out


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


def _heads_eval_plain(folded, h, legal):
    logits, value = _heads(folded, h)
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    probs = torch.softmax(torch.where(legal, logits, neg_inf), dim=-1)
    return probs, value, logits


def heads_eval(folded: Dict[str, Any], h: torch.Tensor,
               legal: torch.Tensor):
    """The heads and the eval epilogue on the trunk output (kernel K5).

    h [B,42,C] f32, legal [B,43] bool.  Returns ``(probs [B,43], value [B],
    logits [B,43])``: ``_heads`` and ``softmax(where(legal, logits, -inf))``,
    all f32.  A row with no legal action gives NaN probabilities.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (no fallback) on the head weights that ``fold_params`` (or
    ``folded_from_jax``) packed once, ``folded["heads_pack"]``: it was
    checked where it was made, so here only its size is held against h's
    channels and the value width.
    """
    if h.device.type == "cpu":
        return _heads_eval_plain(folded, h, legal)
    pack = folded.get("heads_pack")
    if pack is None:
        raise ValueError("heads_eval: the folded dict holds no heads_pack "
                         "(fold with fold_params or folded_from_jax)")
    kernels.require_cuda(h, legal, pack)
    if h.dtype != F32 or h.dim() != 3 or h.shape[1] != BOARD \
            or h.shape[2] % 4 or legal.dtype != torch.bool \
            or legal.shape != (h.shape[0], 43):
        raise ValueError("heads_eval takes f32 h [B,42,C] with C % 4 == 0 "
                         "and bool legal [B,43]")
    b, _, c = h.shape
    v = folded["val_d1_w"].shape[1]
    if pack.numel() != heads_layout(c, v)["end"]:
        raise ValueError("heads_eval: the packed head weights do not fit h")
    if c > 512 or v > 512:
        raise ValueError("heads_eval: K5 takes at most 512 channels and 512 "
                         "value-hidden units")
    kernels.require_aligned(h, pack)
    probs = torch.empty((b, 43), dtype=F32, device=h.device)
    logits = torch.empty((b, 43), dtype=F32, device=h.device)
    value = torch.empty((b,), dtype=F32, device=h.device)
    if b:
        kernels.HEADS_EVAL.launch(h.data_ptr(), pack.data_ptr(),
                                  legal.data_ptr(), probs.data_ptr(),
                                  value.data_ptr(), logits.data_ptr(), b, c,
                                  v)
    return probs, value, logits


def _trunk_out(folded, x, int8):
    """Stem and trunk: x [B,7,6,F] -> [B,42,C] f32.

    The int8 trunk with calibrated scales takes its first input from the
    stem's int8 output.  On the card it runs as one replay of the fold's
    graph for this batch size (``_trunk_graph``), into whose inputs the
    stem writes: the result is then a view of the graph's output buffer,
    which the fold's next evaluation at this batch size overwrites.
    Callers consume it (K5) before that, or clone it."""
    if not int8:
        h, hb, _ = _stem(folded, x, want_bf16=True)
        h = _trunk_xla_bf16(folded, h, hb)
        return h.reshape(h.shape[0], BOARD, -1)
    inv = folded["trunk_convs"][0][4]
    if x.is_cuda and inv is not None:
        g = _trunk_graph(folded, x.shape[0], x.device)
        _stem(folded, x, inv_s=inv, out=g.h0, out_q=g.q0)
        h = _trunk_replay(g)
    else:
        h, _, q = _stem(folded, x, inv_s=inv)
        h = _trunk_xla_int8(folded, h, q)
    return h.reshape(h.shape[0], BOARD, -1)


@torch.no_grad()
def apply_folded(folded: Dict[str, Any], x: torch.Tensor, *,
                 int8: bool = False):
    """Forward pass on folded params.  x [B,7,6,F] -> (logits, value)."""
    h = _trunk_out(folded, x, int8)
    legal = torch.ones((h.shape[0], 43), dtype=torch.bool, device=h.device)
    _, value, logits = heads_eval(folded, h, legal)
    return logits, value


def make_fast_eval_fn(cfg: Config, *, int8: bool = False):
    """MCTS eval_fn over folded params: ``eval_fn(folded, state, legal) ->
    (probs [B,43] legal-masked softmax, value [B])``."""

    @torch.no_grad()
    def eval_fn(folded, state, legal):
        with profiling.span("net.eval"):
            h = _trunk_out(folded, featurize(state, cfg), int8)
            probs, value, _ = heads_eval(folded, h, legal)
        return probs, value

    return eval_fn


def make_fast_paired_eval_fn(cfg: Config, *, int8: bool = False):
    """Two-model eval_fn over folded params for gating arenas:
    ``eval_fn(folded_a, folded_b, use_a, state, legal)`` scores each game's
    leaf with the root mover's own network.  The heads run once per net and
    the rows are selected afterwards, which equals selecting the logits
    first: the softmax is row-wise."""

    @torch.no_grad()
    def eval_fn(folded_a, folded_b, use_a, state, legal):
        with profiling.span("net.eval"):
            feats = featurize(state, cfg)
            pa, va, _ = heads_eval(folded_a,
                                   _trunk_out(folded_a, feats, int8), legal)
            pb, vb, _ = heads_eval(folded_b,
                                   _trunk_out(folded_b, feats, int8), legal)
            return (torch.where(use_a[:, None], pa, pb),
                    torch.where(use_a, va, vb))

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
