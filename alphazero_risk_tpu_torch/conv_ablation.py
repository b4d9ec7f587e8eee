"""Where the time of the tensor-core convs K1 and K4 goes.

    python -m alphazero_risk_tpu_torch.conv_ablation

Builds K1 (``csrc/conv_i8.cu``) and K4 (``csrc/conv_bf16.cu``) once per
variant with ``-DAZ_CONV_ABLATE=<mask>``, which leaves parts of their
shared main loop out (``csrc/conv_tc.cuh``: the weight copies, the halo
plane copies, the ldmatrix of A, the wgmmas, the per-step barrier, the
proxy fence), and once per other split of the large block shape
(``-DAZ_CONV_LARGE_WG``, ``-DAZ_CONV_LARGE_MT``), and times each build
back to back with CUDA events, in the conv_a form (bf16 or int8 out only)
at C=256 and B=1,024 and 64.  A build with parts left out computes wrong
results: its time only says what the parts cost.  K1 at B=1,024 takes
its wide design (``csrc/conv_i8_wide.cuh``), which none of these builds
changes: its line there times that design as it is.  Needs a CUDA card
and ``nvcc``.
"""

from __future__ import annotations

import copy
import sys

import torch

from . import kernels
from .models import fast_infer as FI

# the parts of csrc/conv_tc.cuh's enum Part
WEIGHT_COPY, PLANE_COPY, LDMATRIX, WGMMA, BARRIER, FENCE = 1, 2, 4, 8, 16, 32
VARIANTS = {"base": 0, "no_fence": FENCE, "no_bar": BARRIER,
            "no_bload": WEIGHT_COPY, "no_aload": PLANE_COPY,
            "no_loads": WEIGHT_COPY | PLANE_COPY, "no_mma": WGMMA,
            "no_ldsm": LDMATRIX,
            "only_mma": WEIGHT_COPY | PLANE_COPY | LDMATRIX | BARRIER | FENCE}
# another large shape, warpgroups x 64-row tiles each, every part run:
# 512 rows (12 boards, one block per SM) against the default 2 x 2 (256
# rows, two blocks per SM)
SHAPES = {"large_4x2": (4, 2)}


def variant(k: kernels.Kernel, mask: int = 0,
            shape: tuple[int, int] | None = None) -> kernels.Kernel:
    """``k`` built with the parts in ``mask`` left out, or with another
    large shape (its own library: the flags are part of the library's
    name)."""
    v = copy.copy(k)
    v.flags = k.flags + [f"-DAZ_CONV_ABLATE={mask}"]
    if shape is not None:
        v.flags += [f"-DAZ_CONV_LARGE_WG={shape[0]}",
                    f"-DAZ_CONV_LARGE_MT={shape[1]}"]
    v.launches, v.build_log, v._fn = 0, "", None
    return v


def _us(call, reps: int = 50) -> float:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    convs = (kernels.CONV3X3_BF16, kernels.CONV3X3_I8)
    builds = {(v, k.name): variant(k, mask) for v, mask in VARIANTS.items()
              for k in convs}
    builds.update({(v, k.name): variant(k, shape=shape)
                   for v, shape in SHAPES.items() for k in convs})
    procs = [(k, k.start_build()) for k in builds.values()]
    for k, p in procs:              # one nvcc per build, all started together
        k.finish_build(p)
    for k in convs:                 # ptxas on the default build
        for line in builds[("base", k.name)].build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma")):
                print(k.name, line.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    c = 256
    P = kernels.ptr
    print(torch.cuda.get_device_name(0))
    for b in (1024, 64):
        x = torch.randn((b, 7, 6, c), generator=g, device=dev).bfloat16()
        w = (torch.randn((3, 3, c, c), generator=g, device=dev) / 48
             ).bfloat16()
        bias = torch.randn(c, generator=g, device=dev)
        xo = torch.empty_like(x)
        q = torch.randint(-127, 128, (b, 7, 6, c), generator=g, device=dev,
                          dtype=torch.int8)
        wk = torch.randint(-127, 128, (3, 3, c, c), generator=g, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(c, generator=g, device=dev) / 127
        s = torch.tensor(0.01, device=dev)
        inv = torch.tensor(0.3, device=dev)
        qo = torch.empty_like(q)
        per, blocks = FI.conv_tile(kernels.CONV3X3_BF16, b, c)
        k1 = "K1 wide" if FI.k1_wide(b, c, dev) else "K1 conv_a"
        stream = torch.cuda.current_stream().cuda_stream
        for v in [*VARIANTS, *SHAPES]:
            # the C entry points themselves, with no Python wrapper around
            # them: at B=64 the wrapper's call would set the pace
            f4 = builds[(v, "conv3x3_bf16")]._load()
            f1 = builds[(v, "conv3x3_i8")]._load()
            t4 = _us(lambda: f4(P(x), P(w), P(bias), None, None, None,
                                P(xo), None, b * 42, c, c, 1, stream))
            t1 = _us(lambda: f1(P(q), P(wk), P(ws), P(bias), P(s), None,
                                P(inv), None, P(qo), None, b * 42, c,
                                stream))
            print(f"B={b} {blocks} blocks of {per} boards {v:9s} K4 conv_a "
                  f"{t4:8.2f} us  {k1} {t1:8.2f} us", flush=True)


if __name__ == "__main__":
    main()
