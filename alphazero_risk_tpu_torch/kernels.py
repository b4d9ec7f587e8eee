"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C entry point.  It is
compiled by ``nvcc`` for ``sm_90a`` (Hopper) into its own shared library at
first use, loaded with ``ctypes``, and launched on PyTorch's current stream.
Nothing is built or loaded when this module is imported.

Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.

Every ``Kernel`` counts its launches in ``launches``, a plain integer that
grows by one where the kernel is launched and nowhere else.  The C entry
point returns ``cudaGetLastError()`` and a nonzero code raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [P]   # + the stream
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}_{h}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source unless its library exists."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(tmp, self.library)

    def _load(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise on a CUDA error."""
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"kernel {self.name}: CUDA error {err}")
        self.launches += 1


CONV3X3_I8 = Kernel(
    "conv3x3_i8", "conv_i8.cu", "az_conv3x3_i8",
    [P, P, P, P, P, P, P, P, P, P, I, I])

MCTS_DESCEND = Kernel(
    "mcts_descend", "mcts_descend.cu", "az_mcts_descend",
    [P] * 14 + [F, F, F, I, I, I] + [P] * 8)

MCTS_BACKUP = Kernel(
    "mcts_backup", "mcts_backup.cu", "az_mcts_backup",
    [P] * 8 + [I, I, I])

ALL = (CONV3X3_I8, MCTS_DESCEND, MCTS_BACKUP)


def build_all() -> None:
    """Build every kernel, one ``nvcc`` per source, all started together,
    and load them."""
    procs = [(k, k.start_build()) for k in ALL]
    for k, proc in procs:
        k.finish_build(proc)
    for k in ALL:
        k._load()


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in ALL}


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the same CUDA device and is
    contiguous (what the kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError("kernel inputs must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
