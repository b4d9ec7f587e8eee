"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C entry point.  It is
compiled by ``nvcc`` for ``sm_90a`` (Hopper) into its own shared library at
first use, loaded with ``ctypes``, and launched on PyTorch's current stream.
Nothing is built or loaded when this module is imported.

Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the source, the headers it includes and
the flags, so an edited source is rebuilt and a stale library is never
loaded.

The common flags include ``--fmad=false``: kernels whose float results are
held bit for bit against a plain PyTorch version must round every product
and sum separately, as PyTorch does.  A kernel without that need
(``fmad=True``) is built with the compiler's default contraction; its
flags, and so its library name, differ from the others'.

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

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 fmad: bool = False, headers: tuple = ()):
        self.name = name
        self.flags = [f for f in NVCC_FLAGS
                      if not (fmad and f == "--fmad=false")]
        self.source = CSRC / source
        self.headers = tuple(CSRC / h for h in headers)
        self.symbol = symbol
        self.argtypes = list(argtypes) + [P]   # + the stream
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def library(self) -> Path:
        text = b"".join(p.read_bytes() for p in (self.source, *self.headers))
        h = hashlib.sha256(text + " ".join(self.flags).encode()
                           ).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}_{h}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source unless its library exists."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [nvcc_path(), *self.flags, "-o", str(tmp), str(self.source)],
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

    def query(self, symbol: str, *args: int) -> int:
        """Call the library's int function ``symbol`` on int arguments: a
        question about a launch (no launch, no count)."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes, fn.restype = [I] * len(args), ctypes.c_int
        return fn(*args)

    def launch(self, *args) -> None:
        """Launch on the current stream; raise on a CUDA error."""
        fn = self._load()
        # the handle torch.cuda.current_stream().cuda_stream gives, without
        # building a Stream object on every launch
        stream = torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device())
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"kernel {self.name}: CUDA error {err}")
        self.launches += 1


# The tensor-core convs K1 and K4 share csrc/conv_tc.cuh.
CONV_TC = ("conv_tc.cuh",)

# q, packed w, ws, bias, s, residual, 1/s_next, h, q_next, acc, M, C; its
# wide design for batches that fill the card has a header of its own
CONV3X3_I8 = Kernel(
    "conv3x3_i8", "conv_i8.cu", "az_conv3x3_i8",
    [P] * 10 + [I, I], headers=CONV_TC + ("conv_i8_wide.cuh",))

# root, 10 tree and node-state arrays, gumbel, logp, nrank (int8);
# c_keep, c_add, cpuct, B, N, D; the paths and ends output buffers
MCTS_DESCEND = Kernel(
    "mcts_descend", "mcts_descend.cu", "az_mcts_descend",
    [P] * 14 + [F, F, F, I, I, I, P, P])

# the tree's pointer pack (mcts.search._k6_pack), paths [3, B, D], depth,
# leaf_v and leaf_p (null: the pack's); B, N, D
MCTS_BACKUP = Kernel(
    "mcts_backup", "mcts_backup.cu", "az_mcts_backup",
    [P] * 5 + [I, I, I])

# x, w, bias, residual, 1/s of the int8 output, out f32, out bf16, out
# int8, M, Cin, Cout, x is bf16
CONV3X3_BF16 = Kernel(
    "conv3x3_bf16", "conv_bf16.cu", "az_conv3x3_bf16",
    [P] * 8 + [I] * 4, fmad=True, headers=CONV_TC)

# h, the packed head weights, legal, probs, value, logits, B, C, V
HEADS_EVAL = Kernel(
    "heads_eval", "heads_softmax.cu", "az_heads_eval",
    [P] * 6 + [I, I, I], fmad=True)

# the tree's pointer pack (mcts.search._k6_pack), 14 source state fields,
# status, value, legal, prior, exp_n, exp_a, exp_o, cur, B, N, root_mode
TREE_WRITE = Kernel(
    "write_nodes", "tree_write.cu", "az_write_nodes",
    [P] * 23 + [I, I, I])

# The rules kernels, one warp per game, share csrc/rules_dev.cuh and
# csrc/rules_warp.cuh.  The trailing ints of each: B, land_army_max,
# min_unit_move, max_game_rounds, flags (rules.kernel_flags), and for K8
# the feature version.
RULES_WARP = ("rules_dev.cuh", "rules_warp.cuh")

# 12 state fields and player/drawn cards in, node, N, action, dice,
# outcome, u_card, 12 state fields and player/drawn cards out, status,
# legal, tables
RULES_STEP = Kernel(
    "rules_step", "rules_step.cu", "az_rules_step",
    [P] * 15 + [I] + [P] * 21 + [I] * 5, headers=RULES_WARP)

# 9 state fields, tables, legal, status, features
STATE_VIEWS = Kernel(
    "state_views", "state_views.cu", "az_state_views",
    [P] * 13 + [I] * 5, headers=RULES_WARP)

# The card masks of K9, K10 and the multi-step entry (player_cards,
# drawn_cards, in and out) are null pointers under simple cards.

# 12 state fields, 3 carry fields, reset, u, dice, 2 card masks in; 12
# state fields, 3 carry fields, action, record, 2 card masks out; tables
SCRIPT_STEP = Kernel(
    "script_step", "script_step.cu", "az_script_step",
    [P] * 40 + [I] * 5, headers=RULES_WARP)

# 12 state fields, u, dice, 2 card masks in; 12 state fields, action,
# record, 2 card masks out; tables
RANDOM_STEP = Kernel(
    "random_step", "random_step.cu", "az_random_step",
    [P] * 33 + [I] * 5, headers=RULES_WARP)

# K9's and K10's multi-step entry: 12 state fields, 3 carry fields, prev,
# u [k, B, 4], dice [k, B, 5], 2 card masks in, k, the seats' kinds (two
# bits a seat); 12 state fields, 3 carry fields, prev, the step counts, 2
# card masks out; tables
AGENT_STEPS = Kernel(
    "agent_steps", "agent_steps.cu", "az_agent_steps",
    [P] * 20 + [I] * 2 + [P] * 20 + [I] * 5, headers=RULES_WARP)

ALL = (CONV3X3_I8, MCTS_DESCEND, MCTS_BACKUP, CONV3X3_BF16, HEADS_EVAL,
       TREE_WRITE, RULES_STEP, STATE_VIEWS, SCRIPT_STEP, RANDOM_STEP,
       AGENT_STEPS)


def build_all() -> None:
    """Build every library, one ``nvcc`` per source, all started together,
    and load every kernel."""
    procs = [(k, k.start_build()) for k in ALL]
    for k, proc in procs:
        k.finish_build(proc)
        k._load()


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in ALL}


def require_aligned(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (what the
    kernels' 16-byte asynchronous copies read from)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel inputs must start on a 16-byte boundary")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the same CUDA device and is
    contiguous (what the kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError("kernel inputs must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
