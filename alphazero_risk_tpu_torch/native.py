"""ctypes binding to the native riskcore engine (``native/libriskcore.so``).

The third implementation of the rules, beside the port's batched engine
(``env/rules.py``) and its scalar oracle (``env/oracle.py``): a C++ engine
for host-side match generation (Script and Random games) and for
cross-checking the other two.  ``-m play --p1 sp|rp --cpu`` uses it when it
loads.

The port's own binding, with the same structs, ABI check and calls as
``alphazero_risk_tpu/native.py``.  The library is not tracked in git: when
it is missing, ``load_library`` builds it with ``native/Makefile`` (about
two seconds with g++).  The build runs in a directory of its own under
``build/`` and the library is then moved into ``native/`` in one rename, so
a process that finds the file never loads a half-written one.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .config import Config, NUM_LANDS

ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = ROOT / "native"
LIBRARY = NATIVE_DIR / "libriskcore.so"


class CRiskState(ctypes.Structure):
    _fields_ = [
        ("owner", ctypes.c_int8 * NUM_LANDS),
        ("army", ctypes.c_int8 * NUM_LANDS),
        ("phase", ctypes.c_int8),
        ("round", ctypes.c_int16),
        ("cur_player", ctypes.c_int8),
        ("reinforcements", ctypes.c_int16),
        ("cards", ctypes.c_int16 * 2),
        ("card_sets_played", ctypes.c_int16),
        ("mob_from", ctypes.c_int8),
        ("mob_to", ctypes.c_int8),
        ("can_draw_card", ctypes.c_int8),
        ("attacks_during_turn", ctypes.c_int16),
    ]


class CRiskConfig(ctypes.Structure):
    _fields_ = [
        ("land_army_max", ctypes.c_int),
        ("min_unit_move", ctypes.c_int),
        ("max_game_rounds", ctypes.c_int),
        ("allow_yield", ctypes.c_int),
        ("limit_reinforcement", ctypes.c_int),
        ("limit_attack", ctypes.c_int),
        ("fast_mobilization", ctypes.c_int),
    ]


def _c_config(cfg: Config) -> CRiskConfig:
    return CRiskConfig(
        land_army_max=cfg.land_army_max,
        min_unit_move=cfg.min_unit_move,
        max_game_rounds=cfg.max_game_rounds,
        allow_yield=int(cfg.allow_yield),
        limit_reinforcement=int(cfg.limit_reinforcement_moves),
        limit_attack=int(cfg.limit_attack_moves),
        fast_mobilization=int(cfg.fast_attack_mobilization),
    )


def _build() -> None:
    """Build the library with ``native/Makefile`` in ``build/native-<pid>``
    and move it into ``native/``; one build at a time.  A failed build
    warns on stderr (the caller then has no engine)."""
    work = ROOT / "build" / f"native-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    with open(ROOT / "build" / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if LIBRARY.exists():
                return
            for name in ("Makefile", "riskcore.cpp"):
                shutil.copy(NATIVE_DIR / name, work / name)
            proc = subprocess.run(["make", "-C", str(work)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tail = "\n".join(
                    (proc.stderr or "").strip().splitlines()[-5:])
                print("WARNING: libriskcore.so build failed "
                      f"(rc={proc.returncode}); native engine "
                      f"unavailable:\n{tail}", file=sys.stderr)
                return
            os.replace(work / "libriskcore.so", LIBRARY)
        finally:
            shutil.rmtree(work, ignore_errors=True)


def load_library() -> Optional[ctypes.CDLL]:
    """Load ``native/libriskcore.so``, building it first when it is
    missing; None when it cannot be built."""
    if not LIBRARY.exists() and (NATIVE_DIR / "Makefile").exists():
        _build()
    if not LIBRARY.exists():
        return None
    lib = ctypes.CDLL(str(LIBRARY))
    lib.risk_game_status.restype = ctypes.c_int
    lib.risk_game_status.argtypes = [ctypes.POINTER(CRiskState),
                                     ctypes.POINTER(CRiskConfig)]
    lib.risk_new_game.argtypes = [ctypes.POINTER(CRiskState),
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.risk_legal_actions.argtypes = [
        ctypes.POINTER(CRiskState), ctypes.POINTER(CRiskConfig),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.risk_step.argtypes = [
        ctypes.POINTER(CRiskState), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(CRiskConfig)]
    lib.risk_play_games.restype = ctypes.c_long
    lib.risk_play_games.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(CRiskConfig), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.risk_state_size.restype = ctypes.c_int
    if lib.risk_state_size() != ctypes.sizeof(CRiskState):
        raise RuntimeError("ABI mismatch between libriskcore and native.py")
    return lib


class NativeEngine:
    """Scalar engine handle over the C library."""

    def __init__(self, cfg: Config):
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError(
                "libriskcore.so not built; run `make -C native`")
        self.cfg = cfg
        self.ccfg = _c_config(cfg)

    def new_game(self, permutation: np.ndarray) -> CRiskState:
        s = CRiskState()
        perm = np.ascontiguousarray(permutation, np.int32)
        self.lib.risk_new_game(
            ctypes.byref(s),
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return s

    def legal_actions(self, s: CRiskState) -> np.ndarray:
        mask = np.zeros(43, np.uint8)
        self.lib.risk_legal_actions(
            ctypes.byref(s), ctypes.byref(self.ccfg),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return mask.astype(bool)

    def step(self, s: CRiskState, action: int, dice: np.ndarray) -> None:
        d = np.ascontiguousarray(dice, np.int32)
        self.lib.risk_step(
            ctypes.byref(s), int(action),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(self.ccfg))

    def status(self, s: CRiskState) -> int:
        return self.lib.risk_game_status(ctypes.byref(s),
                                         ctypes.byref(self.ccfg))

    def play_games(self, agent0: str, agent1: str, n_games: int,
                   seed: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Native Script/Random matches (agent in {'sp', 'rp'}).  Returns
        (statuses[n], rounds[n], total_micro_steps)."""
        kind = {"sp": 0, "rp": 1}
        results = np.zeros(n_games, np.int32)
        rounds = np.zeros(n_games, np.int32)
        steps = self.lib.risk_play_games(
            kind[agent0], kind[agent1], n_games, seed,
            ctypes.byref(self.ccfg),
            results.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return results, rounds, int(steps)


def available() -> bool:
    return load_library() is not None
