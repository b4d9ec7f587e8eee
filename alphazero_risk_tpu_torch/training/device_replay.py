"""Device-resident replay ring: self-play samples never leave the card.

Port of ``alphazero_risk_tpu/training/device_replay.py``.  The host
``ReplayBuffer`` (replay.py) costs two transfers per iteration: the actor's
records come down to the host, and ``train_epochs`` uploads the buffer
again.  This class keeps the loop on the device:

  * storage: one ``[cap, ...]`` tensor per field of ``replay.FIELDS``
    (``cap = cfg.samples_storage_max``), a physical ring addressed by the
    host-side pointers ``start`` and ``size``;
  * ingest: value backfill, then the compaction of the valid rows (the
    k-th valid row goes to logical slot ``size + k``), then one wrapped
    ``index_copy_`` per field.  Rows past capacity are dropped, never
    clamped or wrapped onto newer ones: an ingest of more valid rows than
    ``cap`` keeps the newest ``cap``;
  * retention: the reference's MIN/MAX and ``old_game_index`` trim
    (alphazero_nn_data.cpp:67-84) as pointer arithmetic on the host;
  * epochs: ``learner.make_ring_epoch_fn`` samples the valid window in
    place (``Trainer.train_epochs`` dispatches on the buffer's type);
  * persistence: the npz format of the host buffer (``FORMAT_VERSION``),
    so either buffer of either package loads the other's file.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from .replay import FIELDS, FORMAT_VERSION


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.zeros((0,), dt)).dtype


class DeviceReplay:
    """Drop-in for ``ReplayBuffer`` with storage on ``device``."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cap = cfg.samples_storage_max
        self.data: Dict[str, torch.Tensor] = {
            k: torch.zeros((self.cap,) + shape, dtype=_torch_dtype(dt),
                           device=self.device)
            for k, (dt, shape) in FIELDS.items()}
        self.start = 0
        self.size = 0
        self.old_game_index = 0
        # the ring applies the MAX rule at write time; the host buffer
        # applies it in trim(), and trim() applies at most one rule per call
        # (reference trimOldExamples): a write-time overflow makes the next
        # trim() skip the old-game rule, as the host's would
        self._overflowed = False

    def __len__(self) -> int:
        return self.size

    def _advance(self, n: int) -> None:
        """Pointers after ``n`` rows were written at the logical end."""
        overflow = max(self.size + n - self.cap, 0)
        self.start = (self.start + overflow) % self.cap
        self.size = min(self.size + n, self.cap)
        self.old_game_index = max(self.old_game_index - overflow, 0)
        self._overflowed |= overflow > 0

    # ---- ingest ----
    def extend_from_actor(self, samples, status, final_round=None) -> int:
        """Append a stacked [T, B, ...] ``SampleBatch`` (tensors on the
        ring's device) after value backfill; drops invalid records.  One
        host sync: the count of valid rows."""
        from .actor import backfill_values

        filled = backfill_values(
            samples, status, final_round=final_round,
            round_weighted=self.cfg.round_weighted_value)
        rows = torch.nonzero(filled.valid.reshape(-1)).squeeze(1)
        added = int(rows.numel())
        # only the newest ``cap`` valid rows can land; the j-th valid row
        # goes to logical slot size + j
        first = max(added - self.cap, 0)
        rows = rows[first:]
        slots = torch.arange(first, added, device=rows.device)
        idx = (self.start + self.size + slots) % self.cap
        for k, dst in self.data.items():
            v = getattr(filled, k)
            v = v.reshape((-1,) + tuple(v.shape[2:]))
            dst.index_copy_(0, idx, v[rows].to(dst.dtype))
        self._advance(added)
        return added

    def extend(self, samples: Dict[str, np.ndarray]) -> int:
        """Append flat [N, ...] already-backfilled host arrays (one upload;
        the bulk path is ``extend_from_actor``)."""
        n = int(np.asarray(samples["value"]).shape[0])
        if n == 0:
            return 0
        assert n <= self.cap, (n, self.cap)
        idx = torch.from_numpy(
            (self.start + self.size + np.arange(n)) % self.cap).to(
                self.device)
        for k, dst in self.data.items():
            src = np.asarray(samples[k]).astype(FIELDS[k][0])
            dst.index_copy_(0, idx, torch.from_numpy(src).to(self.device))
        self._advance(n)
        return n

    # ---- retention (reference trimOldExamples) ----
    def mark_old_games(self) -> None:
        self.old_game_index = max(self.size - 1, 0)

    def trim(self) -> int:
        cfg = self.cfg
        n = self.size
        dropped = 0
        if self._overflowed:
            # the MAX rule already fired at write time this iteration
            self._overflowed = False
        elif n > cfg.samples_storage_min and self.old_game_index > 0:
            dropped = min(self.old_game_index, n - cfg.samples_storage_min)
        if dropped > 0:
            self.start = (self.start + dropped) % self.cap
            self.size -= dropped
            self.old_game_index = max(self.old_game_index - dropped, 0)
        return dropped

    # ---- learner access ----
    def epoch_view(self):
        """``(data, start, size)`` for ``make_ring_epoch_fn``."""
        return self.data, self.start, self.size

    def sample_arrays(self, max_samples: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
        """The newest ``max_samples`` rows in logical order, as numpy
        arrays (one gather on the device, one download)."""
        n = self.size if max_samples is None else min(max_samples,
                                                      self.size)
        idx = torch.from_numpy(
            (self.start + self.size - n + np.arange(n)) % self.cap).to(
                self.device)
        return {k: v[idx].cpu().numpy() for k, v in self.data.items()}

    # ---- persistence: the host buffer's npz format ----
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path, __version__=FORMAT_VERSION,
            old_game_index=self.old_game_index, **self.sample_arrays())

    def load(self, path: str) -> bool:
        """Read a buffer file into the ring: its newest ``cap`` rows go to
        slots ``[0, keep)``, the other slots are zeroed on the device."""
        if not os.path.exists(path):
            return False
        with np.load(path) as z:
            assert int(z["__version__"]) == FORMAT_VERSION
            old = int(z["old_game_index"])
            arrays = {k: z[k] for k in FIELDS}
        n = arrays["value"].shape[0]
        keep = min(n, self.cap)
        for k, dst in self.data.items():
            dst.zero_()
            src = arrays[k][n - keep:].astype(FIELDS[k][0])
            dst[:keep].copy_(torch.from_numpy(src))
        self.start = 0
        self.size = keep
        self.old_game_index = max(old - (n - keep), 0)
        return True
