"""Host-side replay buffer with the reference's retention semantics.

Port of ``alphazero_risk_tpu/training/replay.py``: numpy storage, the same
``FIELDS`` and the same versioned npz file, so a buffer saved by either
package loads in the other.

Mirrors ``NNTrainDataStorage`` (alphazero_nn_data.{h,cpp}): a flat sample
store with MIN/MAX trim (keep >= min samples, cap at max, preferentially
drop pre-improvement samples via ``old_game_index``), and binary
persistence.  Samples are stored compactly (state snapshot, not expanded
features) and batches are assembled on demand.

The file format is a straightforward npz (versioned) rather than the
reference's raw-struct dump.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..config import Config, NUM_ACTIONS, NUM_LANDS

FIELDS = dict(
    owner=(np.int8, (NUM_LANDS,)),
    army=(np.int8, (NUM_LANDS,)),
    cur_player=(np.int8, ()),
    phase=(np.int8, ()),
    round=(np.int16, ()),
    reinforcements=(np.int16, ()),
    attacks_during_turn=(np.int16, ()),
    can_draw_card=(np.bool_, ()),
    policy=(np.float16, (NUM_ACTIONS,)),
    value=(np.float32, ()),
)

FORMAT_VERSION = 1


class ReplayBuffer:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.data: Dict[str, np.ndarray] = {
            k: np.zeros((0,) + shape, dt) for k, (dt, shape) in
            FIELDS.items()}
        self.old_game_index = 0

    def __len__(self) -> int:
        return self.data["value"].shape[0]

    def extend(self, samples: Dict[str, np.ndarray]) -> int:
        """Append flat [N, ...] sample arrays (already value-backfilled and
        filtered to valid records)."""
        n = samples["value"].shape[0]
        if n == 0:
            return 0
        for k in self.data:
            arr = np.asarray(samples[k]).astype(self.data[k].dtype)
            self.data[k] = np.concatenate([self.data[k], arr])
        return n

    def extend_from_actor(self, samples, status, final_round=None) -> int:
        """Append an actor's stacked [T, B, ...] SampleBatch (tensors on
        any device) after value backfill; drops invalid records."""
        from .actor import backfill_values

        filled = backfill_values(
            samples, status, final_round=final_round,
            round_weighted=self.cfg.round_weighted_value)
        valid = filled.valid.reshape(-1)
        flat = {}
        for k in self.data:
            v = getattr(filled, k)
            flat[k] = v.reshape((-1,) + tuple(v.shape[2:]))[valid] \
                .cpu().numpy()
        return self.extend(flat)

    def mark_old_games(self) -> None:
        """Reference ``updateOldGamesIndex`` (alphazero_nn_data.cpp:160-163):
        samples before this point become preferentially evictable."""
        self.old_game_index = max(len(self) - 1, 0)

    def trim(self) -> int:
        """Reference ``trimOldExamples`` (alphazero_nn_data.cpp:67-84)."""
        n = len(self)
        dropped = 0
        if n > self.cfg.samples_storage_max:
            dropped = n - self.cfg.samples_storage_max
        elif n > self.cfg.samples_storage_min and self.old_game_index > 0:
            dropped = min(self.old_game_index,
                          n - self.cfg.samples_storage_min)
        if dropped > 0:
            for k in self.data:
                self.data[k] = self.data[k][dropped:]
            self.old_game_index = max(self.old_game_index - dropped, 0)
        return dropped

    def sample_arrays(self, max_samples: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
        """Most recent ``max_samples`` as flat arrays for the learner."""
        if max_samples is None or len(self) <= max_samples:
            return dict(self.data)
        return {k: v[-max_samples:] for k, v in self.data.items()}

    # ---- persistence (reference save/loadTrainingSamples,
    # alphazero_nn_data.cpp:86-138) ----
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path, __version__=FORMAT_VERSION,
            old_game_index=self.old_game_index, **self.data)

    def load(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        with np.load(path) as z:
            assert int(z["__version__"]) == FORMAT_VERSION
            self.old_game_index = int(z["old_game_index"])
            # astype: schema-compatible load of archives written before a
            # field narrowed (e.g. float32 policy -> float16)
            self.data = {k: z[k].astype(FIELDS[k][0]) for k in FIELDS}
        return True
