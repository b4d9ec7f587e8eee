"""Work counts from shapes, and the card's published peaks.

The counts are the operations and bytes the algorithm needs, computed from
the configuration's widths; no reading of the program enters them.  A
multiply-add counts as two operations.
"""

from __future__ import annotations

BOARD = 42          # 7 x 6 positions
ACTIONS = 43

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).
PEAK = {
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
    "hbm_bytes": 3.35e12,
}


def trunk_flops(cfg: dict) -> int:
    """The residual trunk of one board: 2 convs a block, each 42 positions
    x 9 taps x C x C multiply-adds."""
    c = cfg["filters"]
    return 2 * cfg["blocks"] * 2 * BOARD * 9 * c * c


def stem_flops(cfg: dict) -> int:
    return 2 * BOARD * 9 * num_features(cfg) * cfg["filters"]


def heads_flops(cfg: dict) -> int:
    c, v = cfg["filters"], cfg["value_hidden"]
    policy = 2 * BOARD * c * 2 + 2 * (2 * BOARD) * ACTIONS
    value = 2 * BOARD * c + 2 * BOARD * v + 2 * v
    return policy + value


def forward_flops(cfg: dict) -> int:
    """One board through the whole network."""
    return trunk_flops(cfg) + stem_flops(cfg) + heads_flops(cfg)


def num_features(cfg: dict) -> int:
    return {1: 12, 2: 13, 3: 14}[cfg["feature_version"]]


def eval_bytes(cfg: dict) -> int:
    """The bytes of one board's evaluation outside the trunk and stem: the
    game state read for the features (12 int32/bool fields, 380 bytes),
    the float32 feature image written, the float32 trunk output read by the
    heads, and the probabilities and value written."""
    state = 380
    features = BOARD * num_features(cfg) * 4
    trunk_out = BOARD * cfg["filters"] * 4
    out = (ACTIONS + 1) * 4
    return state + features + trunk_out + out


def eval_least_seconds(cfg: dict, boards: int) -> float:
    """The least time of ``boards`` evaluations on one card: the trunk at
    the int8 peak, the stem at the bf16 peak, the rest at the memory's
    bandwidth."""
    return boards * (trunk_flops(cfg) / PEAK["int8_ops"]
                     + (stem_flops(cfg) + heads_flops(cfg))
                     / PEAK["bf16_flops"]
                     + eval_bytes(cfg) / PEAK["hbm_bytes"])

