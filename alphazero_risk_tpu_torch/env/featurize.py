"""State -> network-input featurization.

Port of ``alphazero_risk_tpu/env/featurize.py``.  Output is ``[B, 7, 6, F]``
float32 (NHWC, as in the JAX package) where land ``l`` maps to grid cell
``(l // 6, l % 6)``.

Feature layout (INPUT_VECTOR_TYPE_2 default, alphazero_nn_data.h:13-64):
  0  own army / 32          (on owned cells)
  1  enemy army / 32
  2  neutral army / 32
  3  army share             (broadcast; V2+)
  4  reinforcement share    (broadcast)
  5  attacks this turn / 8  (broadcast, clamped)
  6  can draw card          (broadcast)
  7..12  phase one-hot      (broadcast)
V3 inserts round/58 at plane 3 (shifting the rest), V1 drops army share.

On the card ``featurize`` is the features output of kernel K8
(``rules.state_views``); CPU tensors take ``_featurize_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config, MAP_X, MAP_Y, NUM_LANDS, NUM_PHASES
from . import rules
from .rules import calc_reinforcement
from .state import GameState


def featurize(state: GameState, cfg: Config) -> torch.Tensor:
    """[B, 7, 6, F] float32 network input of ``state``."""
    if state.device.type == "cpu":
        return _featurize_plain(state, cfg)
    return rules.state_views(state, cfg, features=True)[0]


def _featurize_plain(state: GameState, cfg: Config) -> torch.Tensor:
    b = state.batch_size
    p = state.cur_player[:, None]
    own = state.owner == p
    enemy = state.owner == (1 - p)
    neutral = ~own & ~enemy
    army = state.army.to(torch.float32) / cfg.land_army_max
    zero = torch.zeros((), dtype=torch.float32, device=state.device)

    planes = [torch.where(own, army, zero),
              torch.where(enemy, army, zero),
              torch.where(neutral, army, zero)]

    ref = calc_reinforcement(own).to(torch.float32)
    eref = calc_reinforcement(enemy).to(torch.float32)
    reinforcement_share = ref / (ref + eref)
    attack_freq = torch.clamp(
        state.attacks_during_turn.to(torch.float32) / 8.0, max=1.0)
    can_draw = state.can_draw_card.to(torch.float32)

    ta = (state.army * own).sum(-1).to(torch.float32)
    eta = (state.army * enemy).sum(-1).to(torch.float32)
    army_share = ta / (ta + eta)

    scalars = []
    if cfg.feature_version == 3:
        scalars.append(state.round.to(torch.float32) / cfg.max_game_rounds)
    if cfg.feature_version >= 2:
        scalars.append(army_share)
    scalars += [reinforcement_share, attack_freq, can_draw]

    phase_onehot = F.one_hot(state.phase.long(), NUM_PHASES).to(
        torch.float32)
    land_planes = torch.stack(planes, dim=-1)          # [B, 42, 3]
    scalar_planes = torch.stack(scalars, dim=-1)       # [B, S]
    flat = torch.cat([
        land_planes,
        scalar_planes[:, None, :].expand(b, NUM_LANDS, scalar_planes.shape[-1]),
        phase_onehot[:, None, :].expand(b, NUM_LANDS, NUM_PHASES),
    ], dim=-1)                                         # [B, 42, F]
    return flat.reshape(b, MAP_Y, MAP_X, flat.shape[-1])
