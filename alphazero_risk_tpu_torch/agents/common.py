"""Shared agent utilities and the explicit randomness discipline.

Port of ``alphazero_risk_tpu/agents/common.py``.  Every agent micro-step
consumes at most ``u[B, 4]`` uniforms (masked choices / coins / amounts /
card draw) and ``dice[B, 5]`` (battle resolution).  Feeding the same
tensors to the JAX agents and to these makes their trajectories
bit-identical.

Slot convention: u[0] primary choice, u[1] secondary (attack-from /
fortify-from), u[2] amount or coin, u[3] card draw (full-cards mode).
"""

from __future__ import annotations

import torch

from ..env.rules import first_set_bit, masked_choice  # noqa: F401

U_PER_STEP = 4
DICE_PER_STEP = 5


def draw_step_randoms(generator: torch.Generator, batch_size: int, device):
    """(u[B,4] float32 in [0,1), dice[B,5] int32 in [1,6]) for one step."""
    gdev = generator.device
    u = torch.rand((batch_size, U_PER_STEP), generator=generator,
                   device=gdev)
    dice = torch.randint(1, 7, (batch_size, DICE_PER_STEP),
                         generator=generator, device=gdev,
                         dtype=torch.int32)
    return u.to(device), dice.to(device)
