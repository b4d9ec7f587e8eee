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


class BlockDraws:
    """``draw_step_randoms`` draws from one generator in blocks that can be
    put back.  ``block(k)`` makes k sequential per-step draws (one draw of
    shape [k, B, ...] would give other numbers) and stacks them into
    ``(u [k, B, 4], dice [k, B, 5])``; ``rewind(m)`` sets the generator
    back to where it stood after the block's first m draws.  A snapshot is
    ``Generator.get_state()``, which for a CUDA generator is its seed and
    offset on the host: no sync."""

    def __init__(self, generator: torch.Generator, batch_size: int, device):
        self.gen, self.batch, self.device = generator, batch_size, device
        self._states = []

    def block(self, k: int):
        us, dice, self._states = [], [], []
        for _ in range(k):
            self._states.append(self.gen.get_state())
            u, d = draw_step_randoms(self.gen, self.batch, self.device)
            us.append(u)
            dice.append(d)
        return torch.stack(us), torch.stack(dice)

    def rewind(self, m: int) -> None:
        if m < len(self._states):
            self.gen.set_state(self._states[m])
