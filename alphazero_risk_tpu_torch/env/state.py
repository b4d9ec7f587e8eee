"""Batched Risk game state as a dataclass of ``[B, ...]`` tensors.

Port of ``alphazero_risk_tpu/env/state.py``.  One ``GameState`` with leading
batch dimension ``B`` holds ``B`` games; every field is an int32 or bool
tensor on one device.  ``tree_map`` takes the place of ``jax.tree.map`` over
the fields of this dataclass and of the other per-game dataclasses of the
port (``Tree``, ``ScriptCarry``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import NEUTRAL_PLAYER, NUM_LANDS, PH_SETUP
from ..device import resolve_device


@dataclasses.dataclass
class GameState:
    """Mirror of reference ``Data`` (state.h:86-105), vectorized."""

    owner: torch.Tensor           # [B, 42] int32 in {0, 1, 2=neutral}
    army: torch.Tensor            # [B, 42] int32 in [0, land_army_max]
    phase: torch.Tensor           # [B] int32, PH_* constants
    round: torch.Tensor           # [B] int32, starts at 1
    cur_player: torch.Tensor      # [B] int32 in {0, 1}
    reinforcements: torch.Tensor  # [B] int32 (setup pool or turn budget)
    cards: torch.Tensor           # [B, 2] int32 card counts (simple_cards)
    card_sets_played: torch.Tensor  # [B] int32
    mob_from: torch.Tensor        # [B] int32 land index, -1 = None
    mob_to: torch.Tensor          # [B] int32 land index, -1 = None
    can_draw_card: torch.Tensor   # [B] bool
    attacks_during_turn: torch.Tensor  # [B] int32
    # Full-cards mode only (per-territory hands and the drawn pile);
    # all-false under simple_cards.
    player_cards: torch.Tensor    # [B, 2, 42] bool
    drawn_cards: torch.Tensor     # [B, 42] bool

    @property
    def batch_size(self) -> int:
        return self.phase.shape[0]

    @property
    def device(self) -> torch.device:
        return self.phase.device

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def tree_map(fn, first, *rest):
    """Apply ``fn`` field by field over dataclasses of the same type."""
    return dataclasses.replace(first, **{
        f.name: fn(getattr(first, f.name), *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(first)})


def new_game(batch_size: int, *, generator: torch.Generator | None = None,
             perm: torch.Tensor | None = None, device="cuda") -> GameState:
    """Deal a fresh batch of games (reference ``State::newGame``,
    state.cpp:137-167).

    The deal is a random permutation of the 42 lands with the owner pattern
    [P0, P1, neutral] tiled over it.  ``perm`` ([B, 42], one permutation per
    game) gives the deal explicitly; otherwise it is drawn from
    ``generator``.
    """
    dev = resolve_device(device)
    b = batch_size
    if perm is None:
        keys = torch.rand((b, NUM_LANDS), generator=generator,
                          device=generator.device if generator else dev)
        perm = torch.argsort(keys, dim=-1)
    perm = perm.to(dev, torch.int64)
    pattern = torch.tensor([0, 1, NEUTRAL_PLAYER], dtype=torch.int32,
                           device=dev).repeat(NUM_LANDS // 3)
    owner = torch.zeros((b, NUM_LANDS), dtype=torch.int32, device=dev)
    owner.scatter_(1, perm, pattern.expand(b, NUM_LANDS).contiguous())

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return GameState(
        owner=owner,
        army=full((b, NUM_LANDS), 1),
        phase=full((b,), PH_SETUP),
        round=full((b,), 1),
        cur_player=full((b,), 0),
        reinforcements=full((b,), 52),
        cards=full((b, 2), 0),
        card_sets_played=full((b,), 0),
        mob_from=full((b,), -1),
        mob_to=full((b,), -1),
        can_draw_card=full((b,), False, torch.bool),
        attacks_during_turn=full((b,), 0),
        player_cards=full((b, 2, NUM_LANDS), False, torch.bool),
        drawn_cards=full((b, NUM_LANDS), False, torch.bool),
    )


def invert_players(state: GameState) -> GameState:
    """Swap the two real players (reference ``State::invertPlayers``,
    state.cpp:493-516).  Used for mirrored game pairs."""
    owner = torch.where(state.owner == 0, 1,
                        torch.where(state.owner == 1, 0, state.owner))
    return state.replace(owner=owner.to(torch.int32),
                         cards=state.cards.flip(1),
                         player_cards=state.player_cards.flip(1))


def set_current_player(state: GameState, player) -> GameState:
    player = torch.as_tensor(player, dtype=torch.int32, device=state.device)
    return state.replace(
        cur_player=player.expand(state.cur_player.shape).clone())


def tree_select(pred: torch.Tensor, a, b):
    """Per-game select between two dataclasses of [B, ...] tensors."""
    def sel(x, y):
        if x is y:
            return x
        p = pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))
        return torch.where(p, x, y)
    return tree_map(sel, a, b)
