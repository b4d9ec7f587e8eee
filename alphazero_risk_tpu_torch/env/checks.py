"""Game invariants of a batch of states, for tests and debugging.

Port of ``alphazero_risk_tpu/env/checks.py``: the debug-build analogue of
the reference's consistency checks (state.cpp:1181-1429), which the
batched engine does not need (there is no incremental state to drift).
Not used on hot paths: it downloads the states.
"""

from __future__ import annotations

from ..config import (
    Config,
    NEUTRAL_PLAYER,
    PH_ATTACK_MOBILIZATION,
    PH_SETUP,
    PH_SETUP_NEUTRAL,
)
from .state import GameState


def validate(state: GameState, cfg: Config) -> None:
    """Raise AssertionError with a precise message on any violated game
    invariant, for every game in the batch."""
    owner = state.owner.cpu().numpy()
    army = state.army.cpu().numpy()
    phase = state.phase.cpu().numpy()
    reinf = state.reinforcements.cpu().numpy()
    cards = state.cards.cpu().numpy()
    mob_from = state.mob_from.cpu().numpy()
    mob_to = state.mob_to.cpu().numpy()

    assert ((owner >= 0) & (owner <= NEUTRAL_PLAYER)).all(), "owner range"
    assert (army >= 0).all() and (army <= cfg.land_army_max).all(), \
        f"army out of [0, {cfg.land_army_max}]"
    in_setup = (phase == PH_SETUP) | (phase == PH_SETUP_NEUTRAL)
    assert (army[~in_setup] >= 1).all(), "empty land outside setup"
    assert (reinf >= 0).all(), "negative reinforcements"
    assert (cards >= 0).all(), "negative card counts"

    in_mob = phase == PH_ATTACK_MOBILIZATION
    assert ((mob_from[in_mob] >= 0) & (mob_to[in_mob] >= 0)).all(), \
        "mobilization phase without endpoints"
    if in_mob.any():
        rows = in_mob.nonzero()[0]
        assert (army[rows, mob_from[rows]] >= 2).all(), \
            "mobilization source must keep an army to move"
    # armies change only through battles and reinforcements (held by the
    # trajectory parity tests); here they are only bounded
    totals = army.sum(-1)
    assert (totals <= 3 * cfg.land_army_max * 42).all()
