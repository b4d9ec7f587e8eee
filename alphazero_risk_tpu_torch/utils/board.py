"""Board visualization: terminal and matplotlib renderers.

Replacement for the reference's Windows-only ImGui board viewer
(``src/risk_game/board/board_gui.{h,cpp}``): renders armies and ownership
per territory, grouped by continent, from one game of a batched
``GameState`` (on any device) or from an ``OracleState``.

The port's own copy of ``alphazero_risk_tpu/utils/board.py``: the same text,
character for character, for the same board.  matplotlib is imported only
inside ``render_png``; nothing on the card's path calls it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import (
    PH_ATTACK,
    PH_ATTACK_MOBILIZATION,
    PH_FORTIFY,
    PH_REINFORCEMENT,
    PH_SETUP,
    PH_SETUP_NEUTRAL,
)
from ..env.topology import CONTINENT_NAMES, CONTINENTS, LAND_NAMES

PHASE_NAMES = {
    PH_SETUP: "SETUP",
    PH_SETUP_NEUTRAL: "SETUP_NEUTRAL",
    PH_REINFORCEMENT: "REINFORCEMENT",
    PH_ATTACK: "ATTACK",
    PH_ATTACK_MOBILIZATION: "ATTACK_MOBILIZATION",
    PH_FORTIFY: "FORTIFY",
}
OWNER_GLYPH = {0: "A", 1: "B", 2: "."}


def render_text(owner, army, phase: int = None, cur_player: int = None,
                round_: int = None, reinforcements: int = None) -> str:
    """ASCII board: one line per continent, entries NAME:owner/army."""
    owner = np.asarray(owner)
    army = np.asarray(army)
    lines = []
    if phase is not None:
        lines.append(
            f"round {round_}  player {cur_player}  "
            f"{PHASE_NAMES.get(int(phase), '?')}  r={reinforcements}")
    for c, name in enumerate(CONTINENT_NAMES):
        lands, bonus = CONTINENTS[name]
        cells = [
            f"{LAND_NAMES[l][:12]:>12}:{OWNER_GLYPH[int(owner[l])]}"
            f"{int(army[l]):<2}" for l in lands]
        lines.append(f"{name[:13]:<14}(+{bonus}) " + " ".join(cells))
    counts = [(owner == p).sum() for p in range(3)]
    totals = [int((army * (owner == p)).sum()) for p in range(3)]
    lines.append(f"lands A/B/n: {counts[0]}/{counts[1]}/{counts[2]}   "
                 f"armies: {totals[0]}/{totals[1]}/{totals[2]}")
    return "\n".join(lines)


def render_state(state, index: int = 0) -> str:
    """Render game ``index`` of a batched ``GameState``: its board and
    header fields are copied to the host, one game only."""
    fields = ("owner", "army", "phase", "cur_player", "round",
              "reinforcements")
    one = {f: getattr(state, f)[index].cpu().numpy() for f in fields}
    return render_text(one["owner"], one["army"], int(one["phase"]),
                       int(one["cur_player"]), int(one["round"]),
                       int(one["reinforcements"]))


def render_png(owner, army, path: str, title: Optional[str] = None) -> None:
    """Matplotlib board map: territories on the 7x6 layout grid, colored by
    owner with army counts."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    owner = np.asarray(owner)
    army = np.asarray(army)
    colors = {0: "#d94b37", 1: "#3770d9", 2: "#b9b9b9"}
    fig, ax = plt.subplots(figsize=(11, 8))
    for l in range(42):
        y, x = divmod(l, 6)
        ax.add_patch(plt.Rectangle((x, 6 - y), 0.94, 0.94,
                                   color=colors[int(owner[l])], alpha=0.75))
        ax.text(x + 0.47, 6 - y + 0.58, LAND_NAMES[l][:10], ha="center",
                fontsize=7)
        ax.text(x + 0.47, 6 - y + 0.25, str(int(army[l])), ha="center",
                fontsize=11, weight="bold")
    ax.set_xlim(-0.1, 6.1)
    ax.set_ylim(-0.1, 7.1)
    ax.set_xticks([])
    ax.set_yticks([])
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
