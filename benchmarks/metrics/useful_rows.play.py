"""Share of the root rows handed to the search that were decisions for a
live AlphaZero mover, over the whole window: the rest is the lockstep tail
(finished games) and, in the arena, games the opponent moves."""


def read(ctx):
    c = ctx["counts"]
    rows = c.get("games", 0) * c.get("window_steps", 0)
    if not rows:
        return None
    return 100.0 * c["window_decisions"] / rows
