"""The whole play step's share of the card's int8 peak: the useful network
work of the traced window (AlphaZero decisions x (simulations + 1)
evaluations x one board's forward) over the window and the peak."""

from benchmarks import work


def read(ctx):
    t, c = ctx.get("trace"), ctx["counts"]
    if not t or t["window_s"] <= 0 or not c.get("decisions"):
        return None
    flops = (c["decisions"] * (c["sims"] + 1)
             * work.forward_flops(ctx["config"]))
    return 100.0 * flops / t["window_s"] / work.PEAK["int8_ops"]
