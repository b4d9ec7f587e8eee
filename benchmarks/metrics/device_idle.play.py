"""Share of the traced play window in which no operation ran on the
device: 100% less the union of the device operations' intervals."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
