"""The int8 trunk's share of its roofline: the traced window's trunk work
(the boards every trunk pass evaluated, the program's ``net.boards``
counter, times one board's trunk operations) at the card's int8 peak, over
the device time of the program's ``net.trunk`` spans, which hold the
trunk's conv launches alone (K1)."""

from benchmarks import spans, work


def read(ctx):
    if not ctx["config"].get("infer_precision", "").startswith("int8 trunk"):
        return None
    busy = spans.total(ctx, "net.trunk", "device_s")
    if not busy:
        return None
    boards = spans.report(ctx)["counters"].get("net.boards", 0)
    return 100.0 * boards * work.trunk_flops(ctx["config"]) \
        / work.PEAK["int8_ops"] / busy
