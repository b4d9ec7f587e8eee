"""The network's share of its roofline: the least time of the traced
window's evaluations (every row of every evaluation: the trunk at the int8
peak, the stem and heads at the bf16 peak, the features' and heads' bytes
at the memory's bandwidth) over the device time of the operations launched
inside the ``net`` spans."""

from benchmarks import work


def read(ctx):
    t, c = ctx.get("trace"), ctx["counts"]
    if not t or not c.get("steps"):
        return None
    busy = t["span_device_s"].get("net", 0.0)
    if busy <= 0:
        return None
    boards = c["games"] * c["steps"] * (c["sims"] + 1)
    return 100.0 * work.eval_least_seconds(ctx["config"], boards) / busy
