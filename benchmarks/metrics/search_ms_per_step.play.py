"""Device milliseconds a micro-step of the search's own operations: the
device time launched inside the ``search`` spans less that inside the
``net`` spans, over the traced micro-steps."""


def read(ctx):
    t, c = ctx.get("trace"), ctx["counts"]
    if not t or not c.get("steps"):
        return None
    d = t["span_device_s"]
    if "search" not in d or d["search"] <= 0:
        return None
    return 1e3 * (d["search"] - d.get("net", 0.0)) / c["steps"]
