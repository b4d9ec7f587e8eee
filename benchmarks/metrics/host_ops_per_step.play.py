"""CPU-side aten operations the profiler recorded, per traced micro-step."""


def read(ctx):
    t, c = ctx.get("trace"), ctx["counts"]
    if not t or not c.get("steps"):
        return None
    return t["host_ops"] / c["steps"]
