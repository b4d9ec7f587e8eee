"""Host milliseconds a micro-step inside the program's ``net.eval`` spans:
the evaluations' launches and the host code around them, over the traced
micro-steps."""

from benchmarks import spans


def read(ctx):
    return spans.ms_per_step(ctx, spans.total(ctx, "net.eval", "host_s"))
