"""Host milliseconds a micro-step in the program's blocking reads from the
device (``host.sync`` spans): each waits until the device's queue is
empty, over the traced micro-steps."""

from benchmarks import spans


def read(ctx):
    return spans.ms_per_step(ctx, spans.total(ctx, "host.sync", "host_s"))
