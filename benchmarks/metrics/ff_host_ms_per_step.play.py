"""Host milliseconds a micro-step of the opponent fast-forward: the
program's ``actor.ff`` spans less the ``host.sync`` reads inside them (the
blocks' draws, launches and rewinds), over the traced micro-steps."""

from benchmarks import spans


def read(ctx):
    return spans.ms_per_step(ctx, spans.total(ctx, "actor.ff",
                                              "host_self_s"))
