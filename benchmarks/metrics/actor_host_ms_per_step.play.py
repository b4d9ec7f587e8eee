"""Host milliseconds a micro-step of the actor's own code: the program's
``actor.step`` spans less the ``search.run``, ``actor.ff`` and
``host.sync`` spans inside them (the move pick, the rules step, the
records, the statuses and selects), over the traced micro-steps."""

from benchmarks import spans


def read(ctx):
    return spans.ms_per_step(ctx, spans.total(ctx, "actor.step",
                                              "host_self_s"))
