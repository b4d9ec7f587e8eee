"""Host milliseconds a micro-step of the search's own code: the program's
``search.run`` spans less the ``net.eval`` spans inside them, over the
traced micro-steps."""

from benchmarks import spans


def read(ctx):
    return spans.ms_per_step(ctx, spans.total(ctx, "search.run",
                                              "host_self_s"))
