"""Device milliseconds a micro-step of the network outside its trunk: the
device time of the program's ``net.eval`` spans less that of the
``net.trunk`` spans inside them (features, stem, the trunk's input
quantization, heads, the paired evaluation's selects), over the traced
micro-steps.  The events also count the time the device waits for the
host inside an evaluation, so the reading holds only in a cell whose
device never drains there (self-play, not the arena)."""

from benchmarks import spans


def read(ctx):
    net = spans.total(ctx, "net.eval", "device_s")
    trunk = spans.total(ctx, "net.trunk", "device_s")
    if net is None or trunk is None:
        return None
    return spans.ms_per_step(ctx, net - trunk)
