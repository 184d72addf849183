"""``full_ba.read_wait_s``: seconds per pass that the host waits at the
full-BA solve's per-trial read (the program's ``full_ba.read`` spans,
``bool(improved)`` alone), summed over each of the traced run's unprofiled
window passes and divided by their count."""

from benchmark import spans


def read(ctx):
    return spans.seconds_per_pass(ctx.spans, "full_ba.read")
