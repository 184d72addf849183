"""``lc.stage_s``: seconds per pass of the loop-closure mini-solves and their gate,
from ``SlamResult.timings`` (each stage ended by a device synchronise or a
host copy), summed over the traced run's unprofiled passes and divided by
their count."""

STAGES = ('loop_closures', 'lc_gate')


def read(ctx):
    return ctx.stage_seconds(STAGES)
