"""``full_ba.stage_s``: seconds per pass of the full bundle adjustment (the
problem's build and the solve), from ``SlamResult.timings`` (the stage ends
with a device synchronise), summed over the traced run's unprofiled passes
and divided by their count."""

STAGES = ('full_ba',)


def read(ctx):
    return ctx.stage_seconds(STAGES)
