"""``pose_graph.stage_s``: seconds per pass of the pose-graph solve,
from ``SlamResult.timings`` (each stage ended by a device synchronise or a
host copy), summed over the traced run's unprofiled passes and divided by
their count."""

STAGES = ('pose_graph',)


def read(ctx):
    return ctx.stage_seconds(STAGES)
