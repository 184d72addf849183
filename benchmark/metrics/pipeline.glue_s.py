"""``pipeline.glue_s``: seconds per pass of the entry's own work outside the solvers: keyframes (the harness's clock), the overlap gate, pair assembly, the evaluation and the result fetch,
from ``SlamResult.timings`` (each stage ended by a device synchronise or a
host copy), summed over the traced run's unprofiled passes and divided by
their count."""

STAGES = ('keyframes', 'overlap_gate', 'kps_assembly', 'evaluation', 'result_fetch')


def read(ctx):
    return ctx.stage_seconds(STAGES)
