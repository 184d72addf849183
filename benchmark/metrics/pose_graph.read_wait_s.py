"""``pose_graph.read_wait_s``: seconds per pass that the host waits at the
pose graph's per-trial read (the program's ``pose_graph.read`` spans,
``bool(improved)`` alone), summed over each of the traced run's unprofiled
window passes and divided by their count."""

from benchmark import spans


def read(ctx):
    return spans.pose_graph_read_wait_s(ctx.spans)
