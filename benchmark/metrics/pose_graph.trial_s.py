"""``pose_graph.trial_s``: the mean length of one LM trial of the pose-graph
solve (the program's ``pose_graph.trial`` span: linearize, step,
candidates' errors and the host read that accepts one), over every trial
of the traced run's unprofiled window passes."""

from benchmark import spans


def read(ctx):
    return spans.pose_graph_trial_s(ctx.spans)
