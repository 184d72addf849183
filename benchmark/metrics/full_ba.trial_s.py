"""``full_ba.trial_s``: the mean length of one LM trial of the full-BA solve
(the program's ``full_ba.trial`` span: linearize, the Schur step, the
candidate's error and accept, and the host read of the stall flag), over
every trial of the traced run's unprofiled window passes."""

from benchmark import spans


def read(ctx):
    return spans.mean_seconds(ctx.spans, "full_ba.trial")
