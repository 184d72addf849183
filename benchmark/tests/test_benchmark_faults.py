"""``correct`` on the CPU at a small size: a sound run holds, the control
(the plain reference in float32 with TF32 products) fails, and so does a
run with the program broken underneath, once for each fault the cell can
have: the pose-graph solve returning its state unchanged, half of the
gated pairs left out, one pose moved by 2 m where the solver produces it,
and one loop closure's relative pose altered where it is produced."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, plainref, synthetic

from .conftest import tiny_plan

CELL = "anno20.batch"
SEED = 4294967311


def _run(registry):
    return harness.run_cell(tiny_plan(registry, CELL), registry, SEED, 0.0, False, torch.device("cpu"), 0.0)


def _break(monkeypatch, fault):
    from diasss_tpu_torch import pipeline
    from diasss_tpu_torch.solvers import lc, pose_graph

    if fault == "half_pairs":
        gate = pipeline._overlap_pairs
        monkeypatch.setattr(pipeline, "_overlap_pairs", lambda *a, **k: gate(*a, **k)[::2])
        return
    if fault == "lc_altered":
        solve_lc = lc.loop_closing_tfs_stacked

        def altered(*args, **kwargs):
            out = solve_lc(*args, **kwargs)
            t = out.rel_pose.t.clone()
            t[0, 1] += 1.0
            return out._replace(rel_pose=out.rel_pose._replace(t=t))

        monkeypatch.setattr(lc, "loop_closing_tfs_stacked", altered)
        return
    solve = pose_graph.solve_pose_graph

    def broken(graph, *args, **kwargs):
        poses, info = solve(graph, *args, **kwargs)
        if fault == "unchanged":
            poses = graph.poses0
        else:  # one pose moved by 2 m where the solver returns it
            t = poses.t.clone()
            t[-1, 0] += 2.0
            poses = poses._replace(t=t)
        return poses, info

    monkeypatch.setattr(pose_graph, "solve_pose_graph", broken)


def test_sound_run_is_correct(registry):
    out = _run(registry)
    assert out["correct"], out["numbers"]
    assert out["attempted"] == 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_pairs", "altered", "lc_altered"])
def test_broken_program_is_not_correct(registry, monkeypatch, fault):
    _break(monkeypatch, fault)
    out = _run(registry)
    assert not out["correct"], out["numbers"]


def test_control_is_not_correct(registry):
    """The plain reference in float32 with TF32 products, put in the
    program's place."""
    plan = tiny_plan(registry, CELL)
    survey = synthetic.make_survey(**plan.config["survey"], seed=SEED)
    ref = plan.reference.run(survey)
    ctl = plan.reference.run(survey, control=True)
    numbers, failed = check.compare(plan.reference.numbers([ctl], ref), plan.config["check"])
    assert not check.passed(numbers, failed), numbers


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265, np.inf, -0.0, -3.14159265], np.float32)
    r = plainref.round_tf32(x)
    assert r.dtype == np.float32 and r[0] == 1.0 and r[2] == 1.0 + 2 ** -10 and r[4] == np.inf
    assert r[1] in (1.0, 1.0 + 2 ** -10)
    assert abs(r[3] - 3.14159265) <= 2 ** -10 * 2 and r[3] != x[3] and r[6] == -r[3]
    ar = plainref.Arith(control=True)
    a = np.full((2, 2), 1.0 + 2 ** -12, np.float32)
    assert np.array_equal(ar.mm(a, a), np.full((2, 2), 2.0)) and not np.array_equal(a @ a, np.full((2, 2), 2.0))


def test_rigid_motions_of_the_reference():
    """The reference's own exponential and logarithm invert each other, and
    its step moves a pose on the right."""
    ar = plainref.Arith()
    rng = np.random.default_rng(5)
    xi = np.concatenate([rng.normal(size=(50, 3)) * np.array([[1.0], [1e-3]] * 25).repeat(3, 1),
                         rng.normal(size=(50, 3)) * 10], -1)
    assert np.allclose(plainref.log(ar, plainref.exp(ar, xi)), xi, atol=1e-9)
    X = plainref.exp(ar, xi)
    assert np.allclose(np.swapaxes(X.R, -1, -2) @ X.R, np.eye(3), atol=1e-12)
    # the geodesic distance between X and X Exp(d) is d
    d = rng.normal(size=(50, 6)) * 1e-2
    Y = plainref.compose(ar, X, plainref.exp(ar, d))
    assert np.allclose(plainref.log(ar, plainref.between(ar, X, Y)), d, atol=1e-12)
