"""Benchmark of the port: end-to-end SLAM throughput in pings/s on one GPU.

Counterpart of the repository's ``bench.py`` (the JAX package's bench), with
the same points, passes, reference proxies and JSON keys:

    python -m diasss_tpu_torch.bench

runs on the card (it raises without CUDA) and prints ONE JSON line on
standard output, with exactly the keys of ``bench.py``'s line; the lines
before it go to standard error, the first of them the card's name and power
limit (``nvidia-smi``).  The points:

* headline (``value``): the reference-parity annotation pipeline on the
  standard synthetic survey (5 lines x 600 pings x 512 bins);
* ``value_12k_poses``: the same pipeline at 20 lines (12000 poses);
* ``value_full_ba`` / ``ate_full_ba``: joint bundle adjustment on a
  crossing-line survey (5 mains + 2 ties, 4200 poses);
* ``value_auto`` / ``ate_auto``: the automatic pipeline (no annotations:
  detect -> dense world-correlation match -> joint BA,
  ``automatic_config()``) on a small drifting survey (1600 poses; kernels
  B1 and B2).

One pass runs from the raw numpy survey to a device synchronise after
``run_slam`` returns: the keyframes are built on the card (stage
``keyframes``, ended by a synchronise), then ``run_slam`` times its own
stages, each ended by a synchronise or a host copy.  Each point takes one
warm-up pass (CUDA context, kernel loads, the allocator) and keeps the best
of ``n_passes`` timed passes; every wall rides the JSON (``wall_samples_*``)
and ``timings_sum_frac_*`` is the stages' seconds over the wall.
``SlamResult.counters`` (solver kinds, matched pairs) stay apart from the
seconds.  Unlike ``bench.py`` no point's failure is caught: a point that
fails ends the run with an error.

``vs_baseline*``: the reference publishes no numbers and its GTSAM/OpenCV
stack is not built here, so the denominator is a MEASURED PROXY of its
estimation core, re-run on the host's CPU at every invocation
(:func:`reference_stream_proxy`, and :func:`reference_auto_proxy` for the
automatic point, which needs OpenCV and is ``null`` without it).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

NO_CUDA = ("the port's bench runs on the card and torch.cuda.is_available() is False; "
           'call run(..., device="cpu") to run it on the CPU')


def reference_stream_proxy(n_pings: int = 3000) -> float:
    """Measured pings/s of a scipy re-implementation of the reference's
    per-ping iSAM2 stream (optimizer.cpp:146-276): per ping, append a 6-dof
    pose + odometry factor and re-solve the growing block-tridiagonal normal
    equations with a banded Cholesky (O(p) per ping — the cost shape of
    iSAM2's Bayes-tree update under the constant relinearization pressure a
    drifting DR chain produces).  CPU, single-threaded, like the reference.
    The same seed and arithmetic as ``bench.reference_stream_proxy``."""
    from scipy.linalg import solveh_banded

    rng = np.random.default_rng(0)
    bw = 11  # 6-dof poses, block-tridiagonal -> scalar bandwidth 11
    # one whitened between-factor linearization (the blocks are the same cost
    # every ping; their values only need to keep the system SPD)
    Ji = np.eye(6) + 0.01 * rng.standard_normal((6, 6))
    Jj = -np.eye(6) + 0.01 * rng.standard_normal((6, 6))
    H12 = np.block([[Ji.T @ Ji, Ji.T @ Jj], [Jj.T @ Ji, Jj.T @ Jj]])
    diags = [np.diag(H12, -c).copy() for c in range(bw + 1)]

    n_dof_max = 6 * n_pings
    ab = np.zeros((bw + 1, n_dof_max))  # scipy lower-banded storage
    rhs = np.zeros(n_dof_max)
    ab[0, :6] = 1e6  # gauge prior on pose 0
    ab[0, :] += 1e-6  # weak diagonal prior (keeps the growing system SPD)

    t0 = time.perf_counter()
    for p in range(1, n_pings):
        o = 6 * (p - 1)
        for c in range(bw + 1):  # scatter the new factor into the band
            ab[c, o : o + len(diags[c])] += diags[c]
        rhs[o : o + 12] += 0.01 * rng.standard_normal(12)
        n_dof = 6 * (p + 1)
        # iSAM2-update equivalent: solve the current system (one GN step)
        sol = solveh_banded(ab[:, :n_dof], rhs[:n_dof], lower=True)
        if not np.all(np.isfinite(sol)):  # keep the work honest
            raise RuntimeError("proxy solve diverged")
    dt = time.perf_counter() - t0
    return n_pings / dt


def reference_auto_proxy(survey, pair_count: int, n_pings_total: int):
    """Measured pings/s of a CPU proxy for the reference's DETECTED pipeline
    at the automatic point: per frame, OpenCV SIFT detect+compute on the
    normalized 8-bit image (the reference's live detector output is SIFT
    descriptors from its vendored ORBextractor — ORBextractor.cpp:1043-1047,
    2000 features, frame.cpp:180); per overlapping pair, a brute-force L2
    2-NN match + the 0.35 ratio test (FEAmatcher.cpp:105-138); plus the
    per-ping iSAM2-stream estimation proxy (:func:`reference_stream_proxy`).

    Includes the reference's process-level hot spot: one LM mini-solve (2
    poses + landmark, ~20 damped normal-equation iterations), one
    triangulation solve, and one QR marginal PER accepted match
    (optimizer.cpp:690-965), priced at the proxy's own measured match
    yield.  Generous like the stream proxy: no SCC RANSAC (1000
    hypotheses/pair), no geo-gating bookkeeping, and OpenCV's default
    multithreading is left on while the reference is single-threaded.

    Returns ``(pings_per_sec, n_matches_total)`` (speed without matches
    corrects no drift), or ``(None, None)`` without opencv-python.  The
    images are normalized by :func:`.frame._normalize_sss_np`, equal bit for
    bit to the JAX package's."""
    try:
        import cv2
    except ImportError:  # pragma: no cover - env-dependent
        return None, None
    from .config import NormalizeConfig
    from .frame import _normalize_sss_np

    imgs = _normalize_sss_np(
        np.stack([l.image for l in survey.lines]).astype(np.float32),
        NormalizeConfig(),
    )
    sift = cv2.SIFT_create(nfeatures=2000)
    t0 = time.perf_counter()
    feats = [sift.detectAndCompute(im, None) for im in imgs]
    bf = cv2.BFMatcher(cv2.NORM_L2)
    F = len(feats)
    done = 0
    n_matches = 0
    for i in range(F):
        for j in range(i + 1, F):
            if done >= pair_count:
                break
            da, db = feats[i][1], feats[j][1]
            if da is None or db is None or len(da) < 2 or len(db) < 2:
                continue
            knn = bf.knnMatch(da, db, k=2)
            n_matches += len([m for m, n2 in knn
                              if m.distance < 0.35 * n2.distance])
            done += 1
    # per-match LoopClosingTFs replay: LM loop + triangulation + QR marginal
    rngp = np.random.default_rng(0)
    J = rngp.standard_normal((12, 15))
    for _ in range(n_matches):
        x = np.zeros(15)
        for _i in range(20):  # optimizer.cpp:815-822 LM iterations
            H = J.T @ J + np.eye(15)
            x = np.linalg.solve(H, J.T @ (J @ x - 1.0))
        for _i in range(10):  # TriangulateOneLandmark (optimizer.cpp:984)
            np.linalg.solve(J[:3, :3].T @ J[:3, :3] + np.eye(3), np.ones(3))
        np.linalg.qr(H)  # Marginals (optimizer.cpp:956)
    dt_feat = time.perf_counter() - t0
    stream_rate = reference_stream_proxy(min(n_pings_total, 3000))
    total = dt_feat + n_pings_total / stream_rate
    return n_pings_total / total, n_matches


def _device(device) -> torch.device:
    """``device``, the card when it is None; raises where CUDA is absent
    unless the caller asked for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run(n_lines=5, n_pings=600, n_bins=512, n_landmarks=60, n_passes=3,
        n_tie_lines=0, cfg=None, with_gt=False, drift_xy=0.004, seed=0, device=None):
    """One bench point: ``make_survey`` at these arguments, one warm-up pass
    and ``n_passes`` timed passes of keyframes + ``run_slam`` with ``cfg``
    (default ``PipelineConfig()``) on ``device`` (the card unless given).
    Returns the best pass's rate, wall, stage seconds (``timings``, with
    ``keyframes``), their share of the wall (``timings_sum_frac``), path
    ``counters``, loop closures and ATEs, and every wall sorted."""
    from .config import PipelineConfig
    from .frame import build_keyframes_batch
    from .pipeline import _sync, run_slam
    from .synthetic import make_survey

    dev = _device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or PipelineConfig()
    survey = make_survey(n_lines=n_lines, n_pings=n_pings, n_bins=n_bins,
                         n_landmarks=n_landmarks, n_tie_lines=n_tie_lines,
                         drift_xy=drift_xy, seed=seed)
    total_pings = sum(len(l.dr_poses) for l in survey.lines)
    gt = [l.gt_poses for l in survey.lines] if with_gt else None

    def one_pass():
        t_start = time.perf_counter()
        frames = build_keyframes_batch(
            [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos)
             for l in survey.lines],
            device=dev,
        )
        _sync(dev)
        stage = {"keyframes": time.perf_counter() - t_start}
        result = run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
        _sync(dev)
        wall = time.perf_counter() - t_start
        stage.update(result.timings)
        return wall, result, stage

    one_pass()  # warm-up: CUDA context, kernel loads, the allocator
    passes = [one_pass() for _ in range(n_passes)]
    walls = sorted(p[0] for p in passes)
    # best of n measured passes: the host's share of the wall varies from
    # pass to pass; every wall rides the JSON so the spread is recorded
    wall, result, stage = min(passes, key=lambda p: p[0])
    return dict(
        pings_per_sec=total_pings / wall,
        wall=wall,
        walls=walls,
        n_lc=result.n_lc_accepted,
        timings=stage,
        timings_sum_frac=sum(stage.values()) / wall,
        counters=dict(result.counters),
        ate_dr=result.ate_dr,
        ate_est=result.ate_est,
        total_pings=total_pings,
    )


def _report(label, r):
    print(f"{label}: {r['pings_per_sec']:.0f} pings/s  walls {['%.3f' % w for w in r['walls']]}  "
          f"sum_frac {r['timings_sum_frac']:.3f}  ate {r['ate_dr']:.4f}->{r['ate_est']:.4f}\n"
          f"    timings {json.dumps({k: round(v, 4) for k, v in r['timings'].items()})}\n"
          f"    counters {json.dumps(r['counters'])}", file=sys.stderr)


def main():
    from .config import annotated_full_ba_config, automatic_config
    from .synthetic import make_survey

    print(card_line(), file=sys.stderr)

    # --- headline: reference-parity annotation pipeline, 3k poses ---
    r3k = run(with_gt=True)
    _report("3k", r3k)

    # --- 12k-pose stress point, best of 3 ---
    r12k = run(n_lines=20, n_passes=3, with_gt=True)
    _report("12k", r12k)

    # --- joint Schur BA on a crossing survey (4200 poses, direct step) ---
    rba = run(n_lines=5, n_tie_lines=2, n_landmarks=300, n_passes=2,
              cfg=annotated_full_ba_config(), with_gt=True)
    _report("full_ba", rba)

    # --- fully-automatic pipeline (no annotations): detect -> dense
    # world-correlation match -> joint BA + drift-compensated re-match ---
    rauto = run(n_lines=3, n_pings=400, n_tie_lines=1, n_landmarks=200,
                n_passes=2, cfg=automatic_config(), with_gt=True,
                drift_xy=0.006, seed=7)
    _report("auto", rauto)
    # measured CPU proxy of the reference's DETECTED pipeline on the same
    # survey (SIFT detect + ratio-test NN match + iSAM2 stream)
    auto_survey = make_survey(n_lines=3, n_pings=400, n_bins=512,
                              n_landmarks=200, n_tie_lines=1,
                              drift_xy=0.006, seed=7)
    n_pairs = int(rauto["counters"].get("eval_stacked_pairs", 6))
    baseline_auto, baseline_auto_matches = reference_auto_proxy(
        auto_survey, n_pairs, rauto["total_pings"])
    if baseline_auto:
        print(f"auto reference proxy: {baseline_auto:.1f} pings/s, "
              f"{baseline_auto_matches} ratio-test matches "
              f"(vs {rauto['pings_per_sec']:.0f} pings/s, "
              f"{rauto['n_lc']} dense matches)", file=sys.stderr)

    def rnd(x, n=3):
        # a NaN the run produced is emitted as null, not bare NaN (which is
        # not valid strict JSON for downstream parsers)
        return round(x, n) if x == x else None

    def solver_kinds(r):
        """Which linear solver(s) actually ran (the pipeline's
        solver_<kind>_solves counters)."""
        ks = sorted(k[len("solver_"):-len("_solves")]
                    for k in r["counters"] if k.startswith("solver_")
                    and k.endswith("_solves"))
        return ",".join(ks) if ks else None

    # best of 2: the proxy's pings/s moves with host CPU state; the faster
    # run is the fairest statement of the reference's capability
    baseline = max(reference_stream_proxy(), reference_stream_proxy())
    baseline_12k = reference_stream_proxy(12000)
    baseline_ba = reference_stream_proxy(4200)
    print(
        json.dumps(
            {
                "metric": "slam_pings_per_sec",
                "value": round(r3k["pings_per_sec"], 2),
                "unit": "pings/s",
                "vs_baseline": round(r3k["pings_per_sec"] / baseline, 3),
                "baseline_proxy_pings_per_sec": round(baseline, 2),
                "wall_samples_3k": [round(w, 3) for w in r3k["walls"]],
                "timings_sum_frac_3k": round(r3k["timings_sum_frac"], 3),
                "ate_3k": round(r3k["ate_est"], 3),
                "ate_dr_3k": round(r3k["ate_dr"], 3),
                "value_12k_poses": round(r12k["pings_per_sec"], 2),
                "vs_baseline_12k": round(r12k["pings_per_sec"] / baseline_12k, 3),
                "baseline_proxy_12k": round(baseline_12k, 2),
                "wall_samples_12k": [round(w, 3) for w in r12k["walls"]],
                "timings_sum_frac_12k": round(r12k["timings_sum_frac"], 3),
                "ate_12k": round(r12k["ate_est"], 3),
                "ate_dr_12k": round(r12k["ate_dr"], 3),
                "value_full_ba": rnd(rba["pings_per_sec"], 2),
                "vs_baseline_full_ba": rnd(rba["pings_per_sec"] / baseline_ba),
                "ate_full_ba": rnd(rba["ate_est"]),
                "ate_dr_full_ba": rnd(rba["ate_dr"]),
                "value_auto": rnd(rauto["pings_per_sec"], 2),
                "vs_baseline_auto": (
                    rnd(rauto["pings_per_sec"] / baseline_auto)
                    if baseline_auto else None
                ),
                "baseline_proxy_auto": rnd(baseline_auto, 2) if baseline_auto else None,
                # the proxy's own match yield: its speed corrects no drift
                # without correspondences (see reference_auto_proxy)
                "baseline_auto_matches": baseline_auto_matches,
                "ate_auto": rnd(rauto["ate_est"]),
                "ate_dr_auto": rnd(rauto["ate_dr"]),
                "solver_3k": solver_kinds(r3k),
                "solver_12k": solver_kinds(r12k),
                "solver_full_ba": solver_kinds(rba),
                "solver_auto": solver_kinds(rauto),
                # the automatic point's stage seconds (detect/matching/full_ba...)
                "timings_auto": {k: round(v, 3) for k, v in rauto["timings"].items()},
            }
        )
    )


if __name__ == "__main__":
    main()
