"""Command-line entry point of the port — the ``test_demo`` equivalent.

Same folder flags as :mod:`diasss_tpu.cli` (the reference binary's five, plus
``--gt``, ``--out``, ``--metrics``), run on one torch device:

    python -m diasss_tpu_torch.cli --image DIR --pose DIR --altitude DIR \\
        --groundrange DIR --annotation DIR [--detected | --auto [--drift-budget M]] \\
        [--estimator full_ba] [--device cuda] [--gt DIR] \\
        [--out DIR --no-marginals] [--metrics FILE --no-marginals]

``--auto`` runs the automatic profile (dense world-correlation matching,
joint full BA, drift-compensated re-matching); ``--estimator full_ba`` runs
the joint BA on annotations.  Flags of features not ported yet
(``--online``, ``--mosaic``, ``--mesh``, non-SIFT descriptors with
``--detected``, and the pose marginals that ``--out``/``--metrics`` turn on
unless ``--no-marginals``) exit with an error that names their ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("diasss_tpu_torch", description="SSS SLAM on PyTorch + CUDA")
    parser.add_argument("--image", required=True, help="folder of sss image XML files")
    parser.add_argument("--pose", required=True, help="folder of auv pose XML files")
    parser.add_argument("--altitude", required=True, help="folder of altitude txt files")
    parser.add_argument("--groundrange", required=True, help="folder of ground range txt files")
    parser.add_argument("--annotation", required=True, help="folder of annotation XML files")
    parser.add_argument("--gt", default=None, help="optional folder of ground-truth pose txt files")
    parser.add_argument("--out", default=None, help="output dir for trajectory dumps")
    parser.add_argument("--metrics", default=None, help="write metrics JSON here")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    parser.add_argument("--no-eval2", action="store_true", help="skip triangulated-consistency eval")
    parser.add_argument("--estimator", default="two_stage", choices=["two_stage", "full_ba"])
    parser.add_argument("--detected", action="store_true",
                        help="detect+match features instead of using annotations (USE_ANNO=0)")
    parser.add_argument("--descriptor", default="sift", choices=["sift", "orb", "geo_patch"])
    parser.add_argument("--auto", action="store_true",
                        help="fully automatic profile: dense world-correlation matching + joint full BA + "
                             "drift-compensated re-matching (the annotation folder is still read for evaluation)")
    parser.add_argument("--drift-budget", type=float, default=4.0,
                        help="--auto: largest credible DR drift between overlapping lines (m)")
    parser.add_argument("--min-overlap", type=float, default=None,
                        help="override the pair-gate IoU threshold (reference: 0.4)")
    parser.add_argument("--online", action="store_true", help="stream lines incrementally")
    parser.add_argument("--mosaic", default=None, metavar="FILE.png", help="estimated-pose mosaic")
    parser.add_argument("--mesh", type=int, default=None, metavar="N", help="N-device mesh")
    parser.add_argument("--no-marginals", action="store_true",
                        help="skip per-pose marginal covariances (required with --out/--metrics "
                             "until the pose marginals are ported, ROADMAP A9)")
    args = parser.parse_args(argv)

    not_ported = [
        (args.online, "--online", "A13: online SLAM"),
        (args.mosaic is not None, "--mosaic", "A13: extras"),
        (bool(args.mesh), "--mesh", "A14: multi-device"),
        (args.detected and not args.auto and args.descriptor != "sift", f"--descriptor {args.descriptor}",
         "A11: orb/geo_patch descriptors"),
        ((args.out or args.metrics) and not args.no_marginals, "--out/--metrics without --no-marginals "
         "(they report pose marginals; pass --no-marginals)", "A9: pose marginals"),
    ]
    for hit, flag, item in not_ported:
        if hit:
            parser.error(f"{flag} is not ported to diasss_tpu_torch yet (ROADMAP {item})")

    import numpy as np
    import torch

    from .config import PipelineConfig, automatic_config, detected_config
    from .frame import build_keyframes_batch
    from .io import load_input_data
    from .pipeline import run_slam

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            parser.error("--device cuda but torch.cuda.is_available() is False; pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.auto:
        cfg = automatic_config(drift_budget=args.drift_budget)
    else:
        cfg = PipelineConfig(estimator=args.estimator)
    if args.min_overlap is not None:
        cfg = dataclasses.replace(cfg, min_overlap=args.min_overlap)
    if args.detected and not args.auto:
        cfg = detected_config(cfg, args.descriptor)

    t0 = time.perf_counter()
    data = load_input_data(args.image, args.pose, args.altitude, args.groundrange, args.annotation)
    items = [
        (k, img, pose, alt, gr, anno)
        for k, (img, pose, alt, gr, anno) in enumerate(zip(
            data.images, data.poses, data.altitudes, data.ground_ranges, data.annotations))
    ]
    frames = build_keyframes_batch(items, cfg.normalize, cfg.mask, device=device)
    print(f"loaded {len(frames)} survey lines on {device} ({time.perf_counter() - t0:.2f}s)")
    for f in frames:
        print(f"  image size: {f.raw.shape[0]} {f.raw.shape[1]}")

    gt_rows = None
    if args.gt:
        gt_rows = [np.loadtxt(os.path.join(args.gt, f)) for f in sorted(os.listdir(args.gt))]

    t0 = time.perf_counter()
    result = run_slam(frames, cfg, gt_rows_list=gt_rows, out_dir=args.out, run_eval2=not args.no_eval2)
    print(f"SLAM solved ({time.perf_counter() - t0:.2f}s)")
    print(f"pairs: {result.pair_ids}; loop closures accepted: {result.n_lc_accepted}")
    print("throughput:", result.summary())
    print(f"graph error: {result.solve_error0:.3e} -> {result.solve_error:.3e}")
    if result.ate_dr is not None:
        print(f"ATE DR/EST: {result.ate_dr:.3f} / {result.ate_est:.3f} m")
    for key, e1 in result.eval1.items():
        print(f"Metric Statics: {e1.improved_pct:.1f} {e1.n_pairs} {key[0]} {key[1]}\n"
              f"Avg X,Y,NORM (DR/EST): {e1.avg_x_dr:.4f}/{e1.avg_x_est:.4f} "
              f"{e1.avg_y_dr:.4f}/{e1.avg_y_est:.4f} {e1.avg_norm_dr:.4f}/{e1.avg_norm_est:.4f}")
    for key, e2 in result.eval2.items():
        print(f"Metric Statics: {e2.range_improved_pct:.1f} {e2.plane_improved_pct:.1f} "
              f"{e2.n_pairs} {key[0]} {key[1]}\n"
              f"Avg R and P (DR/EST): {e2.avg_range_dr:.4f}/{e2.avg_range_est:.4f} "
              f"{e2.avg_plane_dr:.4f}/{e2.avg_plane_est:.4f}")

    if args.metrics:
        metrics = {
            "n_frames": len(frames),
            "device": str(device),
            "pairs": [list(p) for p in result.pair_ids],
            "n_lc_accepted": result.n_lc_accepted,
            "solve_error0": result.solve_error0,
            "solve_error": result.solve_error,
            "ate_dr": result.ate_dr,
            "ate_est": result.ate_est,
            "eval1": {f"{k}": e._asdict() | {"ini_dists": None, "fnl_dists": None}
                      for k, e in result.eval1.items()},
            "eval2": {f"{k}": e._asdict() | {"range_dr_e": None, "range_est_e": None,
                                             "plane_dr_e": None, "plane_est_e": None}
                      for k, e in result.eval2.items()},
            "timings": result.timings,
            "counters": result.counters,
        }
        with open(args.metrics, "w") as f:
            json.dump(metrics, f, indent=2, default=float)
        print(f"metrics written to {args.metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
