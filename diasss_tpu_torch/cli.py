"""Command-line entry point of the port — the ``test_demo`` equivalent.

Same folder flags as :mod:`diasss_tpu.cli` (the reference binary's five, plus
``--gt``, ``--out``, ``--metrics``, ``--mosaic``), run on one torch device:

    python -m diasss_tpu_torch.cli --image DIR --pose DIR --altitude DIR \\
        --groundrange DIR --annotation DIR [--detected [--descriptor sift|orb|geo_patch] \\
        | --auto [--drift-budget M]] [--estimator full_ba] [--online [--window W]] \\
        [--device cuda] [--gt DIR] [--out DIR] [--metrics FILE] [--no-marginals] [--mosaic FILE.png] \
        [--trace DIR]

The lines load through :func:`.parallel.prefetch.load_keyframes_pipelined`:
line k+1 is parsed on a host thread (by the native C++ reader when it
builds, else the Python parser; the CLI prints which) while line k is built
and, for ``--detected`` and ``--auto``, detected on the device.  ``--trace
DIR`` writes a ``torch.profiler`` Chrome trace of the solve (CPU and, on
the card, CUDA activity) to ``DIR/trace.json``; the solve runs inside
:func:`.trace.recording`, so the trace carries the program's spans
(``run_slam``, its stages, the solvers' iterations and trials).

``--auto`` runs the automatic profile (dense world-correlation matching,
joint full BA, drift-compensated re-matching); ``--estimator full_ba`` runs
the joint BA on annotations.  ``--out`` or ``--metrics`` turn on the exact
pose marginals of the estimate unless ``--no-marginals`` is given (the dump
``est_pose_sigmas_all.txt``, the metrics keys ``pose_sigma_mean`` and
``pose_sigma_max_xy``); ``--mosaic`` writes the mosaic rendered from the
estimated poses.  ``--online`` streams the lines one at a time through
:class:`.online.OnlineSlam` (``--window W``: fixed-lag smoothing over the
newest W lines), prints one line per arrival and the ATE, and with
``--out`` writes ``online_est_poses_{img_id}.txt`` per line; it computes no
marginals and writes no metrics.  ``--descriptor orb|geo_patch`` with
``--detected`` takes the JAX package's matcher settings for that family.
``--mesh N`` runs the multi-device layer (:mod:`.parallel`: sequence-parallel
solvers, data-parallel matchers, the ring NN search) with one process per
rank, started by torchrun::

    torchrun --nproc-per-node N -m diasss_tpu_torch.cli --mesh N \
        [--dist-backend nccl|gloo] --image DIR ...

``--dist-backend nccl`` (the default on the card) puts one rank on each GPU;
``gloo`` stages every exchange through host memory and is the one to use
when ranks share a GPU (NCCL refuses two ranks on one device) or run on the
CPU.  Each rank computes on ``cuda:LOCAL_RANK`` modulo the GPU count (with
``--device cuda``).  Only rank 0 prints and writes ``--out``, ``--metrics``,
``--mosaic`` and ``--trace``.  Without torchrun, ``--mesh N`` with N > 1
exits with an error that gives the torchrun line.
"""

from __future__ import annotations

import argparse
import contextlib
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
    parser.add_argument("--online", action="store_true",
                        help="stream survey lines one at a time through the incremental interface "
                             "(an estimate after every line)")
    parser.add_argument("--window", type=int, default=None, metavar="W",
                        help="--online: fixed-lag window of W lines (per-line solve cost stays O(window))")
    parser.add_argument("--mosaic", default=None, metavar="FILE.png",
                        help="write the world mosaic rendered from the estimated poses")
    parser.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="N-rank mesh (sequence-parallel solvers, data-parallel matchers); run under "
                             "torchrun --nproc-per-node N")
    parser.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                        help="--mesh: the process group's transport (default nccl with --device cuda, else gloo; "
                             "gloo when ranks share a GPU)")
    parser.add_argument("--no-marginals", action="store_true",
                        help="skip the exact per-pose marginal covariances that --out/--metrics turn on")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the solve to DIR/trace.json")
    args = parser.parse_args(argv)

    import torch

    mesh_n = args.mesh if args.mesh and args.mesh > 1 else None
    if mesh_n and "WORLD_SIZE" not in os.environ:
        parser.error(f"--mesh {mesh_n} runs one process per rank: torchrun --nproc-per-node {mesh_n} "
                     f"-m diasss_tpu_torch.cli --mesh {mesh_n} [--dist-backend nccl|gloo] ...")
    if mesh_n:
        return _mesh_main(args, parser, mesh_n)
    return _run(args, parser, torch.device(args.device))


def _mesh_main(args, parser, n: int) -> int:
    """``--mesh N`` under torchrun: join the group, run as rank
    ``RANK`` on its device, only rank 0 printing and writing."""
    import torch
    import torch.distributed as dist

    from .parallel.distributed import initialize, is_primary

    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        parser.error(f"--mesh {n} needs torchrun --nproc-per-node {n}, this run has {world} ranks")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda but torch.cuda.is_available() is False; pass --device cpu")
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % max(torch.cuda.device_count(), 1))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(backend=backend)
    try:
        if not is_primary():
            args.out = args.metrics = args.mosaic = args.trace = None
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                return _run(args, parser, device)
        print(f"rank 0 of {world} ({backend}) on {device}")
        return _run(args, parser, device)
    finally:
        dist.destroy_process_group()


def _run(args, parser, device) -> int:
    import numpy as np
    import torch

    from .config import PipelineConfig, automatic_config, detected_config
    from .parallel.prefetch import load_keyframes_pipelined
    from .pipeline import run_slam

    if device.type == "cuda":
        if not torch.cuda.is_available():
            parser.error("--device cuda but torch.cuda.is_available() is False; pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.auto:
        cfg = automatic_config(drift_budget=args.drift_budget)
    else:
        cfg = PipelineConfig(estimator=args.estimator)
    if args.mesh:
        cfg = dataclasses.replace(cfg, mesh_devices=args.mesh)
    if args.min_overlap is not None:
        cfg = dataclasses.replace(cfg, min_overlap=args.min_overlap)
    if args.detected and not args.auto:
        cfg = detected_config(cfg, args.descriptor)
    if (args.out or args.metrics) and not args.no_marginals and not args.online:
        # a dump or metrics file reports the estimate's pose marginals
        if cfg.estimator == "full_ba":
            cfg = dataclasses.replace(cfg, full_ba=dataclasses.replace(cfg.full_ba, marginals=True))
        else:
            cfg = dataclasses.replace(cfg, pose_graph=dataclasses.replace(cfg.pose_graph, marginals=True))

    # detected and automatic runs detect each line as it is built; an online
    # stream detects each arriving line itself
    detect = not cfg.pose_graph.use_anno and not args.online
    load = load_keyframes_pipelined(args.image, args.pose, args.altitude, args.groundrange, args.annotation,
                                    detector_cfg=cfg.detector if detect else None, norm_cfg=cfg.normalize,
                                    mask_cfg=cfg.mask, device=device)
    frames = load.frames
    print(f"loaded {len(frames)} survey lines on {device} pipelined: wall {load.timings['load_pipelined_wall']:.2f}s, "
          f"host parse {load.timings['load_host_parse']:.2f}s{' (detection inline)' if detect else ''}; "
          f"reader: {load.reader}")
    for f in frames:
        print(f"  image size: {f.raw.shape[0]} {f.raw.shape[1]}")

    gt_rows = None
    if args.gt:
        gt_rows = [np.loadtxt(os.path.join(args.gt, f)) for f in sorted(os.listdir(args.gt))]

    if args.online:
        return _online(frames, cfg, args.window, gt_rows, args.out, device)

    t0 = time.perf_counter()
    if args.trace:
        result = _traced(args.trace, device, lambda: run_slam(frames, cfg, gt_rows_list=gt_rows, out_dir=args.out,
                                                               run_eval2=not args.no_eval2, feats=load.feats))
    else:
        result = run_slam(frames, cfg, gt_rows_list=gt_rows, out_dir=args.out, run_eval2=not args.no_eval2,
                          feats=load.feats)
    result.timings.update(load.timings)
    print(f"SLAM solved ({time.perf_counter() - t0:.2f}s)")
    if args.mosaic:
        from .mosaic import build_mosaic, save_mosaic_png
        from .pipeline import _estimated_geo

        mosaic, _, _, _ = build_mosaic(frames, geo_list=_estimated_geo(frames, result.poses))
        save_mosaic_png(args.mosaic, mosaic)
        print(f"estimated-pose mosaic written to {args.mosaic}")
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
            "reader": load.reader,
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
        if result.pose_sigmas is not None:
            sig = result.pose_sigmas
            metrics["pose_sigma_mean"] = sig[1:].mean(axis=0).tolist()
            metrics["pose_sigma_max_xy"] = float(np.sqrt(sig[1:, 3] ** 2 + sig[1:, 4] ** 2).max())
        with open(args.metrics, "w") as f:
            json.dump(metrics, f, indent=2, default=float)
        print(f"metrics written to {args.metrics}")
    return 0


def _traced(trace_dir: str, device, run):
    """``run()`` under ``torch.profiler`` with CPU activity and, on the card,
    CUDA activity, and inside :func:`.trace.recording`, so the program's
    spans are in it; the Chrome trace goes to ``trace_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    from .pipeline import _sync
    from .trace import recording

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof, recording():
        result = run()
        _sync(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
    return result


def _online(frames, cfg, window, gt_rows, out_dir, device) -> int:
    """``--online``: stream the loaded lines through :class:`.online.OnlineSlam`."""
    import numpy as np
    import torch

    from .evaluate import trajectory_ate_pair
    from .online import OnlineSlam
    from .trajectory import save_poses_rpy

    slam = OnlineSlam(cfg, window_frames=window, device=device)
    for k, f in enumerate(frames):
        t1 = time.perf_counter()
        poses = slam.add_frame(f)
        print(f"frame {k} ({f.img_id}): estimate over {poses.t.shape[0]} pings, {slam.state.n_lc} loop closures "
              f"in the solve ({time.perf_counter() - t1:.2f}s)")
    if gt_rows is not None:
        ate_dr, ate_est = trajectory_ate_pair(torch.cat([f.dr_poses[:, 3:6] for f in frames]), poses,
                                              np.concatenate(gt_rows))
        print(f"ATE DR/EST: {ate_dr:.3f} / {ate_est:.3f} m")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for k, f in enumerate(frames):
            save_poses_rpy(os.path.join(out_dir, f"online_est_poses_{f.img_id}.txt"), slam.frame_poses(k))
        print(f"online trajectories written to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
