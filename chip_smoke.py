#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``diasss_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (every one asserts; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit) and build both CUDA
   kernels, ``csrc/fast9.cu`` (B1) and ``csrc/qcorr.cu`` (B2), one ``nvcc``
   each, started together;
2. B1: hold the FAST-9 kernel against its plain torch version at 4992x1280
   and at every pyramid level of the detected survey's 600x512 frames and
   of the automatic survey's 400x512 frames, thresholds 12 and 7, on
   uniform(0, 255) images and normalized waterfalls: bit-identical on
   ``[3:-3, 3:-3]``; time both with CUDA events;
3. the automatic profile (``automatic_config()``, 4 frames of 400x512, 2000
   keypoint slots): one warm-up pass, which also records the q-correlation
   inputs the matcher hands B2 in each round;
4. B2: hold the q-correlation kernel against ``qcorr_plain`` on seeded
   random windows at (12000, 59, 59) T=43 and (12000, 35, 35) T=19, and on
   the recorded real windows: max abs error 0 (both round every multiply and
   add alike); time kernel, plain version and one depthwise
   ``torch.nn.functional.conv2d`` (cuDNN, TF32 off) computing the same maps
   from inputs stacked beforehand;
5. the automatic profile again, timed (``run_slam`` on keyframes already
   on the card, as in every timed phase), with both kernels' launch counts,
   then once more under ``torch.profiler`` (device busy time, top kernels);
6. the detected two-stage path (the ``--detected`` CLI settings) on the
   5-line, 3000-pose survey: warm-up, then a counted, timed pass;
7. the annotation two-stage path at 3000 and 12000 poses, and full BA on
   annotations at 4200 poses (5 lines + 2 tie lines), the last one also
   profiled.

Before the last line it prints the ``kernels`` JSON line (launches from the
automatic run, times and bounds measured here) and the card's name and power
limit.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
There is no CPU path: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SURVEY = dict(n_lines=5, n_pings=600, n_bins=512, n_landmarks=60)
AUTO_SURVEY = dict(n_lines=3, n_pings=400, n_bins=512, n_landmarks=200, n_tie_lines=1, drift_xy=0.006, seed=7)
BA_SURVEY = dict(n_lines=5, n_tie_lines=2, n_landmarks=300)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float):
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_kernels():
    from diasss_tpu_torch import _nvcc
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.matching import dense_cuda

    t0 = time.perf_counter()
    logs = _nvcc.build(fast_cuda.SOURCE, dense_cuda.SOURCE, force=True)
    print(f"[build] {', '.join(str(p) for p in logs)} in {time.perf_counter() - t0:.2f} s")
    for lib, log in logs.items():
        print(f"[build] {lib.name} nvcc: " + " | ".join(l.strip() for l in log.splitlines() if l.strip()))


def build_frames(survey, dev):
    from diasss_tpu_torch.frame import build_keyframes_batch

    return build_keyframes_batch(
        [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines],
        device=dev,
    )


def fast_phase(dev):
    """B1 against its plain version at every shape the detected and automatic paths give it; returns
    (max_err, ms, plain_ms, bound_ms, bound_by) at the automatic path's level-0 shape (400x512,
    threshold 12)."""
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.features.fast import fast_score_plain
    from diasss_tpu_torch.features.pyramid import build_pyramid
    from diasss_tpu_torch.frame import normalize_sss
    from diasss_tpu_torch.synthetic import make_survey

    rng = np.random.default_rng(0)
    def normalized(survey_kw):
        wf = make_survey(**{**survey_kw, "n_lines": 1, "n_tie_lines": 0}).lines[0].image
        return normalize_sss(torch.as_tensor(wf, dtype=torch.float32, device=dev)).float()

    norm = normalized(AUTO_SURVEY)
    cases = [("waterfall", (4992, 1280), normalized(dict(n_pings=4992, n_bins=1280, n_landmarks=60)))]
    for frame in (normalized(SURVEY), norm):  # the detected and the automatic paths' pyramids
        for level in build_pyramid(frame, 6, 1.2):
            cases.append(("waterfall", tuple(level.shape), level.contiguous()))
    for shape in [c[1] for c in cases]:
        cases.append(("uniform", shape, torch.as_tensor(rng.uniform(0, 255, shape), dtype=torch.float32,
                                                        device=dev)))
    max_err = 0.0
    main = None
    print("[B1] image     shape        thr  kernel_ms  plain_ms  bound_ms  max_abs_err[3:-3,3:-3]")
    for kind, shape, img in cases:
        for thr in (12.0, 7.0):
            out_k = fast_cuda.fast9_score(img, thr)
            out_p = fast_score_plain(img, thr)
            torch.cuda.synchronize()
            err = float((out_k - out_p)[3:-3, 3:-3].abs().max())
            check(err == 0.0, f"FAST-9 kernel differs from the plain version: {kind} {shape} t={thr} err={err}")
            check(int((out_k > 0).sum()) > 0, f"no corners at all: {kind} {shape} t={thr}")
            ms = cuda_time_ms(lambda: fast_cuda.fast9_score(img, thr), reps=50)
            plain_ms = cuda_time_ms(lambda: fast_score_plain(img, thr), reps=5, warmup=1)
            # each pixel read once and written once; ~130 float ops per pixel
            bnd, by = bound_ms(8.0 * img.numel(), 130.0 * img.numel())
            max_err = max(max_err, err)
            print(f"[B1] {kind:9s} {shape[0]:5d}x{shape[1]:<5d} {thr:4.0f}  {ms:9.4f} {plain_ms:9.3f} {bnd:9.5f}  {err}")
            if kind == "waterfall" and shape == tuple(norm.shape) and thr == 12.0:
                main = (ms, plain_ms, bnd, by)
    return (max_err,) + main


def profiled(label, fn, wall_unprofiled):
    """Run ``fn`` once under ``torch.profiler`` (device activity only) and
    print the kernels' device time over the profiled wall (a lower bound on
    the busy share: the profiler's start-up is in that wall) and over the
    unprofiled pass's wall, the kernel count and the kernels that take the
    most time."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    print(f"[{label} profiled] wall {wall:.3f} s (profiler on), device busy {busy:.4f} s: "
          f"{100 * busy / wall:.1f}% of it, {100 * busy / wall_unprofiled:.1f}% of the unprofiled "
          f"{wall_unprofiled:.3f} s; {sum(e.count for e in kernels)} kernels; top: "
          + "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3:.1f} ms x{e.count}" for e in top))


def qcorr_bound(K, S, k, T):
    """B2's least time: 4 K T^2 k^2 float32 operations (multiply and add,
    two maps) against 4 K (2 S^2 + k^2 + 2 T^2) bytes read once and written
    once."""
    return bound_ms(4.0 * K * (2 * S * S + k * k + 2 * T * T), 4.0 * K * T * T * k * k)


def qcorr_phase(dev, recorded):
    """B2 against its plain version on random and recorded windows; returns
    (max_err, ms, plain_ms, library_ms, bound_ms, bound_by) on the recorded
    round-0 windows."""
    import torch.nn.functional as F

    from diasss_tpu_torch.matching import dense_cuda
    from diasss_tpu_torch.matching.dense import qcorr_plain

    def conv_inputs(Wvh, Wh, q, k):
        """The depthwise convolution's input (1, 2K, S, S) and weight (2K, 1, k, k)."""
        return torch.cat([Wvh, Wh])[None], q.reshape(-1, 1, k, k).repeat(2, 1, 1, 1)

    rng = np.random.default_rng(1)
    cases = []
    for K, T in ((12000, 43), (12000, 19)):
        k = 17
        S = T + k - 1
        Wv = torch.as_tensor(rng.uniform(0, 1, (K, S, S)), dtype=torch.float32, device=dev)
        Wh = torch.as_tensor(rng.uniform(size=(K, S, S)) > 0.1, dtype=torch.float32, device=dev)
        q = torch.as_tensor(rng.normal(0, 1, (K, k * k)), dtype=torch.float32, device=dev)
        cases.append((f"random T={T}", (Wv * Wh).contiguous(), Wh, (q / q.norm(dim=1, keepdim=True)).contiguous(),
                      k, T))
    for r, (Wvh, Wh, q, k, T) in enumerate(recorded):
        cases.append((f"auto round {r} T={T}", Wvh, Wh, q, k, T))
    max_err = 0.0
    main = None
    print("[B2] windows                K      S   T  kernel_ms  plain_ms  conv2d_ms  bound_ms  max_abs_err  conv2d_err")
    for label, Wvh, Wh, q, k, T in cases:
        K, S = Wvh.shape[0], Wvh.shape[1]
        A, B = dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T)
        A0, B0 = qcorr_plain(Wvh, Wh, q, k, T)
        torch.cuda.synchronize()
        err = max(float((A - A0).abs().max()), float((B - B0).abs().max()))
        check(err == 0.0, f"q-correlation kernel differs from the plain version: {label} err={err}")
        x, w = conv_inputs(Wvh, Wh, q, k)
        conv_err = float((F.conv2d(x, w, groups=2 * K)[0] - torch.cat([A0, B0])).abs().max())
        ms = cuda_time_ms(lambda: dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T), reps=20)
        plain_ms = cuda_time_ms(lambda: qcorr_plain(Wvh, Wh, q, k, T), reps=2, warmup=1)
        lib_ms = cuda_time_ms(lambda: F.conv2d(x, w, groups=2 * K), reps=20)
        bnd, by = qcorr_bound(K, S, k, T)
        max_err = max(max_err, err)
        print(f"[B2] {label:20s} {K:6d} {S:4d} {T:3d}  {ms:9.4f} {plain_ms:9.3f} {lib_ms:10.4f} {bnd:9.4f}  "
              f"{err:11.3g}  {conv_err:.3g} ({by}-bound, kernel at {100 * bnd / ms:.1f}% of it)")
        if label.startswith("auto round 0"):
            main = (ms, plain_ms, lib_ms, bnd, by)
        del x, w
    return (max_err,) + main


def auto_run(frames, cfg, gt, record=None):
    """One automatic-profile pass over keyframes on the card; ``record``
    collects the inputs the matcher hands the q-correlation in each round."""
    from diasss_tpu_torch.matching import dense
    from diasss_tpu_torch.pipeline import run_slam

    if record is None:
        return run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    plain_entry = dense.qcorr

    def recording(Wvh, Wh, q, k, T):
        record.append((Wvh, Wh, q, k, T))
        return plain_entry(Wvh, Wh, q, k, T)

    dense.qcorr = recording
    try:
        return run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    finally:
        dense.qcorr = plain_entry


def auto_phase(dev, survey, cfg, gt, card):
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.matching import dense_cuda

    frames = build_frames(survey, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_cuda.launches = dense_cuda.launches = 0
    t0 = time.perf_counter()
    result = auto_run(frames, cfg, gt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fast_n, qcorr_n = fast_cuda.launches, dense_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    rounds = result.counters["match_stacked_pairs"] // len(result.pair_ids)
    check(qcorr_n == rounds, f"q-correlation kernel launched {qcorr_n} times for {rounds} match rounds")
    check(fast_n == 2 * cfg.detector.n_levels * len(result.frame_slices),
          f"FAST kernel launched {fast_n} times, expected {2 * cfg.detector.n_levels * len(result.frame_slices)}")
    check_poses(result, "automatic")
    check(result.ate_est < result.ate_dr, f"automatic: no improvement ({result.ate_est} >= {result.ate_dr})")
    check(result.counters.get("solver_direct_solves", 0) >= 1 and
          not any(k.startswith("solver_") and k != "solver_direct_solves" for k in result.counters),
          f"automatic: solver counters {result.counters}")
    pings = int(result.poses.t.shape[0])
    rings = {k: v for k, v in result.counters.items() if k.startswith("rematch_r")}
    matches = {f"{i}-{j}": int(result.eval1[(i, j)].n_pairs) for (i, j) in result.pair_ids}
    print(f"[auto] {pings} poses, pairs {len(result.pair_ids)} {result.pair_ids}, match rounds {rounds} "
          f"({len(result.pair_ids)} stacked pairs each), ring cells round 0 "
          f"{int(np.ceil(cfg.matcher.dense.search_radius / cfg.detector.geopatch_res))} then {rings}, "
          f"matches per pair (last round) {matches}, correspondences in the solve {result.n_lc_accepted}")
    print(f"[auto] ATE DR/EST {result.ate_dr:.4f}/{result.ate_est:.4f} m, wall {wall:.3f} s "
          f"({pings / wall:.1f} pings/s), peak device memory {peak / 2**20:.1f} MiB, "
          f"FAST launches {fast_n}, q-correlation launches {qcorr_n} on {card}")
    print(f"[auto] timings {json.dumps({k: round(v, 4) for k, v in result.timings.items()})} "
          f"counters {json.dumps(result.counters)} solve_capped {result.solve_capped}")
    frames = build_frames(survey, dev)
    profiled("auto", lambda: auto_run(frames, cfg, gt), wall)
    return fast_n, qcorr_n


def check_poses(result, label):
    check(bool(torch.isfinite(result.poses.t).all()) and bool(torch.isfinite(result.poses.R).all()),
          f"{label}: non-finite poses")


def detected_phase(dev):
    from diasss_tpu_torch.config import PipelineConfig, detected_config
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.synthetic import make_survey

    survey = make_survey(**SURVEY)
    cfg = detected_config(PipelineConfig())
    gt = [l.gt_poses for l in survey.lines]
    run_slam(build_frames(survey, dev), cfg, gt_rows_list=gt, run_eval2=False)  # warm-up
    frames = build_frames(survey, dev)
    torch.cuda.synchronize()
    fast_cuda.launches = 0
    t0 = time.perf_counter()
    result = run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    wall = time.perf_counter() - t0
    launches = fast_cuda.launches
    expected = 2 * cfg.detector.n_levels * len(frames)
    check(launches == expected, f"FAST kernel launched {launches} times, expected {expected}")
    check_poses(result, "detected")
    check(result.ate_est <= result.ate_dr + 1e-2,
          f"detected: estimate regressed below dead reckoning ({result.ate_est} > {result.ate_dr} + 1e-2)")
    matches = {f"{i}-{j}": int(r.valid.sum()) for (i, j), r in result.lc_results.items()}
    pings = int(result.poses.t.shape[0])
    print(f"[detected] {pings} poses, pairs {len(result.pair_ids)} {result.pair_ids}, "
          f"matched keypoint pairs {matches}, n_lc_accepted {result.n_lc_accepted}, "
          f"ATE DR/EST {result.ate_dr:.4f}/{result.ate_est:.4f} m, wall {wall:.3f} s "
          f"({pings / wall:.1f} pings/s), FAST launches {launches}")
    print(f"[detected] timings {json.dumps({k: round(v, 4) for k, v in result.timings.items()})} "
          f"counters {json.dumps(result.counters)}")
    return launches


def annotation_phase(dev, card, survey_kw, cfg, label, profile=False):
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.synthetic import make_survey

    survey = make_survey(**survey_kw)
    gt = [l.gt_poses for l in survey.lines]
    run_slam(build_frames(survey, dev), cfg, gt_rows_list=gt, run_eval2=False)  # warm-up
    frames = build_frames(survey, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pings = int(result.poses.t.shape[0])
    check_poses(result, f"{label} {pings}")
    check(result.ate_est < result.ate_dr,
          f"{label} {pings}: no improvement over dead reckoning ({result.ate_est} >= {result.ate_dr})")
    print(f"[{label} {pings}] pairs {len(result.pair_ids)}, n_lc_accepted {result.n_lc_accepted}, "
          f"ATE DR/EST {result.ate_dr:.4f}/{result.ate_est:.4f} m, wall {wall:.3f} s, "
          f"{pings / wall:.1f} pings/s, peak device memory {peak / 2**20:.1f} MiB on {card}")
    print(f"[{label} {pings}] timings {json.dumps({k: round(v, 4) for k, v in result.timings.items()})} "
          f"counters {json.dumps(result.counters)} solve_capped {result.solve_capped}")
    if profile:
        frames = build_frames(survey, dev)
        profiled(f"{label} {pings}", lambda: run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False), wall)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import diasss_tpu_torch  # noqa: F401  (fails outside the repository)
    from diasss_tpu_torch.config import PipelineConfig, automatic_config
    from diasss_tpu_torch.synthetic import make_survey

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    print(f"[card] {card}")
    dev = torch.device("cuda", 0)

    build_kernels()
    fast_err, fast_ms, fast_plain_ms, fast_bound, fast_by = fast_phase(dev)

    auto_survey = make_survey(**AUTO_SURVEY)
    auto_cfg = automatic_config()
    auto_gt = [l.gt_poses for l in auto_survey.lines]
    recorded = []
    auto_run(build_frames(auto_survey, dev), auto_cfg, auto_gt, record=recorded)  # warm-up, records B2's inputs
    check(len(recorded) >= 1, "the automatic warm-up pass never reached the q-correlation")
    q_err, q_ms, q_plain_ms, q_lib_ms, q_bound, q_by = qcorr_phase(dev, recorded)
    del recorded
    fast_auto, qcorr_auto = auto_phase(dev, auto_survey, auto_cfg, auto_gt, card)

    fast_detected = detected_phase(dev)
    annotation_phase(dev, card, {**SURVEY, "n_lines": 5}, PipelineConfig(), "anno")
    annotation_phase(dev, card, {**SURVEY, "n_lines": 20}, PipelineConfig(), "anno")
    annotation_phase(dev, card, BA_SURVEY, PipelineConfig(min_overlap=0.1, estimator="full_ba"), "full_ba anno",
                     profile=True)

    print(json.dumps({"kernels": [
        {
            "name": "fast9_score",
            "route": "cuda",
            "source": "diasss_tpu_torch/csrc/fast9.cu",
            "replaces": "diasss_tpu/features/fast_pallas.py:30",
            "launches": fast_auto,
            "launches_by_phase": {"auto": fast_auto, "detected": fast_detected},
            "max_abs_err": fast_err,
            "ms": fast_ms,
            "plain_ms": fast_plain_ms,
            "bound_ms": fast_bound,
            "bound_by": fast_by,
            "library_ms": None,
        },
        {
            "name": "qcorr",
            "route": "cuda",
            "source": "diasss_tpu_torch/csrc/qcorr.cu",
            "replaces": "diasss_tpu/matching/dense_pallas.py:32",
            "launches": qcorr_auto,
            "launches_by_phase": {"auto": qcorr_auto},
            "max_abs_err": q_err,
            "ms": q_ms,
            "plain_ms": q_plain_ms,
            "bound_ms": q_bound,
            "bound_by": q_by,
            "library_ms": q_lib_ms,
        },
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
