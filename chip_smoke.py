#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``diasss_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (every one asserts; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit) and build both CUDA
   kernels, ``csrc/fast9.cu`` (B1) and ``csrc/qcorr.cu`` (B2), one ``nvcc``
   each, started together (``-Xptxas -v``: registers, spills);
2. B1: hold the FAST-9 kernel (one launch per frame: every pyramid level at
   both thresholds, frame mask and NMS) against ``fast_two_threshold_plain``
   on the detected survey's 600x512 pyramid, the automatic survey's 400x512
   pyramid and a one-level 4992x1280 list, thresholds 12 and 7, on
   normalized waterfalls and uniform(0, 255) images: bit-identical on the
   whole map; time each with CUDA events over back-to-back launches, with
   ``torch.profiler`` (the kernel's own device time) and with CUDA events
   around launches queued behind a device spin (the kernels back to back,
   the host hidden; the device time when the profiler records no kernel);
3. the automatic profile (``automatic_config()``, 4 frames of 400x512, 2000
   keypoint slots): one warm-up pass, which also records the inputs of the
   dense correlation (``_correlate``) and of B2 in each round;
4. B2: hold the q-correlation kernel against ``qcorr_plain`` on seeded
   random windows at (12000, 59, 59) T=43, (12000, 35, 35) T=19 and
   (2000, 59, 59) T=43 (one pair of the online stream), and on
   the recorded real windows: max abs error at most 2e-5 (the kernel fuses
   each multiply-add, the plain version rounds twice); on the recorded
   round-0 inputs ``_correlate`` finds the same best offset from both maps
   for at least 99% of the valid keypoints; time kernel (events, profiler
   and queued events, as B1), plain version and one depthwise
   ``torch.nn.functional.conv2d`` (cuDNN, TF32 off) computing the same maps
   from inputs stacked beforehand;
5. the automatic profile again, timed (``run_slam`` on keyframes already
   on the card, as in every timed phase), with both kernels' launch counts
   (one B1 launch per frame, one B2 launch per match round), then once
   more under ``torch.profiler`` (device busy time, top kernels);
6. the detected two-stage path (the ``--detected`` CLI settings) on the
   5-line, 3000-pose survey: warm-up, then a counted, timed pass;
7. the automatic profile with ``full_ba.marginals=True`` (what ``--metrics``
   runs; this slice's main path through both kernels): launch counts read
   around it, ``pose_marginals`` seconds, sigma statistics (finite, zero
   at the gauge pose, positive elsewhere), peak memory; then the
   estimated-pose mosaic of that run written to a temporary PNG;
8. the annotation two-stage path at 3000 and 12000 poses, and full BA on
   annotations at 4200 poses (5 lines + 2 tie lines), the last one also
   profiled; on the same keyframes, one pass each of the PCG family beside
   the direct step (3000: ``dense_seg`` and ``tridiag``; 4200:
   ``dense_seg``; LM trials, CG iterations, solve seconds, ATE gated
   against the direct pass's) and of the exact pose marginals (12000:
   ``pose_graph.marginals``; 4200: ``full_ba.marginals``); and the
   marginals of the 12000-pose chain with 1024 loop closures, their memory
   envelope;
9. online automatic (``OnlineSlam(automatic_config())``, this slice's main
   path): the automatic survey's 4 frames streamed in turn after one
   warm-up stream, per arrival the poses, new pairs, correspondences in the
   solve, LM trials, seconds and both kernels' launches; one B1 launch per
   arriving frame and one B2 launch per pair matched (``match_perpair_pairs``),
   the poses finite after every arrival, the final ATE below DR and within
   ``0.1 * max(ATE_DR, 1)`` of a batch run of the same keyframes with
   ``rematch_iters=0``;
10. online windows: the 12000-pose annotation survey streamed two-stage with
    ``window_frames=4`` and the 4200-pose full-BA survey with
    ``window_frames=3`` (per arrival seconds, window poses, loop closures in
    the solve; poses finite and counted);
11. checkpoint: the 4200-pose full-BA problem solved by
    ``solve_full_ba_checkpointed`` in chunks of 5 trials, and again resumed
    from the snapshot of its first chunk, both within 1e-3 m ATE of the
    one-shot solve, the resumed run paying only the remaining trials; the
    ``determinism_report`` of two one-shot solves (printed: segment sums by
    ``index_add_`` add with atomics on the card);
12. the orb and geo_patch descriptor families on the detected 3000-pose
    survey with the CLI's settings: warm-up, then a counted pass (one B1
    launch per frame, matches per pair, ``ate_est <= ate_dr + 1e-2``).

Before the last line it prints the ``kernels`` JSON line (launches from the
online automatic stream, per phase beside; times, device times and bounds
measured here) and the
card's name and power limit.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
There is no CPU path: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SURVEY = dict(n_lines=5, n_pings=600, n_bins=512, n_landmarks=60)
AUTO_SURVEY = dict(n_lines=3, n_pings=400, n_bins=512, n_landmarks=200, n_tie_lines=1, drift_xy=0.006, seed=7)
BA_SURVEY = dict(n_lines=5, n_tie_lines=2, n_landmarks=300)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (an FMA counts as two)
FP32_INSTR_PER_S = FP32_FLOPS / 2  # float32 instructions that are not FMAs (min, max, compare)
SPIN_CYCLES_PER_S = 2e9  # torch.cuda._sleep's cycles per second, about the H100's highest clock
B1_INSTR_PER_PIXEL = 160  # fast9.cu: 16 differences, 88 + 32 arc min/max, 4 score and thresholds, 18 NMS
QCORR_TOL = 2e-5  # fused multiply-adds against the plain version's separate roundings
B1_LARGE = (4992, 1280)  # a long waterfall as one level
# (K, T) of the random windows: round 0, the 8-cell re-match round, one pair of the online stream
QCORR_RANDOM = ((12000, 43), (12000, 19), (2000, 43))
MAX_LC_MARGINALS = 1024  # loop-closure factors of the marginals envelope: the direct step's limit
PCG_ATE_GATE = {"two_stage": ("abs", 1e-2), "full_ba": ("rel", 0.05)}  # a PCG pass against the direct pass
ONLINE_WINDOWS = {"two_stage": 4, "full_ba": 3}  # fixed-lag windows (lines) of the streamed 12k and 4.2k surveys
CKPT_CHUNK = 5  # LM trials per checkpointed chunk


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


def queued_ms(fn, reps: int) -> float:
    """The device time of one call of ``fn`` from CUDA events around
    ``reps`` calls enqueued while the device spins (``torch.cuda._sleep``):
    every call reaches the queue before the device is free, so the device
    runs the kernels back to back and the events time them, not the host's
    calls.  The spin starts at twice the host's time for the calls and
    doubles until it outlasts their enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    for _ in range(4):
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record()
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if before.elapsed_time(start) > enqueue_ms:
            return start.elapsed_time(end) / reps
        spin_s *= 2
    raise AssertionError(f"the device spin never outlasted the enqueue of {reps} calls ({enqueue_ms:.3f} ms)")


def kernel_device_ms(fn, reps: int, name: str):
    """The device time of one launch of the kernel whose name contains
    ``name`` and what read it: ``torch.profiler`` over ``reps`` back-to-back
    calls of ``fn`` (after one warm-up call), the kernel alone without the
    host's call overhead that CUDA events around the calls also see.  The
    profiler on the card sometimes records no kernel at all (only runtime
    calls), so it is asked twice, and if both miss the launches the time is
    :func:`queued_ms`'s."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in evs)
        # the profiler may drop a launch at the edge of its window; the mean over those it saw stands
        if reps // 2 <= count <= reps:
            return sum(dev_us(e) for e in evs) / count / 1e3, "profiler"
        print(f"[profiler] saw {count} launches of {name} in {reps} calls: "
              f"{[e.key for e in prof.key_averages()][:8]}")
    return queued_ms(fn, reps), "queued events"


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = FP32_FLOPS):
    """The least time the card could take: bytes over the memory rate or
    float32 operations over their rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
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
    (max_err, ms, device_ms, device_ms_by, plain_ms, bound_ms, bound_by) for one frame of the
    automatic path (its 400x512 waterfall pyramid)."""
    from diasss_tpu_torch.config import DetectorConfig
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.features.fast import fast_two_threshold_plain
    from diasss_tpu_torch.features.pyramid import build_pyramid
    from diasss_tpu_torch.frame import normalize_sss
    from diasss_tpu_torch.synthetic import make_survey

    dcfg = DetectorConfig()
    ini_t, min_t = float(dcfg.ini_fast_threshold), float(dcfg.min_fast_threshold)
    rng = np.random.default_rng(0)

    def normalized(survey_kw):
        wf = make_survey(**{**survey_kw, "n_lines": 1, "n_tie_lines": 0}).lines[0].image
        return normalize_sss(torch.as_tensor(wf, dtype=torch.float32, device=dev)).float()

    def pyramid(img):
        return [l.contiguous() for l in build_pyramid(img, dcfg.n_levels, dcfg.scale_factor)]

    frames = [("detected 600x512 pyramid", normalized(SURVEY)), ("automatic 400x512 pyramid", normalized(AUTO_SURVEY))]
    cases = [("waterfall", label, pyramid(img)) for label, img in frames]
    cases.append(("waterfall", "x".join(map(str, B1_LARGE)),
                  [normalized(dict(n_pings=B1_LARGE[0], n_bins=B1_LARGE[1], n_landmarks=60))]))
    for _, label, levels in list(cases):
        cases.append(("uniform", label, [torch.as_tensor(rng.uniform(0, 255, tuple(l.shape)), dtype=torch.float32,
                                                         device=dev) for l in levels]))
    max_err = 0.0
    main = None
    print(f"[B1] thresholds {ini_t:g}/{min_t:g}; times per launch (one launch per row: all its levels, both "
          f"thresholds); bound: 12 B and {B1_INSTR_PER_PIXEL} instructions per pixel")
    print("[B1] image     levels                       pixels  event_ms  device_ms  queued_ms  plain_ms  bound_ms  "
          "corners(hi/lo)  max_abs_err")
    for kind, label, levels in cases:
        out = fast_cuda.fast9_two_threshold(levels, ini_t, min_t)
        ref = fast_two_threshold_plain(levels, ini_t, min_t)
        torch.cuda.synchronize()
        err = 0.0
        for lvl, ((hi, lo), (hi0, lo0)) in enumerate(zip(out, ref)):
            e = max(float((hi - hi0).abs().max()), float((lo - lo0).abs().max()))
            check(e == 0.0 and torch.equal(hi, hi0) and torch.equal(lo, lo0),
                  f"FAST-9 kernel differs from the plain version: {kind} {label} level {lvl} err={e}")
            err = max(err, e)
        n_hi = sum(int((hi > 0).sum()) for hi, _ in out)
        n_lo = sum(int((lo > 0).sum()) for _, lo in out)
        check(n_lo >= n_hi > 0, f"corners: {kind} {label} hi {n_hi} lo {n_lo}")
        ms = cuda_time_ms(lambda: fast_cuda.fast9_two_threshold(levels, ini_t, min_t), reps=50)
        dev_ms, dev_by = kernel_device_ms(lambda: fast_cuda.fast9_two_threshold(levels, ini_t, min_t), 50,
                                          "fast9_two_threshold_kernel")
        q_ms = queued_ms(lambda: fast_cuda.fast9_two_threshold(levels, ini_t, min_t), 50)
        plain_ms = cuda_time_ms(lambda: fast_two_threshold_plain(levels, ini_t, min_t), reps=3, warmup=1)
        px = sum(l.numel() for l in levels)
        bnd, by = bound_ms(12.0 * px, float(B1_INSTR_PER_PIXEL) * px, FP32_INSTR_PER_S)
        max_err = max(max_err, err)
        print(f"[B1] {kind:9s} {label:26s} {px:9d} {ms:9.4f} {dev_ms:10.4f} {q_ms:10.4f} {plain_ms:9.3f} "
              f"{bnd:9.5f}  {n_hi:7d}/{n_lo:<7d} {err}  ({by}-bound, device time ({dev_by}) at "
              f"{100 * bnd / dev_ms:.1f}% of it)")
        if kind == "waterfall" and label.startswith("automatic"):
            main = (ms, dev_ms, dev_by, plain_ms, bnd, by)
    return (max_err,) + main


def profiled(label, fn, wall_unprofiled):
    """Run ``fn`` once under ``torch.profiler`` (device activity only) and
    print the kernels' device time over the profiled wall (a lower bound on
    the busy share: the profiler's start-up is in that wall) and over the
    unprofiled pass's wall, the kernel count and the kernels that take the
    most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # the profiler on the card sometimes records runtime calls only
        print(f"[{label} profiled] wall {wall:.3f} s (profiler on): the profiler recorded no kernel, "
              f"device busy not measured")
        return
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


def qcorr_phase(dev, recorded, correlate_args):
    """B2 against its plain version on random and recorded windows, and
    ``_correlate``'s best offsets from both on the recorded round-0 inputs;
    returns (max_err, ms, device_ms, device_ms_by, plain_ms, library_ms,
    bound_ms, bound_by) on the recorded round-0 windows."""
    import torch.nn.functional as F

    from diasss_tpu_torch.matching import dense, dense_cuda
    from diasss_tpu_torch.matching.dense import qcorr_plain

    def conv_inputs(Wvh, Wh, q, k):
        """The depthwise convolution's input (1, 2K, S, S) and weight (2K, 1, k, k)."""
        return torch.cat([Wvh, Wh])[None], q.reshape(-1, 1, k, k).repeat(2, 1, 1, 1)

    rng = np.random.default_rng(1)
    cases = []
    for K, T in QCORR_RANDOM:
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
    print("[B2] windows                K      S   T  event_ms  device_ms  queued_ms  plain_ms  conv2d_ms  bound_ms  "
          "max_abs_err  conv2d_err")
    for label, Wvh, Wh, q, k, T in cases:
        K, S = Wvh.shape[0], Wvh.shape[1]
        A, B = dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T)
        A0, B0 = qcorr_plain(Wvh, Wh, q, k, T)
        torch.cuda.synchronize()
        err = max(float((A - A0).abs().max()), float((B - B0).abs().max()))
        check(err <= QCORR_TOL, f"q-correlation kernel differs from the plain version: {label} err={err}")
        x, w = conv_inputs(Wvh, Wh, q, k)
        conv_err = float((F.conv2d(x, w, groups=2 * K)[0] - torch.cat([A0, B0])).abs().max())
        ms = cuda_time_ms(lambda: dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T), reps=20)
        dev_ms, dev_by = kernel_device_ms(lambda: dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T), 20, "qcorr_kernel")
        q_ms = queued_ms(lambda: dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T), 20)
        plain_ms = cuda_time_ms(lambda: qcorr_plain(Wvh, Wh, q, k, T), reps=2, warmup=1)
        lib_ms = cuda_time_ms(lambda: F.conv2d(x, w, groups=2 * K), reps=20)
        bnd, by = qcorr_bound(K, S, k, T)
        max_err = max(max_err, err)
        print(f"[B2] {label:20s} {K:6d} {S:4d} {T:3d} {ms:9.4f} {dev_ms:10.4f} {q_ms:10.4f} {plain_ms:9.3f} "
              f"{lib_ms:10.4f} {bnd:9.4f}  {err:11.3g}  {conv_err:.3g} ({by}-bound, device time ({dev_by}) at "
              f"{100 * bnd / dev_ms:.1f}% of it)")
        if label.startswith("auto round 0"):
            main = (ms, dev_ms, dev_by, plain_ms, lib_ms, bnd, by)
        del x, w

    # the round-0 search from the kernel's maps and from the plain version's
    args, kwargs = correlate_args[0]
    kernel_entry = dense.qcorr
    ours = dense._correlate(*args, **kwargs)
    dense.qcorr = qcorr_plain
    try:
        ref = dense._correlate(*args, **kwargs)
    finally:
        dense.qcorr = kernel_entry
    valid = args[1]  # ok_q: keypoints with a usable patch
    same = (ours.tgt_geo == ref.tgt_geo).all(-1)[valid]
    share = float(same.float().mean())
    check(int(valid.sum()) > 0 and share >= 0.99,
          f"round 0: best offsets from the kernel's maps agree with the plain version's on {share:.4f} of "
          f"{int(valid.sum())} valid keypoints")
    print(f"[B2] round 0 _correlate: best offsets identical for {int(same.sum())} of {int(valid.sum())} valid "
          f"keypoints ({100 * share:.3f}%), accepted {int(ours.ok.sum())} (kernel) / {int(ref.ok.sum())} (plain)")
    return (max_err,) + main


def auto_run(frames, cfg, gt, record=None, record_correlate=None):
    """One automatic-profile pass over keyframes on the card; ``record``
    collects the inputs the matcher hands the q-correlation in each round,
    ``record_correlate`` those of the dense correlation."""
    from diasss_tpu_torch.matching import dense
    from diasss_tpu_torch.pipeline import run_slam

    if record is None:
        return run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    qcorr_entry, correlate_entry = dense.qcorr, dense._correlate

    def recording(Wvh, Wh, q, k, T):
        record.append((Wvh, Wh, q, k, T))
        return qcorr_entry(Wvh, Wh, q, k, T)

    def recording_correlate(*args, **kwargs):
        record_correlate.append((args, kwargs))
        return correlate_entry(*args, **kwargs)

    dense.qcorr, dense._correlate = recording, recording_correlate
    try:
        return run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    finally:
        dense.qcorr, dense._correlate = qcorr_entry, correlate_entry


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
    check(fast_n == len(result.frame_slices),
          f"FAST kernel launched {fast_n} times, expected one per frame: {len(result.frame_slices)}")
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
    check(launches == len(frames), f"FAST kernel launched {launches} times, expected one per frame: {len(frames)}")
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


@contextlib.contextmanager
def solver_infos():
    """Collect the SolveInfo / BAInfo of every global solve run inside."""
    from diasss_tpu_torch.solvers import full_ba, pose_graph

    infos = []
    pg_entry, ba_entry = pose_graph.solve_pose_graph, full_ba.solve_full_ba

    def pg(*args, **kwargs):
        out = pg_entry(*args, **kwargs)
        infos.append(out[-1])
        return out

    def ba(*args, **kwargs):
        out = ba_entry(*args, **kwargs)
        infos.append(out[-1])
        return out

    pose_graph.solve_pose_graph, full_ba.solve_full_ba = pg, ba
    try:
        yield infos
    finally:
        pose_graph.solve_pose_graph, full_ba.solve_full_ba = pg_entry, ba_entry


def sigma_summary(result, label) -> str:
    """Checks the pose sigmas (finite, zero at the gauge pose, positive
    elsewhere) and describes them: the mean over poses 1.. and the largest
    horizontal sigma, as the CLI's metrics report them."""
    sig = result.pose_sigmas
    check(sig is not None and sig.shape == (int(result.poses.t.shape[0]), 6), f"{label}: no pose sigmas")
    check(bool(np.isfinite(sig).all()), f"{label}: non-finite pose sigmas")
    check(bool((sig[0] == 0).all()) and bool((sig[1:] > 0).all()),
          f"{label}: sigmas not zero at the gauge pose and positive elsewhere")
    mean = sig[1:].mean(axis=0)
    max_xy = float(np.sqrt(sig[1:, 3] ** 2 + sig[1:, 4] ** 2).max())
    return (f"pose_marginals {result.timings['pose_marginals']:.4f} s, sigma mean (r p y x y z) "
            f"{' '.join(f'{v:.4g}' for v in mean)}, largest xy sigma {max_xy:.4g} m")


def timed_pass(frames, cfg, gt, label, card):
    """One timed ``run_slam`` pass on keyframes already on the card, with
    the peak device memory and every global solve's info; returns
    (result, wall, peak bytes, infos)."""
    from diasss_tpu_torch.pipeline import run_slam

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with solver_infos() as infos:
        t0 = time.perf_counter()
        result = run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pings = int(result.poses.t.shape[0])
    check_poses(result, f"{label} {pings}")
    check(result.ate_est < result.ate_dr,
          f"{label} {pings}: no improvement over dead reckoning ({result.ate_est} >= {result.ate_dr})")
    solve_s = result.timings.get("pose_graph", 0.0) + result.timings.get("full_ba", 0.0)
    print(f"[{label} {pings}] pairs {len(result.pair_ids)}, n_lc_accepted {result.n_lc_accepted}, "
          f"ATE DR/EST {result.ate_dr:.4f}/{result.ate_est:.4f} m, wall {wall:.3f} s, "
          f"{pings / wall:.1f} pings/s, solve {solve_s:.4f} s ({'+'.join(i.solver_kind for i in infos)}: "
          f"LM trials {[i.iterations for i in infos]}, CG iterations {[i.cg_iters_total for i in infos]}), "
          f"peak device memory {peak / 2**20:.1f} MiB on {card}")
    print(f"[{label} {pings}] timings {json.dumps({k: round(v, 4) for k, v in result.timings.items()})} "
          f"counters {json.dumps(result.counters)} solve_capped {result.solve_capped}")
    if result.pose_sigmas is not None:
        print(f"[{label} {pings}] {sigma_summary(result, label)}, peak device memory {peak / 2**20:.1f} MiB")
    return result, wall, peak, infos


def annotation_phase(dev, card, survey_kw, cfg, label, profile=False, variants=()):
    """An annotation cell: warm-up, the timed pass (profiled once more if
    ``profile``), then one pass of each ``(label, cfg)`` variant on the same
    survey.  A variant with another preconditioner is a PCG pass, gated
    against the timed pass's ATE."""
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.synthetic import make_survey

    survey = make_survey(**survey_kw)
    gt = [l.gt_poses for l in survey.lines]
    run_slam(build_frames(survey, dev), cfg, gt_rows_list=gt, run_eval2=False)  # warm-up
    frames = build_frames(survey, dev)
    result, wall, _, _ = timed_pass(frames, cfg, gt, label, card)
    if profile:
        frames = build_frames(survey, dev)
        profiled(f"{label} {int(result.poses.t.shape[0])}",
                 lambda: run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False), wall)
    for v_label, v_cfg in variants:
        frames = build_frames(survey, dev)
        res, _, _, infos = timed_pass(frames, v_cfg, gt, v_label, card)
        solver = v_cfg.full_ba if v_cfg.estimator == "full_ba" else v_cfg.pose_graph
        if solver.preconditioner != "auto":
            check(all(i.solver_kind == solver.preconditioner and i.cg_iters_total > 0 for i in infos),
                  f"{v_label}: solves {[(i.solver_kind, i.cg_iters_total) for i in infos]}")
            how, tol = PCG_ATE_GATE[v_cfg.estimator]
            gap = abs(res.ate_est - result.ate_est)
            check(gap <= (tol * result.ate_est if how == "rel" else tol),
                  f"{v_label}: ATE {res.ate_est} against the direct pass's {result.ate_est}")
            print(f"[{v_label}] ATE {res.ate_est:.4f} m beside the direct pass's {result.ate_est:.4f} m "
                  f"(gap {gap:.2e} m, gate {tol:g}{' relative' if how == 'rel' else ' m'})")
    return survey, result


def marginals_envelope(dev, survey, poses, card, n_lc=MAX_LC_MARGINALS):
    """``pg_pose_marginals`` at the solved poses of a survey's chain with
    ``n_lc`` loop-closure factors (the direct step's limit) measured from
    those poses between pings 100-199 apart: seconds and peak memory of the
    (6L, 6P) buffers at their largest."""
    from diasss_tpu_torch.geometry import se3
    from diasss_tpu_torch.solvers import pose_graph

    P = int(poses.t.shape[0])
    rng = np.random.default_rng(0)
    i = rng.integers(1, P - 200, n_lc)
    j = i + rng.integers(100, 200, n_lc)
    meas = se3.between(poses[torch.as_tensor(i, device=dev)], poses[torch.as_tensor(j, device=dev)])
    graph = pose_graph.build_chain_graph([l.dr_poses for l in survey.lines], i, j, meas,
                                         np.full((n_lc, 6), 0.05, np.float32), np.ones(n_lc, bool), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cov = pose_graph.pg_pose_marginals(graph, poses)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    var = torch.diagonal(cov, dim1=1, dim2=2)
    check(bool(torch.isfinite(cov).all()) and bool((cov[0] == 0).all()) and bool((var[1:] > 0).all()),
          f"marginals envelope: covariances not finite, or not zero at the gauge pose and positive elsewhere")
    buf = 6 * n_lc * 6 * P * cov.element_size()
    print(f"[marginals envelope {P}] L={n_lc} loop closures: pg_pose_marginals {seconds:.4f} s, peak device "
          f"memory above its inputs {peak / 2**20:.1f} MiB (one (6L, 6P) {cov.dtype} buffer: {buf / 2**20:.1f} MiB) "
          f"on {card}")


def auto_marginals_phase(dev, survey, cfg, gt, card):
    """The automatic profile with the pose marginals on, the kernels'
    launches counted around it, and the estimated-pose mosaic of its
    result written to a temporary file; returns (B1 launches, B2 launches)."""
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.matching import dense_cuda
    from diasss_tpu_torch.mosaic import build_mosaic, save_mosaic_png
    from diasss_tpu_torch.pipeline import _estimated_geo

    frames = build_frames(survey, dev)
    fast_cuda.launches = dense_cuda.launches = 0
    result, _, _, _ = timed_pass(frames, cfg, gt, "auto marginals", card)
    fast_n, qcorr_n = fast_cuda.launches, dense_cuda.launches
    rounds = result.counters["match_stacked_pairs"] // len(result.pair_ids)
    check(qcorr_n == rounds, f"auto marginals: q-correlation kernel launched {qcorr_n} times for {rounds} rounds")
    check(fast_n == len(frames), f"auto marginals: FAST kernel launched {fast_n} times for {len(frames)} frames")
    print(f"[auto marginals] FAST launches {fast_n}, q-correlation launches {qcorr_n}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.png")
        mosaic, x0, y0, res = build_mosaic(frames, geo_list=_estimated_geo(frames, result.poses))
        save_mosaic_png(path, mosaic)
        seconds = time.perf_counter() - t0
        size = os.path.getsize(path)
    finite = np.isfinite(mosaic)
    check(bool(finite.any()) and float(mosaic[finite].min()) >= 0 and float(mosaic[finite].max()) <= 255,
          "mosaic: no finite pixel, or pixels outside [0, 255]")
    print(f"[mosaic] {mosaic.shape[0]}x{mosaic.shape[1]} cells of {res} m from ({x0:.2f}, {y0:.2f}), "
          f"{100 * float(finite.mean()):.1f}% with data, PNG {size} bytes, {seconds:.3f} s")
    return fast_n, qcorr_n


def ate_of(frames, poses, gt):
    """(ATE DR, ATE of ``poses``) against the survey's ground truth."""
    from diasss_tpu_torch.evaluate import trajectory_ate_pair

    return trajectory_ate_pair(torch.cat([f.dr_poses[:, 3:6] for f in frames]), poses, np.concatenate(gt))


def stream(slam, frames, label, card, log=True):
    """Feed ``frames`` to ``slam`` one at a time; after each arrival check
    the poses (finite, one frame more) and, with ``log``, print the poses in
    the solve window, the new gated pairs and those matched, loop closures
    or correspondences in the solve, LM trials, seconds and both kernels'
    launches.  Returns the final poses."""
    from diasss_tpu_torch.diagnostics import check_finite
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.matching import dense_cuda
    from diasss_tpu_torch.pipeline import _overlap_pairs

    sizes = [int(f.dr_poses.shape[0]) for f in frames]
    bboxes = {}
    for k, f in enumerate(frames):
        b1, b2 = fast_cuda.launches, dense_cuda.launches
        pairs = slam.counters.get("match_perpair_pairs", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = slam.add_frame(f)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        bad = check_finite(poses, f"{label} arrival {k}")
        total = sum(sizes[:k + 1])
        check(bad == [] and int(poses.t.shape[0]) == total, f"{label} arrival {k}: {bad}, {poses.t.shape[0]} poses")
        if log:
            window = sum(sizes[max(0, k + 1 - (slam.window_frames or k + 1)):k + 1])
            new_pairs = sum(k in p for p in _overlap_pairs(frames[:k + 1], slam.cfg.min_overlap, cache=bboxes))
            print(f"[{label}] arrival {k}: {total} poses, {window} in the window, new pairs {new_pairs} (matched "
                  f"{slam.counters.get('match_perpair_pairs', 0) - pairs}), {slam.state.n_lc} in the solve, "
                  f"LM trials {slam._last_info.iterations}, {seconds:.3f} s, B1 launches {fast_cuda.launches - b1}, "
                  f"B2 launches {dense_cuda.launches - b2} on {card}")
    return poses


def online_auto_phase(dev, survey, cfg, gt, card):
    """The automatic profile streamed (this slice's main path): one warm-up
    stream, then the counted one; returns (B1 launches, B2 launches)."""
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.matching import dense_cuda
    from diasss_tpu_torch.online import OnlineSlam
    from diasss_tpu_torch.pipeline import run_slam

    stream(OnlineSlam(cfg, device=dev), build_frames(survey, dev), "online auto warm-up", card, log=False)
    frames = build_frames(survey, dev)
    slam = OnlineSlam(cfg, device=dev)
    torch.cuda.synchronize()
    fast_cuda.launches = dense_cuda.launches = 0
    t0 = time.perf_counter()
    poses = stream(slam, frames, "online auto", card)
    wall = time.perf_counter() - t0
    fast_n, qcorr_n = fast_cuda.launches, dense_cuda.launches
    pairs = slam.counters.get("match_perpair_pairs", 0)
    check(fast_n == len(frames), f"online auto: FAST kernel launched {fast_n} times for {len(frames)} arrivals")
    check(qcorr_n == pairs > 0, f"online auto: q-correlation kernel launched {qcorr_n} times for {pairs} pairs")
    ate_dr, ate_online = ate_of(frames, poses, gt)
    batch = run_slam(frames, dataclasses.replace(cfg, rematch_iters=0), gt_rows_list=gt, run_eval2=False)
    gap = abs(ate_online - batch.ate_est)
    print(f"[online auto] {int(poses.t.shape[0])} poses in {wall:.3f} s over {len(frames)} arrivals; ATE DR/online "
          f"{ate_dr:.4f}/{ate_online:.4f} m, batch (rematch_iters=0) {batch.ate_est:.4f} m, gap {gap:.4f} m (bound "
          f"{0.1 * max(ate_dr, 1.0):.4f}); FAST launches {fast_n}, q-correlation launches {qcorr_n} for {pairs} "
          f"pairs on {card}")
    check(ate_online < ate_dr, f"online auto: no improvement ({ate_online} >= {ate_dr})")
    check(gap < 0.1 * max(ate_dr, 1.0), f"online auto: ATE {ate_online} against the batch run's {batch.ate_est}")
    return fast_n, qcorr_n


def online_window_phase(dev, card, survey_kw, cfg, window, label):
    """A survey streamed with a fixed-lag window (per arrival: seconds,
    window poses, loop closures in the solve); returns the final ATE pair."""
    from diasss_tpu_torch.online import OnlineSlam
    from diasss_tpu_torch.synthetic import make_survey

    survey = make_survey(**survey_kw)
    frames = build_frames(survey, dev)
    t0 = time.perf_counter()
    poses = stream(OnlineSlam(cfg, window_frames=window, device=dev), frames, label, card)
    wall = time.perf_counter() - t0
    ate_dr, ate_est = ate_of(frames, poses, [l.gt_poses for l in survey.lines])
    print(f"[{label}] {int(poses.t.shape[0])} poses, {len(frames)} arrivals in {wall:.3f} s, window {window} lines, "
          f"ATE DR/EST {ate_dr:.4f}/{ate_est:.4f} m on {card}")


def checkpoint_phase(dev, card):
    """The 4200-pose full-BA problem: one-shot, chunked, and resumed from the
    snapshot of the first chunk; then the determinism report of two
    one-shot solves."""
    from diasss_tpu_torch import checkpoint
    from diasss_tpu_torch.config import PipelineConfig
    from diasss_tpu_torch.diagnostics import determinism_report
    from diasss_tpu_torch.pipeline import _assemble_pairs, _overlap_pairs
    from diasss_tpu_torch.solvers import full_ba
    from diasss_tpu_torch.synthetic import make_survey

    survey = make_survey(**BA_SURVEY)
    gt = [l.gt_poses for l in survey.lines]
    frames = build_frames(survey, dev)
    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba")
    pairs = _overlap_pairs(frames, cfg.min_overlap)
    prob = full_ba.build_ba_problem(frames, _assemble_pairs(frames, None, pairs, cfg, True)[0], pairs, cfg.full_ba,
                                    cfg.pose_graph)

    def solve():
        return full_ba.solve_full_ba(prob, cfg.full_ba, cfg.kp_noise)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, _, ref_info = solve()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    _, ate_ref = ate_of(frames, ref, gt)
    save = checkpoint.save_solver_state
    trials = []  # trials done at each snapshot

    def counted(path, poses, lam, iterations, *args, **kwargs):
        trials.append(iterations)
        save(path, poses, lam, iterations, *args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ba_ckpt.npz")
        checkpoint.save_solver_state = counted
        t0 = time.perf_counter()
        try:
            poses, _, info = checkpoint.solve_full_ba_checkpointed(prob, cfg.full_ba, cfg.kp_noise, path,
                                                                   chunk=CKPT_CHUNK)
        finally:
            checkpoint.save_solver_state = save
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        chunked_trials = trials[-1]
        _, ate_chunked = ate_of(frames, poses, gt)

        def killed(*args, **kwargs):
            save(*args, **kwargs)
            raise KeyboardInterrupt("a kill after the first snapshot")

        checkpoint.save_solver_state = killed
        try:
            checkpoint.solve_full_ba_checkpointed(prob, cfg.full_ba, cfg.kp_noise, path, chunk=CKPT_CHUNK)
        except KeyboardInterrupt:
            pass
        finally:
            checkpoint.save_solver_state = save
        first = checkpoint.load_solver_state(path, dev)["iterations"]
        trials.clear()
        checkpoint.save_solver_state = counted
        t0 = time.perf_counter()
        try:
            resumed, _, _ = checkpoint.solve_full_ba_checkpointed(prob, cfg.full_ba, cfg.kp_noise, path,
                                                                  chunk=CKPT_CHUNK)
        finally:
            checkpoint.save_solver_state = save
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        _, ate_resumed = ate_of(frames, resumed, gt)
        check(not os.path.exists(path), "checkpoint: the snapshot outlived the finished solve")
    # the trial count a snapshot carries is the total since the start: the
    # resumed run's snapshots continue from the first one's count
    resumed_total = trials[-1] if trials else first
    print(f"[checkpoint] full BA {int(ref.t.shape[0])} poses: one-shot {ref_info.iterations} trials {one_s:.3f} s ATE "
          f"{ate_ref:.4f} m; chunks of {CKPT_CHUNK}: {chunked_trials} trials ({info.iterations} in the last chunk), "
          f"{chunked_s:.3f} s, ATE {ate_chunked:.4f} m; resumed after {first} trials: {resumed_total - first} more "
          f"trials ({resumed_total} in all), {resumed_s:.3f} s, ATE {ate_resumed:.4f} m on {card}")
    check(first == CKPT_CHUNK, f"checkpoint: the first snapshot holds {first} trials")
    check(abs(ate_chunked - ate_ref) < 1e-3 and abs(ate_resumed - ate_ref) < 1e-3,
          f"checkpoint: ATE one-shot {ate_ref}, chunked {ate_chunked}, resumed {ate_resumed}")
    check(all(n > first for n in trials) and resumed_total <= cfg.full_ba.max_iters,
          f"checkpoint: the resumed run's snapshots hold {trials} trials after a first snapshot of {first}")
    report = determinism_report(lambda: solve()[0])
    print(f"[checkpoint] determinism_report of two one-shot full-BA solves on {card}: {report}")


def descriptor_phase(dev, card, descriptor):
    """The detected two-stage path with the CLI's settings for ``descriptor``
    on the 5-line survey: warm-up, then a counted pass; returns the B1
    launches."""
    from diasss_tpu_torch.config import PipelineConfig, detected_config
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.synthetic import make_survey

    survey = make_survey(**SURVEY)
    cfg = detected_config(PipelineConfig(), descriptor)
    gt = [l.gt_poses for l in survey.lines]
    run_slam(build_frames(survey, dev), cfg, gt_rows_list=gt, run_eval2=False)  # warm-up
    frames = build_frames(survey, dev)
    torch.cuda.synchronize()
    fast_cuda.launches = 0
    t0 = time.perf_counter()
    result = run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fast_cuda.launches
    check(launches == len(frames), f"{descriptor}: FAST kernel launched {launches} times for {len(frames)} frames")
    check_poses(result, descriptor)
    matches = {f"{i}-{j}": int(r.valid.sum()) for (i, j), r in result.lc_results.items()}
    print(f"[detected {descriptor}] pairs {len(result.pair_ids)}, matched keypoint pairs {matches}, n_lc_accepted "
          f"{result.n_lc_accepted}, ATE DR/EST {result.ate_dr:.4f}/{result.ate_est:.4f} m, wall {wall:.3f} s, "
          f"FAST launches {launches}, counters {json.dumps(result.counters)} on {card}")
    check(result.ate_est <= result.ate_dr + 1e-2,
          f"detected {descriptor}: estimate regressed below dead reckoning ({result.ate_est} > {result.ate_dr} + 1e-2)")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import diasss_tpu_torch  # noqa: F401  (fails outside the repository)
    from diasss_tpu_torch.config import FullBAConfig, PipelineConfig, PoseGraphConfig, automatic_config
    from diasss_tpu_torch.synthetic import make_survey

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    print(f"[card] {card}")
    dev = torch.device("cuda", 0)

    build_kernels()
    fast_err, fast_ms, fast_dev_ms, fast_dev_by, fast_plain_ms, fast_bound, fast_by = fast_phase(dev)

    auto_survey = make_survey(**AUTO_SURVEY)
    auto_cfg = automatic_config()
    auto_gt = [l.gt_poses for l in auto_survey.lines]
    recorded, correlate_args = [], []
    # warm-up, records the inputs of B2 and of the dense correlation
    auto_run(build_frames(auto_survey, dev), auto_cfg, auto_gt, record=recorded, record_correlate=correlate_args)
    check(len(recorded) >= 1 and len(correlate_args) == len(recorded),
          "the automatic warm-up pass never reached the q-correlation")
    q_err, q_ms, q_dev_ms, q_dev_by, q_plain_ms, q_lib_ms, q_bound, q_by = qcorr_phase(dev, recorded,
                                                                                      correlate_args)
    del recorded, correlate_args
    fast_auto, qcorr_auto = auto_phase(dev, auto_survey, auto_cfg, auto_gt, card)
    marg_cfg = dataclasses.replace(auto_cfg, full_ba=dataclasses.replace(auto_cfg.full_ba, marginals=True))
    fast_marg, qcorr_marg = auto_marginals_phase(dev, auto_survey, marg_cfg, auto_gt, card)

    fast_detected = detected_phase(dev)

    def pg(**kw):
        return PipelineConfig(pose_graph=PoseGraphConfig(**kw))

    def ba(**kw):
        return PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(**kw))

    annotation_phase(dev, card, {**SURVEY, "n_lines": 5}, PipelineConfig(), "anno",
                     variants=[("anno dense_seg", pg(preconditioner="dense_seg")),
                               ("anno tridiag", pg(preconditioner="tridiag"))])
    survey12k, result12k = annotation_phase(dev, card, {**SURVEY, "n_lines": 20}, PipelineConfig(), "anno",
                                            variants=[("anno marginals", pg(marginals=True))])
    marginals_envelope(dev, survey12k, result12k.poses, card)
    del survey12k, result12k
    annotation_phase(dev, card, BA_SURVEY, ba(), "full_ba anno", profile=True,
                     variants=[("full_ba anno marginals", ba(marginals=True)),
                               ("full_ba anno dense_seg", ba(preconditioner="dense_seg"))])

    fast_online, qcorr_online = online_auto_phase(dev, auto_survey, auto_cfg, auto_gt, card)
    online_window_phase(dev, card, {**SURVEY, "n_lines": 20}, PipelineConfig(), ONLINE_WINDOWS["two_stage"],
                        "online window anno")
    online_window_phase(dev, card, BA_SURVEY, PipelineConfig(min_overlap=0.1, estimator="full_ba"),
                        ONLINE_WINDOWS["full_ba"], "online window full_ba")
    checkpoint_phase(dev, card)
    fast_orb = descriptor_phase(dev, card, "orb")
    fast_geo_patch = descriptor_phase(dev, card, "geo_patch")

    print(json.dumps({"kernels": [
        {
            "name": "fast9_two_threshold",
            "route": "cuda",
            "source": "diasss_tpu_torch/csrc/fast9.cu",
            "replaces": "diasss_tpu/features/fast_pallas.py:30",
            "launches": fast_online,
            "launches_by_phase": {"auto": fast_auto, "auto_marginals": fast_marg, "detected": fast_detected,
                                  "online_auto": fast_online, "detected_orb": fast_orb,
                                  "detected_geo_patch": fast_geo_patch},
            "max_abs_err": fast_err,
            "ms": fast_ms,
            "device_ms": fast_dev_ms,
            "device_ms_by": fast_dev_by,
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
            "launches": qcorr_online,
            "launches_by_phase": {"auto": qcorr_auto, "auto_marginals": qcorr_marg, "online_auto": qcorr_online},
            "max_abs_err": q_err,
            "ms": q_ms,
            "device_ms": q_dev_ms,
            "device_ms_by": q_dev_by,
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
