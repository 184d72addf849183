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
   5-line, 3000-pose survey: warm-up, then a counted, timed pass; then
   ``detect_features(stacked=True)`` on its frames beside the per-level
   layout (milliseconds and kernels per frame, one B1 launch per frame,
   valid keypoints bit-identical, descriptors within 1e-3, B1 held to its
   plain version on each frame's pyramid);
7. the automatic profile with ``full_ba.marginals=True`` (what ``--metrics``
   runs; this slice's main path through both kernels): launch counts read
   around it, ``pose_marginals`` seconds, sigma statistics (finite, zero
   at the gauge pose, positive elsewhere), peak memory; then the
   estimated-pose mosaic of that run written to a temporary PNG; then, on
   the automatic survey, ``geo_image`` with sensor lever arms (``[geo
   lever]``: card against CPU within 5e-5 m) and the keyframes built in
   float64 (``[keyframes f64]``: geo card against CPU within 1e-9 m);
8. the annotation two-stage path at 3000 and 12000 poses, and full BA on
   annotations at 4200 poses (5 lines + 2 tie lines), the last one also
   profiled; on the same keyframes, one pass each of the PCG family beside
   the direct step (3000: ``dense_seg`` and ``tridiag``; 4200:
   ``dense_seg``; LM trials, CG iterations, solve seconds, ATE gated
   against the direct pass's) and of the exact pose marginals (12000:
   ``pose_graph.marginals``; 4200: ``full_ba.marginals``); and the
   marginals of the 12000-pose chain with 1024 loop closures, their memory
   envelope; then the JAX package's opt-in solver options, solving only on
   the graph and problem those passes built, each after a one-trial
   warm-up, beside the direct solve of the 12000-pose graph (its trials
   and ``SolveInfo.grad_norm``, finite): that graph with ``coarse_init_stride=4``, with the
   damping sweep (0.1, 1, 10; peak memory) and with ``"chain"`` beside a
   ``dense_seg`` solve, and the 4200-pose problem with ``"chain"`` beside
   the ``dense_seg`` pass;
9. online automatic (``OnlineSlam(automatic_config())``, this slice's main
   path): the automatic survey's 4 frames streamed in turn after one
   warm-up stream, per arrival the poses, new pairs, correspondences in the
   solve, LM trials, seconds and both kernels' launches; one B1 launch per
   arriving frame and one B2 launch per pair matched (``match_perpair_pairs``),
   the poses finite after every arrival, the final ATE below DR and within
   ``0.1 * max(ATE_DR, 1)`` of a batch run of the same keyframes with
   ``rematch_iters=0``;
10. online windows: the annotation survey streamed two-stage with
    ``window_frames=4`` (10 lines, 6000 poses: cut from 20 lines to leave
    the multi-device phases room in the time limit) and the 4200-pose
    full-BA survey with ``window_frames=3`` (per arrival seconds, window
    poses, loop closures in the solve; poses finite and counted);
11. checkpoint: the 4200-pose full-BA problem solved by
    ``solve_full_ba_checkpointed`` in chunks of 5 trials, and again resumed
    from the snapshot of its first chunk, both within 1e-3 m ATE of the
    one-shot solve, the resumed run paying only the remaining trials; the
    ``determinism_report`` of two one-shot solves; full BA's float32 cost
    at the one-shot stop against the same cost in float64 (as at the
    automatic profile's final stop, measured in phase 3);
12. the orb and geo_patch descriptor families on the detected 3000-pose
    survey with the CLI's settings: warm-up, then a counted pass (one B1
    launch per frame, matches per pair, ``ate_est <= ate_dr + 1e-2``);
13. surveys whose lines differ in bin count (lines cropped on both sides,
    :func:`crop_lines`): the automatic survey with line 1 at 384 of 512
    bins (warm-up, then a counted, timed pass: one B1 launch per frame at
    both widths, one B2 launch per match round, B1 bit-identical and B2
    within 2e-5 of their plain versions at these shapes, ATE below DR), the
    same survey streamed arrival by arrival, the 3000-pose annotation survey
    with lines 1 and 3 at 448 and 384 bins (two-stage) and the 4200-pose
    full-BA survey with line 1 at 384 bins;
14. the CLI in a subprocess on that mixed 3000-pose survey written to a
    temporary directory (``--device cuda --trace DIR --metrics FILE``):
    the native reader ran, the trace holds CUDA kernel events, and the
    metrics file's ATE is within 1e-3 m of an in-process run on the same
    files; then ``--mesh 2 --dist-backend gloo`` under torchrun (``python
    -m torch.distributed.run --standalone --nproc-per-node 2``, both ranks
    on the card), its metrics ATE within 1e-3 m of the same in-process run;
15. the multi-device layer (``diasss_tpu_torch/parallel``), every line
    labelled "N ranks sharing one H100 over gloo: not a scaling number":
    ``[mesh nccl]``, one NCCL rank (a spawned process) checking every
    collective against its definition on CUDA tensors, a send to itself
    included (the only NCCL run until a host with several GPUs exists);
    ``[mesh 4]``, four ranks spawned on cuda:0 over gloo, each cell held to
    the one-device run of this call: annotations 12k (direct step, its
    ``grad_norm`` finite and equal on every rank; a
    ``dense_seg`` pass held to the one-device ``dense_seg`` pass), full BA
    4.2k (direct step: poses), automatic 1.6k (the data-parallel dense
    matcher, B1 and B2 on every rank, and sequence-parallel full BA), detected
    3k through the ring (``ring_min_kps`` at the keypoint capacity, the
    exclusion radius at 0 on both sides: every NN decision equal to
    ``geo_nn_search``), elastic recovery on the 12k run's pose graph
    (ranks 2-3 out at chunk 1) with the stops of that graph on one device,
    2 and 4 ranks held to each other (ROADMAP C17: trials, the largest pose
    gap in metres and in marginal sigmas, the float32 and float64 cost at
    each stop) and the full-BA stream with a 3-line window; each with its
    wall beside the one-device wall and each rank's peak memory; and
    ``multihost_check`` in two OS processes over tcp://;
16. ``[bench]``: the port's bench (``diasss_tpu_torch.bench.main()``, what
    ``python -m diasss_tpu_torch.bench`` runs) in this process, its output
    captured and printed: its last line has exactly the keys of
    ``bench.py``'s (:data:`BENCH_KEYS`), every ``value*`` is positive, every
    ``ate_*`` finite, and ``ate_3k``, ``ate_12k``, ``ate_full_ba`` and
    ``ate_auto`` are within 1e-3 m (automatic 0.02 m) of this run's own
    ATE of the cell; ``solver_3k`` and ``solver_12k`` read ``direct``; B1
    and B2 launch three times the automatic pass's count (its warm-up and
    two timed passes).
17. ``[mission]``: the mission scripts' surveys at full size
    (``diasss_tpu_torch/scripts``), one ``run_once`` pass each, the peak
    memory reset before it: ``[mission auto b4]`` (``automatic_config()`` on
    the 20-line survey, 18 + 2 lines of 400 pings, 8000 poses, 46 pairs,
    2000 keypoint slots; its ATE printed, not gated: the reference degrades
    there too), ``[mission auto b8]`` (``drift_budget=8``, T = 51: ATE below
    DR), ``[mission anno full_ba]`` (full BA on the survey's annotations:
    ATE below DR) and ``[stress 30k]`` (``stress_bench``'s 50 lines of 600
    pings, ``PipelineConfig()``: the pose-graph solve lowers its cost and is
    not capped; its ATE printed, not gated: the reference's two-stage
    estimate falls behind DR on such surveys from about 25 lines on); per
    run the wall, stage seconds, counters, peak memory, B1 / B2 launches and
    each B2 launch's (K, T) (automatic: one B1 launch per frame, one B2
    launch and one full-BA solve per match round), and each full-BA solve's
    P, K_pad, valid correspondences, kind (gated equal to
    ``resolve_ba_solver_kind``), trials, CG iterations and seconds; each
    ``dense_seg`` solve of the b8 run solved again beside the same problem
    with ``preconditioner="direct"`` (``[mission cutover]``: seconds,
    trials, peak memory; ATE within 5%); ``[mission B2]``: the b8 run's
    round-0 launch (K = 92,000, T = 51) again, 4096 of its rows held
    against ``qcorr_plain`` (2e-5), timed beside the plain version, the
    depthwise convolution and its bound; and full BA's float32 chain solve
    against float64 on one trial at the annotation run's stop.

The repairs of this round are gated here too: the 12000-pose two-stage
solve is not capped (its float64 direct step), two automatic passes give
the same ATE bit for bit, two one-shot 4200-pose full-BA solves are
identical (``determinism_report``), the checkpoint's resumed run takes
the one-shot run's trials (the deterministic segment sums), and the
12000-pose solve stops at the same point on one device, 2 and 4 ranks
(ROADMAP C17).

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
import math
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
# the coarse-to-fine initialization against the direct solve of the same 12k graph: its LM starts near the
# optimum and takes the stall exit after two rejected trials, a little short of the direct solve's stop.  The
# JAX package does the same: on the CPU its coarse run of this graph (direct step) stops 1.89e-2 m in ATE and
# 2.3e-5 in relative error from its own direct run, the port's 1.18e-2 m and 5.6e-5 (1.4e-4 on a 450-pose graph)
COARSE_GATE = {"ate_m": 2.5e-2, "error_rel": 1e-3}
ONLINE_WINDOWS = {"two_stage": 4, "full_ba": 3}  # fixed-lag windows (lines) of the streamed 6k and 4.2k surveys
ONLINE_ANNO_LINES = 10  # the two-stage stream's lines (20 before the multi-device phases needed the time)
CKPT_CHUNK = 5  # LM trials per checkpointed chunk
# lines cropped on both sides (bins of line k lost per side): the automatic
# survey's line 1 at 384 of 512 bins, the 3000-pose survey's lines 1 and 3 at
# 448 and 384, the 4200-pose full-BA survey's line 1 at 384
MIXED_AUTO_CROPS = {1: 64}
MIXED_ANNO_CROPS = {1: 32, 3: 64}
MIXED_BA_CROPS = {1: 64}
CLI_ATE_TOL = 1e-3  # the CLI's metrics against an in-process run on the same files
# the keys of the last line of the repository's bench.py (bench.py:336-374), which the port's
# bench (diasss_tpu_torch/bench.py) prints too; the smoke test may not import bench.py
BENCH_KEYS = frozenset((
    "metric", "value", "unit", "vs_baseline", "baseline_proxy_pings_per_sec", "wall_samples_3k",
    "timings_sum_frac_3k", "ate_3k", "ate_dr_3k", "value_12k_poses", "vs_baseline_12k", "baseline_proxy_12k",
    "wall_samples_12k", "timings_sum_frac_12k", "ate_12k", "ate_dr_12k", "value_full_ba", "vs_baseline_full_ba",
    "ate_full_ba", "ate_dr_full_ba", "value_auto", "vs_baseline_auto", "baseline_proxy_auto",
    "baseline_auto_matches", "ate_auto", "ate_dr_auto", "solver_3k", "solver_12k", "solver_full_ba", "solver_auto",
    "timings_auto"))
# each bench ATE against this run's own ATE of the same cell (smoke refs key, m)
BENCH_ATE_GATES = {"ate_3k": ("anno3k", 1e-3), "ate_12k": ("anno12k", 1e-3), "ate_full_ba": ("ba4k", 1e-3),
                   "ate_auto": ("auto", 0.02)}
BENCH_AUTO_PASSES = 3  # the bench's automatic point: one warm-up and two timed passes
# the mission scripts' surveys (diasss_tpu_torch/scripts): auto_scale.mission_survey's 18 + 2 lines of 400
# pings (8000 poses), stress_bench.main's 50 lines of 600 pings (30000 poses)
MISSION = dict(n_lines=18, n_ties=2, n_pings=400)
STRESS = dict(n_lines=50, n_pings=600, n_bins=512, n_landmarks=600)
MISSION_B2_ROWS = 4096  # rows of the mission's round-0 B2 launch held against qcorr_plain (rows are independent)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def promoted(tree, dtype=torch.float64):
    """``tree`` (a tensor, None, or a NamedTuple of them) with its floating
    tensors in ``dtype``."""
    if tree is None or isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree is not None and tree.is_floating_point() else tree
    return type(tree)(*[promoted(x, dtype) for x in tree])


def pose_graph_cost_f32(poses, graph) -> float:
    """The pose graph's cost formed in float32, as the JAX package forms
    it, beside the solver's float64 ``graph_error`` (ROADMAP C17)."""
    from diasss_tpu_torch.factors.between import between_residual

    r_o = between_residual(poses[:-1], poses[1:], graph.odo_meas) / graph.odo_sigmas
    r_l = between_residual(poses[graph.lc_i], poses[graph.lc_j], graph.lc_meas) / graph.lc_sigmas
    return float(0.5 * (torch.sum(r_o * r_o) + torch.sum(r_l[graph.lc_valid] ** 2)))


@contextlib.contextmanager
def kept_ba_solves(seconds=None):
    """Collect ``(prob, cfg, kp_cfg, poses, lms, info)`` of every one-device
    full-BA solve run inside; a list ``seconds`` takes each solve's seconds
    (a device synchronise before and after it)."""
    from diasss_tpu_torch.solvers import full_ba

    kept, entry = [], full_ba.solve_full_ba

    def run(prob, cfg, kp_cfg, *args, **kwargs):
        if seconds is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = entry(prob, cfg, kp_cfg, *args, **kwargs)
        if seconds is not None:
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        kept.append((prob, cfg, kp_cfg) + tuple(out))
        return out

    full_ba.solve_full_ba = run
    try:
        yield kept
    finally:
        full_ba.solve_full_ba = entry


def ba_cost_gap(label, prob, cfg, kp_cfg, poses, lms, info, card) -> None:
    """Full BA's cost at a stop, float32 (what its accept test reads)
    against the same residuals formed in float64 from the promoted inputs,
    beside the stall rule's 1e-6 of the cost (ROADMAP C17 repaired the pose
    graph's; full BA's stays float32)."""
    from diasss_tpu_torch.solvers.full_ba import _ba_error

    e32 = float(_ba_error(poses, lms, prob, kp_cfg, cfg.huber_delta))
    e64 = float(_ba_error(promoted(poses), promoted(lms), promoted(prob), kp_cfg, cfg.huber_delta))
    check(np.isfinite(e32) and np.isfinite(e64), f"{label}: non-finite cost at the stop")
    print(f"[full_ba cost] {label}: {info.iterations} trials, float32 cost {e32:.6f} against {e64:.6f} in float64 "
          f"at the stop: gap {abs(e32 - e64):.3e} ({abs(e32 - e64) / e64:.2e} of the cost; the stall rule's "
          f"threshold 1e-6 of the cost is {1e-6 * e64:.3e}) on {card}")


def crop_lines(survey, crops):
    """The survey with ``crops[k]`` outermost bins cut from both sides of
    line ``k``: lines that differ in bin count, as lines logged at different
    range settings give.  The ground-range table (indexed by ``|col - n_bins
    // 2|``) keeps its first ``n_bins // 2 - c`` entries; annotation rows
    ``(l_self, l_other, p_self, b_self, p_other, b_other, depth)`` lose ``c``
    from the bin of a cropped line, and rows outside a cropped line go.
    (The parity tests' copy is ``tests/torch_parity_helpers.crop_lines``.)"""
    width = {l.img_id: l.image.shape[1] - 2 * crops.get(l.img_id, 0) for l in survey.lines}

    def cut(a):
        a = a.copy()
        for c_line, c_bin in ((0, 3), (1, 5)):
            a[:, c_bin] -= np.asarray([crops.get(int(i), 0) for i in a[:, c_line]], a.dtype)
        inside = np.ones(len(a), bool)
        for c_line, c_bin in ((0, 3), (1, 5)):
            w = np.asarray([width[int(i)] for i in a[:, c_line]], np.int64)
            inside &= (a[:, c_bin] >= 0) & (a[:, c_bin] < w)
        return a[inside]

    lines = []
    for l in survey.lines:
        c = crops.get(l.img_id, 0)
        n = l.image.shape[1]
        lines.append(dataclasses.replace(l, image=l.image[:, c:n - c], ground_ranges=l.ground_ranges[:n // 2 - c],
                                         annos=cut(l.annos)))
    return dataclasses.replace(survey, lines=lines)


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


def conv_inputs(Wvh, Wh, q, k):
    """B2's maps as one depthwise ``F.conv2d(x, w, groups=2K)``: its input
    (1, 2K, S, S) and weight (2K, 1, k, k)."""
    return torch.cat([Wvh, Wh])[None], q.reshape(-1, 1, k, k).repeat(2, 1, 1, 1)


def qcorr_phase(dev, recorded, correlate_args):
    """B2 against its plain version on random and recorded windows, and
    ``_correlate``'s best offsets from both on the recorded round-0 inputs;
    returns (max_err, ms, device_ms, device_ms_by, plain_ms, library_ms,
    bound_ms, bound_by) on the recorded round-0 windows."""
    import torch.nn.functional as F

    from diasss_tpu_torch.matching import dense, dense_cuda
    from diasss_tpu_torch.matching.dense import qcorr_plain

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


def auto_phase(dev, survey, cfg, gt, card, warm_ate):
    """The timed automatic pass; its ATE must equal the warm-up pass's
    ``warm_ate`` bit for bit (deterministic sums on the card)."""
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
    print(f"[auto] ATE of the warm-up pass {warm_ate!r}, of the timed pass {result.ate_est!r} m (must be equal)")
    check(result.ate_est == warm_ate, f"automatic: two passes gave the ATE {warm_ate!r} and {result.ate_est!r}")
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
    return fast_n, qcorr_n, wall


GEO_LEVER_TOL = 5e-5  # m: float32 positions of tens of metres, card against CPU
F64_GEO_TOL = 1e-9  # m: float64 geo, card against CPU
TF_STB, TF_PORT = (0.3, -0.2, 0.1), (-0.25, 0.15, 0.0)  # sensor lever arms (x, y, z) in metres


def surface_phase(dev, card, survey):
    """The keyword surface the JAX package has and the automatic path does
    not reach: ``geo_image`` with sensor lever arms on every line's DR rows
    and ground ranges (card against CPU, :data:`GEO_LEVER_TOL`; the keyframe
    builders take no lever arms, in either package) and the keyframes built
    in float64 (card against CPU: geo within :data:`F64_GEO_TOL`, poses,
    altitudes, ground ranges and raw exact; the float32 normalization and
    mask may differ where the card's frame-wide mean rounds otherwise)."""
    from diasss_tpu_torch.frame import build_keyframes_batch
    from diasss_tpu_torch.geometry import sonar

    t_phase = time.perf_counter()
    lever_err, shift_err = 0.0, 0.0
    for l in survey.lines:
        def geo(device, *levers):
            dr = torch.as_tensor(l.dr_poses, dtype=torch.float32, device=device)
            gr = torch.as_tensor(l.ground_ranges, dtype=torch.float32, device=device)
            return sonar.geo_image(dr[:, 3:5], dr[:, 2], gr, l.image.shape[1], *levers).cpu()

        card_geo, cpu_geo = geo(dev, TF_STB, TF_PORT), geo("cpu", TF_STB, TF_PORT)
        lever_err = max(lever_err, float((card_geo - cpu_geo).abs().max()))
        half = l.image.shape[1] // 2
        shift = geo(dev) - card_geo
        want = torch.tensor([TF_PORT[:2]] * half + [TF_STB[:2]] * half)
        shift_err = max(shift_err, float((shift - want).abs().max()))
    check(lever_err <= GEO_LEVER_TOL and shift_err <= GEO_LEVER_TOL,
          f"[geo lever] card against CPU {lever_err}, lever shift off by {shift_err} (gate {GEO_LEVER_TOL})")
    print(f"[geo lever] geo_image with tf_stb {TF_STB}, tf_port {TF_PORT} on {len(survey.lines)} lines of "
          f"{survey.lines[0].image.shape}: card against CPU max abs {lever_err:.3e} m, each side moved by its lever "
          f"arm within {shift_err:.3e} m (gate {GEO_LEVER_TOL:g} m) on {card}")

    items = [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_f = build_keyframes_batch(items, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cpu_f = build_keyframes_batch(items, dtype=torch.float64, device="cpu")
    geo_err, norm_off, mask_off, pixels = 0.0, 0, 0, 0
    for a, b in zip(card_f, cpu_f):
        for k in ("raw", "geo", "dr_poses", "altitudes", "ground_ranges"):
            check(getattr(a, k).dtype == torch.float64, f"[keyframes f64] {k} is {getattr(a, k).dtype}")
        for k in ("raw", "dr_poses", "altitudes", "ground_ranges"):
            check(torch.equal(getattr(a, k).cpu(), getattr(b, k)), f"[keyframes f64] {k} differs from the CPU's")
        geo_err = max(geo_err, float((a.geo.cpu() - b.geo).abs().max()))
        diff = (a.norm.cpu().to(torch.int16) - b.norm.to(torch.int16)).abs()
        check(int(diff.max()) <= 1, f"[keyframes f64] norm off by {int(diff.max())} grey levels")
        norm_off += int((diff > 0).sum())
        mask_off += int((a.mask.cpu() != b.mask).sum())
        pixels += b.mask.numel()
    check(geo_err <= F64_GEO_TOL and norm_off <= 1e-3 * pixels and mask_off <= 1e-3 * pixels,
          f"[keyframes f64] geo {geo_err} (gate {F64_GEO_TOL}), norm off on {norm_off}, mask on {mask_off} of "
          f"{pixels} pixels")
    print(f"[keyframes f64] {len(card_f)} float64 keyframes built on the card in {seconds:.4f} s: geo against the "
          f"CPU's float64 build max abs {geo_err:.3e} m (gate {F64_GEO_TOL:g} m), poses, altitudes, ground ranges and "
          f"raw equal, norm off by one on {norm_off} and mask different on {mask_off} of {pixels} pixels; both "
          f"lines {time.perf_counter() - t_phase:.3f} s on {card}")


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
    """Collect the SolveInfo / BAInfo of every global solve run inside, on
    one device or sequence-parallel."""
    from diasss_tpu_torch.parallel import seq
    from diasss_tpu_torch.solvers import full_ba, pose_graph

    infos = []
    entries = [(pose_graph, "solve_pose_graph"), (full_ba, "solve_full_ba"), (seq, "seq_pose_graph_solve"),
               (seq, "seq_full_ba_solve")]
    saved = [getattr(m, name) for m, name in entries]

    def wrap(entry):
        def run(*args, **kwargs):
            out = entry(*args, **kwargs)
            infos.append(out[-1])
            return out
        return run

    for (m, name), entry in zip(entries, saved):
        setattr(m, name, wrap(entry))
    try:
        yield infos
    finally:
        for (m, name), entry in zip(entries, saved):
            setattr(m, name, entry)


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


def timed_pass(frames, cfg, gt, label, card, improve=True):
    """One timed ``run_slam`` pass on keyframes already on the card, with
    the peak device memory and every global solve's info; returns
    (result, wall, peak bytes, infos).  The estimate must beat dead
    reckoning, or with ``improve=False`` not fall behind it by more than
    1e-2 m (a survey whose gated pairs accept no loop closure)."""
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
    if improve:
        check(result.ate_est < result.ate_dr,
              f"{label} {pings}: no improvement over dead reckoning ({result.ate_est} >= {result.ate_dr})")
    else:
        check(result.ate_est <= result.ate_dr + 1e-2,
              f"{label} {pings}: regressed below dead reckoning ({result.ate_est} > {result.ate_dr} + 1e-2)")
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


def annotation_phase(dev, card, survey_kw, cfg, label, profile=False, variants=(), crops=None, improve=True,
                     kept=None):
    """An annotation cell: warm-up, the timed pass (profiled once more if
    ``profile``), then one pass of each ``(label, cfg)`` variant on the same
    survey.  A variant with another preconditioner is a PCG pass, gated
    against the timed pass's ATE.  ``crops``: lines cut to fewer bins
    (:func:`crop_lines`); ``improve``: the timed pass's gate
    (:func:`timed_pass`); ``kept``: a dict that takes each variant's
    ``(result, infos)`` under its label."""
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.synthetic import make_survey

    survey = make_survey(**survey_kw)
    if crops:
        survey = crop_lines(survey, crops)
    gt = [l.gt_poses for l in survey.lines]
    run_slam(build_frames(survey, dev), cfg, gt_rows_list=gt, run_eval2=False)  # warm-up
    frames = build_frames(survey, dev)
    result, wall, _, _ = timed_pass(frames, cfg, gt, label, card, improve)
    result.timings["timed_pass_wall"] = wall
    if profile:
        frames = build_frames(survey, dev)
        profiled(f"{label} {int(result.poses.t.shape[0])}",
                 lambda: run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False), wall)
    for v_label, v_cfg in variants:
        frames = build_frames(survey, dev)
        res, _, _, infos = timed_pass(frames, v_cfg, gt, v_label, card)
        if kept is not None:
            kept[v_label] = (res, infos)
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


@contextlib.contextmanager
def captured(module, name):
    """Record the ``(args, kwargs)`` of every call of ``module.name`` made
    inside."""
    calls = []
    entry = getattr(module, name)

    def run(*args, **kwargs):
        calls.append((args, kwargs))
        return entry(*args, **kwargs)

    setattr(module, name, run)
    try:
        yield calls
    finally:
        setattr(module, name, entry)


def timed_solve(solve, warm):
    """``solve()`` once after ``warm()`` (a one-trial run of the same
    options: the card's libraries and allocations warmed); returns (its
    output, seconds, peak device bytes)."""
    warm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = solve()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def survey_ate(survey, poses) -> float:
    from diasss_tpu_torch.evaluate import trajectory_ate_pair

    dr_t = torch.as_tensor(np.concatenate([l.dr_poses[:, 3:6] for l in survey.lines]), dtype=torch.float32,
                           device=poses.t.device)
    return trajectory_ate_pair(dr_t, poses, np.concatenate([l.gt_poses for l in survey.lines]))[1]


def pg_options_phase(card, survey, call, direct):
    """The pose graph of the 12000-pose timed pass (``call``: the arguments
    it was solved with) solved again, solving only, under each option of the
    JAX package the default does not run: the coarse-to-fine initialization
    (stride 4), the damping sweep (factors 0.1, 1, 10) and the exact
    ``"chain"`` preconditioner, beside a direct and a ``dense_seg`` solve
    of the same graph; each after a one-trial warm-up.  Gates: each ATE
    within 1e-2 m of the direct pass's (``direct``), the coarse and sweep
    solves not capped; the coarse solve, which stops a little short of the
    direct one, as the JAX package's does, within :data:`COARSE_GATE`.  Returns the ``dense_seg`` solve's (ATE, CG
    iterations): the mesh cell's reference."""
    from diasss_tpu_torch.solvers import pose_graph

    graph, base = call[0][0], call[0][1]
    P, L = int(graph.poses0.t.shape[0]), int(graph.lc_valid.sum())

    def run(cfg):
        (poses, info), s, peak = timed_solve(
            lambda: pose_graph.solve_pose_graph(graph, cfg),
            lambda: pose_graph.solve_pose_graph(graph, dataclasses.replace(cfg, max_gn_iters=1)))
        check(bool(torch.isfinite(poses.t).all()), f"anno {P}: non-finite poses under {cfg}")
        capped = info.iterations >= cfg.max_gn_iters and info.stall == 0
        return poses, info, s, peak, survey_ate(survey, poses), capped

    def gate(label, ate, capped=False):
        check(not capped, f"[{label}] the solve stopped at its trial cap while improving")
        check(abs(ate - direct.ate_est) <= PCG_ATE_GATE["two_stage"][1],
              f"[{label}] ATE {ate} against the direct pass's {direct.ate_est}")

    _, d_info, d_s, d_peak, d_ate, _ = run(base)
    check(abs(d_ate - direct.ate_est) <= 1e-4, f"anno {P}: the direct solve alone gave ATE {d_ate!r}, the pass "
                                                f"{direct.ate_est!r}")
    d_gn = float(d_info.grad_norm)
    check(math.isfinite(d_gn), f"anno {P}: the direct solve's grad_norm is {d_gn}")
    print(f"[anno {P}] {L} loop closures; the direct solve alone: {d_info.iterations} trials, grad_norm {d_gn!r} "
          f"(last trial), {d_s:.4f} s, peak {d_peak / 2**20:.1f} MiB, ATE {d_ate!r} m (the pass: {direct.ate_est!r} "
          f"m) on {card}")

    _, info, s, peak, ate, capped = run(dataclasses.replace(base, coarse_init_stride=4))
    adopted = bool(info.error_init < info.error0)
    err_gap = abs(float(info.error) - float(d_info.error)) / float(d_info.error)
    check(not capped, f"[anno {P} coarse4] the solve stopped at its trial cap while improving")
    check(abs(ate - direct.ate_est) <= COARSE_GATE["ate_m"] and err_gap <= COARSE_GATE["error_rel"],
          f"[anno {P} coarse4] ATE {ate} against the direct pass's {direct.ate_est}, error {float(info.error)} "
          f"against the direct solve's {float(d_info.error)}")
    print(f"[anno {P} coarse4] coarse init {'adopted' if adopted else 'not adopted'}, err_init/err0 "
          f"{float(info.error_init) / float(info.error0):.4e}, {info.iterations} trials (direct {d_info.iterations}), "
          f"pose_graph {s:.4f} s (direct {d_s:.4f} s), capped {capped}, final error {float(info.error):.6f} "
          f"({err_gap:.2e} relative from the direct solve's; gate {COARSE_GATE['error_rel']:g}), ATE {ate:.4f} m "
          f"(direct pass {direct.ate_est:.4f} m; gate {COARSE_GATE['ate_m']:g} m) on {card}")

    factors = (0.1, 1.0, 10.0)
    _, info, s, peak, ate, capped = run(dataclasses.replace(base, lam_sweep_factors=factors))
    gate(f"anno {P} sweep", ate, capped)
    print(f"[anno {P} sweep] factors {factors}: {info.iterations} trials (direct {d_info.iterations}), solve "
          f"{s:.4f} s (direct {d_s:.4f} s), peak device memory {peak / 2**20:.1f} MiB (direct "
          f"{d_peak / 2**20:.1f} MiB), capped {capped}, ATE {ate:.4f} m (direct pass {direct.ate_est:.4f} m) on {card}")

    _, ds_info, ds_s, _, ds_ate, _ = run(dataclasses.replace(base, preconditioner="dense_seg"))
    gate(f"anno {P} dense_seg", ds_ate)
    _, info, s, peak, ate, _ = run(dataclasses.replace(base, preconditioner="chain"))
    check(info.solver_kind == "chain" and info.cg_iters_total > 0, f"[anno {P} chain] {info}")
    gate(f"anno {P} chain", ate)
    print(f"[anno {P} chain] {info.iterations} trials, {info.cg_iters_total} CG iterations, solve {s:.4f} s, "
          f"peak {peak / 2**20:.1f} MiB, ATE {ate:.4f} m; the dense_seg solve of the same graph: "
          f"{ds_info.iterations} trials, {ds_info.cg_iters_total} CG, {ds_s:.4f} s, ATE {ds_ate:.4f} m; direct "
          f"{d_s:.4f} s, ATE {direct.ate_est:.4f} m on {card}")
    return ds_ate, ds_info.cg_iters_total, d_gn


def ba_chain_phase(card, survey, call, direct, dense_seg):
    """The 4200-pose full-BA problem of the timed pass (``call``: the
    arguments it was solved with) solved again with the exact ``"chain"``
    preconditioner, solving only, after a one-trial warm-up; printed beside
    the same call's ``dense_seg`` pass (``dense_seg``: its result and solve
    infos) and gated, as that pass is, within 5% of the direct pass's ATE."""
    from diasss_tpu_torch.solvers import full_ba

    (prob, ba_cfg, kp_cfg), kwargs = call
    cfg = dataclasses.replace(ba_cfg, preconditioner="chain")
    (poses, _, info), s, peak = timed_solve(
        lambda: full_ba.solve_full_ba(prob, cfg, kp_cfg, **kwargs),
        lambda: full_ba.solve_full_ba(prob, dataclasses.replace(cfg, max_iters=1), kp_cfg, **kwargs))
    check(bool(torch.isfinite(poses.t).all()), "full_ba anno chain: non-finite poses")
    check(info.solver_kind == "chain" and info.cg_iters_total > 0, f"[full_ba anno chain] {info}")
    ate = survey_ate(survey, poses)
    how, tol = PCG_ATE_GATE["full_ba"]
    check(abs(ate - direct.ate_est) <= tol * direct.ate_est,
          f"[full_ba anno chain] ATE {ate} against the direct pass's {direct.ate_est}")
    res, infos = dense_seg
    print(f"[full_ba anno chain] {int(poses.t.shape[0])} poses: {info.iterations} trials, {info.cg_iters_total} CG "
          f"iterations, solve {s:.4f} s, peak {peak / 2**20:.1f} MiB, ATE {ate:.4f} m (direct pass "
          f"{direct.ate_est:.4f} m, gate {tol:g} relative); the dense_seg pass of this call: "
          f"{[i.iterations for i in infos]} trials, {[i.cg_iters_total for i in infos]} CG, solve "
          f"{res.timings['full_ba']:.4f} s, ATE {res.ate_est:.4f} m; direct {direct.timings['full_ba']:.4f} s on {card}")


def detected_stacked_phase(dev, card):
    """``detect_features(stacked=True)`` on the detected survey's frames
    beside the per-level layout the pipeline runs: after a warm-up of both,
    B1's launches per frame counted around the stacked layout, every
    launch of either layout counted by ``torch.profiler`` (when it records
    kernels), milliseconds per frame of each; valid keypoints bit-identical
    (positions, responses, angles, sizes, levels), descriptors within 1e-3;
    B1 bit-identical to its plain version on each frame's pyramid.  Returns
    (B1 launches, B1 error)."""
    from torch.profiler import ProfilerActivity, profile

    from diasss_tpu_torch.config import PipelineConfig, detected_config
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.features.detector import detect_features
    from diasss_tpu_torch.features.fast import fast_two_threshold_plain
    from diasss_tpu_torch.features.pyramid import build_pyramid
    from diasss_tpu_torch.synthetic import make_survey

    dcfg = detected_config(PipelineConfig()).detector
    frames = build_frames(make_survey(**SURVEY), dev)

    def layout(stacked):
        return [detect_features(f.norm, f.mask, dcfg, stacked=stacked) for f in frames]

    layout(True), layout(False)  # warm-up
    torch.cuda.synchronize()
    fast_cuda.launches = 0
    stacked = layout(True)
    launches = fast_cuda.launches
    check(launches == len(frames), f"detected stacked: FAST kernel launched {launches} times for {len(frames)} frames")
    per_level = layout(False)
    ms = {k: cuda_time_ms(lambda: layout(k), reps=3, warmup=0) / len(frames) for k in (True, False)}
    kernels = {}
    for k in (True, False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            layout(k)
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
        kernels[k] = f"{n / len(frames):.0f}" if n else "not recorded"
    n_valid, desc_err = 0, 0.0
    for i, (a, b) in enumerate(zip(stacked, per_level)):
        check(torch.equal(a.valid, b.valid), f"detected stacked: frame {i} valid masks differ")
        v = b.valid
        for field in ("xy", "response", "angle", "size", "level"):
            check(torch.equal(getattr(a, field)[v], getattr(b, field)[v]),
                  f"detected stacked: frame {i} {field} differs from the per-level layout")
        desc_err = max(desc_err, float((a.desc[v] - b.desc[v]).abs().max()))
        n_valid += int(v.sum())
    check(n_valid > 0 and desc_err <= 1e-3, f"detected stacked: descriptors differ by {desc_err} ({n_valid} valid)")
    ini_t, min_t = float(dcfg.ini_fast_threshold), float(dcfg.min_fast_threshold)
    b1_err = 0.0
    for i, f in enumerate(frames):
        levels = [l.contiguous() for l in build_pyramid(f.norm.float(), dcfg.n_levels, dcfg.scale_factor)]
        for lvl, ((hi, lo), (hi0, lo0)) in enumerate(zip(fast_cuda.fast9_two_threshold(levels, ini_t, min_t),
                                                          fast_two_threshold_plain(levels, ini_t, min_t))):
            e = max(float((hi - hi0).abs().max()), float((lo - lo0).abs().max()))
            check(e == 0.0, f"detected stacked: FAST-9 kernel differs from the plain version, frame {i} level {lvl}")
            b1_err = max(b1_err, e)
    print(f"[detected stacked] {len(frames)} frames of {tuple(frames[0].norm.shape)}: stacked {ms[True]:.3f} ms per "
          f"frame, per-level {ms[False]:.3f} ms; kernels per frame (profiler) stacked {kernels[True]}, per-level "
          f"{kernels[False]}; FAST launches {launches} ({launches / len(frames):g} per frame); {n_valid} valid "
          f"keypoints bit-identical, descriptors within {desc_err:.2e}; B1 max abs error {b1_err} on {card}")
    return launches, b1_err


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
    window poses, loop closures in the solve); returns the final ATE and
    the stream's wall."""
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
    return ate_est, wall


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
    ref, ref_lms, ref_info = solve()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    _, ate_ref = ate_of(frames, ref, gt)
    ba_cost_gap(f"full BA {int(ref.t.shape[0])} poses", prob, cfg.full_ba, cfg.kp_noise, ref, ref_lms, ref_info, card)
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
    check(chunked_trials == ref_info.iterations and resumed_total == ref_info.iterations,
          f"checkpoint: chunked {chunked_trials} and resumed {resumed_total} trials against the one-shot's "
          f"{ref_info.iterations}")
    report = determinism_report(lambda: solve()[0])
    print(f"[checkpoint] determinism_report of two one-shot full-BA solves on {card}: {report}")
    check(report["deterministic"] and report["max_abs_dev"] == 0.0,
          f"checkpoint: two one-shot full-BA solves differ: {report}")


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


def mixed_auto_phase(dev, card, survey, cfg, gt):
    """The automatic profile on a survey whose lines differ in bin count:
    warm-up (recording B2's inputs), then a counted, timed pass; B1 and B2
    held to their plain versions at this survey's shapes.  Returns (B1
    launches, B2 launches, B1 error, B2 error)."""
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.features.fast import fast_two_threshold_plain
    from diasss_tpu_torch.features.pyramid import build_pyramid
    from diasss_tpu_torch.matching import dense_cuda
    from diasss_tpu_torch.matching.dense import qcorr_plain

    recorded = []
    warm = auto_run(build_frames(survey, dev), cfg, gt, record=recorded, record_correlate=[])
    frames = build_frames(survey, dev)
    widths = sorted({int(f.raw.shape[1]) for f in frames})
    check(len(widths) == 2, f"mixed auto: frame widths {widths}")
    torch.cuda.synchronize()
    fast_cuda.launches = dense_cuda.launches = 0
    t0 = time.perf_counter()
    result = auto_run(frames, cfg, gt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fast_n, qcorr_n = fast_cuda.launches, dense_cuda.launches
    rounds = result.counters["match_stacked_pairs"] // len(result.pair_ids)
    check(fast_n == len(frames), f"mixed auto: FAST kernel launched {fast_n} times for {len(frames)} frames")
    check(qcorr_n == rounds > 0, f"mixed auto: q-correlation kernel launched {qcorr_n} times for {rounds} rounds")
    check_poses(result, "mixed auto")
    check(result.ate_est < result.ate_dr, f"mixed auto: no improvement ({result.ate_est} >= {result.ate_dr})")
    check(result.ate_est == warm.ate_est, f"mixed auto: two passes gave the ATE {warm.ate_est!r} and {result.ate_est!r}")

    dcfg = cfg.detector
    b1_err = 0.0
    for w in widths:
        f = next(f for f in frames if int(f.raw.shape[1]) == w)
        levels = [l.contiguous() for l in build_pyramid(f.norm.float(), dcfg.n_levels, dcfg.scale_factor)]
        ini_t, min_t = float(dcfg.ini_fast_threshold), float(dcfg.min_fast_threshold)
        out = fast_cuda.fast9_two_threshold(levels, ini_t, min_t)
        ref = fast_two_threshold_plain(levels, ini_t, min_t)
        for lvl, ((hi, lo), (hi0, lo0)) in enumerate(zip(out, ref)):
            e = max(float((hi - hi0).abs().max()), float((lo - lo0).abs().max()))
            check(e == 0.0 and torch.equal(hi, hi0) and torch.equal(lo, lo0),
                  f"mixed auto: FAST-9 kernel differs from the plain version at width {w} level {lvl}: {e}")
            b1_err = max(b1_err, e)
    b2_err = 0.0
    for Wvh, Wh, q, k, T in recorded:
        A, B = dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T)
        A0, B0 = qcorr_plain(Wvh, Wh, q, k, T)
        b2_err = max(b2_err, float((A - A0).abs().max()), float((B - B0).abs().max()))
    check(b2_err <= QCORR_TOL, f"mixed auto: q-correlation kernel differs from the plain version: {b2_err}")
    print(f"[mixed auto] widths {widths}, {int(result.poses.t.shape[0])} poses, pairs {result.pair_ids}, match rounds "
          f"{rounds}, correspondences {result.n_lc_accepted}, ATE DR/EST {result.ate_dr:.4f}/{result.ate_est:.4f} m, "
          f"wall {wall:.3f} s, FAST launches {fast_n}, q-correlation launches {qcorr_n}; B1 max abs error {b1_err} "
          f"(pyramids at widths {widths}), B2 max abs error {b2_err:.3g} on {len(recorded)} recorded rounds "
          f"(K, S, T = {[(int(r[0].shape[0]), int(r[0].shape[1]), r[4]) for r in recorded]}) on {card}")
    print(f"[mixed auto] timings {json.dumps({k: round(v, 4) for k, v in result.timings.items()})} "
          f"counters {json.dumps(result.counters)}")
    return fast_n, qcorr_n, b1_err, b2_err


def mixed_online_phase(dev, card, survey, cfg, gt):
    """The mixed automatic survey streamed arrival by arrival; returns (B1
    launches, B2 launches)."""
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.matching import dense_cuda
    from diasss_tpu_torch.online import OnlineSlam

    frames = build_frames(survey, dev)
    slam = OnlineSlam(cfg, device=dev)
    torch.cuda.synchronize()
    fast_cuda.launches = dense_cuda.launches = 0
    t0 = time.perf_counter()
    poses = stream(slam, frames, "online mixed auto", card)
    wall = time.perf_counter() - t0
    fast_n, qcorr_n = fast_cuda.launches, dense_cuda.launches
    pairs = slam.counters.get("match_perpair_pairs", 0)
    check(fast_n == len(frames), f"online mixed: FAST kernel launched {fast_n} times for {len(frames)} arrivals")
    check(qcorr_n == pairs > 0, f"online mixed: q-correlation kernel launched {qcorr_n} times for {pairs} pairs")
    ate_dr, ate_est = ate_of(frames, poses, gt)
    print(f"[online mixed auto] {int(poses.t.shape[0])} poses in {wall:.3f} s over {len(frames)} arrivals, ATE DR/EST "
          f"{ate_dr:.4f}/{ate_est:.4f} m, FAST launches {fast_n}, q-correlation launches {qcorr_n} on {card}")
    check(ate_est < ate_dr, f"online mixed: no improvement ({ate_est} >= {ate_dr})")
    return fast_n, qcorr_n


def cli_phase(dev, card, survey_kw, crops):
    """The CLI in a subprocess on a mixed survey written to files: the
    native reader ran, ``--trace`` holds CUDA kernel events, and the metrics
    file's ATE agrees with an in-process run on the same files."""
    from diasss_tpu_torch.config import PipelineConfig
    from diasss_tpu_torch.io import save_survey
    from diasss_tpu_torch.parallel.prefetch import load_keyframes_pipelined
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.synthetic import make_survey

    survey = crop_lines(make_survey(**survey_kw), crops)
    with tempfile.TemporaryDirectory() as tmp:
        folders = save_survey(survey, tmp)
        keys = ("image", "pose", "altitude", "groundrange", "annotation")
        gt_dir, trace_dir, metrics = os.path.join(tmp, "gt-poses"), os.path.join(tmp, "trace"), os.path.join(tmp, "m.json")
        args = [a for k in keys for a in (f"--{k}", folders[k])]
        cmd = [sys.executable, "-m", "diasss_tpu_torch.cli", *args, "--gt", gt_dir, "--device", "cuda", "--trace",
               trace_dir, "--metrics", metrics, "--no-eval2"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        with open(metrics) as f:
            m = json.load(f)
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        load = load_keyframes_pipelined(*[folders[k] for k in keys], device=dev)
        gt = [np.loadtxt(os.path.join(gt_dir, n)) for n in sorted(os.listdir(gt_dir))]
        ref = run_slam(load.frames, PipelineConfig(), gt_rows_list=gt, run_eval2=False)
        cli_mesh_run(card, args, gt_dir, tmp, ref.ate_est)
    lines = [l for l in proc.stdout.splitlines() if l.startswith(("loaded", "  image size", "profiler trace"))]
    print(f"[cli] {' | '.join(lines)}")
    print(f"[cli] {seconds:.3f} s as a subprocess; reader {m['reader']!r}; trace: {len(events)} events, {len(kernels)} "
          f"CUDA kernel events; metrics ATE DR/EST {m['ate_dr']:.4f}/{m['ate_est']:.4f} m, in-process "
          f"{ref.ate_est:.4f} m; loop closures {m['n_lc_accepted']}; counters {json.dumps(m['counters'])} on {card}")
    check(m["reader"] == "native", f"CLI: the native reader did not run: {m['reader']}")
    check(len(kernels) >= 1, f"CLI: the trace holds no CUDA kernel event ({len(events)} events)")
    check(abs(m["ate_est"] - ref.ate_est) <= CLI_ATE_TOL,
          f"CLI: metrics ATE {m['ate_est']} against the in-process run's {ref.ate_est}")


def cli_mesh_run(card, args, gt_dir, tmp, ref_ate):
    """``--mesh 2`` under torchrun (``python -m torch.distributed.run``),
    both ranks on cuda:0 over gloo, on the survey files ``args`` name; its
    metrics ATE against the one-device in-process run's ``ref_ate``."""
    mesh_metrics = os.path.join(tmp, "m_mesh.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m",
           "diasss_tpu_torch.cli", *args, "--gt", gt_dir, "--device", "cuda", "--mesh", "2", "--dist-backend",
           "gloo", "--metrics", mesh_metrics, "--no-eval2"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI --mesh 2 exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(mesh_metrics) as f:
        mm = json.load(f)
    rank0 = [l for l in proc.stdout.splitlines() if l.startswith(("rank 0", "SLAM solved"))]
    print(f"[cli --mesh 2] torchrun --standalone --nproc-per-node 2, {seconds:.3f} s as a subprocess: "
          f"{' | '.join(rank0)}; metrics ATE DR/EST {mm['ate_dr']:.4f}/{mm['ate_est']:.4f} m, in-process (one device) "
          f"{ref_ate:.4f} m; counters {json.dumps(mm['counters'])}; {mesh_label(2)} on {card}")
    check(abs(mm["ate_est"] - ref_ate) <= CLI_ATE_TOL and mm["counters"].get("solver_sp_direct_solves") == 1,
          f"CLI --mesh 2: metrics ATE {mm['ate_est']} against the in-process run's {ref_ate}, {mm['counters']}")


# ---------------------------------------------------------------------------
# The multi-device layer (diasss_tpu_torch/parallel): ranks started with
# spawn, all on cuda:0; the NCCL transport with one rank
# ---------------------------------------------------------------------------

MESH_N = 4
MESH_TIMEOUT_S = 600  # the whole [mesh 4] phase; every process group also times out (distributed.TIMEOUT_S)


def mesh_label(n: int) -> str:
    return f"{n} ranks sharing one H100 over gloo: not a scaling number"


MESH_LABEL = mesh_label(4)
MESH_GATES = {"anno12k": 1e-4, "anno12k_dense_seg": 1e-2, "ba4k_poses": 3e-3, "ba4k_ate_rel": 0.05, "auto": 0.02,
              "detected": 1e-2, "elastic": 1e-4, "elastic_sigma": 0.25, "elastic_error_rel": 1e-7, "online": 1e-3}
# The 12k pose graph's direct step (ROADMAP C17): its cost, linearization
# and sums are formed in float64, so one device, 2 and 4 ranks stop after
# the same trials within 1e-4 m and 1e-7 of the error of each other (on an
# H100: 3.05e-5 m, one float32 step at 256-512 m, and 4.4e-9): the mesh
# run's ATE and poses within "anno12k" (m) of the one-device run's; the
# elastic solve,
# and the same graph's uninterrupted stops on one device and 2 ranks,
# within "elastic" (m) of the uninterrupted 4-rank solve, and within
# "elastic_sigma" of each pose's marginal standard deviation
# (pg_pose_marginals at the uninterrupted poses), the error within
# "elastic_error_rel" relative; chunk boundaries on the same ranks move it
# by 0 (gated exactly).  Before the repair these stops lay up to 0.12 m
# (0.12 sigma) apart.  The dense_seg pass is float32 PCG: "anno12k_dense_seg".


def _spawn(fn, nprocs: int, args: tuple, timeout_s: float, label: str):
    """Run ``fn(rank, *args)`` in ``nprocs`` processes started with spawn;
    fail on any child's exception or exit code, or after ``timeout_s``
    (every child is stopped then)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout_s
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{label}: ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def _rank_setup(rank: int, world: int, store: str, backend: str):
    from diasss_tpu_torch.parallel.distributed import initialize
    from diasss_tpu_torch.parallel.shard import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 8) // max(world, 1) // 1))
    initialize(f"file://{store}", world, rank, backend=backend)
    return make_mesh(world, device=torch.device("cuda", 0))


def nccl_rank(rank: int, tmp: str):
    """One NCCL rank: each collective against its definition on CUDA tensors."""
    from diasss_tpu_torch.parallel import collectives as C
    from diasss_tpu_torch.parallel.distributed import heartbeat

    mesh = _rank_setup(rank, 1, os.path.join(tmp, "nccl_store"), "nccl")
    dev = mesh.device
    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3)
    res = {
        "psum": (C.psum(mesh, x), x),
        "psum_ordered": (C.psum_ordered(mesh, x), x),
        "all_gather": (C.all_gather(mesh, x), x[None]),
        "ppermute (self, batch_isend_irecv)": (C.ppermute(mesh, [x, x > 2], [(0, 0)])[0], x),
        "all_to_all_single": (C.all_to_all(mesh, x[None]), x[None]),
        "broadcast": (C.broadcast(mesh, x, 0), x),
        "heartbeat": (torch.tensor(heartbeat(mesh)), torch.tensor(1)),
    }
    torch.cuda.synchronize()
    for name, (got, want) in res.items():
        check(torch.equal(got.cpu(), want.cpu()), f"[mesh nccl] {name}: {got} against {want}")
    on_host = [name for name, (got, _) in res.items() if name != "heartbeat" and got.device.type != "cuda"]
    check(mesh.transport == "nccl" and not on_host,
          f"[mesh nccl] transport {mesh.transport}; results staged to the host: {on_host}")
    with open(os.path.join(tmp, "nccl.json"), "w") as f:
        json.dump({"checked": sorted(res), "device": str(dev)}, f)
    torch.distributed.destroy_process_group()


def mesh_nccl_phase(card):
    """The NCCL transport with one rank on the card: the only place it runs
    until a host with several GPUs exists (NCCL refuses two ranks on one
    GPU)."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _spawn(nccl_rank, 1, (tmp,), 180, "[mesh nccl]")
        with open(os.path.join(tmp, "nccl.json")) as f:
            got = json.load(f)
    print(f"[mesh nccl] one NCCL rank on {got['device']}, CUDA tensors: {', '.join(got['checked'])} equal their "
          f"definitions ({time.perf_counter() - t0:.1f} s with the process start; the only NCCL run until a "
          f"multi-GPU host exists) on {card}")


def mesh_detected_cfg(mesh_devices=None):
    """The detected 3k cell's settings: the CLI's ``--detected`` with the
    second-best exclusion radius at 0, since the ring search (as the JAX
    package's) has none; the single-device reference takes the same."""
    import dataclasses as dc

    from diasss_tpu_torch.config import PipelineConfig, detected_config

    cfg = detected_config(PipelineConfig(mesh_devices=mesh_devices))
    return dc.replace(cfg, matcher=dc.replace(cfg.matcher, ratio_excl_radius=0.0))


def mesh_rank(rank: int, world: int, tmp: str):
    """One of the [mesh 4] ranks: every cell through the entry points a
    user calls, with ``mesh_devices=world``; writes its results to
    ``tmp/rank{rank}.json`` (rank 0 also the 4.2k BA poses)."""
    import dataclasses as dc

    from diasss_tpu_torch.config import FullBAConfig, PipelineConfig, PoseGraphConfig, automatic_config
    from diasss_tpu_torch.features import detect_features, fast_cuda
    from diasss_tpu_torch.matching import dense_cuda
    from diasss_tpu_torch.matching.geosearch import geo_nn_search
    from diasss_tpu_torch.matching.robust import _ring_nn, kp_geo
    from diasss_tpu_torch.geometry.sonar import geo_bbox
    from diasss_tpu_torch.evaluate import trajectory_ate_pair
    from diasss_tpu_torch.online import OnlineSlam
    from diasss_tpu_torch.parallel.recovery import elastic_seq_pose_graph_solve, group_mesh
    from diasss_tpu_torch.parallel.seq import seq_pose_graph_solve
    from diasss_tpu_torch.pipeline import _overlap_pairs, _pad_feats_common, run_slam
    from diasss_tpu_torch.solvers.pose_graph import graph_error, pg_pose_marginals, solve_pose_graph
    from diasss_tpu_torch.synthetic import make_survey

    mesh = _rank_setup(rank, world, os.path.join(tmp, "store"), "gloo")
    dev = mesh.device
    out = {}

    def cell(name, fn):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fast_cuda.launches = dense_cuda.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = dict(res, wall=time.perf_counter() - t0, peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                         b1=fast_cuda.launches, b2=dense_cuda.launches)

    def slam(survey, cfg, feats=None, frames=None):
        gt = [l.gt_poses for l in survey.lines]
        with solver_infos() as infos:
            res = run_slam(frames if frames is not None else build_frames(survey, dev), cfg, gt_rows_list=gt,
                           run_eval2=False, feats=feats)
        return res, dict(ate_dr=res.ate_dr, ate_est=res.ate_est, capped=res.solve_capped, counters=res.counters,
                         n_lc=res.n_lc_accepted, pairs=len(res.pair_ids), frames=len(res.frame_slices),
                         trials=[i.iterations for i in infos], cg=[i.cg_iters_total for i in infos],
                         stalls=[i.stall for i in infos], errors=[float(i.error) for i in infos],
                         grad_norms=[float(i.grad_norm) for i in infos if hasattr(i, "grad_norm")],
                         error=res.solve_error)

    mesh_cfg = dict(mesh_devices=world)
    s12 = make_survey(**{**SURVEY, "n_lines": 20})
    graph12k = []

    def anno12k():
        from diasss_tpu_torch.parallel import seq

        entry = seq.seq_pose_graph_solve

        def keep(mesh_, graph, *args, **kwargs):
            graph12k.append(graph)
            return entry(mesh_, graph, *args, **kwargs)

        seq.seq_pose_graph_solve = keep
        try:
            res, summary = slam(s12, PipelineConfig(**mesh_cfg))
        finally:
            seq.seq_pose_graph_solve = entry
        if rank == 0:
            np.save(os.path.join(tmp, "anno12k_t.npy"), res.poses.t.cpu().numpy())
        return summary

    cell("anno12k direct", anno12k)
    cell("anno12k dense_seg", lambda: slam(s12, PipelineConfig(pose_graph=PoseGraphConfig(preconditioner="dense_seg"),
                                                               **mesh_cfg))[1])

    def elastic():
        """The 12k run's pose graph: solved uninterrupted on all ranks; in
        chunks with every rank kept; uninterrupted on the survivors (ranks
        0-1) alone; in chunks with ranks 2-3 gone from chunk 1 on; and on
        one device (rank 0): where the one-device, 2-rank and 4-rank solves
        stop (ROADMAP C17)."""
        graph, cfg = graph12k[0], PoseGraphConfig()
        whole, info = seq_pose_graph_solve(mesh, graph, cfg)
        chunked, _, _ = elastic_seq_pose_graph_solve(graph, cfg, chunk=5, mesh=mesh, probe=lambda c, ranks: ranks)
        keep = list(range(world // 2))
        survivors = single = None
        if rank in keep:
            survivors, info_s = seq_pose_graph_solve(group_mesh(mesh, keep), graph, cfg)
        if rank == 0:
            single, info_1 = solve_pose_graph(graph, cfg)
        torch.distributed.barrier()

        def probe(chunk_idx, ranks):
            return ranks if chunk_idx == 0 else [r for r in ranks if r in keep]

        poses, info_e, events = elastic_seq_pose_graph_solve(graph, cfg, chunk=5, mesh=mesh, probe=probe)
        dr = torch.cat([torch.as_tensor(l.dr_poses[:, 3:6], dtype=torch.float32, device=dev) for l in s12.lines])
        gt = np.concatenate([l.gt_poses for l in s12.lines])
        ate_whole, ate_el = trajectory_ate_pair(dr, whole, gt)[1], trajectory_ate_pair(dr, poses, gt)[1]
        # translation gaps in units of each pose's marginal standard deviation
        cov = pg_pose_marginals(graph, whole)[:, 3:6, 3:6]
        R = whole.R.double()
        S = R @ cov @ R.transpose(-1, -2) + 1e-12 * torch.eye(3, dtype=torch.float64, device=dev)

        def sigmas(p, q=whole):
            d = (p.t - q.t).double()
            return float(torch.sqrt(torch.einsum("pi,pij,pj->p", d, torch.linalg.inv(S), d)).max())

        out = dict(gap=float((poses.t - whole.t).abs().max()), gap_sigma=sigmas(poses),
                   gap_chunked=float((chunked.t - whole.t).abs().max()), error=float(info_e.error),
                   error_whole=float(info.error), ate=ate_el, ate_whole=ate_whole, ate_gap=abs(ate_el - ate_whole),
                   events=events, trials=info.iterations, kind=info.solver_kind, survivor=rank in keep)
        if single is not None:  # rank 0 holds all three stops
            stops = {"1 device": (single, info_1), "2 ranks": (survivors, info_s), "4 ranks": (whole, info)}
            out["c17"] = {name: dict(trials=i.iterations, error=float(i.error), ate=trajectory_ate_pair(dr, p, gt)[1],
                                     cost_f64=float(graph_error(p, graph)),
                                     cost_f32=pose_graph_cost_f32(p, graph))
                          for name, (p, i) in stops.items()}
            out["c17_gaps"] = {f"{a} / {b}": dict(m=float((stops[a][0].t - stops[b][0].t).abs().max()),
                                                   sigma=sigmas(stops[a][0], stops[b][0]))
                               for a, b in (("1 device", "4 ranks"), ("2 ranks", "4 ranks"), ("1 device", "2 ranks"))}
        return out

    cell("elastic 12k", elastic)
    del s12, graph12k

    sba = make_survey(**BA_SURVEY)
    ba_cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(preconditioner="direct"),
                            **mesh_cfg)

    def ba4k():
        res, summary = slam(sba, ba_cfg)
        if rank == 0:
            np.save(os.path.join(tmp, "ba4k_t.npy"), res.poses.t.cpu().numpy())
        return summary

    cell("ba4k direct", ba4k)

    auto_survey = make_survey(**AUTO_SURVEY)
    auto = automatic_config()
    auto = dc.replace(auto, full_ba=dc.replace(auto.full_ba, preconditioner="direct"), **mesh_cfg)
    cell("auto", lambda: slam(auto_survey, auto)[1])

    sdet = make_survey(**SURVEY)
    det = mesh_detected_cfg(world)

    def detected():
        frames = build_frames(sdet, dev)
        feats = [detect_features(f.norm, f.mask, det.detector) for f in frames]
        kcap = max(int(f.xy.shape[0]) for f in feats)
        cfg = dc.replace(det, matcher=dc.replace(det.matcher, ring_min_kps=kcap))
        res, summary = slam(sdet, cfg, feats=feats, frames=frames)
        # the ring's NN decisions against the single-device search, every gated pair, both directions
        padded = _pad_feats_common(feats)
        n_rows = n_equal = 0
        for (i, j) in _overlap_pairs(frames, cfg.min_overlap):
            flip = frames[i].img_id % 2 != frames[j].img_id % 2
            for a, b in ((i, j), (j, i)):
                ga, gb = kp_geo(padded[a], frames[a].geo), kp_geo(padded[b], frames[b].geo)
                bb = geo_bbox(frames[b].geo)
                ring = _ring_nn(ga, padded[a], gb, padded[b], bb, cfg.matcher, flip, mesh).corres
                one = geo_nn_search(ga, padded[a].desc, padded[a].valid, gb, padded[b].desc, padded[b].valid, bb,
                                    cfg.matcher, flip).corres
                n_rows += int(ring.numel())
                n_equal += int((ring == one).sum())
        return dict(summary, ring_min_kps=kcap, ring_rows=n_rows, ring_equal=n_equal)

    cell("detected ring", detected)
    del sdet

    def online():
        cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(preconditioner="direct"),
                             **mesh_cfg)
        frames = build_frames(sba, dev)
        slam_ = OnlineSlam(cfg, window_frames=ONLINE_WINDOWS["full_ba"], device=dev)
        for f in frames:
            poses = slam_.add_frame(f)
        ate_dr, ate = ate_of(frames, poses, [l.gt_poses for l in sba.lines])
        return dict(ate_dr=ate_dr, ate_est=ate, kind=slam_._last_info.solver_kind)

    cell("online ba4k window 3", online)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    torch.distributed.destroy_process_group()


def c17_report(stops, gaps, card, gate) -> None:
    """Print where the 12k pose-graph solve stopped on one device, 2 and 4
    ranks (the elastic cell's ``c17`` and ``c17_gaps``) and gate it."""
    print("[C17] where the 12k pose-graph solve stops, the same graph (the [mesh 4] run's) on one device, 2 and 4 "
          "ranks (direct step): " + "; ".join(
              f"{name}: {v['trials']} trials, error {v['error']!r}, ATE {v['ate']!r} m, cost at the stop "
              f"{v['cost_f64']!r} (float64) / {v['cost_f32']!r} (float32, gap {abs(v['cost_f32'] - v['cost_f64']):.3e})"
              for name, v in stops.items()) + "; largest pose gaps " + "; ".join(
              f"{pair} {g['m']:.3e} m = {g['sigma']:.3e} sigma" for pair, g in gaps.items())
          + f" (gates: the same trials, {MESH_GATES['elastic']} m, {MESH_GATES['elastic_sigma']} sigma, error "
            f"{MESH_GATES['elastic_error_rel']} relative); {MESH_LABEL}; on {card}")
    errors = [v["error"] for v in stops.values()]
    gate(len({v["trials"] for v in stops.values()}) == 1
         and all(g["m"] <= MESH_GATES["elastic"] and g["sigma"] <= MESH_GATES["elastic_sigma"] for g in gaps.values())
         and max(errors) - min(errors) <= MESH_GATES["elastic_error_rel"] * min(errors), f"[C17] {stops}, {gaps}")


def mesh4_phase(card, refs):
    """The [mesh 4] phase: MESH_N ranks, spawned, all on cuda:0 over gloo;
    each cell's result on every rank against the single-device run of the
    same smoke run (``refs``).  Returns the per-rank B1 / B2 launches."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _spawn(mesh_rank, MESH_N, (MESH_N, tmp), MESH_TIMEOUT_S, "[mesh 4]")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_N):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        ba_t = np.load(os.path.join(tmp, "ba4k_t.npy"))
        anno_t = np.load(os.path.join(tmp, "anno12k_t.npy"))
    print(f"[mesh 4] {MESH_N} ranks (spawn, gloo, cuda:0) in {wall:.1f} s with the process starts; {MESH_LABEL}")
    from diasss_tpu_torch.config import automatic_config

    r0 = ranks[0]
    failed = []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    def line(name, extra):
        c = r0[name]
        peaks = ", ".join(f"{r[name]['peak_mib']:.0f}" for r in ranks)
        single = refs.get(name + "_wall", refs.get(name.split()[0] + "_wall"))
        solves = f"LM trials {c['trials']}, CG iterations {c['cg']}; " if "trials" in c and isinstance(c["trials"], list) else ""
        if c.get("grad_norms"):
            solves += f"pose-graph grad_norm {c['grad_norms']} on rank 0; "
        print(f"[mesh 4] {name}: {extra}; {solves}wall {c['wall']:.3f} s (single device "
              f"{'not run' if single is None else f'{single:.3f}'} s), peak MiB per rank {peaks}; {MESH_LABEL}; on {card}")

    for r in ranks:  # every rank holds the same result
        for name in r0:
            for key in ("ate_est", "gap"):
                if key in r0[name]:
                    gate(r[name][key] == r0[name][key], f"[mesh 4] {name}: ranks differ in {key}")

    c = r0["anno12k direct"]
    gn = [r["anno12k direct"]["grad_norms"] for r in ranks]
    gate(len(gn[0]) == 1 and math.isfinite(gn[0][0]) and all(g == gn[0] for g in gn),
         f"[mesh 4] anno12k direct: grad_norm per rank {gn}, must be finite and equal")
    line("anno12k direct", f"grad_norm equal on the {MESH_N} ranks (the single device's direct solve "
                           f"{refs['anno12k_grad_norm']!r}), "
                           f"ATE DR/EST {c['ate_dr']:.4f}/{c['ate_est']:.4f} m against the single device's "
                           f"{refs['anno12k']:.4f}, solve error {c['error']:.4f} against {refs['anno12k_error']:.4f}, "
                           f"largest pose gap to the single device {np.abs(anno_t - refs['anno12k_t']).max():.2e} m, "
                           f"capped {c['capped']}, counters {json.dumps(c['counters'])}")
    gap = float(np.abs(anno_t - refs["anno12k_t"]).max())
    gate(abs(c["ate_est"] - refs["anno12k"]) <= MESH_GATES["anno12k"] and gap <= MESH_GATES["anno12k"]
          and not c["capped"] and c["counters"].get("solver_sp_direct_solves") == 1,
          f"[mesh 4] anno12k direct: {c}, pose gap {gap}")
    c = r0["anno12k dense_seg"]
    line("anno12k dense_seg", f"ATE {c['ate_est']:.4f} m against the single device's dense_seg pass "
                              f"{refs['anno12k_dense_seg']:.4f} ({refs['anno12k_dense_seg_cg']} CG iterations) and "
                              f"the mesh direct pass's {r0['anno12k direct']['ate_est']:.4f}, counters "
                              f"{json.dumps(c['counters'])}")
    gate(abs(c["ate_est"] - refs["anno12k_dense_seg"]) <= MESH_GATES["anno12k_dense_seg"]
          and c["counters"].get("solver_sp_dense_seg_solves") == 1, f"[mesh 4] anno12k dense_seg: {c}")
    c = r0["ba4k direct"]
    gap = float(np.abs(ba_t - refs["ba4k_t"]).max())
    line("ba4k direct", f"poses within {gap:.2e} m of the single-device solve (gate {MESH_GATES['ba4k_poses']}), "
                        f"ATE {c['ate_est']:.4f} m against {refs['ba4k']:.4f}, counters {json.dumps(c['counters'])}")
    gate(gap <= MESH_GATES["ba4k_poses"] and abs(c["ate_est"] - refs["ba4k"]) <= MESH_GATES["ba4k_ate_rel"] * refs["ba4k"]
          and c["counters"].get("solver_sp_direct_solves") == 1, f"[mesh 4] ba4k: {c}, gap {gap}")
    c = r0["auto"]
    b1 = [r["auto"]["b1"] for r in ranks]
    b2 = [r["auto"]["b2"] for r in ranks]
    line("auto", f"ATE DR/EST {c['ate_dr']:.4f}/{c['ate_est']:.4f} m against {refs['auto']:.4f}; per solve (match "
                 f"round 0, then the rematch round) LM trials {c['trials']} against the single device's "
                 f"{refs['auto_trials']} (cap {automatic_config().full_ba.max_iters} each), stall at exit {c['stalls']} against "
                 f"{refs['auto_stalls']} (0 at the cap: still improving), error {c['errors']} against "
                 f"{refs['auto_errors']}; solve_capped {c['capped']} against {refs['auto_capped']}; correspondences "
                 f"in the last solve {c['n_lc']} against {refs['auto_n_lc']}; B1 launches per rank {b1}, B2 launches "
                 f"per rank {b2}, counters {json.dumps(c['counters'])}")
    rounds = c["counters"]["match_stacked_pairs"] // c["pairs"]
    gate(abs(c["ate_est"] - refs["auto"]) <= MESH_GATES["auto"] and not c["capped"] and all(n == c["frames"] for n in b1)
          and all(n == rounds for n in b2) and c["counters"].get("match_mesh_devices", 0) > 0,
          f"[mesh 4] auto: {c}, B1 {b1}, B2 {b2}")
    c = r0["detected ring"]
    b1 = [r["detected ring"]["b1"] for r in ranks]
    line("detected ring", f"ring_min_kps lowered to the keypoint capacity {c['ring_min_kps']} so that the ring runs: "
                          f"{c['counters'].get('match_ring_pairs')} ring pairs, NN decisions equal to the single-device "
                          f"geo_nn_search on {c['ring_equal']} of {c['ring_rows']} rows; ATE {c['ate_est']:.4f} m "
                          f"against {refs['detected']:.4f} (the per-pair path draws its SCC hypotheses pair by pair, "
                          f"the single-device stacked path for all pairs at once); B1 launches per rank {b1}")
    gate(c["ring_equal"] == c["ring_rows"] > 0 and c["counters"].get("match_ring_pairs", 0) == c["pairs"] > 0
          and abs(c["ate_est"] - refs["detected"]) <= MESH_GATES["detected"] and all(n == c["frames"] for n in b1),
          f"[mesh 4] detected: {c}, B1 {b1}")
    c = r0["elastic 12k"]
    line("elastic 12k", f"the 12k run's pose graph, ranks 2-3 dropped at chunk 1 (events {c['events']}), against the "
                        f"uninterrupted {c['kind']} solve on {MESH_N} ranks ({c['trials']} trials): ATE {c['ate']:.4f} "
                        f"against {c['ate_whole']:.4f} m, gap {c['ate_gap']:.2e} m (gate {MESH_GATES['elastic']}); "
                        f"largest pose gap {c['gap']:.2e} m (gate {MESH_GATES['elastic']}), {c['gap_sigma']:.3f} of "
                        f"the pose's marginal sigma (gate {MESH_GATES['elastic_sigma']}); error {c['error']:.6f} "
                        f"against {c['error_whole']:.6f} (gate {MESH_GATES['elastic_error_rel']} relative); chunk "
                        f"boundaries with every rank kept move it by {c['gap_chunked']:.2e} m (must be 0)")
    gate(c["gap"] <= MESH_GATES["elastic"] and c["gap_sigma"] <= MESH_GATES["elastic_sigma"]
          and c["gap_chunked"] == 0.0
          and abs(c["error"] - c["error_whole"]) <= MESH_GATES["elastic_error_rel"] * c["error_whole"]
          and c["ate_gap"] <= MESH_GATES["elastic"] and [tuple(e) for e in c["events"]] == [(1, MESH_N, MESH_N // 2)],
          f"[mesh 4] elastic: {c}")
    c17_report(c["c17"], c["c17_gaps"], card, gate)
    c = r0["online ba4k window 3"]
    line("online ba4k window 3", f"final ATE DR/EST {c['ate_dr']:.4f}/{c['ate_est']:.4f} m against the single-device "
                                 f"stream's {refs['online']:.4f} ({c['kind']})")
    gate(abs(c["ate_est"] - refs["online"]) <= MESH_GATES["online"], f"[mesh 4] online: {c}")
    check(not failed, "[mesh 4] gates failed: " + " | ".join(failed))
    return {f"mesh4_auto_rank{r}": ranks[r]["auto"]["b1"] for r in range(MESH_N)}, \
        {f"mesh4_auto_rank{r}": ranks[r]["auto"]["b2"] for r in range(MESH_N)}, \
        {f"mesh4_detected_rank{r}": ranks[r]["detected ring"]["b1"] for r in range(MESH_N)}


def multihost_phase(card):
    """``multihost_check`` in two OS processes over tcp:// on the card
    (gloo: the ranks share cuda:0)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "diasss_tpu_torch.parallel.multihost_check", "--init-method",
                               f"tcp://127.0.0.1:{port}", "--world-size", "2", "--rank", str(r), "--backend", "gloo",
                               "--device", "cuda:0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=repo) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"multihost_check rank {r} exited {p.returncode}:\n{out[-3000:]}")
        for marker in ("MULTIHOST_OK", "MULTIHOST_BA_OK", "MULTIHOST_ELASTIC_OK"):
            check(marker in out, f"multihost_check rank {r} printed no {marker}:\n{out[-3000:]}")
    lines = [l for l in outs[0].splitlines() if l.startswith(("rank 0", "MULTIHOST"))]
    print(f"[multihost_check] 2 processes over tcp:// (gloo, cuda:0), {time.perf_counter() - t0:.1f} s: "
          f"{' | '.join(lines)} on {card}")


def mesh_refs(dev, card, refs):
    """The single-device runs the mesh cells are held to: those of this
    smoke run's earlier phases (``refs``; the 12k ``dense_seg`` solve is
    :func:`pg_options_phase`'s), and the one made here, the detected cell's
    (its exclusion radius at 0)."""
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.synthetic import make_survey

    def single(survey_kw, cfg):
        survey = make_survey(**survey_kw)
        frames = build_frames(survey, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_slam(frames, cfg, gt_rows_list=[l.gt_poses for l in survey.lines], run_eval2=False)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res, refs["detected_wall"] = single(SURVEY, mesh_detected_cfg())
    refs["detected"] = res.ate_est
    print(f"[mesh refs] single device: anno12k {refs['anno12k']:.4f} m (dense_seg {refs['anno12k_dense_seg']:.4f} m), "
          f"ba4k {refs['ba4k']:.4f} m, auto "
          f"{refs['auto']:.4f} m, detected (exclusion radius 0) {refs['detected']:.4f} m, online ba4k window "
          f"{ONLINE_WINDOWS['full_ba']} {refs['online']:.4f} m on {card}")
    return refs


def mesh_phases(dev, card, refs):
    """[mesh nccl], [mesh 4] and the two-process multihost check; returns
    the per-rank launches of [mesh 4] (B1 and B2 of the automatic cell, B1
    of the detected cell)."""
    t0 = time.perf_counter()
    mesh_nccl_phase(card)
    refs = mesh_refs(dev, card, refs)
    launches = mesh4_phase(card, refs)
    multihost_phase(card)
    print(f"[mesh] the multi-device phases took {time.perf_counter() - t0:.1f} s")
    return launches


def bench_phase(card, refs, per_pass):
    """``diasss_tpu_torch.bench.main()`` in this process, its standard output
    and error captured: its last line has exactly ``bench.py``'s keys, every
    rate is positive, every ATE finite and within :data:`BENCH_ATE_GATES` of
    this run's own ATE of the cell, and the two-stage points solved with the
    direct step.  ``per_pass``: the (B1, B2) launches of one automatic pass
    in this run; the bench's automatic point launches them in each of its
    passes.  Returns the bench's (B1, B2) launches."""
    import io

    from diasss_tpu_torch import bench
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.matching import dense_cuda

    out, err = io.StringIO(), io.StringIO()
    fast_cuda.launches = dense_cuda.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        bench.main()
    seconds = time.perf_counter() - t0
    launches = fast_cuda.launches, dense_cuda.launches
    for line in err.getvalue().splitlines():
        print(f"[bench] {line}")
    last = out.getvalue().strip().splitlines()[-1]
    print(f"[bench] {last}")
    got = json.loads(last)
    print(f"[bench] python -m diasss_tpu_torch.bench in process: {seconds:.1f} s; B1 launches {launches[0]}, "
          f"B2 launches {launches[1]} on {card}")
    check(set(got) == BENCH_KEYS, f"[bench] keys {sorted(set(got) ^ BENCH_KEYS)} differ from bench.py's")
    rates = {k: v for k, v in got.items() if k.startswith("value")}
    check(len(rates) == 4 and all(v is not None and v > 0 for v in rates.values()), f"[bench] rates {rates}")
    ates = {k: v for k, v in got.items() if k.startswith("ate_")}
    check(len(ates) == 8 and all(v is not None and math.isfinite(v) for v in ates.values()), f"[bench] ATEs {ates}")
    for key, (ref, tol) in BENCH_ATE_GATES.items():
        print(f"[bench] {key} {got[key]} m against this run's {ref} {refs[ref]:.4f} m (gate {tol:g} m)")
        check(abs(got[key] - refs[ref]) <= tol, f"[bench] {key} {got[key]} against {ref} {refs[ref]}")
    check(got["solver_3k"] == got["solver_12k"] == "direct",
          f"[bench] solvers {got['solver_3k']!r}, {got['solver_12k']!r}")
    check(launches == tuple(BENCH_AUTO_PASSES * n for n in per_pass),
          f"[bench] launches {launches}, {BENCH_AUTO_PASSES} automatic passes of {per_pass}")
    return launches


def mission_run(label, run, card, automatic, keep_first=False):
    """One pass of ``run()`` (a mission script's ``run_once``: keyframes from the
    raw survey, ``run_slam``, a synchronise; returns (wall, result)) with
    the peak device memory reset before it, both kernels' launches counted
    (the (K, T) of each B2 launch recorded) and every full-BA solve kept
    with its seconds.  Gates: poses finite; an ``automatic`` run launches
    B1 once per frame and B2 once per match round, and solves full BA once
    per round; every full-BA solve took ``resolve_ba_solver_kind`` of its
    size.  Returns (result, kept solves, the inputs of the first B2 launch
    if ``keep_first``, B1 launches, B2 launches)."""
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.matching import dense, dense_cuda
    from diasss_tpu_torch.solvers import full_ba

    shapes, first = [], []
    entry = dense.qcorr

    def recording(Wvh, Wh, q, k, T):
        shapes.append((int(Wvh.shape[0]), T))
        if keep_first and not first:
            first.append((Wvh, Wh, q, k, T))
        return entry(Wvh, Wh, q, k, T)

    seconds = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_cuda.launches = dense_cuda.launches = 0
    dense.qcorr = recording
    try:
        with solver_infos() as infos, kept_ba_solves(seconds) as kept:
            wall, result = run()
    finally:
        dense.qcorr = entry
    b1, b2 = fast_cuda.launches, dense_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    check_poses(result, label)
    pings = int(result.poses.t.shape[0])
    print(f"[{label}] {pings} poses, {len(result.frame_slices)} frames, pairs {len(result.pair_ids)}, "
          f"correspondences in the last solve {result.n_lc_accepted}, ATE DR/EST {result.ate_dr:.4f}/"
          f"{result.ate_est:.4f} m, wall {wall:.3f} s ({pings / wall:.1f} pings/s), peak device memory "
          f"{peak / 2**20:.1f} MiB, B1 launches {b1}, B2 launches {b2} at (K, T) {shapes} on {card}")
    print(f"[{label}] timings {json.dumps({k: round(v, 4) for k, v in result.timings.items()})} "
          f"counters {json.dumps(result.counters)} solve_capped {result.solve_capped}")
    for r, ((prob, cfg, _, _, _, info), s) in enumerate(zip(kept, seconds)):
        P, K_pad = int(prob.poses0.t.shape[0]), int(prob.kp_i.shape[0])
        kind = full_ba.resolve_ba_solver_kind(cfg.preconditioner, P, K_pad)
        print(f"[{label}] full BA solve {r}: P {P}, K_pad {K_pad}, valid correspondences "
              f"{int(prob.kp_valid.sum())}, kind {info.solver_kind} (resolve_ba_solver_kind("
              f"{cfg.preconditioner!r}, P, K_pad): {kind}), LM trials {info.iterations}, CG iterations "
              f"{info.cg_iters_total}, {s:.4f} s")
        check(info.solver_kind == kind, f"[{label}] solve {r} took {info.solver_kind}, resolved {kind}")
    if "pose_graph" in result.timings:
        print(f"[{label}] pose graph: {', '.join(f'{i.solver_kind} {i.iterations} trials, {i.cg_iters_total} CG' for i in infos)}"
              f", {result.timings['pose_graph']:.4f} s")
    if "full_ba" in result.timings:
        solves = sum(v for k, v in result.counters.items() if k.startswith("solver_"))
        check(len(kept) == solves, f"[{label}] {len(kept)} full-BA solves kept, counters {result.counters}")
    if automatic:
        rounds = result.counters["match_stacked_pairs"] // len(result.pair_ids)
        check(b2 == rounds and len(kept) == rounds,
              f"[{label}] {b2} B2 launches and {len(kept)} full-BA solves for {rounds} match rounds")
        check(b1 == len(result.frame_slices), f"[{label}] B1 launched {b1} times for {len(result.frame_slices)} frames")
    return result, kept, first[0] if first else None, b1, b2


def mission_cutover(survey, kept, card):
    """Every ``dense_seg`` solve of the run solved again, and the same
    problem with ``preconditioner="direct"``, each after a one-trial
    warm-up (seconds, trials, peak memory); the PCG solve's ATE within 5% of
    the direct solve's.  Without one, each solve's K_pad is printed."""
    from diasss_tpu_torch.pipeline import _woodbury_width
    from diasss_tpu_torch.solvers import full_ba

    crossed = [e for e in kept if e[-1].solver_kind == "dense_seg"]
    if not crossed:
        print(f"[mission cutover] no solve crossed K_pad {full_ba.MAX_DIRECT_KPAD}: K_pad "
              f"{[int(e[0].kp_i.shape[0]) for e in kept]} on {card}")
        return
    how, tol = PCG_ATE_GATE["full_ba"]
    for prob, cfg, kp_cfg, _, _, _ in crossed:
        cols = _woodbury_width(prob, int(prob.kp_valid.sum()))
        line = []
        ates = {}
        for kind in ("dense_seg", "direct"):
            solve_cfg = dataclasses.replace(cfg, preconditioner=kind)
            (poses, _, info), s, peak = timed_solve(
                lambda: full_ba.solve_full_ba(prob, solve_cfg, kp_cfg, k_direct_cols=cols),
                lambda: full_ba.solve_full_ba(prob, dataclasses.replace(solve_cfg, max_iters=1), kp_cfg,
                                              k_direct_cols=cols))
            check(bool(torch.isfinite(poses.t).all()) and info.solver_kind == kind, f"[mission cutover] {kind}")
            ates[kind] = survey_ate(survey, poses)
            line.append(f"{kind} {info.iterations} trials, {info.cg_iters_total} CG, {s:.4f} s, peak "
                        f"{peak / 2**20:.1f} MiB, ATE {ates[kind]:.4f} m")
        print(f"[mission cutover] P {int(prob.poses0.t.shape[0])}, K_pad {int(prob.kp_i.shape[0])}, valid "
              f"{int(prob.kp_valid.sum())}: {'; '.join(line)} (gate {tol:g} relative) on {card}")
        check(abs(ates["dense_seg"] - ates["direct"]) <= tol * ates["direct"],
              f"[mission cutover] dense_seg ATE {ates['dense_seg']} against direct {ates['direct']}")


def mission_qcorr(inputs, card):
    """B2 at the mission's round-0 shape (the recorded windows): one launch
    over every keypoint, :data:`MISSION_B2_ROWS` rows spread over all pairs
    held against ``qcorr_plain``, timed beside the plain version, the
    depthwise convolution and its bound.  Returns the row's numbers."""
    import torch.nn.functional as F

    from diasss_tpu_torch.matching import dense_cuda
    from diasss_tpu_torch.matching.dense import qcorr_plain

    Wvh, Wh, q, k, T = inputs
    K, S = int(Wvh.shape[0]), int(Wvh.shape[1])
    rows = torch.linspace(0, K - 1, MISSION_B2_ROWS, device=Wvh.device).round().to(torch.int64)
    A, B = dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T)
    A0, B0 = qcorr_plain(Wvh[rows].contiguous(), Wh[rows].contiguous(), q[rows].contiguous(), k, T)
    err = max(float((A[rows] - A0).abs().max()), float((B[rows] - B0).abs().max()))
    check(err <= QCORR_TOL, f"[mission B2] K={K}, T={T}: kernel differs from the plain version by {err}")
    del A, B, A0, B0
    ms = cuda_time_ms(lambda: dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T), reps=5)
    dev_ms, dev_by = kernel_device_ms(lambda: dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T), 5, "qcorr_kernel")
    plain_ms = cuda_time_ms(lambda: qcorr_plain(Wvh, Wh, q, k, T), reps=1, warmup=1)
    x, w = conv_inputs(Wvh, Wh, q, k)
    lib_ms = cuda_time_ms(lambda: F.conv2d(x, w, groups=2 * K), reps=5)
    del x, w
    bnd, by = qcorr_bound(K, S, k, T)
    print(f"[mission B2] K={K}, S={S}, T={T} (the mission's round-0 windows): {MISSION_B2_ROWS} rows against "
          f"qcorr_plain max abs error {err:.3g} (gate {QCORR_TOL:g}); events {ms:.4f} ms, device {dev_ms:.4f} ms "
          f"({dev_by}), plain {plain_ms:.3f} ms, conv2d {lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}): device time at "
          f"{100 * bnd / dev_ms:.1f}% of it, on {card}")
    return dict(K=K, T=T, max_abs_err=err, ms=ms, device_ms=dev_ms, device_ms_by=dev_by, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bnd, bound_by=by)


def ba_chain_f64_gap(label, prob, cfg, kp_cfg, poses, lms, info, card) -> None:
    """Full BA's float32 chain solve (the direct step's multi-RHS cyclic
    reduction) against the same solve of the promoted blocks in float64, on
    one trial at the stop (the solve's poses, landmarks and damping): the
    relative gap of the solution, beside the 2-3e-3 measured at 4.2k and at
    the automatic point when the chain was left in float32."""
    from diasss_tpu_torch.pipeline import _woodbury_width
    from diasss_tpu_torch.solvers import full_ba, tridiag

    gaps, entry = [], tridiag.solve_block_tridiag_multi

    def both(D, U, B):
        W = entry(D, U, B)
        W64 = entry(D.double(), U.double(), B.double())
        gaps.append(float(torch.linalg.vector_norm(W.double() - W64) / torch.linalg.vector_norm(W64)))
        return W

    tridiag.solve_block_tridiag_multi = both
    try:
        full_ba.solve_full_ba(prob._replace(poses0=poses, lm0=lms),
                              dataclasses.replace(cfg, preconditioner="direct", max_iters=1), kp_cfg,
                              lam0=info.lam, k_direct_cols=_woodbury_width(prob, int(prob.kp_valid.sum())))
    finally:
        tridiag.solve_block_tridiag_multi = entry
    check(len(gaps) == 1 and math.isfinite(gaps[0]), f"[{label}] chain gaps {gaps}")
    print(f"[{label}] float32 chain solve against float64 on one trial at the stop (P {int(poses.t.shape[0])}, "
          f"K_pad {int(prob.kp_i.shape[0])}, damping {float(info.lam):.3g}): relative gap {gaps[0]:.3e} "
          f"(2-3e-3 at 4.2k and 1.6k before) on {card}")


def mission_phase(dev, card):
    """``[mission]``: the two mission scripts' surveys at full size, one
    pass each through their ``run_once``: the 20-line automatic mission
    (``auto_scale``) at drift budgets 4 and 8 and with annotations through
    full BA, and the 30,000-pose stress survey (``stress_bench``); B2 at the
    mission's shape against its plain version.  Returns (B1 launches, B2
    launches) of the runs and the B2 row."""
    from diasss_tpu_torch.config import PipelineConfig, automatic_config
    from diasss_tpu_torch.scripts import auto_scale, stress_bench
    from diasss_tpu_torch.synthetic import make_survey

    t_phase = time.perf_counter()
    survey = auto_scale.mission_survey(**MISSION)
    res, _, _, b1_4, b2_4 = mission_run("mission auto b4", lambda: auto_scale.run_once(survey, automatic_config(), dev),
                                        card, automatic=True)
    print(f"[mission auto b4] rematch_saturated_rounds {res.counters.get('rematch_saturated_rounds', 0)}; ATE "
          f"{res.ate_dr:.4f} -> {res.ate_est:.4f} m, printed, not gated (the reference: 12.88 -> 13.63 m)")
    del res
    res, kept, inputs, b1_8, b2_8 = mission_run(
        "mission auto b8", lambda: auto_scale.run_once(survey, automatic_config(drift_budget=8), dev), card,
        automatic=True, keep_first=True)
    check(res.ate_est < res.ate_dr, f"[mission auto b8] no improvement ({res.ate_est} >= {res.ate_dr})")
    del res
    mission_cutover(survey, kept, card)
    del kept
    b2_row = mission_qcorr(inputs, card)
    del inputs
    res, kept, _, _, _ = mission_run(
        "mission anno full_ba",
        lambda: auto_scale.run_once(survey, PipelineConfig(min_overlap=0.1, estimator="full_ba"), dev), card,
        automatic=False)
    check(res.ate_est < res.ate_dr, f"[mission anno full_ba] no improvement ({res.ate_est} >= {res.ate_dr})")
    ba_chain_f64_gap("mission anno full_ba", *kept[-1], card)
    del res, kept
    res, _, _, _, _ = mission_run("stress 30k", lambda: stress_bench.run_once(make_survey(**STRESS), dev), card,
                                  automatic=False)
    # the reference's own two-stage estimate falls behind dead reckoning from about 25 such lines on (CPU:
    # PYTHONPATH=. python tests/torch_parity_helpers.py --stress 10 20 30), so the gate is the solve's own: it
    # lowers the graph's cost and stops before its trial cap; the ATE is printed
    check(not res.solve_capped and res.solve_error < res.solve_error0,
          f"[stress 30k] pose-graph solve capped {res.solve_capped}, error {res.solve_error0} -> {res.solve_error}")
    print(f"[stress 30k] solver kind {[k for k in res.counters if k.startswith('solver_')]}, graph error "
          f"{res.solve_error0:.6g} -> {res.solve_error:.6g}; ATE {res.ate_dr:.4f} -> {res.ate_est:.4f} m, printed, "
          f"not gated (the reference on the CPU, 30 of these lines: 29.34 -> 33.62 m)")
    print(f"[mission] the phase took {time.perf_counter() - t_phase:.1f} s on {card}")
    return b1_4 + b1_8, b2_4 + b2_8, b2_row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import diasss_tpu_torch  # noqa: F401  (fails outside the repository)
    from diasss_tpu_torch.bench import card_line
    from diasss_tpu_torch.config import FullBAConfig, PipelineConfig, PoseGraphConfig, automatic_config
    from diasss_tpu_torch.solvers import full_ba, pose_graph
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
    with solver_infos() as warm_infos, kept_ba_solves() as warm_ba:
        warm = auto_run(build_frames(auto_survey, dev), auto_cfg, auto_gt, record=recorded,
                        record_correlate=correlate_args)
    check(len(recorded) >= 1 and len(correlate_args) == len(recorded),
          "the automatic warm-up pass never reached the q-correlation")
    ba_cost_gap("automatic 1.6k, final solve", *warm_ba[-1], card)
    del warm_ba
    q_err, q_ms, q_dev_ms, q_dev_by, q_plain_ms, q_lib_ms, q_bound, q_by = qcorr_phase(dev, recorded,
                                                                                      correlate_args)
    del recorded, correlate_args
    fast_auto, qcorr_auto, auto_wall = auto_phase(dev, auto_survey, auto_cfg, auto_gt, card, warm.ate_est)
    refs = dict(auto=warm.ate_est, auto_wall=auto_wall, auto_trials=[i.iterations for i in warm_infos],
                auto_stalls=[i.stall for i in warm_infos], auto_errors=[float(i.error) for i in warm_infos],
                auto_capped=warm.solve_capped, auto_n_lc=warm.n_lc_accepted)
    marg_cfg = dataclasses.replace(auto_cfg, full_ba=dataclasses.replace(auto_cfg.full_ba, marginals=True))
    fast_marg, qcorr_marg = auto_marginals_phase(dev, auto_survey, marg_cfg, auto_gt, card)
    surface_phase(dev, card, auto_survey)

    fast_detected = detected_phase(dev)
    fast_stacked, b1_stacked_err = detected_stacked_phase(dev, card)

    def pg(**kw):
        return PipelineConfig(pose_graph=PoseGraphConfig(**kw))

    def ba(**kw):
        return PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(**kw))

    _, result3k = annotation_phase(dev, card, {**SURVEY, "n_lines": 5}, PipelineConfig(), "anno",
                                   variants=[("anno dense_seg", pg(preconditioner="dense_seg")),
                                             ("anno tridiag", pg(preconditioner="tridiag"))])
    refs["anno3k"] = result3k.ate_est
    del result3k
    with captured(pose_graph, "solve_pose_graph") as pg_calls:
        survey12k, result12k = annotation_phase(dev, card, {**SURVEY, "n_lines": 20}, PipelineConfig(), "anno",
                                                variants=[("anno marginals", pg(marginals=True))])
    print(f"[anno 12000] the float64 direct step: solve_capped {result12k.solve_capped}, pose_graph "
          f"{result12k.timings['pose_graph']:.4f} s, ATE {result12k.ate_est:.4f} m")
    check(not result12k.solve_capped, "anno 12000: the pose-graph solve stopped at its trial cap while improving")
    refs.update(anno12k=result12k.ate_est, anno12k_error=result12k.solve_error,
                anno12k_wall=result12k.timings["timed_pass_wall"], anno12k_t=result12k.poses.t.cpu().numpy())
    marginals_envelope(dev, survey12k, result12k.poses, card)
    refs["anno12k_dense_seg"], refs["anno12k_dense_seg_cg"], refs["anno12k_grad_norm"] = pg_options_phase(
        card, survey12k, pg_calls[-1], result12k)
    del survey12k, result12k, pg_calls
    ba_kept = {}
    with captured(full_ba, "solve_full_ba") as ba_calls:
        survey4k, result4k = annotation_phase(dev, card, BA_SURVEY, ba(), "full_ba anno", profile=True,
                                              variants=[("full_ba anno marginals", ba(marginals=True)),
                                                        ("full_ba anno dense_seg", ba(preconditioner="dense_seg"))],
                                              kept=ba_kept)
    ba_chain_phase(card, survey4k, ba_calls[1], result4k, ba_kept["full_ba anno dense_seg"])
    del survey4k, ba_calls, ba_kept
    refs.update(ba4k=result4k.ate_est, ba4k_t=result4k.poses.t.cpu().numpy(),
                ba4k_wall=result4k.timings["timed_pass_wall"])
    del result4k

    fast_online, qcorr_online = online_auto_phase(dev, auto_survey, auto_cfg, auto_gt, card)
    online_window_phase(dev, card, {**SURVEY, "n_lines": ONLINE_ANNO_LINES}, PipelineConfig(),
                        ONLINE_WINDOWS["two_stage"], "online window anno")
    refs["online"], refs["online_wall"] = online_window_phase(
        dev, card, BA_SURVEY, PipelineConfig(min_overlap=0.1, estimator="full_ba"), ONLINE_WINDOWS["full_ba"],
        "online window full_ba")
    checkpoint_phase(dev, card)
    fast_orb = descriptor_phase(dev, card, "orb")
    fast_geo_patch = descriptor_phase(dev, card, "geo_patch")

    mixed_survey = crop_lines(auto_survey, MIXED_AUTO_CROPS)
    mixed_gt = [l.gt_poses for l in mixed_survey.lines]
    fast_mixed, qcorr_mixed, b1_mixed_err, b2_mixed_err = mixed_auto_phase(dev, card, mixed_survey, auto_cfg, mixed_gt)
    fast_mixed_online, qcorr_mixed_online = mixed_online_phase(dev, card, mixed_survey, auto_cfg, mixed_gt)
    # the crop leaves 2 gated pairs and 8 annotated correspondences, none accepted (as in the JAX package)
    annotation_phase(dev, card, SURVEY, PipelineConfig(), "mixed anno", crops=MIXED_ANNO_CROPS, improve=False)
    annotation_phase(dev, card, BA_SURVEY, ba(), "mixed full_ba anno", crops=MIXED_BA_CROPS)
    cli_phase(dev, card, SURVEY, MIXED_ANNO_CROPS)
    fast_mesh, qcorr_mesh, fast_mesh_detected = mesh_phases(dev, card, refs)
    fast_bench, qcorr_bench = bench_phase(card, refs, (fast_auto, qcorr_auto))
    fast_mission, qcorr_mission, b2_mission = mission_phase(dev, card)

    print(json.dumps({"kernels": [
        {
            "name": "fast9_two_threshold",
            "route": "cuda",
            "source": "diasss_tpu_torch/csrc/fast9.cu",
            "replaces": "diasss_tpu/features/fast_pallas.py:30",
            "launches": fast_online,
            "launches_by_phase": {"auto": fast_auto, "auto_marginals": fast_marg, "detected": fast_detected,
                                  "detected_stacked": fast_stacked, "online_auto": fast_online, "detected_orb": fast_orb,
                                  "detected_geo_patch": fast_geo_patch, "mixed_auto": fast_mixed,
                                  "online_mixed_auto": fast_mixed_online, **fast_mesh, **fast_mesh_detected,
                                  "bench": fast_bench, "mission": fast_mission},
            "max_abs_err": max(fast_err, b1_mixed_err, b1_stacked_err),
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
            "launches_by_phase": {"auto": qcorr_auto, "auto_marginals": qcorr_marg, "online_auto": qcorr_online,
                                  "mixed_auto": qcorr_mixed, "online_mixed_auto": qcorr_mixed_online, **qcorr_mesh,
                                  "bench": qcorr_bench, "mission": qcorr_mission},
            "max_abs_err": max(q_err, b2_mixed_err, b2_mission["max_abs_err"]),
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
