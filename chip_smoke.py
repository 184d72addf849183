#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``diasss_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (every one asserts; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   FAST-9 kernel from ``diasss_tpu_torch/csrc/fast9.cu``;
2. hold the kernel against its plain torch version at 4992x1280 and at every
   pyramid level of a 600x512 frame, thresholds 12 and 7, on uniform(0, 255)
   images and a normalized synthetic waterfall: bit-identical on
   ``[3:-3, 3:-3]``; time both with CUDA events;
3. run the detected two-stage SLAM path (the ``--detected`` CLI settings) on
   the 5-line, 3000-pose synthetic survey: one warm-up pass, one timed pass
   whose FAST launches are counted;
4. run the annotation two-stage path at 3000 and 12000 poses.

The last line of standard output is
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


def kernel_phase(dev):
    from diasss_tpu.synthetic import make_survey
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.features.fast import fast_score_plain
    from diasss_tpu_torch.features.pyramid import build_pyramid
    from diasss_tpu_torch.frame import normalize_sss

    t0 = time.perf_counter()
    fast_cuda.build(force=True)
    print(f"[build] {fast_cuda.LIBRARY} in {time.perf_counter() - t0:.2f} s")
    print("[build] nvcc: " + " | ".join(l.strip() for l in fast_cuda.build_log.splitlines() if l.strip()))

    rng = np.random.default_rng(0)
    wf600 = make_survey(n_lines=1, n_pings=600, n_bins=512, n_landmarks=20).lines[0].image
    wf_big = make_survey(n_lines=1, n_pings=4992, n_bins=1280, n_landmarks=60).lines[0].image
    norm600 = normalize_sss(torch.as_tensor(wf600, dtype=torch.float32, device=dev)).float()
    cases = [("waterfall", (4992, 1280),
              normalize_sss(torch.as_tensor(wf_big, dtype=torch.float32, device=dev)).float())]
    for level in build_pyramid(norm600, 6, 1.2):
        cases.append(("waterfall", tuple(level.shape), level.contiguous()))
    for shape in [c[1] for c in cases]:
        cases.append(("uniform", shape, torch.as_tensor(rng.uniform(0, 255, shape), dtype=torch.float32,
                                                        device=dev)))
    max_err = 0.0
    main_ms = main_plain_ms = None
    print("[B1] image     shape        thr  kernel_ms  plain_ms  max_abs_err[3:-3,3:-3]")
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
            max_err = max(max_err, err)
            print(f"[B1] {kind:9s} {shape[0]:5d}x{shape[1]:<5d} {thr:4.0f}  {ms:9.4f} {plain_ms:9.3f}  {err}")
            if kind == "waterfall" and shape == (600, 512) and thr == 12.0:
                main_ms, main_plain_ms = ms, plain_ms
    return max_err, main_ms, main_plain_ms


def build_frames(survey, dev):
    from diasss_tpu_torch.frame import build_keyframes_batch

    return build_keyframes_batch(
        [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines],
        device=dev,
    )


def check_poses(result, label):
    check(bool(torch.isfinite(result.poses.t).all()) and bool(torch.isfinite(result.poses.R).all()),
          f"{label}: non-finite poses")


def detected_phase(dev):
    from diasss_tpu.config import PipelineConfig
    from diasss_tpu.synthetic import make_survey
    from diasss_tpu_torch.cli import detected_config
    from diasss_tpu_torch.features import fast_cuda
    from diasss_tpu_torch.pipeline import run_slam

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


def annotation_phase(dev, n_lines, card):
    from diasss_tpu.config import PipelineConfig
    from diasss_tpu.synthetic import make_survey
    from diasss_tpu_torch.pipeline import run_slam

    survey = make_survey(**{**SURVEY, "n_lines": n_lines})
    gt = [l.gt_poses for l in survey.lines]
    cfg = PipelineConfig()
    run_slam(build_frames(survey, dev), cfg, gt_rows_list=gt, run_eval2=False)  # warm-up
    frames = build_frames(survey, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    wall = time.perf_counter() - t0
    check_poses(result, f"annotations {n_lines} lines")
    check(result.ate_est < result.ate_dr,
          f"annotations {n_lines} lines: no improvement over dead reckoning ({result.ate_est} >= {result.ate_dr})")
    pings = int(result.poses.t.shape[0])
    print(f"[anno {pings}] pairs {len(result.pair_ids)}, n_lc_accepted {result.n_lc_accepted}, "
          f"ATE DR/EST {result.ate_dr:.4f}/{result.ate_est:.4f} m, wall {wall:.3f} s, "
          f"{pings / wall:.1f} pings/s on {card}")
    print(f"[anno {pings}] timings {json.dumps({k: round(v, 4) for k, v in result.timings.items()})} "
          f"counters {json.dumps(result.counters)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import diasss_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    print(f"[card] {card}")
    dev = torch.device("cuda", 0)

    max_err, ms, plain_ms = kernel_phase(dev)
    launches = detected_phase(dev)
    annotation_phase(dev, 5, card)
    annotation_phase(dev, 20, card)

    print(json.dumps({"kernels": [{
        "name": "fast9_score",
        "route": "cuda",
        "source": "diasss_tpu_torch/csrc/fast9.cu",
        "replaces": "diasss_tpu/features/fast_pallas.py:30",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
