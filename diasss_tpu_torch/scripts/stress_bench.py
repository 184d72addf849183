"""Long-mission stress run: a synthetic survey of 50 lines x 600 pings
(30000 poses, 600 landmarks) through the annotation pipeline
(``PipelineConfig()``: LC mini-solves, then the pose graph's float64
direct step) on one device, the keyframes built line by line.  One
warm-up pass, then one timed pass; prints the survey, both walls, pings/s,
the pairs and accepted loop closures, the ATE, the stage seconds and the
counters.

Counterpart of the repository's ``scripts/stress_bench.py`` (its ``--cpu``
is ``--device cpu`` here).  Run on the card:

    python -m diasss_tpu_torch.scripts.stress_bench [--lines 50 --pings 600 --bins 512 --landmarks 600]
"""

from __future__ import annotations

import argparse
import json
import time

from ..config import PipelineConfig
from ..frame import build_keyframe
from ..pipeline import _sync, run_slam
from ..synthetic import make_survey
from . import card_device


def run_once(survey, device):
    """One pass from the raw survey to a device synchronise: keyframes
    built line by line on ``device``, then ``run_slam`` with
    ``PipelineConfig()``.  Returns (wall s, SlamResult)."""
    t0 = time.perf_counter()
    frames = [build_keyframe(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos, device=device)
              for l in survey.lines]
    result = run_slam(frames, PipelineConfig(), gt_rows_list=[l.gt_poses for l in survey.lines], run_eval2=False)
    _sync(device)
    return time.perf_counter() - t0, result


def main(lines: int = 50, pings: int = 600, bins: int = 512, landmarks: int = 600, device=None) -> dict:
    """The stress survey through a warm-up pass and a timed pass of
    :func:`run_once`; returns what it printed as a dict, with the gated
    pairs."""
    dev = card_device(device, "stress_bench.main")
    t0 = time.perf_counter()
    survey = make_survey(n_lines=lines, n_pings=pings, n_bins=bins, n_landmarks=landmarks)
    total = lines * pings
    print(f"survey: {lines} lines x {pings} pings = {total} poses ({time.perf_counter() - t0:.1f} s to generate)")
    warm, _ = run_once(survey, dev)
    print(f"pass 1 (warm-up): {warm:.3f} s")
    wall, r = run_once(survey, dev)
    print(f"pass 2: {wall:.3f} s -> {total / wall:,.1f} pings/s at {total} poses")
    print(f"pairs {len(r.pair_ids)}, LC accepted {r.n_lc_accepted}")
    print(f"ATE DR/EST: {r.ate_dr:.4f} / {r.ate_est:.4f} m")
    print("timings:", json.dumps({k: round(v, 4) for k, v in r.timings.items()}), "counters:",
          json.dumps(r.counters))
    return dict(lines=lines, pings=pings, poses=total, warm_wall=warm, wall=wall, pings_per_sec=total / wall,
                pair_ids=list(r.pair_ids), n_lc_accepted=r.n_lc_accepted, ate_dr=r.ate_dr, ate_est=r.ate_est,
                timings=dict(r.timings), counters=dict(r.counters))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Long-mission stress run of the port")
    parser.add_argument("--lines", type=int, default=50)
    parser.add_argument("--pings", type=int, default=600)
    parser.add_argument("--bins", type=int, default=512)
    parser.add_argument("--landmarks", type=int, default=600)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.lines, args.pings, args.bins, args.landmarks, args.device)
