"""The 20-line automatic mission: a large survey with no annotations,
18 main lines and 2 tie lines of 400 pings (8000 poses, 46 gated pairs),
through the automatic profile (``automatic_config()``: dense
world-correlation matching of 2000 keypoint slots per frame, joint full BA,
drift-compensated re-matching).  Full BA's ``"auto"`` solver kind takes the
direct Woodbury step while the padded correspondence count stays at or
under ``full_ba.MAX_DIRECT_KPAD`` and ``dense_seg`` PCG above it, solve by
solve; the counters name the kind each solve took.

Counterpart of the repository's ``scripts/auto_scale.py``; ``main`` also
takes the pipeline configuration (``cfg``, default ``automatic_config()``)
and the device.  Run on the card:

    python -m diasss_tpu_torch.scripts.auto_scale [n_lines n_ties n_pings]
"""

from __future__ import annotations

import json
import sys
import time

from ..config import automatic_config
from ..frame import build_keyframes_batch
from ..pipeline import _sync, run_slam
from ..synthetic import make_survey
from . import card_device


def mission_survey(n_lines: int = 18, n_ties: int = 2, n_pings: int = 400):
    """The mission's synthetic survey: 512 bins, 1200 landmarks, 4 mm of DR
    drift per ping, seed 3."""
    return make_survey(n_lines=n_lines, n_pings=n_pings, n_bins=512, n_landmarks=1200, n_tie_lines=n_ties,
                       drift_xy=0.004, seed=3)


def run_once(survey, cfg, device):
    """One pass from the raw survey to a device synchronise: keyframes
    built on ``device``, then ``run_slam``.  Returns (wall s, SlamResult)."""
    t0 = time.perf_counter()
    frames = build_keyframes_batch(
        [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines],
        device=device)
    result = run_slam(frames, cfg, gt_rows_list=[l.gt_poses for l in survey.lines], run_eval2=False)
    _sync(device)
    return time.perf_counter() - t0, result


def main(n_lines: int = 18, n_ties: int = 2, n_pings: int = 400, cfg=None, device=None) -> dict:
    """One warm-up pass, then one timed pass of the mission; prints the
    wall, pings/s and ATE, the counters, the stage seconds and the accepted
    correspondences, and returns them (with the gated pairs) as a dict."""
    dev = card_device(device, "auto_scale.main")
    cfg = cfg or automatic_config()
    survey = mission_survey(n_lines, n_ties, n_pings)
    total = sum(len(l.dr_poses) for l in survey.lines)
    run_once(survey, cfg, dev)  # warm-up: CUDA context, kernel loads, the allocator
    wall, r = run_once(survey, cfg, dev)
    out = dict(n_lines=n_lines, n_ties=n_ties, pings=total, wall=wall, pings_per_sec=total / wall,
               ate_dr=r.ate_dr, ate_est=r.ate_est, counters=dict(r.counters), timings=dict(r.timings),
               n_lc_accepted=r.n_lc_accepted, pair_ids=list(r.pair_ids))
    print(f"{n_lines}+{n_ties} lines, {total} pings: wall {wall:.3f} s ({total / wall:.1f} pings/s)  "
          f"ate {r.ate_dr:.4f} -> {r.ate_est:.4f}")
    print("counters:", json.dumps(out["counters"]))
    print("times:", json.dumps({k: round(v, 4) for k, v in r.timings.items()}))
    print(f"accepted correspondences: {r.n_lc_accepted} over {len(r.pair_ids)} pairs")
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
