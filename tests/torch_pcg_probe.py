"""The pose graph's PCG passes, and full BA's ``dense_seg`` pass, on one card.

For comparing two checkouts of the port on the same card: each cell's LM
trials, CG iterations, solve seconds, pass wall, final cost and ATE, one
JSON line per cell, then the card's name and power limit.  The cells are
``chip_smoke.py``'s: the 3,000-pose annotation survey (five lines of
600x512) on ``dense_seg`` and ``tridiag``, the 12,000-pose survey (twenty
lines) on ``dense_seg``, and the 4,200-pose full-BA survey on
``dense_seg``; a 3,000-pose direct pass first warms the process up.

    python3 tests/torch_pcg_probe.py [--root DIR] [--label NAME]

from the repository root.  ``--root`` imports the port from another
checkout (for example a parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists); the default is this checkout.  Needs
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SURVEY = dict(n_lines=5, n_pings=600, n_bins=512, n_landmarks=60)
BA_SURVEY = dict(n_lines=5, n_tie_lines=2, n_landmarks=300)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("torch_pcg_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from diasss_tpu_torch.config import FullBAConfig, PipelineConfig, PoseGraphConfig
    from diasss_tpu_torch.frame import build_keyframes_batch
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.solvers import full_ba, pose_graph
    from diasss_tpu_torch.synthetic import make_survey

    dev = torch.device("cuda", 0)
    infos = []
    for module, name in ((pose_graph, "solve_pose_graph"), (full_ba, "solve_full_ba")):
        entry = getattr(module, name)

        def run(*a, _entry=entry, **kw):
            out = _entry(*a, **kw)
            infos.append(out[-1])
            return out

        setattr(module, name, run)

    def cell(label, survey_kw, cfg):
        survey = make_survey(**survey_kw)
        frames = build_keyframes_batch(
            [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines], device=dev)
        del infos[:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_slam(frames, cfg, gt_rows_list=[l.gt_poses for l in survey.lines], run_eval2=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps(dict(tree=args.label or args.root, cell=label, poses=int(res.poses.t.shape[0]),
                              kinds=[i.solver_kind for i in infos], trials=[int(i.iterations) for i in infos],
                              cg=[int(i.cg_iters_total) for i in infos],
                              solve_s=res.timings.get("pose_graph", 0.0) + res.timings.get("full_ba", 0.0),
                              wall_s=wall, error=res.solve_error, ate_dr=res.ate_dr, ate_est=res.ate_est)), flush=True)

    def pg(kind):
        return PipelineConfig(pose_graph=PoseGraphConfig(preconditioner=kind))

    cell("warm-up anno3k direct", SURVEY, PipelineConfig())
    cell("anno3k dense_seg", SURVEY, pg("dense_seg"))
    cell("anno3k tridiag", SURVEY, pg("tridiag"))
    cell("anno12k dense_seg", {**SURVEY, "n_lines": 20}, pg("dense_seg"))
    cell("ba4k dense_seg", BA_SURVEY,
         PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(preconditioner="dense_seg")))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    print(f"[card] {card[0] if card else 'not read'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
