"""Reference-format observability dumps (the port's copy of
:mod:`diasss_tpu.dumps`).

Writes the same text artifacts the reference scatters next to its build dir
(optimizer.cpp:652-672, 1586-1613, 1775-1781), so downstream tooling written for
the reference consumes our outputs unchanged:

* ``annotated_kps.txt`` — the keypoint pairs fed to the LC solver (:78-83)
* ``ini_lm_errors.txt`` / ``fnl_lm_errors.txt`` — LC geo distances (:900-902)
* ``dr_range_e.txt`` / ``dr_plane_e.txt`` / ``est_range_e.txt`` /
  ``est_plane_e.txt`` — consistency errors (:925-951)
* ``depth_est_wp.txt`` / ``depth_drape.txt`` — depth estimates (:830-834)
* ``result/pr_errors/*`` and ``result/anno_errors/*`` — per-pair eval files

NOTE: the reference truncates these files once per ``LoopClosingTFs`` call, so
only the **last** pair's rows survive a multi-pair run (a reference bug).  We
write all pairs' rows concatenated in pair order — a deliberate fix.
"""

from __future__ import annotations

import os

import numpy as np


def _writecol(path: str, values) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in np.asarray(values).ravel():
            f.write(f"{v}\n")


def write_reference_dumps(out_dir: str, result, kps_pairs: dict) -> None:
    """Write the full reference text-artifact set from a SlamResult."""
    os.makedirs(out_dir, exist_ok=True)

    # exact full-BA pose marginals (FullBAConfig.marginals): one row per
    # ping, 6 sigmas (r p y x y z) — the artifact analogue of the
    # reference's GTSAM Marginals (optimizer.cpp:956), which it only ever
    # consumed internally as LC noise models
    if getattr(result, "pose_sigmas", None) is not None:
        with open(os.path.join(out_dir, "est_pose_sigmas_all.txt"), "w") as f:
            for row in np.asarray(result.pose_sigmas):
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")

    # annotated_kps.txt (optimizer.cpp:78-83)
    with open(os.path.join(out_dir, "annotated_kps.txt"), "w") as f:
        for (i, j) in result.pair_ids:
            kp = kps_pairs.get((i, j))
            if kp is None:
                continue
            for row in kp.pairs[kp.valid]:
                f.write(
                    f"{i} {j} " + " ".join(f"{v:.9f}" for v in row[:6]) + "\n"
                )

    # LC solver dumps, concatenated across pairs
    cols = {
        "ini_lm_errors.txt": "ini_dist",
        "fnl_lm_errors.txt": "fnl_dist",
        "dr_range_e.txt": "dr_range_e",
        "dr_plane_e.txt": "dr_plane_e",
        "est_range_e.txt": "est_range_e",
        "est_plane_e.txt": "est_plane_e",
        "depth_est_wp.txt": "depth_est",
        "depth_drape.txt": "depth_drape",
    }
    for fname, field in cols.items():
        rows = []
        for (i, j) in result.pair_ids:
            res = result.lc_results.get((i, j))
            if res is None:
                continue
            vals = np.asarray(getattr(res, field))
            rows.extend(vals[np.asarray(res.valid)].tolist())
        _writecol(os.path.join(out_dir, fname), rows)

    # per-pair eval_1 files (result/anno_errors/*, optimizer.cpp:1775-1781)
    for idx, (i, j) in enumerate(result.pair_ids):
        e1 = result.eval1.get((i, j))
        if e1 is None or e1.n_pairs == 0:
            continue
        _writecol(os.path.join(out_dir, "result", "anno_errors", f"dr_lm_dist_{idx}.txt"), e1.ini_dists)
        _writecol(os.path.join(out_dir, "result", "anno_errors", f"est_lm_dist_{idx}.txt"), e1.fnl_dists)
        _writecol(
            os.path.join(out_dir, "result", "anno_errors", f"lm_dist_compare_{idx}.txt"),
            e1.ini_dists - e1.fnl_dists,
        )

    # per-pair eval_2 averages (result/pr_errors/*_avg.txt, optimizer.cpp:1586-1594)
    if result.eval2:
        for name, field in [
            ("dr_range_e_avg.txt", "avg_range_dr"),
            ("dr_plane_e_avg.txt", "avg_plane_dr"),
            ("est_range_e_avg.txt", "avg_range_est"),
            ("est_plane_e_avg.txt", "avg_plane_est"),
        ]:
            vals = [getattr(result.eval2[k], field) for k in result.pair_ids if k in result.eval2]
            _writecol(os.path.join(out_dir, "result", "pr_errors", name), vals)

        # per-pair eval_2 error columns ({dr,est}_{range,plane}_e_<i>.txt,
        # optimizer.cpp:1605-1612) — one file per gated pair, pair order
        for idx, key in enumerate(result.pair_ids):
            e2 = result.eval2.get(key)
            if e2 is None or e2.n_pairs == 0:
                continue
            for name, field in [
                (f"dr_range_e_{idx}.txt", "range_dr_e"),
                (f"dr_plane_e_{idx}.txt", "plane_dr_e"),
                (f"est_range_e_{idx}.txt", "range_est_e"),
                (f"est_plane_e_{idx}.txt", "plane_est_e"),
            ]:
                _writecol(
                    os.path.join(out_dir, "result", "pr_errors", name),
                    getattr(e2, field),
                )
