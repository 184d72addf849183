"""Synthetic side-scan sonar survey generator (the port's copy of
:mod:`diasss_tpu.synthetic`, bit-identical output for the same arguments).

The reference ships a bundled 5-line survey (``test_data/``, gitignored — layout
documented in the reference's .gitignore) that its demo and evaluation run
on.  That data is not available here, so this module generates surveys with the
same structure and file formats:

* a lawnmower ground-truth trajectory with alternating headings (the reference's
  parity logic assumes odd/even lines run in opposite directions,
  FEAmatcher.cpp:209-212),
* dead-reckoning poses = ground truth + integrated drift (what SLAM must fix),
* waterfall images with speckle background and bright landmark echoes (gives the
  feature detector/matcher something real to find),
* annotation rows ``(id_s, id_t, ping_s, bin_s, ping_t, bin_t, depth*1e5)`` in
  the reference's integer format (util.cpp:190-210, optimizer.cpp:616-625),
* altitude and ground-range tables.

Because ground truth is known, we can compute true trajectory ATE — a stronger
evaluation than the reference's self-consistency metrics, reported alongside them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SurveyLine:
    img_id: int
    gt_poses: np.ndarray  # (N, 6) ground-truth rows (r, p, y, x, y, z)
    dr_poses: np.ndarray  # (N, 6) dead-reckoning rows
    altitudes: np.ndarray  # (N,)
    ground_ranges: np.ndarray  # (G,)
    image: np.ndarray  # (N, M) raw intensities (float)
    annos: np.ndarray  # (Ka, 7) int annotation rows (source frame = this line)


@dataclasses.dataclass
class Survey:
    lines: List[SurveyLine]
    landmarks: np.ndarray  # (L, 3) world positions
    floor_z: float

    @property
    def n_lines(self):
        return len(self.lines)


def make_survey(
    n_lines: int = 5,
    n_pings: int = 600,
    n_bins: int = 512,
    n_landmarks: int = 60,
    spacing: float = 30.0,
    ping_step: float = 0.35,
    altitude: float = 12.0,
    r0: float = 5.0,
    drift_xy: float = 0.004,
    drift_yaw: float = 2e-5,
    n_tie_lines: int = 0,
    seed: int = 0,
) -> Survey:
    """Generate a synthetic survey.

    Drift model: per-ping random-walk increments in (x, y, yaw), integrated along
    each line and carried across lines — mimicking DVL/INS dead-reckoning error.

    ``n_tie_lines`` appends perpendicular crossing lines (yaw +-pi/2) spread over
    the survey — standard hydrographic practice.  Crossing geometry makes BOTH
    horizontal drift components observable by the sonar plane constraint (an
    E-W line's zero-plane residual only pins x; a N-S tie line pins y), so loop
    closures recover much more of the drift than parallel-pass-only surveys.
    NOTE: a main-vs-tie bbox IoU is ~0.2, so tie-line pairs require lowering the
    reference's 0.4 overlap gate (PipelineConfig.min_overlap).
    """
    rng = np.random.default_rng(seed)
    half = n_bins // 2
    g_max = 40.0
    dgr = (g_max - r0) / (half - 1)
    ground_ranges = r0 + dgr * np.arange(half)
    floor_z = -altitude

    length = (n_pings - 1) * ping_step
    # landmarks scattered over the surveyed strip (kept away from line ends)
    lx = rng.uniform(0.12 * length, 0.88 * length, n_landmarks)
    ly = rng.uniform(-g_max, (n_lines - 1) * spacing + g_max, n_landmarks)
    landmarks = np.stack([lx, ly, np.full(n_landmarks, floor_z)], axis=1)

    # line specs: (origin_x, origin_y, yaw); mains alternate 0/pi, ties +-pi/2
    y_mid = (n_lines - 1) * spacing / 2
    specs = []
    for l in range(n_lines):
        forward = l % 2 == 0
        specs.append(
            (0.0 if forward else length, l * spacing, 0.0 if forward else np.pi)
        )
    for t in range(n_tie_lines):
        tx = length * (t + 1) / (n_tie_lines + 1)
        up = t % 2 == 0
        specs.append(
            (tx, y_mid - length / 2 if up else y_mid + length / 2, np.pi / 2 if up else -np.pi / 2)
        )

    # world-anchored seabed reflectivity field: real SSS texture is a property
    # of the seafloor, so different passes over the same area see correlated
    # intensity patterns (this is what makes descriptor matching physically
    # possible); per-ping speckle multiplies it, view-dependent
    tex_res = 0.7  # meters per texture cell
    ty_lo = min(-(g_max + 5.0), y_mid - length / 2 - g_max - 5.0)
    ty_hi = max((n_lines - 1) * spacing + g_max + 5.0, y_mid + length / 2 + g_max + 5.0)
    tx0, ty0 = -(g_max + 5.0), ty_lo
    tw = int((length + 2 * g_max + 10.0) / tex_res) + 2
    th = int((ty_hi - ty_lo) / tex_res) + 2
    tex = rng.uniform(0.0, 1.0, (th, tw))
    # smooth to a ~1.5 m correlation length
    kern = np.exp(-0.5 * (np.arange(-2, 3) ** 2))
    kern /= kern.sum()
    tex = np.apply_along_axis(lambda r: np.convolve(r, kern, "same"), 1, tex)
    tex = np.apply_along_axis(lambda c: np.convolve(c, kern, "same"), 0, tex)

    def reflectivity(gx, gy):
        """Bilinear sample of the world texture at geo coords (arrays)."""
        u = np.clip((gx - tx0) / tex_res, 0, tw - 1.001)
        v = np.clip((gy - ty0) / tex_res, 0, th - 1.001)
        u0 = u.astype(np.int64)
        v0 = v.astype(np.int64)
        fu = u - u0
        fv = v - v0
        t = (
            tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv
            + tex[v0 + 1, u0 + 1] * fu * fv
        )
        return 12.0 + 38.0 * t

    # --- ground-truth + drift trajectories ---
    lines: List[SurveyLine] = []
    drift = np.zeros(3)  # accumulated (dx, dy, dyaw), carried across lines
    all_obs = []  # (line, ping, bin, landmark_idx) observation events
    for l, (ox, oy, yaw) in enumerate(specs):
        s = np.arange(n_pings) * ping_step
        xs = ox + s * np.cos(yaw)
        ys = oy + s * np.sin(yaw)
        gt = np.zeros((n_pings, 6))
        gt[:, 2] = yaw + rng.normal(0, 0.002, n_pings)  # small heading wiggle
        gt[:, 3] = xs + rng.normal(0, 0.02, n_pings) * abs(np.sin(yaw))
        gt[:, 4] = ys + rng.normal(0, 0.02, n_pings) * abs(np.cos(yaw))
        gt[:, 5] = 0.0

        # integrate drift
        inc = rng.normal(0, 1, (n_pings, 3)) * np.array([drift_xy, drift_xy, drift_yaw])
        # bias the walk slightly so drift grows like real DR error
        inc += np.array([drift_xy, drift_xy, drift_yaw]) * 0.5
        walk = drift + np.cumsum(inc, axis=0)
        drift = walk[-1]
        dr = gt.copy()
        dr[:, 3] += walk[:, 0]
        dr[:, 4] += walk[:, 1]
        dr[:, 2] += walk[:, 2]

        alts = altitude + rng.normal(0, 0.05, n_pings)

        # --- render the waterfall image (ground truth geometry) ---
        # per-pixel geo position under GT poses -> world reflectivity x speckle
        cols = np.arange(n_bins)
        g_idx = np.clip(np.abs(cols - half), 0, half - 1)
        gr_col = ground_ranges[g_idx]
        ang = gt[:, 2][:, None] + np.where(cols[None, :] >= half, np.pi / 2, -np.pi / 2)
        px = gt[:, 3][:, None] + gr_col[None, :] * np.cos(ang)
        py = gt[:, 4][:, None] + gr_col[None, :] * np.sin(ang)
        refl = reflectivity(px, py)
        img = refl * rng.rayleigh(scale=1.0, size=(n_pings, n_bins)) * 0.35 + refl * 0.65
        # nadir return: bright stripe at the innermost bins
        img[:, half - 2 : half + 2] *= 3.0

        heading = np.stack([np.cos(gt[:, 2]), np.sin(gt[:, 2])], axis=1)  # (N,2)
        stb_dir = np.stack([np.cos(gt[:, 2] + np.pi / 2), np.sin(gt[:, 2] + np.pi / 2)], axis=1)
        rel = landmarks[None, :, :2] - gt[:, None, 3:5]  # (N, L, 2)
        along = np.einsum("nlk,nk->nl", rel, heading)
        cross = np.einsum("nlk,nk->nl", rel, stb_dir)  # + -> starboard
        g_rng = np.abs(cross)
        in_swath = (g_rng >= r0 + 1.0) & (g_rng <= g_max - 1.0) & (np.abs(along) <= ping_step)

        # each landmark is a distinctive constellation of sub-scatterers (so
        # descriptors can discriminate — a single blob template would make every
        # landmark identical and the matcher's ratio test would rightly reject
        # everything); sub-scatterer world offsets are a deterministic function
        # of the landmark id, shared across survey lines
        for li in range(n_landmarks):
            vis = np.nonzero(in_swath[:, li])[0]
            if len(vis) == 0:
                continue
            pi = vis[np.argmin(np.abs(along[vis, li]))]
            lrng = np.random.default_rng(1000 + li)
            n_sub = lrng.integers(4, 8)
            sub_along = lrng.normal(0, 1.2, n_sub)  # meters along-track
            sub_cross = lrng.normal(0, 1.2, n_sub)  # meters cross-track
            # amplitudes stay below the mask's bright-pixel kill rule
            # (> 2.5 x image mean, frame.cpp:98): background Rayleigh mean is
            # ~25, so peaks ~2.0-2.3 x mean survive masking like real seabed
            # texture (the rule targets sensor glitches, not scatterers)
            sub_amp = lrng.uniform(22, 40, n_sub)
            sub_amp[0] = 45.0  # dominant scatterer at the center
            sub_along[0] = sub_cross[0] = 0.0

            side = 1.0 if cross[pi, li] > 0 else -1.0
            k0 = (g_rng[pi, li] - r0) / dgr
            b0 = half + side * k0
            for a_off, c_off, amp in zip(sub_along, sub_cross, sub_amp):
                pf = pi + a_off / ping_step
                bf = b0 + side * c_off / dgr
                pc, bc = int(round(pf)), int(round(bf))
                if not (2 <= pc < n_pings - 2 and 2 <= bc < n_bins - 2):
                    continue
                ys, xs = np.mgrid[pc - 2 : pc + 3, bc - 2 : bc + 3]
                img[pc - 2 : pc + 3, bc - 2 : bc + 3] += amp * np.exp(
                    -((ys - pf) ** 2 + (xs - bf) ** 2) / 1.6
                )
            # acoustic shadow behind the dominant scatterer
            bc0 = int(round(b0))
            if side > 0 and bc0 + 7 < n_bins:
                img[max(pi - 1, 0) : pi + 2, bc0 + 4 : bc0 + 7] *= 0.35
            elif side < 0 and bc0 - 7 >= 0:
                img[max(pi - 1, 0) : pi + 2, bc0 - 6 : bc0 - 3] *= 0.35

            k_idx = int(round(k0))
            k_idx = min(max(k_idx, 0), half - 1)
            b_rec = half + k_idx if side > 0 else half - k_idx
            all_obs.append((l, int(pi), int(min(max(b_rec, 0), n_bins - 1)), li))

        lines.append(
            SurveyLine(
                img_id=l,
                gt_poses=gt,
                dr_poses=dr,
                altitudes=alts,
                ground_ranges=ground_ranges,
                image=img,
                annos=np.zeros((0, 7), np.int64),
            )
        )

    # --- annotations: landmarks seen from two different lines ---
    obs_by_lm: dict = {}
    for l, pi, b, li in all_obs:
        obs_by_lm.setdefault(li, []).append((l, pi, b))
    annos_per_line = [[] for _ in range(len(specs))]
    for li, obs in obs_by_lm.items():
        depth_int = int(round(-landmarks[li, 2] * 1e5))  # reference stores depth*1e5
        for a in range(len(obs)):
            for b in range(a + 1, len(obs)):
                (l1, p1, b1), (l2, p2, b2) = obs[a], obs[b]
                if l1 == l2:
                    continue
                annos_per_line[l1].append((l1, l2, p1, b1, p2, b2, depth_int))
                annos_per_line[l2].append((l2, l1, p2, b2, p1, b1, depth_int))
    for l in range(len(specs)):
        if annos_per_line[l]:
            lines[l].annos = np.asarray(annos_per_line[l], np.int64)

    return Survey(lines=lines, landmarks=landmarks, floor_z=floor_z)


def _main():
    """Write a synthetic survey dataset in the reference file layout.

    Usage: python -m diasss_tpu_torch.synthetic OUTDIR [n_lines] [n_pings] [n_bins]
    """
    import sys

    from .io import save_survey

    out = sys.argv[1] if len(sys.argv) > 1 else "./synthetic_survey"
    n_lines = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    n_pings = int(sys.argv[3]) if len(sys.argv) > 3 else 600
    n_bins = int(sys.argv[4]) if len(sys.argv) > 4 else 512
    survey = make_survey(n_lines=n_lines, n_pings=n_pings, n_bins=n_bins)
    folders = save_survey(survey, out)
    print(f"synthetic survey written to {out}")
    for k, v in folders.items():
        print(f"  --{k} {v}")


if __name__ == "__main__":
    _main()
