"""Online (incremental) SLAM: frames arrive one at a time and the estimate
is available after each arrival (the iSAM2 interface, optimizer.cpp:264-268).

Counterpart of :mod:`diasss_tpu.online`.  On each arrival the overlap gate
runs against every earlier frame (the bounding boxes of earlier frames are
cached); with detection on, the new frame is detected once (one B1 launch)
and matched against every gated earlier frame pair by pair (the keypoint
matcher, or the dense matcher with one B2 launch per new pair on rasters
fitted to each frame); the accumulated matches feed the solve, which is
warm-started from the previous estimate.  Both estimators:

* two-stage: the loop-closure mini-solves of the new pairs only, the
  accepted factors accumulated, then the chain pose graph;
* full BA: the joint problem rebuilt on every arrival (landmarks from the
  correspondences, as the batch pipeline does), the poses warm-started.

``window_frames`` gives fixed-lag smoothing in both: poses of frames older
than the window freeze at their last estimate.  Two-stage loop closures
across the boundary are re-anchored onto the boundary pose; full-BA factors
with one frozen endpoint keep it as a constant pose
(``BAProblem.kp_{i,j}_fix``), those with both frozen drop.

With ``cfg.mesh_devices`` (every rank of a process group streaming the same
frames), the full-BA window solve is the sequence-parallel one
(:func:`.parallel.seq.seq_full_ba_solve`): the frozen endpoints owner-align
like any other factor data.

Bucketing (``bucket=True``, the default): the pose chain is padded to a
power-of-two length by repeating the last pose with identity odometry, and
the loop-closure / correspondence axes by invalid rows.  It exists in the
JAX package so that an arrival reuses a compiled program; eager PyTorch has
nothing to reuse, and the port keeps it only so that both packages solve
the same padded problem: a padded leaf pose leaves the undamped optimum
alone, but its damped block moves the LM trials of the real poses slightly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import PipelineConfig
from .frame import Keyframe
from .geometry import se3
from .padding import pad_rows
from .pairs import get_kps_pairs
from .pipeline import _assemble_pairs, _check_supported, _match_pairs, _maybe_mesh, _overlap_pairs
from .rng import TorchRng


def bucket_capacity(n: int, base: int = 256) -> int:
    """Smallest power of two >= n (>= base)."""
    cap = base
    while cap < n:
        cap *= 2
    return cap


def _pad_chain_to(poses0: se3.Pose3, odo_meas: se3.Pose3, p_cap: int):
    """Pad a pose chain to ``p_cap`` poses by repeating the last pose joined
    by identity odometry: zero-residual leaf factors."""
    p = int(poses0.t.shape[0])
    if p_cap <= p:
        return poses0, odo_meas
    padn = p_cap - p
    last = se3.Pose3(poses0.R[p - 1:p].expand(padn, 3, 3), poses0.t[p - 1:p].expand(padn, 3))
    ident = se3.identity((padn,), poses0.t.dtype, poses0.t.device)
    return se3.cat([poses0, last]), se3.cat([odo_meas, ident])


@dataclasses.dataclass
class OnlineState:
    frames: List[Keyframe]
    poses: Optional[se3.Pose3]  # current estimate over all frames
    frame_slices: List[slice]
    n_lc: int


class OnlineSlam:
    """Incremental front end over the batched solvers::

        slam = OnlineSlam(cfg)
        for line in survey.lines:
            poses = slam.add_frame(build_keyframe(...))  # poses after this frame

    ``window_frames``: fixed-lag smoothing (module docstring), at least 2
    (the newest frame and one estimated boundary frame).  ``device``: where
    the frames live and the solves run (the card unless the caller asks for
    the CPU).  ``rng``: the SCC hypothesis draws of the keypoint matcher
    (default a :class:`.rng.TorchRng` seeded from ``cfg``).  ``counters``
    accumulates the matcher's path counters over the stream
    (``match_perpair_pairs``)."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), bucket: bool = True,
                 window_frames: int | None = None, device="cuda", rng=None):
        if window_frames is not None and window_frames < 2:
            # window_frames=1 would freeze every earlier pose on arrival: the
            # boundary pose the re-anchoring fixes would be the new frame's
            # first pose, which has no estimate yet
            raise ValueError("window_frames must be >= 2 (the newest frame "
                             "plus at least one estimated boundary frame)")
        _maybe_mesh(cfg, device)  # raises at once without a process group of mesh_devices ranks
        self.cfg = cfg
        self.bucket = bucket
        self.window_frames = window_frames
        self.device = torch.device(device)
        self.rng = rng if rng is not None else TorchRng.from_config(cfg, self.device)
        self.state = OnlineState(frames=[], poses=None, frame_slices=[], n_lc=0)
        self.counters: Dict[str, int] = {}
        self._feats: List = []  # detected features per frame (use_anno=False)
        # frame idx -> [(ref_img_id, corres rows)], the _match_pairs layout
        self._corres_rows: Dict[int, list] = {}
        self._accepted: List[tuple] = []  # two-stage accepted LC factors
        self._bbox_cache: Dict[int, object] = {}  # id(frame) -> geo bbox
        self._host: Dict[int, tuple] = {}  # frame idx -> host (altitudes, ground_ranges)
        self._last_info = None

    def add_frame(self, frame: Keyframe) -> se3.Pose3:
        """Take the next frame; returns the estimate over every frame so far."""
        if frame.geo.device.type != self.device.type:
            raise ValueError(f"frame on {frame.geo.device}, OnlineSlam on {self.device}")
        cfg = self.cfg
        st = self.state
        _check_supported(st.frames + [frame], cfg)
        st.frames.append(frame)
        new_idx = len(st.frames) - 1
        offsets = np.cumsum([0] + [int(f.dr_poses.shape[0]) for f in st.frames])
        st.frame_slices = [slice(int(offsets[k]), int(offsets[k + 1])) for k in range(len(st.frames))]
        self._host[new_idx] = (frame.altitudes.cpu().numpy(), frame.ground_ranges.cpu().numpy())

        # matching and loop closures run only for the pairs with the new frame
        pair_ids = _overlap_pairs(st.frames, cfg.min_overlap, cache=self._bbox_cache)
        new_pairs = [p for p in pair_ids if new_idx in p]
        self._corres_rows.setdefault(new_idx, [])
        if not cfg.pose_graph.use_anno:
            from .features import detect_features

            self._feats.append(detect_features(frame.norm, frame.mask, cfg.detector))
            if new_pairs:
                fresh = _match_pairs(st.frames, self._feats, [f.geo for f in st.frames], new_pairs, cfg,
                                     cfg.matcher, self.rng, self.counters, stacked=False)
                for i, lst in fresh.items():
                    if lst:
                        self._corres_rows.setdefault(i, []).extend(lst)

        if cfg.estimator == "full_ba":
            return self._solve_full_ba(pair_ids)
        return self._solve_two_stage(pair_ids, new_pairs, offsets)

    def _cut(self, offsets) -> tuple:
        """(first frame in the window, its first pose)."""
        n = len(self.state.frames)
        cut_frame = n - self.window_frames if self.window_frames is not None and n > self.window_frames else 0
        return cut_frame, int(offsets[cut_frame])

    # --- full BA: rebuild the joint problem, warm-start the poses ---
    def _solve_full_ba(self, pair_ids) -> se3.Pose3:
        from .solvers.full_ba import build_ba_problem, solve_full_ba

        cfg = self.cfg
        st = self.state
        use_anno = cfg.pose_graph.use_anno
        kps_pairs, _ = _assemble_pairs(st.frames, self._corres_rows, pair_ids, cfg, use_anno)
        ba_cfg = cfg.full_ba
        if not use_anno and ba_cfg.max_geo_discrepancy == 0:
            # detected matches carry outliers (the batch pipeline's gate)
            ba_cfg = dataclasses.replace(ba_cfg, max_geo_discrepancy=4.0)
        prob = build_ba_problem(st.frames, kps_pairs, pair_ids, ba_cfg, cfg.pose_graph)
        if st.poses is not None:
            prev_P = int(st.poses.t.shape[0])
            R0, t0 = prob.poses0.R.clone(), prob.poses0.t.clone()
            R0[:prev_P], t0[:prev_P] = st.poses.R, st.poses.t
            prob = prob._replace(poses0=se3.Pose3(R0, t0))

        offsets = np.cumsum([0] + [int(f.dr_poses.shape[0]) for f in st.frames])
        _, cut = self._cut(offsets)
        if cut > 0:
            prob = self._window_ba_problem(prob, cut)
        p_real = int(prob.poses0.t.shape[0])
        if self.bucket:
            prob = self._pad_ba_problem(prob)
        mesh = _maybe_mesh(cfg, self.device)
        if mesh is not None:
            from .parallel.seq import seq_full_ba_solve

            poses, _, info = seq_full_ba_solve(mesh, prob, ba_cfg, cfg.kp_noise)
        else:
            poses, _, info = solve_full_ba(prob, ba_cfg, cfg.kp_noise)
        win = poses[:p_real]
        st.poses = se3.cat([st.poses[:cut], win]) if cut > 0 else win
        st.n_lc = int(prob.kp_valid.sum())
        self._last_info = info
        return st.poses

    def _window_ba_problem(self, prob, cut: int):
        """Restrict a global BAProblem to poses ``[cut:]``: endpoints below the
        cut become constant poses at their previous estimate, factors with
        both endpoints below it drop, and the kept rows are compacted."""
        st = self.state
        dev = prob.kp_i.device
        kp_i, kp_j, valid = torch.stack([prob.kp_i, prob.kp_j, prob.kp_valid.to(torch.int64)]).cpu().numpy()
        valid = valid.astype(bool)
        fix_s = kp_i < cut
        fix_t = kp_j < cut
        idx = np.nonzero(valid & ~(fix_s & fix_t))[0]
        if len(idx) == 0:
            idx = np.array([0])
            keep_valid = np.zeros(1, bool)
        else:
            keep_valid = np.ones(len(idx), bool)
        fix_s, fix_t, kp_i, kp_j = fix_s[idx], fix_t[idx], kp_i[idx], kp_j[idx]
        frozen = st.poses  # every pose below the cut
        last = int(frozen.t.shape[0]) - 1

        def up(a, dtype=torch.int64):
            return torch.as_tensor(a, device=dev).to(dtype)

        sel = up(idx)
        return prob._replace(
            poses0=prob.poses0[cut:],
            odo_meas=prob.odo_meas[cut:],
            kp_i=up(np.where(fix_s, 0, kp_i - cut)), kp_j=up(np.where(fix_t, 0, kp_j - cut)),
            kp_sr_s=prob.kp_sr_s[sel], kp_sr_t=prob.kp_sr_t[sel],
            kp_valid=up(keep_valid, torch.bool),
            lm0=prob.lm0[sel], lm_prior=prob.lm_prior[sel],
            kp_i_fix=up(fix_s, torch.bool), kp_j_fix=up(fix_t, torch.bool),
            kp_pose_s=frozen[up(np.minimum(kp_i, last))], kp_pose_t=frozen[up(np.minimum(kp_j, last))],
        )

    def _pad_ba_problem(self, prob):
        """Bucket the pose (P, base 256) and correspondence (K, base 64) axes."""
        p_cap = bucket_capacity(int(prob.poses0.t.shape[0]))
        k = int(prob.kp_i.shape[0])
        k_cap = bucket_capacity(k, base=64)
        poses0, odo_meas = _pad_chain_to(prob.poses0, prob.odo_meas, p_cap)
        fixed = {}
        if prob.kp_i_fix is not None:
            # padded slots: not fixed, identity constant poses
            eye = se3.identity((k_cap - k,), prob.poses0.t.dtype, prob.poses0.t.device)
            fixed = dict(kp_i_fix=pad_rows(prob.kp_i_fix, k_cap, False),
                         kp_j_fix=pad_rows(prob.kp_j_fix, k_cap, False),
                         kp_pose_s=se3.cat([prob.kp_pose_s, eye]), kp_pose_t=se3.cat([prob.kp_pose_t, eye]))
        return prob._replace(
            poses0=poses0, odo_meas=odo_meas,
            kp_i=pad_rows(prob.kp_i, k_cap, 0), kp_j=pad_rows(prob.kp_j, k_cap, 0),
            kp_sr_s=pad_rows(prob.kp_sr_s, k_cap, 1.0), kp_sr_t=pad_rows(prob.kp_sr_t, k_cap, 1.0),
            kp_valid=pad_rows(prob.kp_valid, k_cap, False),
            lm0=pad_rows(prob.lm0, k_cap, 0.0), lm_prior=pad_rows(prob.lm_prior, k_cap, 0.0),
            **fixed,
        )

    # --- two-stage: LC mini-solves of the new pairs + the pose graph ---
    def _solve_two_stage(self, pair_ids, new_pairs, offsets) -> se3.Pose3:
        from .solvers.lc import loop_closing_tfs
        from .solvers.pose_graph import build_chain_graph, solve_pose_graph

        cfg = self.cfg
        st = self.state
        use_anno = cfg.pose_graph.use_anno
        dev = self.device

        for (i, j) in new_pairs:
            if use_anno:
                rows = st.frames[i].annos
            else:
                mine = [r for (ref_id, r) in self._corres_rows.get(i, []) if ref_id == st.frames[j].img_id]
                rows = np.concatenate(mine, axis=0) if mine else np.zeros((0, 6))
            kp = get_kps_pairs(rows, st.frames[j].img_id, *self._host[i], *self._host[j], use_anno=use_anno,
                               nadir_threshold=cfg.loop_closure.nadir_threshold)
            if not kp.valid.any():
                continue
            fi, fj = st.frames[i], st.frames[j]
            res = loop_closing_tfs(torch.as_tensor(kp.pairs, device=dev), torch.as_tensor(kp.valid, device=dev),
                                   fi.dr_poses, fj.dr_poses, fi.geo, fj.geo, fi.altitudes, fj.altitudes,
                                   fj.ground_ranges, n_bins=int(fi.raw.shape[1]), kp_cfg=cfg.kp_noise,
                                   cfg=cfg.loop_closure)
            q, var, Rm, tm = (a.cpu().numpy() for a in (res.quality, res.variance6, res.rel_pose.R, res.rel_pose.t))
            for k in range(len(q)):
                if not kp.valid[k] or not (q[k] > 0) or not np.all(np.isfinite(var[k])):
                    continue
                self._accepted.append((int(offsets[i] + kp.pairs[k, 0]), int(offsets[j] + kp.pairs[k, 3]),
                                       Rm[k], tm[k], np.sqrt(np.maximum(var[k], 1e-12))))

        # fixed-lag window: freeze the poses of frames older than the window
        # and re-anchor boundary-crossing loop closures onto the boundary pose
        cut_frame, cut = self._cut(offsets)
        factors = self._window_factors(cut)

        l_real = max(len(factors), 1)
        l_cap = bucket_capacity(l_real, base=16) if self.bucket else l_real
        lc_i = np.zeros(l_cap, np.int64)
        lc_j = np.full(l_cap, min(1, int(offsets[-1]) - cut - 1), np.int64)
        lc_sigmas = np.ones((l_cap, 6), np.float32)
        lc_valid = np.zeros(l_cap, bool)
        Rm = np.broadcast_to(np.eye(3, dtype=np.float32), (l_cap, 3, 3)).copy()
        tm = np.zeros((l_cap, 3), np.float32)
        for k, (fi, fj, R, t, sig) in enumerate(factors):
            lc_i[k], lc_j[k] = fi, fj
            Rm[k], tm[k] = R, t
            lc_sigmas[k] = sig
            lc_valid[k] = True
        lc_meas = se3.Pose3(torch.as_tensor(Rm, device=dev), torch.as_tensor(tm, device=dev))

        graph = build_chain_graph([f.dr_poses for f in st.frames[cut_frame:]], lc_i=lc_i, lc_j=lc_j,
                                  lc_meas=lc_meas, lc_sigmas=lc_sigmas, lc_valid=lc_valid, cfg=cfg.pose_graph,
                                  device=dev)
        # warm start: the previous estimate for the window poses seen before,
        # DR for the new frame; with a window, pose 0 is the boundary pose
        if st.poses is not None:
            prev_win = int(st.poses.t.shape[0]) - cut
            if prev_win > 0:
                R0, t0 = graph.poses0.R.clone(), graph.poses0.t.clone()
                R0[:prev_win], t0[:prev_win] = st.poses.R[cut:], st.poses.t[cut:]
                graph = graph._replace(poses0=se3.Pose3(R0, t0))
        p_real = int(graph.poses0.t.shape[0])
        if self.bucket:
            poses0, odo_meas = _pad_chain_to(graph.poses0, graph.odo_meas, bucket_capacity(p_real))
            graph = graph._replace(poses0=poses0, odo_meas=odo_meas)
        # warm-started from the previous estimate: a coarse DR-chain init
        # would only degrade it
        poses, info = solve_pose_graph(graph, cfg.pose_graph, allow_coarse_init=False)
        win = poses[:p_real]
        st.poses = se3.cat([st.poses[:cut], win]) if cut > 0 else win
        st.n_lc = int(lc_valid.sum())
        self._last_info = info
        return st.poses

    def _window_factors(self, cut: int) -> list:
        """The accepted loop closures as window factors ``(i, j, R, t,
        sigmas)`` with pose indices relative to ``cut``: those inside the
        window as they are, those with one endpoint below it re-anchored onto
        pose ``cut`` (at its current estimate, one batched compose per side),
        those with both below it dropped."""
        st = self.state
        src_frozen = [a for a in self._accepted if a[0] < cut <= a[1]]
        tgt_frozen = [a for a in self._accepted if a[1] < cut <= a[0]]
        anchored = {}
        for side, group in (("s", src_frozen), ("t", tgt_frozen)):
            if not group:
                continue
            m = se3.Pose3(torch.as_tensor(np.stack([a[2] for a in group]), device=self.device),
                          torch.as_tensor(np.stack([a[3] for a in group]), device=self.device))
            frozen = st.poses[torch.as_tensor([a[0] if side == "s" else a[1] for a in group], device=self.device)]
            boundary = st.poses[cut:cut + 1]
            m2 = (se3.compose(se3.between(boundary, frozen), m) if side == "s"
                  else se3.compose(m, se3.between(frozen, boundary)))
            R2, t2 = m2.R.cpu().numpy(), m2.t.cpu().numpy()
            for k, a in enumerate(group):
                anchored[id(a)] = (R2[k], t2[k])
        factors = []
        for a in self._accepted:
            gi, gj, R, t, sig = a
            if gi >= cut and gj >= cut:
                factors.append((gi - cut, gj - cut, R, t, sig))
            elif id(a) in anchored:
                factors.append((0, gj - cut, *anchored[id(a)], sig) if gi < cut
                               else (gi - cut, 0, *anchored[id(a)], sig))
        return factors

    def frame_poses(self, f: int) -> se3.Pose3:
        return self.state.poses[self.state.frame_slices[f]]

    def run_stream(self, frame_thunks, depth: int = 2):
        """Stream frames with pipeline overlap: a background thread runs the
        next thunks' host work while the current frame's detection, matching
        and solve run.  Each thunk returns the :func:`.frame.build_keyframe`
        arguments ``(img_id, image, dr_poses, altitudes, ground_ranges,
        annos)`` as host arrays; the keyframe is built here, on the consumer
        thread.  Yields the estimate after each frame."""
        from .frame import build_keyframe
        from .parallel.prefetch import prefetch_iter

        for args in prefetch_iter(frame_thunks, depth=depth):
            yield self.add_frame(build_keyframe(*args, device=self.device))
