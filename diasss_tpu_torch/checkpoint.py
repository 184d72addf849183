"""Checkpoint and resume of pipeline and solver state.

Counterpart of :mod:`diasss_tpu.checkpoint`, with the same ``.npz`` keys, so
a snapshot written by one package loads in the other:

* loop-closure results and the solved trajectory (``save/load_lc_results``,
  ``save/load_trajectory_state``), so evaluation and reporting resume
  without a re-solve;
* the full LM state of either solver (``save/load_solver_state``: poses,
  landmarks, damping ``lam`` as float64, trials done, stall counter), and
  :func:`solve_pose_graph_checkpointed` / :func:`solve_full_ba_checkpointed`,
  which run the solver in chunks of ``chunk`` LM trials (``lam0`` /
  ``stall0``), snapshot the state between chunks with an atomic replace, and
  on restart continue from the snapshot: the rerun reaches the one-shot
  solve's optimum having paid only the remaining trials.

Loaders put tensors on ``device`` (the card unless the caller asks for the
CPU); the checkpointed solvers keep their input's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from .geometry import se3
from .solvers.lc import LCResult


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _makedirs(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def save_lc_results(path: str, lc: Dict[tuple, LCResult]) -> None:
    _makedirs(path)
    arrays = {}
    manifest = []
    for (i, j), res in lc.items():
        key = f"{i}_{j}"
        manifest.append([i, j])
        arrays[f"{key}_rel_R"] = _np(res.rel_pose.R)
        arrays[f"{key}_rel_t"] = _np(res.rel_pose.t)
        for field in LCResult._fields:
            if field != "rel_pose":
                arrays[f"{key}_{field}"] = _np(getattr(res, field))
    np.savez_compressed(path, manifest=np.asarray(manifest), **arrays)


def load_lc_results(path: str, device="cuda") -> Dict[tuple, LCResult]:
    data = np.load(path)

    def up(name):
        return torch.as_tensor(data[name], device=device)

    out: Dict[tuple, LCResult] = {}
    for i, j in data["manifest"]:
        key = f"{i}_{j}"
        kwargs = {"rel_pose": se3.Pose3(up(f"{key}_rel_R"), up(f"{key}_rel_t"))}
        for field in LCResult._fields:
            if field != "rel_pose":
                kwargs[field] = up(f"{key}_{field}")
        out[(int(i), int(j))] = LCResult(**kwargs)
    return out


def save_trajectory_state(path: str, poses: se3.Pose3, frame_slices, meta: dict | None = None) -> None:
    _makedirs(path)
    np.savez_compressed(path, R=_np(poses.R), t=_np(poses.t),
                        slices=np.asarray([[s.start, s.stop] for s in frame_slices]), meta=json.dumps(meta or {}))


def load_trajectory_state(path: str, device="cuda"):
    data = np.load(path, allow_pickle=False)
    poses = se3.Pose3(torch.as_tensor(data["R"], device=device), torch.as_tensor(data["t"], device=device))
    slices = [slice(int(a), int(b)) for a, b in data["slices"]]
    return poses, slices, json.loads(str(data["meta"]))


def save_solver_state(path: str, poses: se3.Pose3, lam, iterations: int, landmarks=None, meta: dict | None = None,
                      stall: int = 0) -> None:
    """Snapshot a solver's LM state: iterate, damping, trials done and the
    stall counter (so the two-trial stall exit is the same across chunks)."""
    _makedirs(path)
    arrays = dict(R=_np(poses.R), t=_np(poses.t), lam=np.asarray(float(lam), np.float64),
                  iterations=np.asarray(int(iterations), np.int64), stall=np.asarray(int(stall), np.int64),
                  meta=json.dumps(meta or {}))
    if landmarks is not None:
        arrays["landmarks"] = _np(landmarks)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)  # atomic: a kill mid-write never corrupts the snapshot


def load_solver_state(path: str, device="cuda"):
    data = np.load(path, allow_pickle=False)
    poses = se3.Pose3(torch.as_tensor(data["R"], device=device), torch.as_tensor(data["t"], device=device))
    lms = torch.as_tensor(data["landmarks"], device=device) if "landmarks" in data else None
    return dict(poses=poses, lam=float(data["lam"]), iterations=int(data["iterations"]),
                stall=int(data["stall"]) if "stall" in data else 0, landmarks=lms,
                meta=json.loads(str(data["meta"])))


def _chunked(total_iters: int, chunk: int):
    done = 0
    while done < total_iters:
        yield min(chunk, total_iters - done)
        done += chunk


def solve_pose_graph_checkpointed(graph, cfg=None, path: str = "solver_ckpt.npz", chunk: int = 5):
    """:func:`.solvers.pose_graph.solve_pose_graph` in resumable chunks of
    ``chunk`` trials: the LM loop is split at chunk boundaries with iterate,
    damping and stall counter carried over.  If ``path`` exists the solve
    resumes from it; the snapshot is deleted at the end.  Returns (poses,
    info); a resume at a finished snapshot runs a zero-trial solve, so
    ``info`` describes the snapshot's iterate."""
    from .config import PoseGraphConfig
    from .solvers.pose_graph import solve_pose_graph

    cfg = cfg or PoseGraphConfig()
    done, lam, stall = 0, None, 0
    if os.path.exists(path):
        st = load_solver_state(path, graph.poses0.t.device)
        graph = graph._replace(poses0=st["poses"])
        lam, done, stall = st["lam"], st["iterations"], st["stall"]
    info = None
    for n in _chunked(cfg.max_gn_iters - done, chunk):
        if stall >= 2:
            break
        poses, info = solve_pose_graph(graph, dataclasses.replace(cfg, max_gn_iters=n), lam0=lam, stall0=stall)
        done += info.iterations
        lam, stall = float(info.lam), info.stall
        graph = graph._replace(poses0=poses)
        save_solver_state(path, poses, lam, done, stall=stall, meta={"error": float(info.error)})
        if info.iterations < n:  # converged inside the chunk
            break
    if info is None:
        _, info = solve_pose_graph(graph, dataclasses.replace(cfg, max_gn_iters=0), lam0=lam, stall0=stall)
    if os.path.exists(path):
        os.remove(path)
    return graph.poses0, info


def solve_full_ba_checkpointed(prob, cfg, kp_cfg, path: str = "ba_ckpt.npz", chunk: int = 5):
    """:func:`.solvers.full_ba.solve_full_ba` in resumable chunks (poses,
    landmarks and damping snapshotted), as
    :func:`solve_pose_graph_checkpointed`.  Returns (poses, landmarks,
    info)."""
    from .solvers.full_ba import solve_full_ba

    done, lam, stall = 0, None, 0
    if os.path.exists(path):
        st = load_solver_state(path, prob.poses0.t.device)
        prob = prob._replace(poses0=st["poses"], lm0=st["landmarks"])
        lam, done, stall = st["lam"], st["iterations"], st["stall"]
    info = None
    lms = prob.lm0
    for n in _chunked(cfg.max_iters - done, chunk):
        if stall >= 2:
            break
        poses, lms, info = solve_full_ba(prob, dataclasses.replace(cfg, max_iters=n), kp_cfg, lam0=lam, stall0=stall)
        done += info.iterations
        lam, stall = float(info.lam), info.stall
        prob = prob._replace(poses0=poses, lm0=lms)
        save_solver_state(path, poses, lam, done, landmarks=lms, stall=stall, meta={"error": float(info.error)})
        if info.iterations < n:
            break
    if info is None:
        _, lms, info = solve_full_ba(prob, dataclasses.replace(cfg, max_iters=0), kp_cfg, lam0=lam, stall0=stall)
    if os.path.exists(path):
        os.remove(path)
    return prob.poses0, lms, info
