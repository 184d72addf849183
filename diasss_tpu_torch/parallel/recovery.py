"""Elastic failure recovery: heartbeat-gated chunked solves that survive
losing ranks.

Counterpart of :mod:`diasss_tpu.parallel.recovery`.  The sequence-parallel
solver's state is explicit (pose iterate, LM damping, stall counter), so
recovery is a group rebuild plus a warm restart:

1. the solve runs in chunks of ``chunk`` LM trials;
2. at every chunk boundary a probe decides which ranks are alive — by
   default :func:`heartbeat_probe` (an all-reduce of ones under a
   watchdog); tests inject probes that drop ranks deliberately;
3. when the set changes, a group of the alive ranks is built with only
   those ranks taking part (``new_group(..., use_local_synchronization=True)``:
   a dead peer is never waited for), the chain re-partitions to the new
   block size, and the solve continues from the carried state; a rank that
   comes back receives that state by a broadcast from the first rank that
   carried it;
4. with ``path`` set, every boundary also snapshots to disk
   (:func:`..checkpoint.save_solver_state`), so the state survives the
   loss of every process (kill and resume).

A rank left out of a chunk waits at the default store for the survivors'
record of that chunk: the final one carries the result, so every rank
returns it.  Same fixed point as the uninterrupted solve: the iterate and
damping carry over exactly; only the chunk boundaries and the rank count
differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import threading
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..config import PoseGraphConfig
from ..geometry import se3
from ..solvers.pose_graph import PoseGraph
from .collectives import Mesh, broadcast, solo
from .seq import seq_pose_graph_solve

# rank sets whose heartbeat HUNG (not errored): {key: chunks to skip}.  A
# hung collective cannot be cancelled, so re-probing the same set at once
# would stack another hung collective on it every chunk; the period doubles
# (1, 2, 4, ... chunk boundaries) up to 64.  Keys are stable identities
# (transport, rank), never object ids.
_hang_backoff: dict = {}
_HANG_BACKOFF_CAP = 64
_calls = [0]  # elastic solves run by this process: the store keys of each


def _rank_set_key(ranks, transport: str) -> tuple:
    return tuple((transport, int(r)) for r in ranks)


def group_mesh(mesh: Mesh, ranks) -> Mesh:
    """The mesh of ``ranks`` (ranks of the default group, in order) on
    ``mesh``'s device: ``mesh`` itself for its whole set, a group-less mesh
    for this rank alone, else a new group that only those ranks build."""
    ranks = tuple(sorted(int(r) for r in ranks))
    me = mesh.ranks[mesh.rank]
    if ranks == tuple(sorted(mesh.ranks)):
        return mesh
    if ranks == (me,):
        return solo(mesh)
    group = dist.new_group(list(ranks), use_local_synchronization=True)
    return Mesh(group=group, rank=ranks.index(me), size=len(ranks), device=mesh.device, transport=mesh.transport,
                ranks=ranks)


def heartbeat_probe(chunk_idx: int, ranks: list, retries: int = 1, timeout_s: float = 30.0,
                    mesh: Optional[Mesh] = None) -> list:
    """Default liveness probe: the heartbeat over the candidate ``ranks``
    (ranks of the default group; this rank among them); returns them all if
    it counts them all.  A clean collective error is retried ``retries``
    times before any shrink (one transient error must not serialize the
    rest of the solve).  A dead peer usually shows as a collective that
    HANGS, so each attempt runs in a daemon thread under a ``timeout_s``
    watchdog; a hang is not retried (the abandoned attempt still holds its
    collective) and the set enters the re-probe backoff.  On failure the
    probe falls back to this rank alone: the failure does not say which
    peer died.  ``mesh``: the mesh the ranks belong to (default the global
    mesh)."""
    from .distributed import global_mesh, heartbeat

    base = mesh if mesh is not None else global_mesh()
    me = base.ranks[base.rank]
    key = _rank_set_key(ranks, base.transport)
    left = _hang_backoff.get(key)
    if left is not None and left.get("skip", 0) > 0:
        left["skip"] -= 1
        return left["fallback"]

    def attempt() -> Optional[bool]:
        result = {}

        def work():
            try:
                result["ok"] = heartbeat(group_mesh(base, ranks)) == len(ranks)
            except Exception:  # a collective failure
                result["ok"] = False

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(timeout_s)
        return result.get("ok")  # None: timed out (a hung peer)

    hung = False
    for _ in range(max(retries, 0) + 1):
        ok = attempt()
        if ok:
            _hang_backoff.pop(key, None)
            return list(ranks)
        if ok is None:  # a hang: do not stack another collective on these ranks
            hung = True
            break
    local = [me]
    if hung:
        prev = _hang_backoff.get(key, {"period": 1})
        period = min(prev.get("period", 1) * 2, 64)
        _hang_backoff.pop(key, None)  # re-insert: newest in insertion order
        _hang_backoff[key] = {"skip": period - 1, "period": period, "fallback": local}
        while len(_hang_backoff) > _HANG_BACKOFF_CAP:
            _hang_backoff.pop(next(iter(_hang_backoff)))
    return local


def _pack_state(poses: se3.Pose3, lam, done: int, stall: int) -> torch.Tensor:
    P = poses.t.shape[0]
    head = torch.tensor([float(lam if lam is not None else -1.0), done, stall, P], dtype=torch.float64)
    return torch.cat([head.to(poses.t.device), poses.R.reshape(-1).double(), poses.t.reshape(-1).double()])


def _unpack_state(x: torch.Tensor, dtype):
    lam, done, stall, P = x[:4].tolist()
    P = int(P)
    R = x[4:4 + 9 * P].reshape(P, 3, 3).to(dtype)
    t = x[4 + 9 * P:4 + 12 * P].reshape(P, 3).to(dtype)
    return se3.Pose3(R, t), (None if lam < 0 else lam), int(done), int(stall)


def _store():
    from torch.distributed.distributed_c10d import _get_default_store

    return _get_default_store()


def elastic_seq_pose_graph_solve(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig(), chunk: int = 5,
                                 mesh: Optional[Mesh] = None,
                                 probe: Optional[Callable[[int, list], list]] = heartbeat_probe,
                                 path: Optional[str] = None):
    """Sequence-parallel pose-graph solve that survives losing ranks; every
    rank of ``mesh`` (default the global mesh) calls it with the same graph.

    Returns ``(poses, info, events)``, the same on every rank; ``events``
    records every change of the rank set, shrink or re-grow, as
    ``(chunk_idx, n_before, n_after)``.  The probe gets the full original
    rank list at every boundary, so ranks that come back are re-admitted."""
    from .. import checkpoint as ckpt
    from .distributed import global_mesh

    mesh = mesh if mesh is not None else global_mesh(graph.poses0.t.device)
    _calls[0] += 1
    token = f"diasss_elastic/{_calls[0]}"
    all_ranks = list(mesh.ranks)
    me = all_ranks[mesh.rank]
    dtype, dev = graph.poses0.t.dtype, graph.poses0.t.device
    members = all_ranks  # the ranks that carry the state into the next chunk
    done, lam, stall, poses0 = 0, None, 0, graph.poses0
    if path and os.path.exists(path):
        st = ckpt.load_solver_state(path, device=dev)
        poses0, lam, done, stall = st["poses"], st["lam"], st["iterations"], st["stall"]

    events: List[tuple] = []
    info, cur, chunk_idx = None, mesh, 0
    while done < cfg.max_gn_iters:
        alive = sorted(probe(chunk_idx, all_ranks)) if probe is not None else members
        if alive != sorted(members):
            events.append((chunk_idx, len(members), len(alive)))
        if me not in alive:
            # left out: wait for the survivors' record of this chunk
            rec = torch.load(io.BytesIO(_store().get(f"{token}/{chunk_idx}")), weights_only=True)
            members = alive
            if bool(rec["finished"]):
                poses0, lam, done, stall = _unpack_state(rec["state"].to(dev), dtype)
                info = None
                break
            chunk_idx += 1
            continue
        cur = group_mesh(mesh, alive)
        carriers = [r for r in alive if r in members]
        if len(carriers) < len(alive):  # re-admitted ranks: the state from its first carrier
            state = _pack_state(poses0, lam, done, stall)
            head = broadcast(cur, state[:4].clone(), src=alive.index(carriers[0]))
            if me not in carriers:
                state = torch.zeros(4 + 12 * int(head[3]), dtype=torch.float64, device=dev)
            poses0, lam, done, stall = _unpack_state(broadcast(cur, state, src=alive.index(carriers[0])), dtype)
        members = alive
        if stall >= 2:
            break
        n_it = min(chunk, cfg.max_gn_iters - done)
        poses0, info = seq_pose_graph_solve(cur, graph._replace(poses0=poses0),
                                            dataclasses.replace(cfg, max_gn_iters=n_it), lam0=lam, stall0=stall)
        done += int(info.iterations)
        lam, stall = float(info.lam), int(info.stall)
        finished = int(info.iterations) < n_it or done >= cfg.max_gn_iters or stall >= 2
        if cur.rank == 0:
            if path:
                ckpt.save_solver_state(path, poses0, lam, done, stall=stall, meta={"error": float(info.error)})
            buf = io.BytesIO()
            torch.save({"finished": torch.tensor(finished), "state": _pack_state(poses0, lam, done, stall).cpu()}, buf)
            _store().set(f"{token}/{chunk_idx}", buf.getvalue())
        if finished:
            break
        chunk_idx += 1
    if info is None:
        # resumed at a converged snapshot, or left out at the end: a
        # zero-trial solve gives a consistent SolveInfo
        alone = solo(mesh)
        _, info = seq_pose_graph_solve(alone, graph._replace(poses0=poses0),
                                       dataclasses.replace(cfg, max_gn_iters=0), lam0=lam, stall0=stall)
    if path and cur.rank == 0 and me in members:
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)
    return poses0, info, events
