"""The mesh of the port and the collectives its per-rank code calls.

Counterpart of the named-axis collectives the JAX package calls inside
``shard_map`` (:mod:`diasss_tpu.parallel.seq`, ``ring``, ``alltoall``).  The
port runs one process per rank (PyTorch's SPMD idiom): every rank runs the
same function on its own block, and each ``lax`` collective becomes a call
on the mesh's process group:

==========================  ============================================
``lax`` inside shard_map    here
==========================  ============================================
``lax.axis_index(axis)``    ``mesh.rank``
``lax.psum(x, axis)``       :func:`psum` (``all_reduce`` SUM) where each
                            element has one owner (a masked gather), or
                            :func:`psum_ordered` (an all-gather summed in
                            rank order) where the sum steers the LM
``lax.ppermute(x, perm)``   :func:`ppermute` (``batch_isend_irecv`` with
                            the same pairs)
``lax.all_gather(x)``       :func:`all_gather`
``lax.all_to_all``          :func:`all_to_all` (``all_to_all_single`` over
                            the same ``(n, capacity, row)`` layout)
(replicated input)          :func:`broadcast`
==========================  ============================================

Two transports, chosen by the caller through the group's backend and never
switched on failure:

* ``nccl`` — one rank per GPU, tensors stay on the card;
* ``gloo`` — every collective stages its tensors through host memory (gloo
  runs ``all_to_all`` and point-to-point only on CPU tensors).  It is the
  CPU tests' transport and the only way to put several ranks on one card
  (NCCL refuses two ranks on one GPU).  Compute stays on the rank's device;
  only the exchange crosses the host.

Every result is the same on every rank: :func:`psum` only ever adds zeros
to one owner's value, and :func:`psum_ordered` adds the gathered
contributions in rank order on each rank, so the scalar LM state (error,
damping, stall) and every accept/reject decision agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-axis mesh of ``size`` ranks: this process is rank ``rank``,
    computes on ``device``, and talks over ``group`` (``transport`` is the
    group's backend).  ``ranks`` are the members' ranks in the default
    group, in mesh order (point-to-point calls address them)."""

    group: object
    rank: int
    size: int
    device: torch.device
    transport: str
    ranks: Tuple[int, ...]
    # a one-rank mesh may carry no group (:func:`solo`); with a group, even
    # of one rank, every collective goes through it

    @property
    def staged(self) -> bool:
        """The exchange crosses host memory (gloo) although compute may not."""
        return self.transport == "gloo"


def _out(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the transport takes it: contiguous, on the host for gloo,
    bool carried as uint8."""
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if mesh.staged:
        x = x.cpu()
    return x.contiguous()


def _fresh(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """:func:`_out` in storage of its own, for the collectives that write
    their input in place."""
    t = _out(mesh, x)
    return t.clone() if t.data_ptr() == x.data_ptr() else t


def _back(mesh: Mesh, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=mesh.device, dtype=like.dtype)


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``lax.psum``: the elementwise sum over ranks (``all_reduce`` SUM).
    Bit-identical on every rank where at most one rank holds a nonzero
    element (the masked-gather idiom); use :func:`psum_ordered` otherwise."""
    if mesh.group is None:
        return x
    t = _fresh(mesh, x)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return _back(mesh, t, x)


def psum_ordered(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``lax.psum`` with the ranks' contributions added in rank order on
    every rank: the same bits everywhere, whatever the transport."""
    if mesh.group is None:
        return x
    g = all_gather(mesh, x)
    out = g[0]
    for k in range(1, mesh.size):
        out = out + g[k]
    return out


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``lax.all_gather``: (n, *x.shape), row k from rank k."""
    if mesh.group is None:
        return x[None]
    t = _out(mesh, x)
    if mesh.staged:
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t, group=mesh.group)
        out = torch.stack(parts)
    else:
        out = torch.empty((mesh.size, *t.shape), dtype=t.dtype, device=t.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, t, group=mesh.group)
    return _back(mesh, out, x)


def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``lax.ppermute`` of several tensors at once: for each ``(src, dst)``
    of ``perm`` (mesh ranks), rank ``src`` sends its ``xs`` to ``dst``;
    returns what this rank received (zeros where no pair sends to it).  One
    ``batch_isend_irecv`` for all tensors; NCCL sends to itself, gloo
    cannot, so there a pair from this rank to itself is a copy."""
    me = mesh.rank
    outs = [torch.zeros_like(x) for x in xs]
    ops, recvs = [], []
    for src, dst in perm:
        if src == me == dst and (mesh.group is None or mesh.transport != "nccl"):
            outs = [x.clone() for x in xs]
            continue
        if src == me:
            ops += [dist.P2POp(dist.isend, _out(mesh, x), mesh.ranks[dst], mesh.group) for x in xs]
        if dst == me:
            bufs = [_out(mesh, torch.empty_like(x)) for x in xs]
            recvs.append(bufs)
            ops += [dist.P2POp(dist.irecv, b, mesh.ranks[src], mesh.group) for b in bufs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for bufs in recvs:
        outs = [_back(mesh, b, x) for b, x in zip(bufs, xs)]
    return outs


def all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all`` (split and concat on axis 0, tiled): ``x`` is
    (n, ...), row block ``k`` goes to rank ``k``; returns (n, ...) whose row
    block ``a`` came from rank ``a``."""
    if mesh.group is None:
        return x
    t = _out(mesh, x)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.group)
    return _back(mesh, out, x)


def broadcast(mesh: Mesh, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (the replicated inputs of the JAX
    package's multi-process model)."""
    if mesh.group is None:
        return x
    t = _fresh(mesh, x)
    dist.broadcast(t, src=mesh.ranks[src], group=mesh.group)
    return _back(mesh, t, x)


def solo(mesh: Mesh, rank: int | None = None) -> Mesh:
    """A one-rank mesh without a group on ``mesh``'s device: every
    collective is the identity (a rank that continues alone)."""
    me = mesh.ranks[mesh.rank] if rank is None else rank
    return Mesh(group=None, rank=0, size=1, device=mesh.device, transport=mesh.transport, ranks=(me,))
