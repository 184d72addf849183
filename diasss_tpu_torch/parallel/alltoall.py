"""Owner-aligned resharding by one ``all_to_all`` per leaf.

Counterpart of :mod:`diasss_tpu.parallel.alltoall`.  Rows of a tree sharded
over the ranks (by arrival order) move to the rank ``dest[k]``, with a
static per-destination ``capacity``: overflow rows are dropped and counted,
so callers can size the capacity.  Each rank sorts its block by destination
(stable), lays the rows out as an ``(n, capacity, row)`` send buffer and
exchanges it in one ``all_to_all``; rank ``d`` receives ``[rows from rank
0 (capacity), rows from rank 1, ...]``, each lane in its sender's stable
destination order.  ``seq._simulate_reshard_layout`` replicates this layout
on the host, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..padding import pad_rows
from .collectives import Mesh, all_gather, all_to_all, psum_ordered
from .shard import block_of


def _send_layout(dest_blk: torch.Tensor, valid_blk: torch.Tensor, n: int, capacity: int):
    """This rank's send plan: the sort order of its rows by destination,
    each sorted row's (destination, slot) in the (n+1, capacity+1) buffer
    (row n and slot ``capacity`` are the dump of invalid and overflow rows),
    and the rows sent and dropped per destination."""
    kb = dest_blk.shape[0]
    d = torch.where(valid_blk, dest_blk, torch.full_like(dest_blk, n))
    d_sorted, order = torch.sort(d, stable=True)
    idx = torch.arange(kb, device=d.device)
    is_start = torch.ones(kb, dtype=torch.bool, device=d.device)
    is_start[1:] = d_sorted[1:] != d_sorted[:-1]
    block_start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)), 0).values
    lane_rank = idx - block_start
    overflow = lane_rank >= capacity
    real = d_sorted < n
    slot = torch.where(overflow | ~real, capacity, lane_rank)
    sent = torch.bincount(d_sorted[real & ~overflow], minlength=n + 1)[:n]
    dropped = torch.bincount(d_sorted[real & overflow], minlength=n + 1)[:n]
    return order, d_sorted, slot, overflow, sent, dropped


def reshard_local(mesh: Mesh, tree, dest: torch.Tensor, valid: torch.Tensor, capacity: int):
    """The exchange on this rank's block of rows: ``tree``, ``dest`` and
    ``valid`` hold every row (same on every rank, a mesh multiple of them).
    Returns ``(rows (n * capacity, ...), valid (n * capacity,), rows dropped
    by this rank per destination)``."""
    n = mesh.size
    blk = block_of(mesh, int(dest.shape[0]))
    dest_b, valid_b = dest[blk], valid[blk]
    order, d_sorted, slot, overflow, _, dropped = _send_layout(dest_b, valid_b, n, capacity)

    def send(x):
        buf = torch.zeros((n + 1, capacity + 1, *x.shape[1:]), dtype=x.dtype, device=x.device)
        buf[d_sorted, slot] = x[order]
        return buf[:n, :capacity]

    kept = torch.zeros_like(valid_b)
    kept[order] = ~overflow
    out = pytree.tree_map(lambda x: all_to_all(mesh, send(x[blk])).reshape(n * capacity, *x.shape[1:]), tree)
    vout = all_to_all(mesh, send(valid_b & kept)).reshape(n * capacity)
    return out, vout, dropped


def reshard_rows(mesh: Mesh, tree, dest: torch.Tensor, valid: torch.Tensor | None = None,
                 capacity: int | None = None):
    """Move each row of ``tree`` (leading axis, sharded over the ranks by
    its order) to the rank ``dest[k]``.

    Returns ``(tree_out, valid_out, dropped_total)``: the ranks' receive
    buffers of ``n * capacity`` rows each, concatenated in rank order
    (``n * n * capacity`` rows, whole on every rank), their validity mask,
    and the rows dropped for exceeding ``capacity`` on some (src, dst) lane.
    ``capacity`` defaults to the balanced ``ceil(K / n^2) * 2``."""
    n = mesh.size
    k = int(dest.shape[0])
    if valid is None:
        valid = torch.ones(k, dtype=torch.bool, device=dest.device)
    if capacity is None:
        capacity = max(1, int(np.ceil(k / (n * n))) * 2)
    kp = k + (-k) % n
    tree = pytree.tree_map(lambda a: pad_rows(a, kp), tree)
    out, vout, dropped = reshard_local(mesh, tree, pad_rows(dest, kp), pad_rows(valid, kp), int(capacity))
    whole = pytree.tree_map(lambda a: all_gather(mesh, a).reshape(-1, *a.shape[1:]), out)
    total = int(psum_ordered(mesh, dropped).sum())
    return whole, all_gather(mesh, vout).reshape(-1), total
