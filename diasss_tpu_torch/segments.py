"""Segment sums in a fixed order of addition.

``index_add_`` on a CUDA tensor adds with atomics, so a float sum that
several rows share comes out in a different order, and so with different
last bits, from one run to the next.  Near an optimum the LM stall test is
decided by differences of that size, so a solve on the card did not repeat
itself (ROADMAP C14).  The JAX package's segment sums are deterministic on
the TPU.

A :class:`Segments` plan sorts the indices once (a stable sort, so the rows
of a segment keep their order) and sums each segment with
``torch.segment_reduce``, which adds a segment's rows in one fixed order on
every device.  The indices of a solve do not change across its LM trials,
so one plan serves all of them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Segments(NamedTuple):
    """The rows of ``idx`` sorted by segment: ``perm`` (F,) orders the rows,
    ``lengths`` (n,) counts the rows of each of the n segments."""

    perm: torch.Tensor
    lengths: torch.Tensor

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) sums of the rows of ``x`` (F, ...) in each segment; an
        empty segment sums to zero."""
        return torch.segment_reduce(x[self.perm], "sum", lengths=self.lengths, axis=0, unsafe=True)


def segments(idx: torch.Tensor, n: int) -> Segments:
    """The plan of the segment indices ``idx`` (F,), each in ``[0, n)``."""
    order = torch.sort(idx, stable=True)
    bounds = torch.searchsorted(order.values, torch.arange(n + 1, dtype=idx.dtype, device=idx.device))
    return Segments(order.indices, bounds[1:] - bounds[:-1])


def segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``zeros((n, ...)).index_add_(0, idx, x)`` in a fixed order."""
    return segments(idx, n).sum(x)


def chain_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, ...) sums of chain factors: row ``i`` of ``a`` (P-1, ...) at ``i``
    and of ``b`` at ``i + 1``; no scatter."""
    z = torch.zeros_like(a[:1])
    return torch.cat([a, z]) + torch.cat([z, b])
