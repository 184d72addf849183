"""Row padding: the append-fill-rows idiom of every capacity + mask site.

Counterpart of :mod:`diasss_tpu.padding`.  Tensors stay on their device.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def pad_rows(a: torch.Tensor, n_rows: int, fill=0) -> torch.Tensor:
    """Pad dim 0 of ``a`` with ``fill`` up to ``n_rows`` (no-op if already
    at least that long).  Bool tensors pad with ``False`` under the default
    fill: the validity-mask convention."""
    pad = n_rows - a.shape[0]
    if pad <= 0:
        return a
    return torch.cat([a, torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype, device=a.device)])


def pad_rows_tree(tree, n_rows: int, fill=0):
    """:func:`pad_rows` over every tensor leaf of a tree (NamedTuples too)."""
    return pytree.tree_map(lambda a: pad_rows(a, n_rows, fill), tree)


def pad_to_multiple(a: torch.Tensor, m: int, fill=0) -> torch.Tensor:
    """Pad dim 0 up to the next multiple of ``m`` (the mesh-alignment idiom)."""
    return pad_rows(a, a.shape[0] + ((-a.shape[0]) % m), fill)
