"""State carried between the JAX package and the port.

The system has no weights; its state is the trees of arrays the pipeline
passes between stages.  :func:`to_torch` turns a tree of the JAX package
(``Keyframe``, ``DetectedFeatures``, ``Pose3``, ``KpsPairs``, ``PoseGraph``,
``LCResult``, ``BAProblem``, with JAX or numpy leaves) into the port's tree of the same name
with tensors on ``device``; :func:`to_numpy` turns a port tree into the same
tree with numpy leaves, whose fields line up with the JAX type's.  Neither
imports JAX: JAX arrays convert through ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from .pairs import KpsPairs

from .features.detector import DetectedFeatures
from .frame import Keyframe
from .geometry.se3 import Pose3
from .solvers.full_ba import BAProblem
from .solvers.lc import LCResult
from .solvers.pose_graph import PoseGraph

PORT_TYPES = {cls.__name__: cls for cls in (Keyframe, DetectedFeatures, Pose3, KpsPairs, PoseGraph, LCResult,
                                            BAProblem)}
# fields that stay host numpy in both packages
_HOST_FIELDS = {("Keyframe", "annos"), ("KpsPairs", "pairs"), ("KpsPairs", "valid")}
# integer fields the port indexes with (int64 indices)
_INDEX_FIELDS = {("PoseGraph", "lc_i"), ("PoseGraph", "lc_j"), ("BAProblem", "kp_i"), ("BAProblem", "kp_j")}


def _is_tree(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, device="cuda"):
    """JAX-package tree -> the port's tree of the same type name on ``device``
    (the card unless the caller asks for another)."""
    name = type(tree).__name__
    if name not in PORT_TYPES:
        raise TypeError(f"no port counterpart for {name}; known: {sorted(PORT_TYPES)}")
    out = []
    for field, value in zip(tree._fields, tree):
        if _is_tree(value):
            out.append(to_torch(value, device))
        elif (name, field) in _HOST_FIELDS:
            out.append(np.asarray(value))
        elif isinstance(value, (int, str)) or value is None:
            out.append(value)
        else:
            t = torch.as_tensor(np.array(value), device=device)
            out.append(t.to(torch.int64) if (name, field) in _INDEX_FIELDS else t)
    return PORT_TYPES[name](*out)


def to_numpy(tree):
    """Port tree -> the same tree with numpy leaves (host copies)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if _is_tree(tree):
        return type(tree)(*[to_numpy(v) for v in tree])
    return tree
