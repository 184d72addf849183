"""Parallelism of the port: the host-side overlap of parsing with device
work (:mod:`.prefetch`) and the multi-device layer on ``torch.distributed``
(:mod:`.collectives`, :mod:`.distributed`, :mod:`.shard`, :mod:`.alltoall`,
:mod:`.seq`, :mod:`.ring`, :mod:`.recovery`, :mod:`.multihost_check`), one
process per rank."""

from .ring import ring_geo_nn_search
from .shard import make_mesh, sharded_full_ba_solve, sharded_lc_solve, sharded_pose_graph_solve

__all__ = [
    "make_mesh",
    "ring_geo_nn_search",
    "sharded_full_ba_solve",
    "sharded_lc_solve",
    "sharded_pose_graph_solve",
]
