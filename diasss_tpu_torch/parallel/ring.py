"""Ring-pass correspondence search over the ranks of a mesh.

Counterpart of :mod:`diasss_tpu.parallel.ring`: both keypoint sets are
sharded over the ranks; query blocks stay resident and reference blocks
ride the ring (one point-to-point exchange per step, the ring-attention
pattern), so no rank ever holds more than a ``(Kq/n, Kr/n)`` distance
block.  The running (best, second-best) merge reproduces the global top-2
with the lower global index winning ties, so the decisions equal the
single-device geo-gated search
(:func:`..matching.geosearch.geo_nn_search`, FEAmatcher.cpp:52-321): the
same bound by metric and id parity, ratio test and single-candidate rule.
The second-best's spatial exclusion (``ratio_excl_radius``) is not part of
the ring, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..config import MatcherConfig
from ..matching.geosearch import _BIG, NNResult, accept, accept_bound, descriptor_distance
from .collectives import Mesh, all_gather, ppermute
from .shard import block_of


def ring_geo_nn_search(geo_q, desc_q, valid_q, geo_r, desc_r, valid_r, ref_bbox,
                       cfg: MatcherConfig = MatcherConfig(), parity_flip: bool = False,
                       mesh: Mesh | None = None) -> NNResult:
    """The distributed geo-gated NN search; returns ``geo_nn_search``'s
    ``(corres, n_candidates, best_dist)``, whole on every rank.  ``Kq`` and
    ``Kr`` must be multiples of the mesh size (pad with invalid slots)."""
    if mesh is None:
        from .distributed import global_mesh

        mesh = global_mesh(geo_q.device)
    n, me = mesh.size, mesh.rank
    Kq, Kr = int(geo_q.shape[0]), int(geo_r.shape[0])
    if Kq % n or Kr % n:
        raise ValueError(f"ring search needs keypoint counts divisible by {n}, got {Kq} and {Kr}")
    qb, rb = block_of(mesh, Kq), block_of(mesh, Kr)
    gq, dq, vq = geo_q[qb], desc_q[qb], valid_q[qb]
    gr, dr, vr = geo_r[rb], desc_r[rb], valid_r[rb]
    blk = Kr // n
    bound = accept_bound(cfg, torch.as_tensor(parity_flip, device=gq.device))
    in_bbox = ((gq[:, 0] >= ref_bbox[0]) & (gq[:, 0] <= ref_bbox[1])
               & (gq[:, 1] >= ref_bbox[2]) & (gq[:, 1] <= ref_bbox[3]))
    kq = gq.shape[0]
    best = torch.full((kq,), _BIG, dtype=torch.float32, device=gq.device)
    second = best.clone()
    best_id = torch.zeros(kq, dtype=torch.int64, device=gq.device)
    ncand = torch.zeros(kq, dtype=torch.int64, device=gq.device)
    off = me * blk
    perm = [(i, (i + 1) % n) for i in range(n)]
    for step in range(n):
        d2 = torch.sum((gq[:, None, :] - gr[None, :, :]) ** 2, dim=-1)
        gate = (d2 < cfg.geo_radius ** 2) & vq[:, None] & vr[None, :] & in_bbox[:, None]
        masked = torch.where(gate, descriptor_distance(dq, dr, cfg), _BIG)
        i1 = torch.argmin(masked, dim=-1)  # the first index among equal distances
        b1 = torch.gather(masked, -1, i1[:, None])[:, 0]
        b2 = (masked.scatter(-1, i1[:, None], _BIG).amin(-1) if blk >= 2
              else torch.full_like(b1, _BIG))
        i1 = i1 + off
        # merge the running top-2 with the block's: the lower global index
        # wins ties, as the single-device argmin over the whole row
        take = (b1 < best) | ((b1 == best) & (i1 < best_id))
        second = torch.minimum(torch.where(take, best, b1), torch.minimum(second, b2))
        best = torch.where(take, b1, best)
        best_id = torch.where(take, i1, best_id)
        ncand = ncand + gate.sum(-1)
        if step + 1 < n:
            gr, dr, vr, o = ppermute(mesh, [gr, dr, vr, torch.tensor([off], device=gq.device)], perm)
            off = int(o[0])
    ok = accept(best, second, ncand, bound, cfg)
    corres = torch.where(ok, best_id, torch.full_like(best_id, -1))
    out = all_gather(mesh, torch.stack([corres, ncand])).transpose(0, 1).reshape(2, Kq)
    return NNResult(corres=out[0], n_candidates=out[1], best_dist=all_gather(mesh, best).reshape(Kq))
