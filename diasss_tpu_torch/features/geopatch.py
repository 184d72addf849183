"""World-aligned geo-patch descriptors: the sonar-native matching descriptor.

Counterpart of :mod:`diasss_tpu.features.geopatch`.  The normalized
waterfall is sampled on a world-aligned metric grid around each keypoint:
the local inverse of the geo map is the 2x2 Jacobian d(world)/d(bin, ping)
by central differences at the keypoint, inverted in closed form, and the
patch is bilinear-sampled at the pixel coordinates of each grid node.  The
descriptor is mean-subtracted and L2-normalized, so the matcher's dot
product is the normalized cross-correlation.  Batched over frames and
keypoints.
"""

from __future__ import annotations

import torch


def _geo_patch_batch(img, geo, xy, half: int, res: float):
    """Descriptors of a batch of frames: ``img`` (F, N, M), ``geo``
    (F, N, M, 2), ``xy`` (F, K, 2) -> ((F, K, G) descriptors, (F, K) ok)."""
    img = img.to(torch.float32)
    Fn, n, m = img.shape
    dev = img.device
    f = torch.arange(Fn, device=dev)[:, None]
    b = xy[..., 0].to(torch.int32).to(torch.int64)
    p = xy[..., 1].to(torch.int32).to(torch.int64)
    bc = torch.clamp(b, 1, m - 2)
    pc = torch.clamp(p, 1, n - 2)

    # central-difference world Jacobian wrt (bin, ping): world ~ J @ (db, dp)
    dgb = (geo[f, pc, bc + 1] - geo[f, pc, bc - 1]) * 0.5  # (F, K, 2)
    dgp = (geo[f, pc + 1, bc] - geo[f, pc - 1, bc]) * 0.5
    J = torch.stack([dgb, dgp], dim=-1)  # (F, K, 2, 2)
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    ok = torch.abs(det) > 1e-6
    det_safe = torch.where(ok, det, 1.0)
    Jinv = torch.stack([torch.stack([J[..., 1, 1], -J[..., 0, 1]], -1),
                        torch.stack([-J[..., 1, 0], J[..., 0, 0]], -1)], -2) / det_safe[..., None, None]

    # world-aligned grid -> per-keypoint fractional pixel offsets
    g = torch.arange(-half, half + 1, dtype=torch.float32, device=dev) * res
    oy, ox = torch.meshgrid(g, g, indexing="ij")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)])  # (2, G) world offsets
    pix = Jinv[..., :, 0, None] * offs[0] + Jinv[..., :, 1, None] * offs[1]  # (F, K, 2, G): (dbin, dping)
    sb = b[..., None].to(torch.float32) + pix[..., 0, :]
    sp = p[..., None].to(torch.float32) + pix[..., 1, :]

    # bilinear sample; out-of-image nodes fall back to the patch mean
    sb0 = torch.clamp(torch.floor(sb), 0, m - 2)
    sp0 = torch.clamp(torch.floor(sp), 0, n - 2)
    fb = torch.clamp(sb - sb0, 0.0, 1.0)
    fp = torch.clamp(sp - sp0, 0.0, 1.0)
    bi, pi = sb0.to(torch.int64), sp0.to(torch.int64)
    ff = f[..., None]
    v = (img[ff, pi, bi] * (1 - fb) * (1 - fp) + img[ff, pi, bi + 1] * fb * (1 - fp)
         + img[ff, pi + 1, bi] * (1 - fb) * fp + img[ff, pi + 1, bi + 1] * fb * fp)  # (F, K, G)
    inb = (sb >= 0) & (sb <= m - 1) & (sp >= 0) & (sp <= n - 1)
    cnt = torch.clamp(inb.sum(-1, keepdim=True), min=1)
    mean = torch.where(inb, v, 0.0).sum(-1, keepdim=True) / cnt
    v = torch.where(inb, v, mean) - mean
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    desc = v / torch.clamp(nrm, min=1e-6)
    return desc, ok & (nrm[..., 0] > 1e-3)


def geo_patch_descriptors(norm_img: torch.Tensor, geo: torch.Tensor, xy: torch.Tensor, half: int = 8,
                          res: float = 0.5):
    """``(desc, ok)``: (K, (2*half+1)^2) unit descriptors of keypoints ``xy``
    (K, 2) (bin, ping) and a (K,) mask, false where the local Jacobian is
    singular (at nadir) or the patch has no contrast."""
    desc, ok = _geo_patch_batch(norm_img[None], geo[None], xy[None], half, res)
    return desc[0], ok[0]


def attach_geo_patch_descriptors(feats, norm_img, geo, cfg):
    """``feats`` with geo-patch descriptors computed against ``geo`` (DR geo,
    or drift-compensated geo on re-match rounds); keypoints with a singular
    Jacobian or no contrast are invalidated."""
    desc, ok = geo_patch_descriptors(norm_img, geo, feats.xy, half=cfg.geopatch_half, res=cfg.geopatch_res)
    return feats._replace(desc=desc, valid=feats.valid & ok)


def attach_geo_patch_descriptors_batch(feats_list, norm_list, geo_list, cfg):
    """:func:`attach_geo_patch_descriptors` of every frame: one batch when
    the frames share image shape and keypoint capacity, else frame by frame."""
    same = len({tuple(x.shape) for x in norm_list}) == 1 and len({int(f.xy.shape[0]) for f in feats_list}) == 1
    if not same or len(feats_list) <= 1:
        return [attach_geo_patch_descriptors(f, x, g, cfg) for f, x, g in zip(feats_list, norm_list, geo_list)]
    descs, oks = _geo_patch_batch(torch.stack(list(norm_list)), torch.stack(list(geo_list)),
                                  torch.stack([f.xy for f in feats_list]), cfg.geopatch_half, cfg.geopatch_res)
    return [f._replace(desc=descs[k], valid=f.valid & oks[k]) for k, f in enumerate(feats_list)]
