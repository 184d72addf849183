"""Dense world-correlation matching: correspondences without detector
repeatability.

Counterpart of :mod:`diasss_tpu.matching.dense` (full-map path):

1. every frame is rasterized into a world-aligned grid (scatter-mean of the
   normalized waterfall by deterministic segment sums), keeping per-cell mean (ping, bin)
   provenance so matches map back to waterfall coordinates;
2. each source keypoint's world-aligned patch is read from its own frame's
   raster, and slid over every stride-1 offset around its predicted position
   in the target raster: the two q-dependent correlation maps come from one
   :func:`qcorr` call (the hand-written CUDA kernel on the card, B2), the
   window statistics from integral images, the NCC of every offset follows
   elementwise, and the coarse lattice + stride-1 refinement index that map;
3. a local displacement-field consistency filter keeps matches that agree
   with the median displacement of their accepted neighbours.

The stacked matcher (:func:`dense_matching_stacked`, the batch pipeline)
makes the pair axis a real batch dimension: all gated pairs' keypoints go
into one :func:`qcorr` call per match round as ``(pairs * K, S, S)``
windows, every frame rasterized at the survey-common shape.  The per-pair
matcher (:func:`dense_matching`, the online stream) correlates one pair per
:func:`qcorr` call against rasters fitted to each frame
(:func:`world_raster`), so its cells are the JAX package's per-pair cells.
The JAX package's round-5 lattice branch (``_split_parity_planes``, the
``lattice`` argument), which it takes off the TPU, is not ported: the port
computes the full map on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DenseMatchConfig, DetectorConfig
from ..segments import segment_sum


class WorldRaster(NamedTuple):
    """A frame's world-aligned raster (:func:`world_raster`)."""

    img: torch.Tensor  # (H, W) mean normalized intensity (0 where empty)
    cnt: torch.Tensor  # (H, W) contributing-pixel count
    ping: torch.Tensor  # (H, W) mean source ping index
    col: torch.Tensor  # (H, W) mean source bin (column) index
    x0: float  # world origin of cell (0, 0), a float32 value
    y0: float
    res: float


class DenseMatches(NamedTuple):
    tgt_geo: torch.Tensor  # (..., K, 2) matched world position in the target raster
    tgt_ping: torch.Tensor  # (..., K) target ping (float, scatter-mean provenance)
    tgt_col: torch.Tensor  # (..., K) target bin
    score: torch.Tensor  # (..., K) best NCC
    ok: torch.Tensor  # (..., K) accepted mask (pre smoothness filter)


def _rasterize(norm_img, geo, x0, y0, res: float, width: int, height: int):
    """Scatter-mean rasters of a batch of frames: ``norm_img`` (F, N, M),
    ``geo`` (F, N, M, 2), ``x0``/``y0`` (F,) float32 -> (img, cnt, ping, col),
    each (F, height, width).  One segment sum (:mod:`..segments`, a fixed
    order of addition on every device) of all four quantities over all
    frames."""
    Fn, n, m = norm_img.shape
    dev = norm_img.device
    xi = torch.clamp(((geo[..., 0] - x0[:, None, None]) / res).to(torch.int32), 0, width - 1)
    yi = torch.clamp(((geo[..., 1] - y0[:, None, None]) / res).to(torch.int32), 0, height - 1)
    total = width * height
    frame = torch.arange(Fn, device=dev)[:, None, None] * total
    flat = (frame + yi.to(torch.int64) * width + xi.to(torch.int64)).reshape(-1)
    v = norm_img.to(torch.float32).reshape(-1)
    pings = torch.arange(n, dtype=torch.float32, device=dev)[None, :, None].expand(Fn, n, m).reshape(-1)
    cols = torch.arange(m, dtype=torch.float32, device=dev)[None, None, :].expand(Fn, n, m).reshape(-1)

    c, s, sp, sc = segment_sum(torch.stack([torch.ones_like(v), v, pings, cols], 1), flat, Fn * total).unbind(1)
    cs = torch.clamp(c, min=1.0)
    shape = (Fn, height, width)
    return (s / cs).reshape(shape), c.reshape(shape), (sp / cs).reshape(shape), (sc / cs).reshape(shape)


def _shape_from_bounds(xmin, xmax, ymin, ymax, res: float, margin: float):
    width = int(np.ceil((xmax + 2 * margin - xmin) / res)) + 1
    height = int(np.ceil((ymax + 2 * margin - ymin) / res)) + 1
    return int(np.ceil(height / 64) * 64), int(np.ceil(width / 64) * 64)


def _geo_bounds_batch(geo_st: torch.Tensor) -> torch.Tensor:
    """(F, N, M, 2) stacked geo -> (F, 4) [xmin, xmax, ymin, ymax]."""
    x = geo_st[..., 0].reshape(geo_st.shape[0], -1)
    y = geo_st[..., 1].reshape(geo_st.shape[0], -1)
    return torch.stack([x.amin(1), x.amax(1), y.amin(1), y.amax(1)], dim=1)


def _geo_kps_batch(geo_st: torch.Tensor, xy_st: torch.Tensor) -> torch.Tensor:
    """(F, N, M, 2) geo + (F, K, 2) pixel coords -> (F, K, 2) world positions."""
    N, M = geo_st.shape[1], geo_st.shape[2]
    xi = torch.clamp(xy_st[..., 0].to(torch.int32), 0, M - 1).to(torch.int64)
    yi = torch.clamp(xy_st[..., 1].to(torch.int32), 0, N - 1).to(torch.int64)
    f = torch.arange(geo_st.shape[0], device=geo_st.device)[:, None]
    return geo_st[f, yi, xi]


def _origins(bb: np.ndarray, margin: float):
    """float32 raster origins ``min - margin`` of (F, 4) float32 bounds."""
    m = np.float32(margin)
    return (bb[:, 0] - m).astype(np.float32), (bb[:, 2] - m).astype(np.float32)


def raster_shape(geo: torch.Tensor, res: float, margin: float = 2.0):
    """(height, width) a frame's world raster needs, bucketed to x64."""
    bb = _geo_bounds_batch(geo[None]).cpu().numpy()[0]
    return _shape_from_bounds(*bb, res, margin)


def world_raster(norm_img: torch.Tensor, geo: torch.Tensor, res: float, margin: float = 2.0,
                 shape: tuple | None = None) -> WorldRaster:
    """World-aligned raster of one frame, origin at its geo minimum less
    ``margin``; ``shape=(H, W)`` overrides the frame-fit dims
    (:func:`raster_shape`).  One host read of the frame's geo bounds."""
    bb = _geo_bounds_batch(geo[None]).cpu().numpy()
    height, width = _shape_from_bounds(*bb[0], res, margin) if shape is None else shape
    x0, y0 = _origins(bb, margin)
    img, cnt, ping, col = _rasterize(norm_img[None], geo[None], torch.as_tensor(x0, device=geo.device),
                                     torch.as_tensor(y0, device=geo.device), res, width, height)
    return WorldRaster(img[0], cnt[0], ping[0], col[0], float(x0[0]), float(y0[0]), res)


def _window_slices(img: torch.Tensor, cnt: torch.Tensor, cy, cx, ext: int, size: int):
    """(B, K, size, size) windows of ``img``/``cnt`` (B, H, W) at rows
    ``cy - ext ..`` and columns ``cx - ext ..`` (``cy``, ``cx`` (B, K)), as
    the JAX package reads them: the raster is edge-padded by ``2 * ext`` on
    every side and each window's start is clamped into the padded raster, so
    a centre further out than ``ext`` reads a shifted window (callers mask
    those keypoints out)."""
    p = 2 * ext
    B, H, W = img.shape
    img_p = F.pad(img[:, None], (p, p, p, p), mode="replicate")[:, 0]
    cnt_p = F.pad(cnt[:, None], (p, p, p, p), mode="replicate")[:, 0]
    Hp, Wp = H + 2 * p, W + 2 * p
    y0 = torch.clamp(cy.to(torch.int64) + ext, 0, Hp - size)
    x0 = torch.clamp(cx.to(torch.int64) + ext, 0, Wp - size)
    ar = torch.arange(size, device=img.device)
    rows = (y0[..., None] + ar)[..., :, None]  # (B, K, size, 1)
    cols = (x0[..., None] + ar)[..., None, :]  # (B, K, 1, size)
    b = torch.arange(B, device=img.device)[:, None, None, None]
    return img_p[b, rows, cols], cnt_p[b, rows, cols]


def _cells(geo_kp, x0, y0, res: float):
    """Raster cell (cx, cy) of world positions (B, K, 2); origins (B,)."""
    cx = torch.round((geo_kp[..., 0] - x0[:, None]) / res).to(torch.int32)
    cy = torch.round((geo_kp[..., 1] - y0[:, None]) / res).to(torch.int32)
    return cx, cy


def _raster_patches(img, cnt, x0, y0, res: float, geo_kp, half: int, min_cover: float):
    """(B, K, (2*half+1)^2) mean-free unit patches read from each frame's own
    raster (``img``, ``cnt`` (B, H, W)) at each keypoint's cell, + validity
    (coverage and contrast)."""
    cx, cy = _cells(geo_kp, x0, y0, res)
    k = 2 * half + 1
    vw, cw = _window_slices(img, cnt, cy, cx, half, k)
    v = vw.reshape(*vw.shape[:2], k * k)
    have = (cw > 0).reshape(v.shape)
    nh = have.sum(-1)
    mean = torch.where(have, v, 0.0).sum(-1) / torch.clamp(nh, min=1)
    vz = torch.where(have, v - mean[..., None], 0.0)
    nrm = torch.linalg.vector_norm(vz, dim=-1)
    desc = vz / torch.clamp(nrm, min=1e-6)[..., None]
    return desc, (nh >= min_cover * k * k) & (nrm > 1e-3)


def qcorr_plain(Wvh: torch.Tensor, Wh: torch.Tensor, q: torch.Tensor, k: int, T: int):
    """The two q-dependent correlation maps, each (K, T, T), of windows
    ``Wvh, Wh`` (K, S, S) and flattened patches ``q`` (K, k*k), S = T + k - 1:
    ``A[r, t1, t2] = sum_g q[r, g] * Wvh[r, t1 + g // k, t2 + g % k]`` and
    ``B`` the same over ``Wh``; g ascending, each step ``A = A + q_g * W_g``
    (the shift-scan of the JAX package's ``_correlate``)."""
    K = Wvh.shape[0]
    A = torch.zeros((K, T, T), dtype=torch.float32, device=Wvh.device)
    B = torch.zeros_like(A)
    for g in range(k * k):
        dy, dx = divmod(g, k)
        qi = q[:, g][:, None, None]
        A = A + qi * Wvh[:, dy:dy + T, dx:dx + T]
        B = B + qi * Wh[:, dy:dy + T, dx:dx + T]
    return A, B


CPU_QCORR_ROWS = 1024  # keypoints per plain call on the CPU: each block's maps stay in cache


def qcorr(Wvh: torch.Tensor, Wh: torch.Tensor, q: torch.Tensor, k: int, T: int):
    """:func:`qcorr_plain` for CPU tensors, over blocks of
    :data:`CPU_QCORR_ROWS` keypoints (rows are independent: the same maps
    bit for bit, several times faster than one call at tens of thousands of
    rows); the CUDA kernel of :mod:`.dense_cuda` (which raises on anything
    it does not take) for CUDA tensors."""
    from . import dense_cuda

    if Wvh.device.type == "cpu":
        dense_cuda.check_inputs(Wvh, Wh, q, k, T)
        blocks = [qcorr_plain(Wvh[r:r + CPU_QCORR_ROWS], Wh[r:r + CPU_QCORR_ROWS], q[r:r + CPU_QCORR_ROWS], k, T)
                  for r in range(0, Wvh.shape[0], CPU_QCORR_ROWS)]
        if len(blocks) == 1:
            return blocks[0]
        return torch.cat([a for a, _ in blocks]), torch.cat([b for _, b in blocks])
    return dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T)


def _correlate(desc_q, ok_q, geo_q, img, cnt, ping, col, x0, y0, res: float, half: int, n_ring: int,
               step_cells: int, ncc_min: float, ncc_ratio: float, min_cover: float) -> DenseMatches:
    """Dense NCC search of a batch of keypoint sets (B, K) against their
    target rasters (B, H, W): the shift-scan formulation of the JAX package's
    ``_correlate`` on its full-map path.

    Windows (B, K, S, S) are read once per keypoint; the q-dependent maps
    come from one :func:`qcorr` call over all B*K keypoints; the
    q-independent window statistics (sum have, sum v*have, sum v^2*have over
    every k x k window) from integral images; the NCC of every stride-1
    offset follows elementwise.  The coarse lattice, the second-best outside
    the winner's neighbourhood and the stride-1 refinement index that map."""
    Bn, H, W = img.shape
    k = 2 * half + 1
    R = n_ring + max(step_cells - 1, 0)
    T = 2 * R + 1
    S = T + k - 1
    K = desc_q.shape[1]
    dev = img.device

    cx, cy = _cells(geo_q, x0, y0, res)
    vw, cw = _window_slices(img, cnt, cy, cx, R + half, S)
    Wv = vw * (1.0 / 255.0)
    Wh = (cw > 0).to(torch.float32)
    Wvh = Wv * Wh

    def box_sums(X):
        c = torch.cumsum(torch.cumsum(X, dim=-2), dim=-1)
        c = F.pad(c, (1, 0, 1, 0))
        return c[..., k:k + T, k:k + T] - c[..., 0:T, k:k + T] - c[..., k:k + T, 0:T] + c[..., 0:T, 0:T]

    C1 = box_sums(Wh)
    C2 = box_sums(Wvh)
    C3 = box_sums(Wv * Wvh)
    mean = C2 / torch.clamp(C1, min=1.0)
    nrm = torch.sqrt(torch.clamp(C3 - mean * mean * C1, min=0.0))
    doff = torch.arange(T, device=dev) - R
    cover_ok = C1 >= min_cover * k * k
    oy = cy[..., None] + doff
    ox = cx[..., None] + doff
    inb_y = ((oy - half) >= 0) & ((oy + half) < H)  # (B, K, T)
    inb_x = ((ox - half) >= 0) & ((ox + half) < W)
    valid = cover_ok & (nrm > 1e-3 / 255.0) & inb_y[..., :, None] & inb_x[..., None, :]

    Aq, Bq = qcorr(Wvh.reshape(Bn * K, S, S).contiguous(), Wh.reshape(Bn * K, S, S).contiguous(),
                   desc_q.reshape(Bn * K, k * k).contiguous(), k, T)
    Aq, Bq = Aq.reshape(Bn, K, T, T), Bq.reshape(Bn, K, T, T)
    s_full = (Aq - mean * Bq) / torch.clamp(nrm, min=1e-6)
    s_full = torch.where(valid, s_full, -2.0)  # (B, K, T, T)

    # coarse lattice = the original candidate grid (row-major offsets)
    g = torch.arange(-n_ring, n_ring + 1, step_cells, dtype=torch.int64, device=dev)
    offs = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)  # (O, 2)
    lat = g + R
    scores = s_full[..., lat[:, None], lat[None, :]].reshape(Bn, K, -1)  # (B, K, O)

    best_o = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
    best = torch.gather(scores, -1, best_o[..., None])[..., 0]
    boff = offs[best_o]  # (B, K, 2)
    # second best outside the best's immediate neighbourhood (correlated cells)
    sep = torch.amax(torch.abs(offs - boff[..., None, :]), dim=-1)  # (B, K, O)
    far = sep > max(2, step_cells)
    second = torch.amax(torch.where(far, scores, -2.0), dim=-1)

    if step_cells > 1:
        # stride-1 refinement around the coarse winner (all within +-R)
        dg = torch.arange(-(step_cells - 1), step_cells, dtype=torch.int64, device=dev)
        deltas = torch.stack(torch.meshgrid(dg, dg, indexing="ij"), -1).reshape(-1, 2)  # (D, 2)
        fy = boff[..., 0, None] + deltas[:, 0] + R  # (B, K, D)
        fx = boff[..., 1, None] + deltas[:, 1] + R
        fine = torch.gather(s_full.reshape(Bn, K, T * T), -1, fy * T + fx)
        fbest = torch.argmax(fine, dim=-1)
        best = torch.gather(fine, -1, fbest[..., None])[..., 0]
        boff = boff + deltas[fbest]

    ok = ok_q & (best >= ncc_min)
    if ncc_ratio < 1.0:
        ok = ok & ((1.0 - best) <= ncc_ratio * (1.0 - torch.clamp(second, min=-1.0)))

    myy = torch.clamp(cy.to(torch.int64) + boff[..., 0], 0, H - 1)
    mxx = torch.clamp(cx.to(torch.int64) + boff[..., 1], 0, W - 1)
    tgt_geo = torch.stack([x0[:, None] + mxx.to(torch.float32) * res,
                           y0[:, None] + myy.to(torch.float32) * res], dim=-1)
    b = torch.arange(Bn, device=dev)[:, None]
    return DenseMatches(tgt_geo=tgt_geo, tgt_ping=ping[b, myy, mxx], tgt_col=col[b, myy, mxx],
                        score=best, ok=ok)


def _smooth_filter_dev(kp_geo, tgt_geo, ok, radius: float, min_neighbors: int, tol: float):
    """Local displacement-field consistency of a batch (B, K): keep matches
    whose displacement agrees (within ``tol``) with the componentwise median
    displacement of accepted neighbours within ``radius``; matches with fewer
    than ``min_neighbors`` neighbours are dropped.  The masked median is a
    sort of the neighbour-masked (B, K, K) displacement rows, one component
    at a time, with numpy's rule for an even count."""
    d = tgt_geo - kp_geo  # (B, K, 2)
    diff = kp_geo[..., :, None, :] - kp_geo[..., None, :, :]
    dist2 = (diff * diff).sum(-1)  # (B, K, K)
    del diff
    K = kp_geo.shape[-2]
    eye = torch.eye(K, dtype=torch.bool, device=kp_geo.device)
    nbr = (dist2 <= radius * radius) & ok[..., None, :] & ~eye
    del dist2
    nn = nbr.sum(-1)  # (B, K)
    lo_i = torch.clamp((nn - 1) // 2, min=0)[..., None]
    hi_i = (nn // 2)[..., None]

    def med(comp):
        m = torch.where(nbr, comp[..., None, :], 1e9)
        s = torch.sort(m, dim=-1).values
        return 0.5 * (torch.gather(s, -1, lo_i)[..., 0] + torch.gather(s, -1, hi_i)[..., 0])

    m0 = d[..., 0] - med(d[..., 0])
    m1 = d[..., 1] - med(d[..., 1])
    dev = torch.sqrt(m0 ** 2 + m1 ** 2)
    return ok & (nn >= min_neighbors) & (dev <= tol)


def _smooth_filter(kp_geo, tgt_geo, ok, cfg: DenseMatchConfig) -> torch.Tensor:
    """:func:`_smooth_filter_dev` of one keypoint set (K,) with the
    smoothness settings of ``cfg``; no accepted match short-circuits to an
    all-False mask (one host read of ``ok.any()``)."""
    if not bool(ok.any()):
        return torch.zeros_like(ok)
    return _smooth_filter_dev(kp_geo.to(torch.float32), tgt_geo.to(torch.float32), ok,
                              radius=float(cfg.smooth_radius), min_neighbors=int(cfg.smooth_min_neighbors),
                              tol=float(cfg.smooth_tol))


def _dense_pairs_program(rimg, rcnt, rping, rcol, x0s, y0s, geo_kps, kp_valid, si, ti, res: float,
                         half: int, n_ring: int, step_cells: int, ncc_min: float, ncc_ratio: float,
                         min_cover: float, radius: float, min_neighbors: int, tol: float):
    """All gated pairs' patches, correlation and displacement-field filter,
    with the pair axis as the batch dimension: ``rimg``.. (F, H, W) stacked
    rasters, ``x0s``/``y0s`` (F,), ``geo_kps`` (F, K, 2), ``kp_valid``
    (F, K), ``si``/``ti`` (Pn,) source/target frame per pair.  Returns the
    (Pn, K) :class:`DenseMatches` and the (Pn, K) keep mask."""
    geo_kp = geo_kps[si]
    desc_q, ok_q = _raster_patches(rimg[si], rcnt[si], x0s[si], y0s[si], res, geo_kp, half, min_cover)
    dm = _correlate(desc_q, ok_q & kp_valid[si], geo_kp, rimg[ti], rcnt[ti], rping[ti], rcol[ti],
                    x0s[ti], y0s[ti], res, half=half, n_ring=n_ring, step_cells=step_cells,
                    ncc_min=ncc_min, ncc_ratio=ncc_ratio, min_cover=min_cover)
    keep = _smooth_filter_dev(geo_kp, dm.tgt_geo, dm.ok, radius=radius, min_neighbors=min_neighbors, tol=tol)
    return dm, keep


def _corres_rows(img_id_s, img_id_t, xy, idx, ping_t, col_t):
    """(rows_s, rows_t) in the corres_kps layout (img_id, ref_id, ping, bin,
    ref_ping, ref_bin) for the kept source keypoints ``idx``."""
    n = len(idx)
    rows_s = np.empty((n, 6), np.float64)
    rows_s[:, 0] = img_id_s
    rows_s[:, 1] = img_id_t
    rows_s[:, 2] = xy[idx, 1]
    rows_s[:, 3] = xy[idx, 0]
    rows_s[:, 4] = np.round(ping_t[idx])
    rows_s[:, 5] = np.round(col_t[idx])
    rows_t = np.empty((n, 6), np.float64)
    rows_t[:, 0] = img_id_t
    rows_t[:, 1] = img_id_s
    rows_t[:, 2:4] = rows_s[:, 4:6]
    rows_t[:, 4:6] = rows_s[:, 2:4]
    return rows_s, rows_t


def dense_matching_stacked(pair_ids, img_ids, feats_list, norm_list, geo_list, det_cfg: DetectorConfig,
                           cfg: DenseMatchConfig, mesh=None):
    """Whole-survey dense matching: every frame rasterized once at the
    survey-common raster shape, every gated pair correlated and
    smoothness-filtered in one batch, one device-to-host transfer.

    Requires all frames to share the keypoint capacity K.  Returns ``{(i, j): (rows_s, rows_t, n)}``
    in the corres_kps layout.

    ``mesh``: the pair axis is data-parallel over its ranks (the rasters
    are made whole on every rank; each rank correlates its block of pairs,
    so the q-correlation kernel runs on every rank; dummy pairs, frame 0
    against itself, fill the last block and their results are cut off);
    one all-gather of the per-pair outcomes, the same rows on every rank."""
    res = det_cfg.geopatch_res
    dev = geo_list[0].device
    xy_st = torch.stack([f.xy for f in feats_list])
    if len({tuple(g.shape) for g in geo_list}) == 1:
        # one bounds reduction and one rasterization for all frames
        margin = 2.0
        geo_st = torch.stack(list(geo_list))
        bb = _geo_bounds_batch(geo_st).cpu().numpy()  # (F, 4) float32
        shapes = [_shape_from_bounds(*bb[f], res, margin) for f in range(len(geo_list))]
        H = max(s[0] for s in shapes)
        W = max(s[1] for s in shapes)
        x0_np, y0_np = _origins(bb, margin)
        x0s, y0s = torch.as_tensor(x0_np, device=dev), torch.as_tensor(y0_np, device=dev)
        rimg, rcnt, rping, rcol = _rasterize(torch.stack(list(norm_list)), geo_st, x0s, y0s, res, W, H)
        geo_kps = _geo_kps_batch(geo_st, xy_st)
    else:
        # frames of different shapes (the JAX package's mixed branch): each
        # rasterized on its own at the survey-common shape, each keypoint's
        # geo read from its own frame, clipped to that frame's axes
        shapes = [raster_shape(g, res) for g in geo_list]
        H = max(s[0] for s in shapes)
        W = max(s[1] for s in shapes)
        rasters = [world_raster(nm, g, res, shape=(H, W)) for nm, g in zip(norm_list, geo_list)]
        rimg, rcnt, rping, rcol = (torch.stack([getattr(r, a) for r in rasters]) for a in ("img", "cnt", "ping", "col"))
        x0s = torch.tensor([r.x0 for r in rasters], dtype=torch.float32, device=dev)
        y0s = torch.tensor([r.y0 for r in rasters], dtype=torch.float32, device=dev)
        geo_kps = torch.cat([_geo_kps_batch(g[None], f.xy[None]) for f, g in zip(feats_list, geo_list)])
    kp_valid = torch.stack([f.valid for f in feats_list])
    si = torch.as_tensor([i for (i, j) in pair_ids], dtype=torch.int64, device=dev)
    ti = torch.as_tensor([j for (i, j) in pair_ids], dtype=torch.int64, device=dev)

    n_pairs = len(pair_ids)
    if mesh is not None:
        from ..padding import pad_to_multiple
        from ..parallel.shard import block_of

        si, ti = pad_to_multiple(si, mesh.size), pad_to_multiple(ti, mesh.size)
        blk = block_of(mesh, int(si.shape[0]))
        si, ti = si[blk], ti[blk]
    n_ring = int(np.ceil(cfg.search_radius / res))
    dm, keep = _dense_pairs_program(
        rimg, rcnt, rping, rcol, x0s, y0s, geo_kps, kp_valid, si, ti,
        res=res, half=det_cfg.geopatch_half, n_ring=n_ring, step_cells=cfg.step_cells,
        ncc_min=cfg.ncc_min, ncc_ratio=cfg.ncc_ratio, min_cover=cfg.min_cover,
        radius=float(cfg.smooth_radius), min_neighbors=int(cfg.smooth_min_neighbors), tol=float(cfg.smooth_tol),
    )
    per_pair = torch.stack([keep.to(torch.float32), dm.tgt_ping, dm.tgt_col])  # (3, pairs, K)
    if mesh is not None:
        from ..parallel.collectives import all_gather

        per_pair = all_gather(mesh, per_pair).transpose(0, 1).reshape(3, -1, per_pair.shape[2])[:, :n_pairs]
    # one transfer for the whole survey: keep, ping, col per pair + all frames' keypoints
    K = per_pair.shape[2]
    host = torch.cat([per_pair.reshape(-1), xy_st.reshape(-1)]).cpu().numpy()
    packed = host[: 3 * n_pairs * K].reshape(3, n_pairs, K)
    keep_np, ping_np, col_np = packed[0] > 0, packed[1], packed[2]
    xy_np = host[3 * n_pairs * K:].reshape(xy_st.shape)

    out = {}
    for p, (i, j) in enumerate(pair_ids):
        idx = np.nonzero(keep_np[p])[0]
        rows_s, rows_t = _corres_rows(img_ids[i], img_ids[j], xy_np[i], idx, ping_np[p], col_np[p])
        out[(i, j)] = (rows_s, rows_t, len(idx))
    return out



def dense_matching(img_id_s: int, img_id_t: int, feats_s, frame_s_norm: torch.Tensor, geo_s: torch.Tensor,
                   frame_t_norm: torch.Tensor, geo_t: torch.Tensor, det_cfg: DetectorConfig, cfg: DenseMatchConfig,
                   raster_s: WorldRaster | None = None, raster_t: WorldRaster | None = None):
    """Match one frame's source keypoints into a target frame by dense world
    correlation, each frame on its own fitted raster.  ``frame_s_norm`` /
    ``frame_t_norm``: the two frames' normalized (uint8) images, read only
    to build a raster that is not passed in (``raster_s`` / ``raster_t``
    reuse rasters across pairs).  One :func:`qcorr` call.  Returns
    ``(rows_s, rows_t, n_matches)`` in the corres_kps layout."""
    res = det_cfg.geopatch_res
    dev = geo_s.device
    xi = torch.clamp(feats_s.xy[:, 0].to(torch.int32), 0, geo_s.shape[1] - 1).to(torch.int64)
    yi = torch.clamp(feats_s.xy[:, 1].to(torch.int32), 0, geo_s.shape[0] - 1).to(torch.int64)
    geo_kp = geo_s[yi, xi]
    rs = raster_s if raster_s is not None else world_raster(frame_s_norm, geo_s, res)
    rt = raster_t if raster_t is not None else world_raster(frame_t_norm, geo_t, res)

    def origin(r):
        return (torch.tensor([r.x0], dtype=torch.float32, device=dev),
                torch.tensor([r.y0], dtype=torch.float32, device=dev))

    (x0s, y0s), (x0t, y0t) = origin(rs), origin(rt)
    desc_q, ok_q = _raster_patches(rs.img[None], rs.cnt[None], x0s, y0s, res, geo_kp[None], det_cfg.geopatch_half,
                                   cfg.min_cover)
    dm = _correlate(desc_q, ok_q & feats_s.valid[None], geo_kp[None], rt.img[None], rt.cnt[None], rt.ping[None],
                    rt.col[None], x0t, y0t, res, half=det_cfg.geopatch_half,
                    n_ring=int(np.ceil(cfg.search_radius / res)), step_cells=cfg.step_cells, ncc_min=cfg.ncc_min,
                    ncc_ratio=cfg.ncc_ratio, min_cover=cfg.min_cover)
    keep = _smooth_filter(geo_kp, dm.tgt_geo[0], dm.ok[0], cfg)
    K = keep.shape[0]
    host = torch.cat([torch.stack([keep.to(torch.float32), dm.tgt_ping[0], dm.tgt_col[0]]).reshape(-1),
                      feats_s.xy.reshape(-1)]).cpu().numpy()
    keep_np, ping_np, col_np = host[:K] > 0, host[K:2 * K], host[2 * K:3 * K]
    idx = np.nonzero(keep_np)[0]
    rows_s, rows_t = _corres_rows(img_id_s, img_id_t, host[3 * K:].reshape(-1, 2), idx, ping_np, col_np)
    return rows_s, rows_t, len(idx)
