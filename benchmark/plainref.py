"""The plain reference of the annotated two-stage survey, written from the
stated mathematics in numpy and scipy at float64.  It imports nothing of
the program and takes nothing the program made: from the raw survey it
works out again

1. each line's geo image: pixel (n, j) of a line of M bins lies at
   ``p_n + g(j) (cos a, sin a)``, ``a = psi_n + pi/2`` for starboard
   columns (``j >= M/2``) and ``psi_n - pi/2`` for port ones, with ``p_n``
   and ``psi_n`` the ping's DR position and its third DR entry, and ``g(j)``
   the ground range of ``|j - M/2|`` clamped to ``[0, M/2 - 1]``;
2. the overlap gate: line pairs whose axis-aligned geo extents overlap by
   an IoU over ``MIN_OVERLAP``;
3. the keypoint pairs: the source line's annotation rows aimed at the
   target line, each bin at least ``NADIR_BINS`` from nadir, with the slant
   ranges ``sqrt(altitude^2 + g^2)``;
4. one loop-closure problem per keypoint pair: the target ping's pose X
   and the landmark L minimise, with the source ping's DR pose S held,
   ``|Log(Z^-1 S^-1 X) / s_odo|^2 + |h(L, S) / s_1|^2 + |h(L, X) / s_2|^2``
   (Z the DR relative pose, ``h(L, X) = (|X^-1 L| - r, (X^-1 L)_x)`` the
   slant-range and zero-plane residual), by Levenberg-Marquardt on central
   differences to convergence; then its quality (the DR geo distance of the
   two pixels over the distance from the source pixel to the target pixel
   re-projected under X, less 2), the marginal variances of X, and the
   relative pose of the two pings;
5. the loop-closure gate (quality over 0, finite variances, the first row
   to reach a target ping wins) and the chain pose graph over every ping,
   ``sum_k |Log(D_k^-1 X_k^-1 X_k+1) / s|^2 + sum_lc |Log(C^-1 X_i^-1 X_j) / s_lc|^2``
   (D_k the DR step, C and s_lc the loop closures), the first pose held,
   by Levenberg-Marquardt on sparse normal equations from the DR poses to
   convergence.

Poses are ``(R, t)`` pairs of arrays, tangent vectors ``(omega, v)``, and a
step ``xi`` moves a pose X to ``X Exp(xi)``.  The constants are those of the
configuration's pipeline profile (the upstream optimizer's, cited by line).

:class:`Arith` chooses the arithmetic: float64, or the control, which is
float32 with the operands of every matrix product rounded to TF32, the
precision below the float32 with TF32 off that the configuration states.

The numbers compared (:func:`numbers`; a configuration's ``check`` entry
names the ones it holds, with their limits):

* ``pose_gap_m``: the widest distance between a ping's estimated position
  in a pass and in the reference, per checked pass (metres): each pass is
  held to it alone;
* ``lc_flips``: keypoint pairs whose loop closure one side accepts and the
  other does not (a count; the last checked pass);
* ``lc_gap_m``: the widest distance between the relative translations that
  the two sides' loop-closure problems give one keypoint pair, over every
  pair, accepted or not (metres; the same pass).

A number that cannot be formed (another set of gated pairs, another count
of keypoint pairs, a shape that differs) reads as infinite, and so fails.
"""

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

DEG = math.pi / 180.0

PROFILE = {"profile": "default"}  # the program's pipeline profile that this reference computes
NUMBERS = ("pose_gap_m", "lc_flips", "lc_gap_m")

# the default pipeline profile (upstream optimizer.cpp and diasss2.cpp)
MIN_OVERLAP = 0.4  # pair gate, IoU of the geo extents (diasss2.cpp:28)
NADIR_BINS = 20  # optimizer.cpp:602
SIGMA_R, ALPHA_BW = 0.1, 0.1 * DEG  # keypoint noise (optimizer.cpp:685, 706-707)
LC_ODO = dict(roll=0.1 * DEG, pitch=0.1 * DEG, yaw=0.5 * DEG, x_scale=2.0, y_scale=0.1, z=0.1, floor=1e-3)
COMPASS_FLIP_YAW = 2.0 * math.pi / 3.0  # optimizer.cpp:700-703
QUALITY_OFFSET = 2.0  # accept where the distance ratio exceeds 2 (optimizer.cpp:884, 896)
PG_ODO = (0.001 * DEG, 0.001 * DEG, 0.001 * DEG, 0.01, 0.01, 0.001)  # optimizer.cpp:24-28
LC_VAR_FLOOR = 1e-12

LC_ITERS = 100
PG_ITERS = 50
PG_REL_TOL = 1e-13


class Arith:
    """The arithmetic of a run: float64, or (``control``) float32 with every
    matrix product's operands rounded to TF32."""

    def __init__(self, control: bool = False):
        self.control = control
        self.dtype = np.float32 if control else np.float64
        self.step = float(np.finfo(self.dtype).eps) ** (1.0 / 3.0)  # central differences

    def a(self, x) -> np.ndarray:
        return np.asarray(x, dtype=self.dtype)

    def op(self, x):
        return round_tf32(x) if self.control else x

    def mm(self, a, b):
        return np.matmul(self.op(a), self.op(b))


def round_tf32(x) -> np.ndarray:
    """``x`` in float32 with every finite value rounded to TF32's 10-bit
    mantissa (to nearest, ties away from zero)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    bits = x.view(np.uint32)
    rounded = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return np.where(np.isfinite(x), rounded, x)


# --- rotations and rigid motions ---------------------------------------------------------

class Pose(NamedTuple):
    R: np.ndarray  # (..., 3, 3)
    t: np.ndarray  # (..., 3)


def hat(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(th2):
    """``sin(th)/th``, ``(1-cos th)/th^2``, ``(th-sin th)/th^3`` and
    ``(1 - th sin th / (2 (1 - cos th))) / th^2``, by series near 0."""
    small = th2 < 1e-4
    th2s = np.where(small, 1.0, th2).astype(th2.dtype)
    th = np.sqrt(th2s)
    s, c = np.sin(th), np.cos(th)
    a = np.where(small, 1 - th2 / 6 + th2 * th2 / 120, s / th)
    b = np.where(small, 0.5 - th2 / 24 + th2 * th2 / 720, (1 - c) / th2s)
    cc = np.where(small, 1 / 6 - th2 / 120 + th2 * th2 / 5040, (th - s) / (th2s * th))
    d = np.where(small, 1 / 12 + th2 / 720 + th2 * th2 / 30240, (1 - th * s / (2 * (1 - c))) / th2s)
    return a, b, cc, d


def _eye(ar, shape):
    return np.broadcast_to(np.eye(3, dtype=ar.dtype), (*shape, 3, 3))


def rot_exp(ar, w):
    """Rodrigues' formula."""
    a, b, _, _ = _coeffs(np.sum(w * w, -1))
    W = hat(w)
    return _eye(ar, w.shape[:-1]) + a[..., None, None] * W + b[..., None, None] * ar.mm(W, W)


def rot_log(ar, R):
    """The rotation vector of ``R`` (angles below pi)."""
    cos = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    th = np.arccos(cos)
    v = 0.5 * np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    th2 = th * th
    small = th2 < 1e-4
    ratio = np.where(small, 1 + th2 / 6 + 7 * th2 * th2 / 360, th / np.sin(np.where(small, 1.0, th)))
    return v * ratio[..., None]


def apply(ar, R, v):
    return ar.mm(R, v[..., None])[..., 0]


def compose(ar, a: Pose, b: Pose) -> Pose:
    return Pose(ar.mm(a.R, b.R), apply(ar, a.R, b.t) + a.t)


def inverse(ar, a: Pose) -> Pose:
    Rt = np.swapaxes(a.R, -1, -2)
    return Pose(Rt, -apply(ar, Rt, a.t))


def between(ar, a: Pose, b: Pose) -> Pose:
    """``a^-1 b``."""
    return compose(ar, inverse(ar, a), b)


def exp(ar, xi) -> Pose:
    w, v = xi[..., :3], xi[..., 3:]
    a, b, c, _ = _coeffs(np.sum(w * w, -1))
    W = hat(w)
    WW = ar.mm(W, W)
    R = _eye(ar, w.shape[:-1]) + a[..., None, None] * W + b[..., None, None] * WW
    V = _eye(ar, w.shape[:-1]) + b[..., None, None] * W + c[..., None, None] * WW
    return Pose(R, apply(ar, V, v))


def log(ar, p: Pose):
    w = rot_log(ar, p.R)
    _, _, _, d = _coeffs(np.sum(w * w, -1))
    W = hat(w)
    Vinv = _eye(ar, w.shape[:-1]) - 0.5 * W + d[..., None, None] * ar.mm(W, W)
    return np.concatenate([w, apply(ar, Vinv, p.t)], -1)


def from_dr(ar, rows) -> Pose:
    """DR rows ``(rx, ry, rz, x, y, z)``: a rotation vector and a position."""
    rows = ar.a(rows)
    return Pose(rot_exp(ar, rows[..., :3]), rows[..., 3:6])


def take(p: Pose, idx) -> Pose:
    return Pose(p.R[idx], p.t[idx])


def between_residual(ar, meas: Pose, xi: Pose, xj: Pose):
    """``Log(meas^-1 xi^-1 xj)``."""
    return log(ar, between(ar, meas, between(ar, xi, xj)))


# --- the survey's derived quantities ------------------------------------------------------

class Line(NamedTuple):
    img_id: int
    dr: np.ndarray  # (N, 6)
    alts: np.ndarray  # (N,)
    gras: np.ndarray  # (G,)
    n_bins: int
    annos: np.ndarray  # (K, 7)


def ground_range_index(col, n_bins: int):
    half = n_bins // 2
    return np.clip(np.abs(np.asarray(col) - half), 0, half - 1)


def geo_of(ar, line: Line, ping, col):
    """World (x, y) of pixels ``(ping, col)`` of ``line`` under its DR poses."""
    half = line.n_bins // 2
    col = np.asarray(col)
    g = ar.a(line.gras)[ground_range_index(col, line.n_bins)]
    yaw = ar.a(line.dr[ping, 2])
    ang = yaw + np.where(col >= half, 0.5 * math.pi, -0.5 * math.pi)
    return np.stack([ar.a(line.dr[ping, 3]) + g * np.cos(ang), ar.a(line.dr[ping, 4]) + g * np.sin(ang)], -1)


def geo_extent(ar, line: Line):
    """``(x0, x1, y0, y1)`` of the line's whole geo image."""
    n, m = len(line.dr), line.n_bins
    geo = geo_of(ar, line, np.arange(n)[:, None], np.arange(m)[None, :])
    return geo[..., 0].min(), geo[..., 0].max(), geo[..., 1].min(), geo[..., 1].max()


def gated_pairs(ar, lines: List[Line]) -> List[Tuple[int, int]]:
    boxes = [geo_extent(ar, l) for l in lines]
    out = []
    for i in range(len(lines)):
        for j in range(i + 1, len(lines)):
            ax0, ax1, ay0, ay1 = boxes[i]
            bx0, bx1, by0, by1 = boxes[j]
            w, h = min(ax1, bx1) - max(ax0, bx0), min(ay1, by1) - max(ay0, by0)
            if w > 0 and h > 0:
                inter = w * h
                iou = inter / ((ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter)
                if iou > MIN_OVERLAP:
                    out.append((i, j))
    return out


def keypoint_pairs(ar, src: Line, tgt: Line):
    """``(ping_s, bin_s, ping_t, bin_t, range_s, range_t)`` of the source
    line's annotations aimed at the target line, off nadir."""
    rows = np.asarray(src.annos).reshape(-1, 7)
    rows = rows[rows[:, 1].astype(np.int64) == tgt.img_id]
    ps, bs, pt, bt = (rows[:, k].astype(np.int64) for k in (2, 3, 4, 5))
    keep = ((np.abs(bs - len(src.gras)) >= NADIR_BINS) & (np.abs(bt - len(tgt.gras)) >= NADIR_BINS)
            & (ps >= 0) & (ps < len(src.dr)) & (pt >= 0) & (pt < len(tgt.dr)))
    ps, bs, pt, bt = ps[keep], bs[keep], pt[keep], bt[keep]

    def slant(line, ping, col):
        g = ar.a(line.gras)[np.clip(np.abs(col - len(line.gras)), 0, len(line.gras) - 1)]
        a = ar.a(line.alts)[ping]
        return np.sqrt(a * a + g * g)

    return ps, bs, pt, bt, slant(src, ps, bs), slant(tgt, pt, bt)


# --- loop closures ----------------------------------------------------------------------------

def _yaw_flip(ar, yaw) -> Pose:
    ang = np.where(np.abs(yaw) > COMPASS_FLIP_YAW, math.pi, 0.0)
    w = np.zeros((*ang.shape, 3), ar.dtype)
    w[..., 2] = ang
    return Pose(rot_exp(ar, w), np.zeros((*ang.shape, 3), ar.dtype))


def sonar_residual(ar, L, X: Pose, slant):
    """``(|X^-1 L| - r, (X^-1 L)_x)``."""
    q = apply(ar, np.swapaxes(X.R, -1, -2), L - X.t)
    return np.stack([np.sqrt(np.sum(q * q, -1)) - slant, q[..., 0]], -1)


def solve_or_nan(A, b):
    """``A^-1 b`` for a batch of systems (b ``(B, n, k)``); a system that
    the factorisation finds singular gives NaN."""
    try:
        return np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        out = np.full(b.shape, np.nan, b.dtype)
        for k in range(len(A)):
            try:
                out[k] = np.linalg.solve(A[k], b[k])
            except np.linalg.LinAlgError:
                pass
        return out


def _numeric_jacobian(ar, fn, n: int, batch: int):
    """``(r, J)`` of ``fn(delta)`` (delta ``(B, n)``) at 0, by central differences."""
    zero = np.zeros((batch, n), ar.dtype)
    r = fn(zero)
    cols = []
    for k in range(n):
        d = np.zeros((batch, n), ar.dtype)
        d[:, k] = ar.step
        cols.append((fn(d) - fn(-d)) / (2 * ar.step))
    return r, np.stack(cols, -1)


def solve_loop_closures(ar, S: Pose, T: Pose, slant_s, slant_t, L0):
    """Every loop-closure problem at once: ``(X, H)``, the target poses and
    the Gauss-Newton Hessians ``J^T J`` at them."""
    K = len(slant_s)
    Z = between(ar, S, T)
    sig_odo = np.stack([np.full(K, LC_ODO["roll"]), np.full(K, LC_ODO["pitch"]), np.full(K, LC_ODO["yaw"]),
                        np.maximum(np.abs(Z.t[:, 0]) * LC_ODO["x_scale"], LC_ODO["floor"]),
                        np.maximum(np.abs(Z.t[:, 1]) * LC_ODO["y_scale"], LC_ODO["floor"]),
                        np.full(K, LC_ODO["z"])], -1).astype(ar.dtype)
    sig_s = np.stack([np.full(K, SIGMA_R), slant_s * ALPHA_BW], -1).astype(ar.dtype)
    sig_t = np.stack([np.full(K, SIGMA_R), slant_t * ALPHA_BW], -1).astype(ar.dtype)

    def residual(X: Pose, L):
        return np.concatenate([between_residual(ar, Z, S, X) / sig_odo, sonar_residual(ar, L, S, slant_s) / sig_s,
                               sonar_residual(ar, L, X, slant_t) / sig_t], -1)

    def moved(X, L, delta):
        return compose(ar, X, exp(ar, delta[:, :6])), L + delta[:, 6:]

    def cost(X, L):
        r = residual(X, L)
        return 0.5 * np.sum(r * r, -1)

    X, L = T, ar.a(L0)
    err = cost(X, L)
    lam = np.full(K, 1e-3, ar.dtype)
    eye = np.eye(9, dtype=ar.dtype)
    for _ in range(LC_ITERS):
        r, J = _numeric_jacobian(ar, lambda d: residual(*moved(X, L, d)), 9, K)
        Jt = np.swapaxes(J, -1, -2)
        H = ar.mm(Jt, J)
        g = ar.mm(Jt, r[..., None])[..., 0]
        A = H + lam[:, None, None] * (np.diagonal(H, axis1=-2, axis2=-1)[..., None] * eye + 1e-12 * eye)
        delta = -solve_or_nan(A, g[..., None])[..., 0]
        Xn, Ln = moved(X, L, delta)
        errn = cost(Xn, Ln)
        good = np.isfinite(errn) & (errn < err)
        X = Pose(np.where(good[:, None, None], Xn.R, X.R), np.where(good[:, None], Xn.t, X.t))
        L = np.where(good[:, None], Ln, L)
        err = np.where(good, errn, err)
        lam = np.where(good, np.maximum(lam * 0.1, 1e-12), np.minimum(lam * 10.0, 1e12)).astype(ar.dtype)
    _, J = _numeric_jacobian(ar, lambda d: residual(*moved(X, L, d)), 9, K)
    return X, ar.mm(np.swapaxes(J, -1, -2), J)


def target_geo(ar, X: Pose, line: Line, col):
    """World (x, y) of target bins ``col`` seen from poses ``X``."""
    yaw = np.arctan2(X.R[:, 1, 0], X.R[:, 0, 0])
    half = line.n_bins // 2
    g = ar.a(line.gras)[ground_range_index(col, line.n_bins)]
    ang = yaw + np.where(col >= half, 0.5 * math.pi, -0.5 * math.pi)
    return np.stack([X.t[:, 0] + g * np.cos(ang), X.t[:, 1] + g * np.sin(ang)], -1)


class LoopClosures(NamedTuple):
    rel: Pose  # (K,) relative pose, source ping -> target ping
    variance: np.ndarray  # (K, 6) marginal variances of the target pose
    accepted: np.ndarray  # (K,) quality over 0 and finite variances
    ping_s: np.ndarray
    ping_t: np.ndarray


def loop_closures(ar, lines: List[Line], pairs) -> Dict[Tuple[int, int], LoopClosures]:
    """The loop-closure problems of every gated pair, solved in one batch."""
    rows = []
    for (i, j) in pairs:
        src, tgt = lines[i], lines[j]
        ps, bs, pt, bt, rs, rt = keypoint_pairs(ar, src, tgt)
        row_s, row_t = ar.a(src.dr[ps]), ar.a(tgt.dr[pt])
        flip_s, flip_t = _yaw_flip(ar, row_s[:, 2]), _yaw_flip(ar, row_t[:, 2])
        g_s, g_t = geo_of(ar, src, ps, bs).reshape(-1, 2), geo_of(ar, tgt, pt, bt).reshape(-1, 2)
        z = 0.5 * ((row_s[:, 5] - ar.a(src.alts)[ps]) + (row_t[:, 5] - ar.a(tgt.alts)[pt]))
        L0 = np.stack([0.5 * (g_s[:, 0] + g_t[:, 0]), 0.5 * (g_s[:, 1] + g_t[:, 1]), z], -1)
        rows.append((ps, pt, bt, compose(ar, from_dr(ar, row_s), flip_s), compose(ar, from_dr(ar, row_t), flip_t),
                     flip_s, flip_t, g_s, g_t, rs, rt, L0))
    if not rows or sum(len(r[0]) for r in rows) == 0:
        empty = Pose(np.zeros((0, 3, 3), ar.dtype), np.zeros((0, 3), ar.dtype))
        return {key: LoopClosures(empty, np.zeros((0, 6)), np.zeros(0, bool), r[0], r[1]) for key, r in zip(pairs, rows)}

    def cat(k):
        if isinstance(rows[0][k], Pose):
            return Pose(np.concatenate([r[k].R for r in rows]), np.concatenate([r[k].t for r in rows]))
        return np.concatenate([r[k] for r in rows])

    S, T = cat(3), cat(4)
    X, H = solve_loop_closures(ar, S, T, cat(9), cat(10), cat(11))
    # the variances of a problem whose Hessian is not positive definite are
    # not finite, and its row is no loop closure
    spd = np.all(np.isfinite(H), (-2, -1))
    spd[spd] = np.all(np.linalg.eigvalsh(H[spd].astype(np.float64)) > 0, -1)
    cov = solve_or_nan(np.where(spd[:, None, None], H, np.eye(9, dtype=ar.dtype)),
                       np.broadcast_to(np.eye(9, dtype=ar.dtype), H.shape).copy())
    var = np.where(spd[:, None], np.diagonal(cov, axis1=-2, axis2=-1)[:, :6], np.nan)
    src_pose = compose(ar, S, inverse(ar, cat(5)))
    dst_pose = compose(ar, X, inverse(ar, cat(6)))
    rel = between(ar, src_pose, dst_pose)
    out, k0 = {}, 0
    for (i, j), (ps, pt, bt, *_rest) in zip(pairs, rows):
        k1 = k0 + len(ps)
        part = slice(k0, k1)
        g_s, g_t = _rest[4], _rest[5]
        ini = np.linalg.norm(g_s - g_t, axis=-1)
        fnl = np.linalg.norm(g_s - target_geo(ar, take(dst_pose, part), lines[j], bt), axis=-1)
        quality = ini / np.maximum(fnl, 1e-9) - QUALITY_OFFSET
        accepted = (quality > 0) & np.all(np.isfinite(var[part]), -1)
        out[(i, j)] = LoopClosures(take(rel, part), var[part], accepted, ps, pt)
        k0 = k1
    return out


# --- the pose graph ---------------------------------------------------------------------------

class Graph(NamedTuple):
    meas: Pose  # (F,) measured relative poses
    i: np.ndarray  # (F,)
    j: np.ndarray  # (F,)
    sigma: np.ndarray  # (F, 6)


def graph_residual(ar, g: Graph, X: Pose):
    return between_residual(ar, g.meas, take(X, g.i), take(X, g.j)) / g.sigma


def graph_jacobians(ar, g: Graph, X: Pose):
    """``(r, Ji, Jj)``: the whitened residuals and their central-difference
    Jacobians in the steps of each factor's two poses."""
    Xi, Xj = take(X, g.i), take(X, g.j)
    r = between_residual(ar, g.meas, Xi, Xj) / g.sigma
    out = []
    for moving_i in (True, False):
        cols = []
        for k in range(6):
            d = np.zeros(6, ar.dtype)
            d[k] = ar.step
            plus, minus = exp(ar, d), exp(ar, -d)
            if moving_i:
                rp = between_residual(ar, g.meas, compose(ar, Xi, plus), Xj)
                rm = between_residual(ar, g.meas, compose(ar, Xi, minus), Xj)
            else:
                rp = between_residual(ar, g.meas, Xi, compose(ar, Xj, plus))
                rm = between_residual(ar, g.meas, Xi, compose(ar, Xj, minus))
            cols.append((rp - rm) / (2 * ar.step) / g.sigma)
        out.append(np.stack(cols, -1))
    return r, out[0], out[1]


def solve_pose_graph(ar, g: Graph, X0: Pose) -> Pose:
    """Levenberg-Marquardt over every pose but the first, from ``X0``."""
    P, F = len(X0.t), len(g.i)
    rows = np.repeat(np.arange(6 * F).reshape(F, 6, 1), 6, axis=2)

    def cost(X):
        r = graph_residual(ar, g, X)
        return 0.5 * float(np.sum(r.astype(np.float64) ** 2))

    X, err, lam = X0, cost(X0), 1e-8
    for _ in range(PG_ITERS):
        r, Ji, Jj = graph_jacobians(ar, g, X)
        Ji, Jj, r = ar.op(Ji), ar.op(Jj), ar.op(r)
        ci = 6 * g.i[:, None, None] + np.arange(6)[None, None, :]
        cj = 6 * g.j[:, None, None] + np.arange(6)[None, None, :]
        J = sp.csr_matrix((np.concatenate([Ji.ravel(), Jj.ravel()]),
                           (np.concatenate([rows.ravel(), rows.ravel()]),
                            np.concatenate([np.broadcast_to(ci, rows.shape).ravel(),
                                            np.broadcast_to(cj, rows.shape).ravel()]))),
                          shape=(6 * F, 6 * P))[:, 6:]
        H = (J.T @ J).tocsc()
        grad = J.T @ r.ravel()
        diag = H.diagonal()
        accepted = False
        while lam < 1e10:
            A = (H + sp.diags(lam * diag + 1e-12)).tocsc()
            step = -spla.spsolve(A, grad)
            d = np.concatenate([np.zeros(6, ar.dtype), ar.a(step)]).reshape(P, 6)
            Xn = compose(ar, X, exp(ar, d))
            errn = cost(Xn)
            if np.isfinite(errn) and errn < err:
                accepted = True
                break
            lam *= 10.0
        if not accepted:
            break
        gain = err - errn
        X, err, lam = Xn, errn, max(lam * 0.1, 1e-12)
        if gain <= PG_REL_TOL * err:
            break
    return X


# --- one pass ---------------------------------------------------------------------------------

def survey_lines(survey) -> List[Line]:
    return [Line(int(l.img_id), np.asarray(l.dr_poses, np.float64), np.asarray(l.altitudes, np.float64),
                 np.asarray(l.ground_ranges, np.float64), int(np.asarray(l.image).shape[1]),
                 np.asarray(l.annos).reshape(-1, 7)) for l in survey.lines]


def run(survey, control: bool = False) -> Dict[str, object]:
    """The reference's answers for one survey: ``poses_t`` (P, 3), the
    estimated positions of every ping in the survey's order, and ``lc``,
    per gated line pair ``(i, j)``, ``(accepted (K,), rel_t (K, 3))`` of
    its keypoint pairs in the annotations' order."""
    ar = Arith(control)
    lines = survey_lines(survey)
    offsets = np.cumsum([0] + [len(l.dr) for l in lines])
    pairs = gated_pairs(ar, lines)
    lc: Dict[Tuple[int, int], tuple] = {}
    fi, fj, fR, ft, fs = [], [], [], [], []
    seen = set()
    for (i, j), res in loop_closures(ar, lines, pairs).items():
        lc[(i, j)] = (res.accepted, res.rel.t.astype(np.float64))
        for k in np.flatnonzero(res.accepted):
            gi, gj = int(offsets[i] + res.ping_s[k]), int(offsets[j] + res.ping_t[k])
            if gj in seen:
                continue
            seen.add(gj)
            fi.append(gi)
            fj.append(gj)
            fR.append(res.rel.R[k])
            ft.append(res.rel.t[k])
            fs.append(np.sqrt(np.maximum(res.variance[k], LC_VAR_FLOOR)))
    X0 = from_dr(ar, np.concatenate([l.dr for l in lines]))
    P = len(X0.t)
    odo = between(ar, take(X0, slice(0, P - 1)), take(X0, slice(1, P)))
    graph = Graph(
        meas=Pose(np.concatenate([odo.R] + ([np.stack(fR)] if fR else [])),
                  np.concatenate([odo.t] + ([np.stack(ft)] if ft else []))),
        i=np.concatenate([np.arange(P - 1), np.asarray(fi, np.int64)]),
        j=np.concatenate([np.arange(1, P), np.asarray(fj, np.int64)]),
        sigma=ar.a(np.concatenate([np.broadcast_to(PG_ODO, (P - 1, 6))] + ([np.stack(fs)] if fs else []))),
    )
    X = solve_pose_graph(ar, graph, X0)
    return {"poses_t": X.t.astype(np.float64), "lc": lc}


# --- the program's answers, and the numbers that compare them -----------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def outputs(rec) -> dict:
    """The program's answers of one pass (``rec.result``, its
    ``SlamResult``), on the host, in the layout of :func:`run`:
    ``poses_t`` (P, 3), and ``lc``, per gated line pair, ``(accepted,
    rel_t)`` of its keypoint pairs (the padding the program adds left out).
    A pair whose valid rows do not lead its padded batch has ``None``
    there, which the comparison fails."""
    lc = {}
    for key, res in rec.result.lc_results.items():
        valid = _host(res.valid).astype(bool)
        n = int(valid.sum())
        if not valid[:n].all():
            lc[key] = None
            continue
        accepted = (_host(res.quality[:n]) > 0) & np.all(np.isfinite(_host(res.variance6[:n])), axis=-1)
        lc[key] = (accepted, _host(res.rel_pose.t[:n]).astype(np.float64))
    return {"poses_t": _host(rec.result.poses.t).astype(np.float64), "lc": lc}


def pose_gap(prog: dict, ref: dict) -> float:
    a, b = prog["poses_t"], ref["poses_t"]
    if a.shape != b.shape:
        return math.inf
    gap = np.linalg.norm(a - b, axis=-1)
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else math.inf


def lc_numbers(prog: dict, ref: dict):
    """``(lc_flips, lc_gap_m)``."""
    a, b = prog["lc"], ref["lc"]
    if a.keys() != b.keys():
        return math.inf, math.inf
    flips, gap = 0, 0.0
    for key, theirs in b.items():
        mine = a[key]
        if mine is None or mine[0].shape != theirs[0].shape:
            return math.inf, math.inf
        (acc_a, t_a), (acc_b, t_b) = mine, theirs
        flips += int(np.sum(acc_a != acc_b))
        if len(t_b):
            d = np.linalg.norm(t_a - t_b, axis=-1)
            gap = max(gap, float(np.max(d)) if np.all(np.isfinite(d)) else math.inf)
    return float(flips), gap


def numbers(passes: List[dict], ref: dict) -> Dict[str, object]:
    """The numbers of :data:`NUMBERS` for the :func:`outputs` of every
    checked pass, in order: ``pose_gap_m`` one per pass, the loop-closure
    numbers of the last."""
    flips, gap = lc_numbers(passes[-1], ref)
    return {"pose_gap_m": [pose_gap(p, ref) for p in passes], "lc_flips": flips, "lc_gap_m": gap}
