"""The plain reference of the annotated survey under joint bundle adjustment,
written from the stated mathematics in numpy and scipy at float64.  It
imports nothing of the program and takes nothing the program made; it
shares :mod:`benchmark.plainref`'s rigid motions, geo images, keypoint
pairs and :class:`~benchmark.plainref.Arith`.  From the raw survey it
works out again

1. each line's geo image under its DR poses (:func:`plainref.geo_of`);
2. the overlap gate: line pairs whose axis-aligned geo extents overlap by
   an IoU over ``MIN_OVERLAP`` (0.1, low enough for tie-line crossings);
3. the keypoint pairs: the source line's annotation rows aimed at the
   target line, each bin at least ``NADIR_BINS`` from nadir, with the slant
   ranges ``sqrt(altitude^2 + g^2)`` (:func:`plainref.keypoint_pairs`);
   every such pair is a landmark of its own, in the order of the gated
   pairs and, within a pair, of the annotation rows;
4. each landmark's initial value ``L0``: the midpoint of the two pixels'
   DR geo positions, z the mean over both pings of DR depth less altitude;
5. the joint cost over every ping's pose ``X`` and every landmark ``L``,

       sum_k |Log(D_k^-1 X_k^-1 X_k+1) / s|^2 / 2
     + sum_c rho(|h(L_c, X_s(c)) / s_s(c)|^2) + rho(|h(L_c, X_t(c)) / s_t(c)|^2)
     + sum_c |(L_c - L0_c) / s_L|^2 / 2,

   ``D_k`` the DR step over the whole concatenated chain (line ends
   included), ``s`` the pose graph's odometry sigmas, ``h(L, X) = (|X^-1
   L| - r, (X^-1 L)_x)`` the slant-range and zero-plane residual,
   ``s_s = (SIGMA_R, r ALPHA_BW)`` the range-dependent keypoint sigmas,
   ``rho`` Huber's loss of ``HUBER_DELTA`` on the whitened norm (``rho(q)
   = q / 2`` for ``sqrt(q) <= delta``, else ``delta (sqrt(q) - delta /
   2)``), ``s_L`` the landmark prior's sigmas;
6. its minimum from the DR poses and ``L0``, the first pose held, by
   Levenberg-Marquardt on the sparse normal equations of all poses and
   landmarks together (Jacobians by central differences, ``H + lam
   diag(H)``, a step kept only where the cost falls): first with Huber by
   reweighting (each sonar block's residual and Jacobian scaled by
   ``sqrt(min(1, delta / |r|))``), until a step gains under ``SWITCH`` of
   the cost; then with each block's exact curvature, each joint step
   followed by every landmark's own steps with the poses held
   (``REFINE_ITERS`` 3x3 LM steps), to a relative gain under
   ``REL_TOL_EPS`` units of the arithmetic's rounding.  Landmarks in
   Huber's linear part are where reweighted steps creep (a linear rate),
   and the landmark steps are kept out of the first phase, where the poses
   still move by metres: there they took a landmark through the sonar's
   plane to its mirror image (z = +12 m), a second minimum of the cost.

Departures from the program: it starts from the DR poses with the pose
graph's injected initial noise (0.5 m, 0.5 deg a pose; the first pose
exact), eliminates the landmarks (Schur) and solves the reduced pose
system, damps with ``lam (D + I)`` on the landmark blocks and the pose
diagonal, and runs in float32; none of these moves the minimum.  It
applies Huber by reweighting alone, which converges only at a linear rate
for a block in the loss's linear part (``|r| > delta``: the reweighted
curvature ``(delta / |r|) J^T J`` has curvature along ``r``, where the
loss has none), and stops after two trials that gain under 1e-6 relative
or after 40: such landmarks stop short of the minimum (0.8-1.6 m on the
four surveys of ``annofba20``, on the card), which ``lm_gap_m`` reads.
On a few surveys two rejected float32 steps in a row at the damping
floor end the solve early, and the poses stop short too (0.6-4.7 m on 3
of 14 surveys).  This reference runs to the minimum.

The arithmetic: float64, or the control (:class:`ControlArith`), float32
with the operands of the normal equations' products ``J^T J`` and ``J^T
r`` rounded to TF32, the precision below the float32 with TF32 off that
the configuration states, where a card applies it: the solver's large
products.  The rigid motions, the residuals and the per-landmark 3x3
steps stay in float32.  With TF32 in the rigid motions too (as
:class:`plainref.Arith`'s control has it), a position 300-600 m from the
origin rounds by 0.25-0.5 m inside every odometry residual, against
sigmas of 1 cm and 1 mm: no step that moves a pose lowers the cost, so
that control stops at the DR poses after 1-3 steps that move only the
landmarks, and reads the DR drift rather than what the lower precision
does to a solve.  This control solves: it moves the poses the whole
drift, to a cost within 1% of the minimum, and stops short of it where
the rounded gradient vanishes.

The numbers compared (:func:`numbers`):

* ``pose_gap_m``: the widest distance between a ping's estimated position
  in a pass and in the reference, per checked pass (metres);
* ``lm_gap_m``: the widest distance between a landmark's estimate in the
  last checked pass and in the reference (metres).

A number that cannot be formed (another set of gated pairs, another count
or order of landmarks, a shape that differs, no landmarks in the result)
reads as infinite, and so fails.
"""

import math
import sys
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from benchmark import plainref as pr

PROFILE = {"profile": "annotated_full_ba"}  # the program's pipeline profile that this reference computes
NUMBERS = ("pose_gap_m", "lm_gap_m")

# the annotated full-BA profile (diasss_tpu_torch.config.annotated_full_ba_config)
MIN_OVERLAP = 0.1  # pair gate, IoU of the geo extents: admits main-vs-tie crossings
NADIR_BINS = pr.NADIR_BINS
SIGMA_R, ALPHA_BW = pr.SIGMA_R, pr.ALPHA_BW  # keypoint noise (optimizer.cpp:685, 706-707)
PG_ODO = pr.PG_ODO  # odometry sigmas of the pose graph (optimizer.cpp:24-28)
LM_PRIOR = (50.0, 50.0, 1.5)  # landmark prior sigmas, x y z (m): the flat-floor depth regularization
HUBER_DELTA = 3.0

ITERS = 100
REFINE_ITERS = 50
SWITCH, SWITCH_LAM = 1e-3, 1e-2
REL_TOL_EPS = 4096  # stop at a relative gain under this many units of the arithmetic's rounding (float64: 9.1e-13)


def gated_pairs(ar, lines: List[pr.Line], min_overlap: float = MIN_OVERLAP) -> List[Tuple[int, int]]:
    boxes = [pr.geo_extent(ar, l) for l in lines]
    out = []
    for i in range(len(lines)):
        for j in range(i + 1, len(lines)):
            ax0, ax1, ay0, ay1 = boxes[i]
            bx0, bx1, by0, by1 = boxes[j]
            w, h = min(ax1, bx1) - max(ax0, bx0), min(ay1, by1) - max(ay0, by0)
            if w > 0 and h > 0:
                inter = w * h
                if inter / ((ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter) > min_overlap:
                    out.append((i, j))
    return out


class Landmarks(NamedTuple):
    i: np.ndarray  # (K,) global index of the source ping
    j: np.ndarray  # (K,) global index of the target ping
    slant_s: np.ndarray  # (K,)
    slant_t: np.ndarray
    L0: np.ndarray  # (K, 3) initial values and prior centres


def landmarks(ar, lines: List[pr.Line], pairs) -> Landmarks:
    """Every nadir-passing keypoint pair of the gated pairs, in order."""
    offsets = np.cumsum([0] + [len(l.dr) for l in lines])
    parts = []
    for (i, j) in pairs:
        src, tgt = lines[i], lines[j]
        ps, bs, pt, bt, rs, rt = pr.keypoint_pairs(ar, src, tgt)
        g_s, g_t = pr.geo_of(ar, src, ps, bs).reshape(-1, 2), pr.geo_of(ar, tgt, pt, bt).reshape(-1, 2)
        z = 0.5 * ((ar.a(src.dr[ps, 5]) - ar.a(src.alts)[ps]) + (ar.a(tgt.dr[pt, 5]) - ar.a(tgt.alts)[pt]))
        L0 = np.concatenate([0.5 * (g_s + g_t), z[:, None]], -1)
        parts.append((offsets[i] + ps, offsets[j] + pt, rs, rt, L0))
    if not parts:
        return Landmarks(np.zeros(0, np.int64), np.zeros(0, np.int64), ar.a(np.zeros(0)), ar.a(np.zeros(0)),
                         ar.a(np.zeros((0, 3))))
    return Landmarks(*(np.concatenate([p[k] for p in parts]) for k in range(5)))


# --- the joint cost and its linearization ---------------------------------------------------------

def _huber(q):
    n = np.sqrt(q)
    return np.where(n <= HUBER_DELTA, 0.5 * q, HUBER_DELTA * (n - 0.5 * HUBER_DELTA))


def _huber_blocks(r, exact: bool):
    """``(w2, S)`` of sonar blocks ``r`` (K, 2): the gradient's weight
    ``rho'`` (``delta / |r|`` in the loss's linear part, else 1), so that
    ``g = J^T w2 r``, and the square root ``S`` (K, 2, 2) of the curvature
    that ``H`` takes, ``(S J)^T (S J)``: ``sqrt(w2) I`` (reweighting), or
    with ``exact`` the loss's own in the linear part, ``sqrt(w2) (I - u
    u^T)`` with ``u = r / |r|`` (a projection: no curvature along ``r``)."""
    norm = np.sqrt(np.sum(r.astype(np.float64) ** 2, -1))
    linear = norm > HUBER_DELTA
    w2 = np.where(linear, HUBER_DELTA / np.maximum(norm, 1e-300), 1.0)
    u = r / np.maximum(norm, 1e-300)[:, None]
    proj = np.eye(2) - np.where((linear & exact)[:, None, None], u[:, :, None] * u[:, None, :], 0.0)
    return w2.astype(r.dtype), (np.sqrt(w2)[:, None, None] * proj).astype(r.dtype)


class Joint:
    """The survey's joint problem: the odometry chain (a :class:`plainref.Graph`
    over consecutive pings), the landmarks and their sigmas."""

    def __init__(self, ar, X_dr: pr.Pose, lms: Landmarks):
        self.ar, self.lms = ar, lms
        P = len(X_dr.t)
        odo = pr.between(ar, pr.take(X_dr, slice(0, P - 1)), pr.take(X_dr, slice(1, P)))
        self.chain = pr.Graph(meas=odo, i=np.arange(P - 1), j=np.arange(1, P),
                              sigma=ar.a(np.broadcast_to(PG_ODO, (P - 1, 6))))
        self.sig_s = ar.a(np.stack([np.full(len(lms.i), SIGMA_R), lms.slant_s * ALPHA_BW], -1))
        self.sig_t = ar.a(np.stack([np.full(len(lms.j), SIGMA_R), lms.slant_t * ALPHA_BW], -1))
        self.sig_L = ar.a(LM_PRIOR)

    def sonar(self, X: pr.Pose, L):
        """Whitened sonar residuals ``(r_s, r_t)``, (K, 2) each."""
        ar, lms = self.ar, self.lms
        return (pr.sonar_residual(ar, L, pr.take(X, lms.i), lms.slant_s) / self.sig_s,
                pr.sonar_residual(ar, L, pr.take(X, lms.j), lms.slant_t) / self.sig_t)

    def cost(self, X: pr.Pose, L) -> float:
        r_o = pr.graph_residual(self.ar, self.chain, X).astype(np.float64)
        r_s, r_t = (r.astype(np.float64) for r in self.sonar(X, L))
        r_p = ((L - self.lms.L0) / self.sig_L).astype(np.float64)
        return float(0.5 * np.sum(r_o ** 2) + 0.5 * np.sum(r_p ** 2)
                     + np.sum(_huber(np.sum(r_s ** 2, -1))) + np.sum(_huber(np.sum(r_t ** 2, -1))))

    def landmark_costs(self, X: pr.Pose, L):
        """(K,) each landmark's share of the cost: its two sonar blocks and
        its prior."""
        r_s, r_t = self.sonar(X, L)
        r_p = (L - self.lms.L0) / self.sig_L
        return (_huber(np.sum(r_s.astype(np.float64) ** 2, -1)) + _huber(np.sum(r_t.astype(np.float64) ** 2, -1))
                + 0.5 * np.sum(r_p.astype(np.float64) ** 2, -1))

    def refine_landmarks(self, X: pr.Pose, L, iters: int):
        """The landmarks moved towards their own minima with the poses
        held: ``iters`` Levenberg-Marquardt steps per landmark on its 3x3
        system (the exact Huber curvature, the sonar Jacobian ``(q^T / |q|,
        e_x^T) R^T / s`` of ``q = R^T (L - t)``), each kept only where that
        landmark's cost falls."""
        ar, lms = self.ar, self.lms
        cost = self.landmark_costs(X, L)
        lam = np.full(len(L), 1e-3)
        eye3 = np.eye(3, dtype=ar.dtype)
        prior = ar.a(np.diag(1.0 / self.sig_L ** 2))
        for _ in range(iters):
            H = np.broadcast_to(prior, (len(L), 3, 3)).copy()
            g = (L - lms.L0) / self.sig_L ** 2
            for idx, slant, sig in ((lms.i, lms.slant_s, self.sig_s), (lms.j, lms.slant_t, self.sig_t)):
                Xk = pr.take(X, idx)
                Rt = np.swapaxes(Xk.R, -1, -2)
                q = pr.apply(ar, Rt, L - Xk.t)
                n = np.sqrt(np.sum(q * q, -1))
                r = np.stack([n - slant, q[:, 0]], -1) / sig
                J = np.stack([ar.mm((q / n[:, None])[:, None, :], Rt)[:, 0], Rt[:, 0]], 1) / sig[..., None]
                w2, S = _huber_blocks(r, True)
                SJ = ar.mm(S, J)
                H += ar.mm(np.swapaxes(SJ, -1, -2), SJ)
                g += ar.mm(np.swapaxes(J, -1, -2), (w2[:, None] * r)[..., None])[..., 0]
            A = H + lam[:, None, None] * (np.diagonal(H, axis1=-2, axis2=-1)[..., None] * eye3)
            Ln = L - pr.solve_or_nan(A, g[..., None])[..., 0]
            cost_n = self.landmark_costs(X, Ln)
            good = np.isfinite(cost_n) & (cost_n < cost)
            L = np.where(good[:, None], Ln, L)
            cost = np.where(good, cost_n, cost)
            lam = np.where(good, np.maximum(lam * 0.1, 1e-12), np.minimum(lam * 10.0, 1e12))
        return L

    def _sonar_jacobian(self, X: pr.Pose, L, idx, slant, sig):
        """``(r, J)``: one side's whitened residuals (K, 2) and their
        central-difference Jacobians (K, 2, 9) in the pose step (6) and the
        landmark step (3)."""
        ar = self.ar
        Xk = pr.take(X, idx)

        def fn(d):
            return pr.sonar_residual(ar, L + d[:, 6:], pr.compose(ar, Xk, pr.exp(ar, d[:, :6])), slant) / sig

        return pr._numeric_jacobian(ar, fn, 9, len(idx))

    def normal_equations(self, X: pr.Pose, L, exact: bool = True):
        """``(H, g)`` of the Gauss-Newton system over every pose but the
        first, then every landmark.  A sonar block in Huber's linear part
        (``|r| > delta``) enters ``H`` with its exact curvature, ``(delta /
        |r|) J^T (I - r r^T / |r|^2) J`` (none along ``r``, where the loss
        is linear), and ``g`` with ``(delta / |r|) J^T r``; so the steps
        converge on the Huber cost's own minimum, which a plain reweighting
        (``(delta / |r|) J^T J``) reaches only at a linear rate."""
        ar, lms = self.ar, self.lms
        P, K = len(X.t), len(L)
        r_o, Ji, Jj = pr.graph_jacobians(ar, self.chain, X)
        blocks = []  # (rows, cols, values of H's factor, values of g's factor) of the sparse Jacobians

        def block(rows, col0, J_h, J_g=None):
            """``J_h``, ``J_g`` (B, m, n): factor b's rows ``rows[b] + [0, m)``,
            columns ``col0[b] + [0, n)``."""
            B, m, n = J_h.shape
            rr = np.broadcast_to(rows[:, None, None] + np.arange(m)[None, :, None], J_h.shape)
            cc = np.broadcast_to(col0[:, None, None] + np.arange(n)[None, None, :], J_h.shape)
            blocks.append((rr.ravel(), cc.ravel(), ar.op(J_h).ravel(), ar.op(J_h if J_g is None else J_g).ravel()))

        f = np.arange(P - 1)
        block(6 * f, 6 * f, Ji)
        block(6 * f, 6 * (f + 1), Jj)
        res = [r_o.ravel()]
        nrow = 6 * (P - 1)
        lm_col = 6 * P + 3 * np.arange(K)
        for idx, slant, sig in ((lms.i, lms.slant_s, self.sig_s), (lms.j, lms.slant_t, self.sig_t)):
            if not K:
                continue
            r, J = self._sonar_jacobian(X, L, idx, slant, sig)
            w2, S = _huber_blocks(r, exact)
            J_h = ar.mm(S, J)
            rows = nrow + 2 * np.arange(K)
            block(rows, 6 * idx, J_h[..., :6], J[..., :6])
            block(rows, lm_col, J_h[..., 6:], J[..., 6:])
            res.append((r * w2[:, None]).ravel())
            nrow += 2 * K
        if K:
            block(nrow + 3 * np.arange(K), lm_col,
                  np.broadcast_to(np.diag(1.0 / self.sig_L).astype(ar.dtype), (K, 3, 3)))
            res.append(((L - lms.L0) / self.sig_L).ravel())
            nrow += 3 * K
        rows, cols, v_h, v_g = (np.concatenate([b[k] for b in blocks]) for k in range(4))
        J_h, J_g = (sp.csr_matrix((v, (rows, cols)), shape=(nrow, 6 * P + 3 * K))[:, 6:] for v in (v_h, v_g))
        return (J_h.T @ J_h).tocsc(), J_g.T @ ar.op(np.concatenate(res))


def _sym_solve(A, b):
    """``A^-1 b`` for a sparse symmetric positive definite ``A``: SuperLU
    with a minimum-degree ordering of ``A^T + A`` and diagonal pivots."""
    return spla.splu(A, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.0,
                     options=dict(SymmetricMode=True)).solve(b)


def solve(ar, joint: Joint, X0: pr.Pose, L0):
    """Levenberg-Marquardt over every pose but the first and every
    landmark, from ``(X0, L0)``: ``(X, L, iterations)``.  The joint steps
    take the reweighted curvature, sound far from the minimum, until one
    gains under ``SWITCH`` of the cost; then the exact curvature, from a
    damping of at least ``SWITCH_LAM``, each accepted step followed by
    ``REFINE_ITERS`` steps of each landmark alone
    (:meth:`Joint.refine_landmarks`), which take the landmarks in Huber's
    linear part to their own minima, where the joint steps creep; to a
    relative gain under ``REL_TOL_EPS`` units of the arithmetic's
    rounding (module docstring, step 6)."""
    P = len(X0.t)
    rel_tol = REL_TOL_EPS * float(np.finfo(ar.dtype).eps)
    X, L = X0, ar.a(L0)
    err, lam, exact = joint.cost(X, L), 1e-4, False
    it = 0
    for it in range(1, ITERS + 1):
        H, grad = joint.normal_equations(X, L, exact)
        diag = H.diagonal()
        accepted = False
        while lam < 1e10:
            step = -_sym_solve((H + sp.diags(lam * diag + 1e-12)).tocsc(), grad)
            d = np.concatenate([np.zeros(6, ar.dtype), ar.a(step[:6 * (P - 1)])]).reshape(P, 6)
            Xn, Ln = pr.compose(ar, X, pr.exp(ar, d)), L + ar.a(step[6 * (P - 1):]).reshape(-1, 3)
            errn = joint.cost(Xn, Ln)
            if np.isfinite(errn) and errn < err:
                accepted = True
                break
            lam *= 10.0
        if not accepted:
            break
        if exact:
            Ln = joint.refine_landmarks(Xn, Ln, REFINE_ITERS)
            errn = joint.cost(Xn, Ln)
        gain = err - errn
        X, L, err, lam = Xn, Ln, errn, max(lam * 0.1, 1e-12)
        if gain <= rel_tol * err:
            break
        if not exact and gain <= SWITCH * err:
            exact, lam = True, max(lam, SWITCH_LAM)
    return X, L, it


# --- one pass ---------------------------------------------------------------------------------

class ControlArith(pr.Arith):
    """The control's arithmetic: float32, with the operands that
    :meth:`Joint.normal_equations` passes through ``op`` rounded to TF32,
    and every other product (``mm``: the rigid motions, the residuals,
    the per-landmark steps) in float32 alone."""

    def __init__(self):
        super().__init__(control=True)

    def mm(self, a, b):
        return np.matmul(np.asarray(a, np.float32), np.asarray(b, np.float32))



def run(survey, control: bool = False) -> Dict[str, object]:
    """The reference's answers for one survey: ``poses_t`` (P, 3), every
    ping's estimated position in the survey's order, and ``landmarks`` (K,
    3), every landmark's estimate in the order of :func:`landmarks`."""
    t0 = time.perf_counter()
    ar = ControlArith() if control else pr.Arith()
    lines = pr.survey_lines(survey)
    lms = landmarks(ar, lines, gated_pairs(ar, lines))
    X_dr = pr.from_dr(ar, np.concatenate([l.dr for l in lines]))
    X, L, iters = solve(ar, Joint(ar, X_dr, lms), X_dr, lms.L0)
    print(f"[plainref_fba] {'control' if control else 'float64'}: {len(X.t)} poses, {len(L)} landmarks, "
          f"{iters} LM iterations in {time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    return {"poses_t": X.t.astype(np.float64), "landmarks": L.astype(np.float64)}


# --- the program's answers, and the numbers that compare them -----------------------------------

def outputs(rec) -> dict:
    """The program's answers of one pass (``rec.result``, its
    ``SlamResult``), on the host, in the layout of :func:`run`; a result
    without ``landmarks`` has None there, which the comparison fails."""
    lms = getattr(rec.result, "landmarks", None)
    return {"poses_t": pr._host(rec.result.poses.t).astype(np.float64),
            "landmarks": None if lms is None else pr._host(lms).astype(np.float64)}


def lm_gap(prog: dict, ref: dict) -> float:
    a, b = prog["landmarks"], ref["landmarks"]
    if a is None or a.shape != b.shape:
        return math.inf
    if not len(b):
        return 0.0
    gap = np.linalg.norm(a - b, axis=-1)
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else math.inf


def numbers(passes: List[dict], ref: dict) -> Dict[str, object]:
    """``pose_gap_m`` one per checked pass, ``lm_gap_m`` of the last."""
    return {"pose_gap_m": [pr.pose_gap(p, ref) for p in passes], "lm_gap_m": lm_gap(passes[-1], ref)}
