"""Block-tridiagonal SPD chains: cyclic-reduction solves, selected inversion
and the segment preconditioners of the PCG family.

Counterpart of :mod:`diasss_tpu.solvers.tridiag`:

* ``solve_block_tridiag`` / ``solve_block_tridiag_multi`` — cyclic
  reduction, ``log2(P)`` levels, each one batch of 6x6 Cholesky inverses
  and small matrix products: the shape that suits a GPU running eagerly
  (the 2P-step Thomas scan is not ported);
* ``block_tridiag_selected_inverse`` — the diagonal blocks of ``T^-1``
  along the same ``log2(P)`` levels (the JAX package runs two P-step scans);
* ``solve_block_tridiag_segmented``, ``dense_segment_inverses``,
  ``apply_dense_segment_inverses`` and ``auto_dense_segment`` — the chain
  cut into independent segments, as PCG preconditioners;
* ``ChainFactor``, ``chain_factor`` and ``chain_solve`` — the same dense
  segment inverses joined by their spikes and one reduced boundary system:
  an exact solve whose every application is a few batched products.

Convention: ``T x = b`` with diagonal blocks ``D`` (P, 6, 6), super-diagonal
blocks ``U`` (P-1, 6, 6) coupling (i, i+1), sub-diagonal ``U^T``.  The
right-hand side is (P, 6) or (P, 6, R).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _invert_blocks(D: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverses via Cholesky (NaN where the factorisation fails)."""
    from .lm import cholesky_solve_or_nan

    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device).expand(D.shape)
    return cholesky_solve_or_nan(D, eye)


def solve_block_tridiag(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD block-tridiagonal system; returns x with ``b``'s shape."""
    vec = b.dim() == 2
    x = _cr(D[None], U[None], (b[..., None] if vec else b)[None])[0]
    return x[..., 0] if vec else x


def solve_block_tridiag_multi(D: torch.Tensor, U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Multi-RHS solve: ``B`` (P, 6, R) -> (P, 6, R); every factorisation of
    the reduction serves all R columns."""
    return _cr(D[None], U[None], B[None])[0]


class _Level(NamedTuple):
    """One cyclic-reduction level: index sets, the odd blocks' couplings and
    inverses, and the Schur complement on the even blocks, itself a chain."""

    odd: torch.Tensor
    even: torch.Tensor
    has_right: torch.Tensor  # odd block i has a right neighbour i+1
    has_lodd: torch.Tensor  # even block j has an odd left neighbour j-1 (n_even, 1, 1)
    has_rodd: torch.Tensor  # ... an odd right neighbour j+1
    k_l: torch.Tensor  # that left neighbour's position among the odd blocks
    k_r: torch.Tensor
    U_left: torch.Tensor  # (C, n_odd, 6, 6) block (i-1, i)
    U_right: torch.Tensor  # block (i, i+1), zero without a right neighbour
    U_even: torch.Tensor  # block (j, j+1)
    Ul_T: torch.Tensor  # block (j, j-1)
    Dinv: torch.Tensor
    Dinv_Ul: torch.Tensor
    Dinv_Ur: torch.Tensor
    D_new: torch.Tensor
    U_new: torch.Tensor


def _odd_even(D: torch.Tensor, U: torch.Tensor) -> _Level:
    """One cyclic-reduction level of a batch of chains ``D`` (C, P, 6, 6),
    ``U`` (C, P-1, 6, 6), P >= 3."""
    P = D.shape[1]
    dev = D.device
    odd = torch.arange(1, P, 2, device=dev)
    even = torch.arange(0, P, 2, device=dev)
    n_odd = odd.shape[0]
    n_u = U.shape[1]

    U_left = U[:, odd - 1]  # block (i-1, i)
    has_right = odd + 1 < P
    U_right = torch.where(has_right[:, None, None], U[:, torch.clamp(odd, max=n_u - 1)],
                          torch.zeros_like(U_left))  # block (i, i+1)
    Dinv = _invert_blocks(D[:, odd])
    Dinv_Ul = Dinv @ U_left.transpose(-1, -2)
    Dinv_Ur = Dinv @ U_right

    U_even = U[:, torch.clamp(even, max=n_u - 1)]
    has_rodd = (even + 1 < P)[:, None, None]
    k_r = torch.clamp(even // 2, max=n_odd - 1)
    D_new = D[:, even] - torch.where(has_rodd, U_even @ Dinv_Ul[:, k_r], torch.zeros_like(D[:, even]))
    has_lodd = (even - 1 >= 0)[:, None, None]
    k_l = torch.clamp((even - 2) // 2, min=0)
    Ul_T = U[:, torch.clamp(even - 1, min=0)].transpose(-1, -2)
    D_new = D_new - torch.where(has_lodd, Ul_T @ Dinv_Ur[:, k_l], torch.zeros_like(D_new))

    # couplings between consecutive even blocks j, j+2 (via odd j+1)
    j_idx = even[:-1]
    U_new = -(U[:, j_idx] @ Dinv_Ur[:, torch.clamp(j_idx // 2, max=n_odd - 1)])
    return _Level(odd, even, has_right, has_lodd, has_rodd, k_l, k_r, U_left, U_right, U_even, Ul_T, Dinv,
                  Dinv_Ul, Dinv_Ur, D_new, U_new)


def _cr(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cyclic reduction of a batch of C independent chains on (C, P, 6, R)
    right-hand sides: eliminate the odd blocks, recurse on the even ones,
    back-substitute the odd ones."""
    P = D.shape[1]
    if P == 1:
        return _invert_blocks(D) @ b
    if P == 2:
        A = torch.cat([torch.cat([D[:, 0], U[:, 0]], -1), torch.cat([U[:, 0].transpose(-1, -2), D[:, 1]], -1)], -2)
        x = torch.linalg.solve(A, torch.cat([b[:, 0], b[:, 1]], -2))
        return torch.stack([x[:, :6], x[:, 6:]], 1)

    lv = _odd_even(D, U)
    odd, even = lv.odd, lv.even
    n_even = even.shape[0]
    b_odd = b[:, odd]
    Dinv_b = lv.Dinv @ b_odd
    b_new = b[:, even] - torch.where(lv.has_rodd, lv.U_even @ Dinv_b[:, lv.k_r], torch.zeros_like(b[:, even]))
    b_new = b_new - torch.where(lv.has_lodd, lv.Ul_T @ Dinv_b[:, lv.k_l], torch.zeros_like(b_new))

    x_even = _cr(lv.D_new, lv.U_new, b_new)

    x_left = x_even[:, torch.clamp((odd - 1) // 2, max=n_even - 1)]
    x_right = torch.where(lv.has_right[:, None, None], x_even[:, torch.clamp((odd + 1) // 2, max=n_even - 1)],
                          torch.zeros_like(x_left))
    x_odd = lv.Dinv @ (b_odd - lv.U_left.transpose(-1, -2) @ x_left - lv.U_right @ x_right)

    x = torch.empty_like(b)
    x[:, even] = x_even
    x[:, odd] = x_odd
    return x


def spike_block_tridiag_multi(mesh, D_loc: torch.Tensor, U_loc: torch.Tensor, U_bd: torch.Tensor,
                              B_rhs: torch.Tensor) -> torch.Tensor:
    """Exact multi-RHS solve of a block-tridiagonal chain partitioned over
    the ranks of ``mesh`` (SPIKE), run by every rank on its own block.

    This rank owns ``D_loc`` (B, 6, 6), the couplings ``U_loc`` (B-1, 6, 6)
    between its rows, ``U_bd`` (6, 6) coupling its last row to the next
    rank's first (zero on the last rank and across invalid factors) and its
    right-hand-side rows ``B_rhs`` (B, 6, R).  Steps:

    1. one local multi-RHS cyclic reduction of ``[B_rhs | e_last U_bd |
       e_first U_prev^T]`` (the two spikes are 12 more columns);
    2. ``U_bd`` to the next rank (one point-to-point exchange), an
       all-gather of the first and last rows of the local solutions and
       spikes: the solve's whole communication;
    3. every rank solves the same (12n, 12n) reduced boundary system;
    4. local back-substitution ``x = w - F y_next - G y_prev``.

    Counterpart of ``diasss_tpu.solvers.tridiag.spike_block_tridiag_multi``;
    the local solve is the port's cyclic reduction on every device, where
    the JAX package runs a Thomas scan off the TPU."""
    from ..parallel.collectives import all_gather, ppermute

    B, R = D_loc.shape[0], B_rhs.shape[2]
    if B < 2:
        raise ValueError("SPIKE partitioning needs >= 2 rows per rank")
    n, d = mesh.size, mesh.rank
    dtype, dev = D_loc.dtype, D_loc.device
    # left coupling: the previous rank's boundary block (the cyclic pair is
    # harmless: the last rank's U_bd is zero by contract)
    U_prev = ppermute(mesh, [U_bd], [(i, (i + 1) % n) for i in range(n)])[0]
    cols = torch.zeros((B, 6, 12), dtype=dtype, device=dev)
    cols[B - 1, :, :6] = U_bd
    cols[0, :, 6:] = U_prev.T
    W = solve_block_tridiag_multi(D_loc, U_loc, torch.cat([B_rhs, cols], dim=2))
    w, F, G = W[:, :, :R], W[:, :, R:R + 6], W[:, :, R + 6:]

    Fg = all_gather(mesh, torch.stack([F[0], F[B - 1], G[0], G[B - 1]]))  # (n, 4, 6, 6)
    wg = all_gather(mesh, torch.stack([w[0], w[B - 1]]))  # (n, 2, 6, R)
    # reduced system over y = [x_0[0], x_0[B-1], x_1[0], ...]:
    #   x_d[0]   + F_d[0]   x_{d+1}[0] + G_d[0]   x_{d-1}[B-1] = w_d[0]
    #   x_d[B-1] + F_d[B-1] x_{d+1}[0] + G_d[B-1] x_{d-1}[B-1] = w_d[B-1]
    M = torch.zeros((n, 2, 6, n, 2, 6), dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    for k in range(n):
        for r in range(2):
            M[k, r, :, k, r, :] = eye6
            if k + 1 < n:
                M[k, r, :, k + 1, 0, :] += Fg[k, r]
            if k >= 1:
                M[k, r, :, k - 1, 1, :] += Fg[k, 2 + r]
    y = torch.linalg.solve(M.reshape(12 * n, 12 * n), wg.reshape(12 * n, R)).reshape(n, 2, 6, R)
    x = w
    if d + 1 < n:
        x = x - F @ y[d + 1, 0]
    if d >= 1:
        x = x - G @ y[d - 1, 1]
    return x


def block_tridiag_selected_inverse(D: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """(P, 6, 6) diagonal blocks of ``T^-1`` for the SPD block-tridiagonal
    ``T`` — selected inversion along the cyclic-reduction levels, no dense
    inverse and no loop that grows with P (recursion depth ``log2(P)``).

    With the odd blocks eliminated, ``T^-1`` is ``S^-1`` on the even blocks
    (``S`` the reduced chain) and ``Dinv + X S^-1 X^T`` on each odd block
    ``i``, where ``X`` holds ``Dinv_i U_{i-1}^T`` and ``Dinv_i U_i`` at its two
    even neighbours.  So each level needs the reduced inverse's diagonal
    blocks and its blocks coupling consecutive even rows; it returns both
    for its own rows in turn."""
    return _selinv(D[None], U[None])[0][0]


def _selinv(D: torch.Tensor, U: torch.Tensor):
    """Diagonal (C, P, 6, 6) and super-diagonal (C, P-1, 6, 6) blocks of the
    inverse of each chain of the batch."""
    P = D.shape[1]
    if P == 1:
        return _invert_blocks(D), D.new_zeros((D.shape[0], 0, 6, 6))
    if P == 2:
        A = torch.cat([torch.cat([D[:, 0], U[:, 0]], -1), torch.cat([U[:, 0].transpose(-1, -2), D[:, 1]], -1)], -2)
        Ainv = _invert_blocks(A)
        return torch.stack([Ainv[:, :6, :6], Ainv[:, 6:, 6:]], 1), Ainv[:, None, :6, 6:]

    lv = _odd_even(D, U)
    odd, even, Dinv, Dinv_Ul, Dinv_Ur = lv.odd, lv.even, lv.Dinv, lv.Dinv_Ul, lv.Dinv_Ur
    n_even = even.shape[0]
    S_diag, S_sup = _selinv(lv.D_new, lv.U_new)

    kl = (odd - 1) // 2  # the odd row's left even neighbour, in the reduced chain
    kr = torch.clamp(kl + 1, max=n_even - 1)  # its right one (Dinv_Ur is zero without it)
    S_ll, S_rr = S_diag[:, kl], S_diag[:, kr]
    S_lr = S_sup[:, torch.clamp(kl, max=n_even - 2)]  # (kl, kl + 1)

    t = Dinv_Ul @ S_lr @ Dinv_Ur.transpose(-1, -2)
    sig_odd = (Dinv + Dinv_Ul @ S_ll @ Dinv_Ul.transpose(-1, -2) + Dinv_Ur @ S_rr @ Dinv_Ur.transpose(-1, -2)
               + t + t.transpose(-1, -2))
    left = -(Dinv_Ul @ S_ll + Dinv_Ur @ S_lr.transpose(-1, -2))  # (i, i-1)
    right = -(Dinv_Ul @ S_lr + Dinv_Ur @ S_rr)  # (i, i+1)

    diag = torch.empty_like(D)
    diag[:, even] = S_diag
    diag[:, odd] = sig_odd
    sup = torch.empty_like(U)
    sup[:, odd - 1] = left.transpose(-1, -2)
    n_right = (P - 1) // 2  # odd rows with a right neighbour: all but the last when P is even
    sup[:, odd[:n_right]] = right[:, :n_right]
    return diag, sup


def _segment_chains(D: torch.Tensor, U: torch.Tensor, segment: int):
    """The chain cut into S = ceil(P / segment) independent segments: padded
    with identity blocks, the couplings that cross a segment border dropped.
    Returns (D_seg (S, segment, 6, 6), U_seg (S, segment-1, 6, 6))."""
    P = D.shape[0]
    S = -(-P // segment)
    pad = S * segment - P
    if pad:
        D = torch.cat([D, torch.eye(6, dtype=D.dtype, device=D.device).expand(pad, 6, 6)])
    U_full = torch.cat([U, U.new_zeros((pad + 1, 6, 6))])[: S * segment]
    cross = (torch.arange(S * segment, device=D.device) % segment) == (segment - 1)
    U_full = torch.where(cross[:, None, None], 0.0, U_full)
    return D.reshape(S, segment, 6, 6), U_full.reshape(S, segment, 6, 6)[:, : segment - 1]


def solve_block_tridiag_segmented(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor,
                                  segment: int = 256) -> torch.Tensor:
    """Approximate solve for a (P, 6) right-hand side: the chain cut into
    independent segments of ``segment`` blocks (cross-segment couplings
    dropped), all segments reduced together as one batch of chains —
    ``log2(segment)`` levels instead of ``log2(P)``.  As a preconditioner it
    lies between block-Jacobi (segment 1) and the exact chain solve."""
    P = D.shape[0]
    if P <= segment:
        return solve_block_tridiag(D, U, b)
    D_seg, U_seg = _segment_chains(D, U, segment)
    S = D_seg.shape[0]
    b_p = torch.cat([b, b.new_zeros((S * segment - P, 6))])
    x = _cr(D_seg, U_seg, b_p.reshape(S, segment, 6, 1))
    return x.reshape(S * segment, 6)[:P]


def _segment_matrices(D_seg: torch.Tensor, U_seg: torch.Tensor) -> torch.Tensor:
    """(S, 6*segment, 6*segment) dense matrices of the segment chains of
    :func:`_segment_chains`, filled by three batched index assignments."""
    S, segment = D_seg.shape[:2]
    T = D_seg.new_zeros((S, segment, 6, segment, 6))
    ii = torch.arange(segment, device=D_seg.device)
    T[:, ii, :, ii, :] = D_seg.transpose(0, 1)
    if segment > 1:
        jj = ii[:-1]
        T[:, jj, :, jj + 1, :] = U_seg.transpose(0, 1)
        T[:, jj + 1, :, jj, :] = U_seg.transpose(-1, -2).transpose(0, 1)
    return T.reshape(S, 6 * segment, 6 * segment)


def _inverses(T: torch.Tensor) -> torch.Tensor:
    """LU inverses of a batch of matrices, one call each: batched LU of
    such matrices on the CPU (torch 2.13 with oneMKL 2024.2) fails with more
    than one thread."""
    return torch.stack([torch.linalg.inv(M) for M in T])


def dense_segment_inverses(D: torch.Tensor, U: torch.Tensor, segment: int) -> torch.Tensor:
    """(S, 6*segment, 6*segment) explicit inverses of the segments' dense
    chain matrices — the same preconditioner as
    :func:`solve_block_tridiag_segmented`, applied as one batched GEMM.

    One float32 LU inverse per segment and LM trial (:func:`_inverses`).
    The JAX package tried storing the inverse in bf16 and rejected it: the
    chain matrices are ill-conditioned enough that bf16 rounding wrecks the
    preconditioner."""
    return _inverses(_segment_matrices(*_segment_chains(D, U, segment)))


def apply_dense_segment_inverses(Minv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Apply the segment inverses to a (P, 6) vector: one batched GEMM."""
    S, m, _ = Minv.shape
    P = b.shape[0]
    b_p = torch.cat([b, b.new_zeros((S * (m // 6) - P, 6))])
    return (Minv @ b_p.reshape(S, m, 1)).reshape(-1, 6)[:P]


def auto_dense_segment(P: int, requested: int, budget_floats: int = 150_000_000) -> int:
    """Largest power-of-two segment <= ``requested`` whose inverse store
    ``36 * P * segment`` floats fits the budget (at least 8).  The JAX
    package also caps it at 64 on a TPU; the port keys nothing on the
    device and keeps the rule the JAX package applies elsewhere."""
    seg = 8
    while seg * 2 <= requested and 36 * P * (seg * 2) <= budget_floats:
        seg *= 2
    return min(seg, max(8, requested))


class ChainFactor(NamedTuple):
    """Reusable exact factorization of a block-tridiagonal chain (two-level
    SPIKE on one device): the chain cut into S segments of ``segment``
    rows, each segment's dense (m, m) matrix inverted once (m = 6 *
    segment), the right and left spikes ``F``, ``G`` coupling each segment
    to its neighbours, and the (12S, 12S) reduced boundary system inverted
    once.  Every :func:`chain_solve` is then batched products only: ``w =
    Minv b`` per segment, one boundary correction, two spike products.

    Unlike :func:`dense_segment_inverses`, which drops the couplings across
    segment borders and is only a preconditioner, this solves the whole
    chain: it equals :func:`solve_block_tridiag_multi`.  The segment size
    and the real row count are read from the shapes at apply time."""

    Minv: torch.Tensor  # (S, m, m) per-segment dense inverses
    F: torch.Tensor  # (S, m, 6) right spikes (coupling to the next segment)
    G: torch.Tensor  # (S, m, 6) left spikes (coupling to the previous segment)
    Rinv: torch.Tensor  # (12S, 12S) inverse of the reduced boundary system


def chain_factor(D: torch.Tensor, U: torch.Tensor, segment: int = 64) -> ChainFactor:
    """Factor the SPD block-tridiagonal chain (``D`` (P, 6, 6), ``U`` (P-1,
    6, 6)) into a :class:`ChainFactor`: the segment inverses of
    :func:`dense_segment_inverses`, two spike products and one (12S, 12S)
    inverse, in the dtype of ``D``."""
    P = D.shape[0]
    S = -(-P // segment)
    m = 6 * segment
    dev, dtype = D.device, D.dtype
    D_seg, U_seg = _segment_chains(D, U, segment)
    Minv = _inverses(_segment_matrices(D_seg, U_seg))
    # U_bd[s] couples segment s's last row to segment s+1's first; the last
    # segment's falls in the zero padding
    U_bd = torch.cat([U, U.new_zeros((S * segment - P + 1, 6, 6))])[segment - 1::segment]
    U_prev = torch.cat([U_bd.new_zeros((1, 6, 6)), U_bd[:-1]])
    F = Minv[:, :, m - 6:] @ U_bd
    G = Minv[:, :, :6] @ U_prev.transpose(-1, -2)

    # reduced system over y = [x_s[first 6], x_s[last 6]] for every segment s:
    #   x_s[r] + F_s[r] y_{s+1,first} + G_s[r] y_{s-1,last} = w_s[r],  r in (first, last)
    M = torch.zeros((S, 2, 6, S, 2, 6), dtype=dtype, device=dev)
    s = torch.arange(S, device=dev)
    r = torch.arange(2, device=dev)
    M[s[:, None], r[None, :], :, s[:, None], r[None, :], :] = torch.eye(6, dtype=dtype, device=dev)
    if S > 1:
        M[s[:-1], :, :, s[1:], 0, :] = torch.stack([F[:-1, :6], F[:-1, m - 6:]], 1)
        M[s[1:], :, :, s[:-1], 1, :] = torch.stack([G[1:, :6], G[1:, m - 6:]], 1)
    Rinv = torch.linalg.inv(M.reshape(12 * S, 12 * S))
    return ChainFactor(Minv=Minv, F=F, G=G, Rinv=Rinv)


def chain_solve(fac: ChainFactor, b: torch.Tensor) -> torch.Tensor:
    """Exact chain solve with a :class:`ChainFactor`; ``b`` (P, 6) or (P, 6,
    R), returns the same shape."""
    vec = b.dim() == 2
    if vec:
        b = b[:, :, None]
    P, _, R = b.shape
    S, m, _ = fac.Minv.shape
    segment = m // 6
    b = torch.cat([b, b.new_zeros((S * segment - P, 6, R))])
    w = fac.Minv @ b.reshape(S, m, R)  # (S, m, R)
    wb = torch.stack([w[:, :6], w[:, m - 6:]], 1)  # (S, 2, 6, R)
    y = (fac.Rinv @ wb.reshape(12 * S, R)).reshape(S, 2, 6, R)
    zero = b.new_zeros((1, 6, R))
    y_next = torch.cat([y[1:, 0], zero])  # (S, 6, R)
    y_prev = torch.cat([zero, y[:-1, 1]])
    x = (w - fac.F @ y_next - fac.G @ y_prev).reshape(S * segment, 6, R)[:P]
    return x[:, :, 0] if vec else x
