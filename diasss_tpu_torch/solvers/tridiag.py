"""Block-tridiagonal SPD solve by cyclic reduction.

Counterpart of the cyclic-reduction pair of :mod:`diasss_tpu.solvers.tridiag`
(``solve_block_tridiag`` / ``solve_block_tridiag_multi``): ``log2(P)``
levels, each one batch of 6x6 Cholesky inverses and small matrix products —
the shape that suits a GPU running eagerly (the 2P-step Thomas scan is not
ported).

Convention: ``T x = b`` with diagonal blocks ``D`` (P, 6, 6), super-diagonal
blocks ``U`` (P-1, 6, 6) coupling (i, i+1), sub-diagonal ``U^T``.  The
right-hand side is (P, 6) or (P, 6, R).
"""

from __future__ import annotations

import torch


def _invert_blocks(D: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverses via Cholesky (NaN where the factorisation fails)."""
    from .lm import cholesky_solve_or_nan

    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device).expand(D.shape)
    return cholesky_solve_or_nan(D, eye)


def solve_block_tridiag(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD block-tridiagonal system; returns x with ``b``'s shape."""
    vec = b.dim() == 2
    x = _cr(D, U, b[..., None] if vec else b)
    return x[..., 0] if vec else x


def solve_block_tridiag_multi(D: torch.Tensor, U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Multi-RHS solve: ``B`` (P, 6, R) -> (P, 6, R); every factorisation of
    the reduction serves all R columns."""
    return _cr(D, U, B)


def _cr(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cyclic reduction on (P, 6, R) right-hand sides: eliminate the odd
    blocks, recurse on the even ones, back-substitute the odd ones."""
    P = D.shape[0]
    if P == 1:
        return _invert_blocks(D) @ b
    if P == 2:
        A = torch.cat([torch.cat([D[0], U[0]], 1), torch.cat([U[0].T, D[1]], 1)], 0)
        x = torch.linalg.solve(A, torch.cat([b[0], b[1]], 0))
        return torch.stack([x[:6], x[6:]])

    dev = D.device
    odd = torch.arange(1, P, 2, device=dev)
    even = torch.arange(0, P, 2, device=dev)
    n_odd, n_even = odd.shape[0], even.shape[0]
    n_u = U.shape[0]

    D_odd, b_odd = D[odd], b[odd]
    U_left = U[odd - 1]  # block (i-1, i)
    has_right = odd + 1 < P
    U_right = torch.where(has_right[:, None, None], U[torch.clamp(odd, max=n_u - 1)],
                          torch.zeros_like(U_left))  # block (i, i+1)

    Dinv = _invert_blocks(D_odd)
    Dinv_Ul = Dinv @ U_left.transpose(-1, -2)
    Dinv_Ur = Dinv @ U_right
    Dinv_b = Dinv @ b_odd

    # reduced system on the even blocks
    U_even = U[torch.clamp(even, max=n_u - 1)]
    has_rodd = (even + 1 < P)[:, None, None]
    k_r = torch.clamp(even // 2, max=n_odd - 1)
    D_new = D[even] - torch.where(has_rodd, U_even @ Dinv_Ul[k_r], torch.zeros_like(D[even]))
    b_new = b[even] - torch.where(has_rodd, U_even @ Dinv_b[k_r], torch.zeros_like(b[even]))

    has_lodd = (even - 1 >= 0)[:, None, None]
    k_l = torch.clamp((even - 2) // 2, min=0)
    Ul_T = U[torch.clamp(even - 1, min=0)].transpose(-1, -2)
    D_new = D_new - torch.where(has_lodd, Ul_T @ Dinv_Ur[k_l], torch.zeros_like(D_new))
    b_new = b_new - torch.where(has_lodd, Ul_T @ Dinv_b[k_l], torch.zeros_like(b_new))

    # couplings between consecutive even blocks j, j+2 (via odd j+1)
    j_idx = even[:-1]
    U_new = -(U[j_idx] @ Dinv_Ur[torch.clamp(j_idx // 2, max=n_odd - 1)])

    x_even = _cr(D_new, U_new, b_new)

    x_left = x_even[torch.clamp((odd - 1) // 2, max=n_even - 1)]
    x_right = torch.where(has_right[:, None, None], x_even[torch.clamp((odd + 1) // 2, max=n_even - 1)],
                          torch.zeros_like(x_left))
    rhs = b_odd - U_left.transpose(-1, -2) @ x_left - U_right @ x_right
    x_odd = Dinv @ rhs

    x = torch.empty_like(b)
    x[even] = x_even
    x[odd] = x_odd
    return x
