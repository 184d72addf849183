"""Batched dense Levenberg-Marquardt on product manifolds.

Counterpart of :mod:`diasss_tpu.solvers.lm`.  The JAX package ``vmap``s one
LM solve over a batch of small independent problems; here the batch is a
written-out leading dimension:

* ``residual_fn(x, *args) -> r`` (B, m) is the whitened residual of a batch
  of problems; ``x0`` (any pytree) and every tensor in ``args`` carry the
  batch on dim 0, and the function computes row b from row b alone.
* ``retract_fn(x, delta) -> x'`` applies a (B, n) tangent step.

Jacobians are forward-mode derivatives (``torch.func.jvp``, vmapped over the
n basis directions) of ``delta -> residual_fn(retract_fn(x, delta))`` at
``delta = 0`` — what ``jax.jacfwd`` computes per problem.  The batch stays a
real tensor dimension inside the residual: under ``vmap`` over problems every
per-problem scalar would be a 0-dim tensor, and forward-mode AD in torch
promotes the tangent of a 0-dim tensor times a Python float to float64.

The loop is the same fixed-trip masked loop (GTSAM defaults: lambda 1e-5,
factor 10, cap 1e5; freeze on lambda stall): a Python loop whose
accept/reject decisions stay on the device in ``torch.where``, with no host
synchronisation.  Each trip is a ``lm.iteration`` span (:mod:`..trace`)
holding ``lm.linearize`` and ``lm.step``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jvp, vmap
from torch.utils import _pytree as pytree

from .. import trace


class LMResult(NamedTuple):
    x: object  # final estimate (same pytree as x0)
    error: torch.Tensor  # (B,) final 0.5*||r||^2
    initial_error: torch.Tensor  # (B,)
    hessian: torch.Tensor  # (B, n, n) J^T J at the final estimate
    iterations: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool


def tree_where(mask: torch.Tensor, a, b):
    """Per-problem select between two batched pytrees (``mask`` is (B,))."""
    la, spec = pytree.tree_flatten(a)
    lb, _ = pytree.tree_flatten(b)
    out = [torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y) for x, y in zip(la, lb)]
    return pytree.tree_unflatten(out, spec)


def linearize(residual_fn: Callable, retract_fn: Callable, x, args, n_dim: int):
    """Batched (r, J): r (B, m), J (B, m, n) at ``delta = 0``."""

    def local(delta):
        return residual_fn(retract_fn(x, delta), *args)

    ref = pytree.tree_leaves(x)[0]
    B = ref.shape[0]
    zero = torch.zeros((B, n_dim), dtype=ref.dtype, device=ref.device)
    basis = torch.eye(n_dim, dtype=ref.dtype, device=ref.device)[:, None, :].expand(n_dim, B, n_dim)
    r = local(zero)
    cols = vmap(lambda t: jvp(local, (zero,), (t,))[1])(basis)  # (n, B, m)
    return r, cols.permute(1, 2, 0)


def cholesky_solve_or_nan(A: torch.Tensor, b: torch.Tensor, triangular: bool = False) -> torch.Tensor:
    """Solve the SPD systems ``A x = b`` (b (..., n) or (..., n, k)); systems
    whose Cholesky factorisation fails give NaN, as ``jnp.linalg.cholesky``
    does, so an LM step on them is rejected.  ``triangular`` solves with the
    factor by two triangular solves (on the CPU the BLAS calls, and bits, of
    ``torch.cholesky_solve``), which a CUDA graph can capture: on the card
    the batched ``torch.cholesky_solve`` takes MAGMA's solve, which
    allocates device memory as it runs, and a capture refuses that."""
    L, info = torch.linalg.cholesky_ex(A)
    vec = b.dim() == A.dim() - 1
    rhs = b[..., None] if vec else b
    if triangular:
        x = torch.linalg.solve_triangular(L.mT, torch.linalg.solve_triangular(L, rhs, upper=False), upper=True)
    else:
        x = torch.cholesky_solve(rhs, L)
    x = x[..., 0] if vec else x
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def levenberg_marquardt(
    residual_fn: Callable,
    retract_fn: Callable,
    x0,
    args: tuple,
    n_dim: int,
    max_iters: int = 40,
    lambda_init: float = 1e-5,
    lambda_factor: float = 10.0,
    lambda_max: float = 1e5,
    abs_tol: float = 1e-5,
) -> LMResult:
    """Minimise ``0.5 * ||residual_fn(x)||^2`` for every problem of the batch."""

    def error_of(x):
        r = residual_fn(x, *args)
        return 0.5 * torch.sum(r * r, dim=-1)

    ref = pytree.tree_leaves(x0)[0]
    B, dtype, dev = ref.shape[0], ref.dtype, ref.device
    eye = torch.eye(n_dim, dtype=dtype, device=dev)
    err0 = error_of(x0)
    x, err = x0, err0
    lam = torch.full((B,), lambda_init, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        with trace.span("lm.iteration"):
            with trace.span("lm.linearize"):
                r, J = linearize(residual_fn, retract_fn, x, args, n_dim)
            with trace.span("lm.step"):
                Jt = J.transpose(-1, -2)
                A = Jt @ J + lam[:, None, None] * eye
                delta = cholesky_solve_or_nan(A, -(Jt @ r[..., None])[..., 0], triangular=True)
                x_new = retract_fn(x, delta)
                err_new = error_of(x_new)
                good = torch.isfinite(err_new) & (err_new < err)
                upd = good & ~done
                x = tree_where(upd, x_new, x)
                err = torch.where(upd, err_new, err)
                lam_up = torch.clamp(lam * lambda_factor, max=lambda_max)
                lam = torch.where(done, lam, torch.where(good, lam / lambda_factor, lam_up))
                done = done | (~good & (lam >= lambda_max))
                iters = iters + torch.where(done, 0, 1).to(torch.int32)

    with trace.span("lm.linearize"):
        r, J = linearize(residual_fn, retract_fn, x, args, n_dim)
    Jt = J.transpose(-1, -2)
    H = Jt @ J
    grad_norm = torch.linalg.norm((Jt @ r[..., None])[..., 0], dim=-1)
    converged = (grad_norm <= 1e-3 * (1.0 + err)) | (err <= abs_tol)
    return LMResult(x=x, error=err, initial_error=err0, hessian=H, iterations=iters, converged=converged)


def marginal_covariance(hessian: torch.Tensor, block: slice) -> torch.Tensor:
    """``(H^-1)[block, block]`` per problem (Marginals::QR equivalent)."""
    n = hessian.shape[-1]
    eye = torch.eye(n, dtype=hessian.dtype, device=hessian.device)[:, block]
    cols = cholesky_solve_or_nan(hessian, eye.expand(*hessian.shape[:-2], n, eye.shape[-1]), triangular=True)
    return cols[..., block, :]
