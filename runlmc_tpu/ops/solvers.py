"""Batched MINRES / CG Krylov solvers in ``lax.while_loop``, with
true-residual restart cycles for float32 robustness.

Behavioral parity target: reference runlmc/approx/iterative.py:20-62 —
scipy MINRES (default) or CG, ``maxiter = n``, terminating when the
absolute residual 2-norm ||y - K x|| drops below ``tol``; the reference
polls the true reconstruction error every 100 iterations via a callback.

Structure here: an *inner* Krylov cycle (<= ``cycle`` iterations, default
100, mirroring the reference's polling period) runs on the current
residual; an *outer* refinement loop recomputes the TRUE residual
r = b - A x, restarts the cycle on it, and keeps the best iterate.
Restarting bounds the floating-point orthogonality drift that plain
MINRES/CG suffer over thousands of f32 iterations, and the outer
stall check (a cycle must cut the residual by ``stall_ratio``) stops
cleanly at the f32 accuracy floor instead of spinning to maxiter.

Batched design: ONE solver instance handles a whole batch of
right-hand sides (observations + Hutchinson probes + prediction
columns); each iteration performs a single fused batched matvec; per-RHS
convergence is handled with masks. This replaces the reference's
``multiprocessing.Pool.starmap`` over independent scipy solves
(runlmc/lmc/stochastic_deriv.py:51-52). Under a ``jax.sharding.Mesh``
the batch axis shards across devices and XLA partitions the loop.
"""

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class SolveResult(NamedTuple):
    x: jax.Array  # (B, n) solutions
    iterations: jax.Array  # (B,) Krylov iterations used
    error: jax.Array  # (B,) final true residual ||b - A x||
    converged: jax.Array  # (B,) bool: error < tol


def _norm(v):
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


# --------------------------------------------------------------------------
# Inner cycles: fixed-budget Krylov from x=0 on a given residual.
# --------------------------------------------------------------------------


def _minres_cycle(matvec, b, tol, max_inner):
    """One MINRES cycle (Paige-Saunders Lanczos + Givens QR) from zero,
    batched. Returns (dx, iters): approximate solution of A dx = b."""
    B, n = b.shape
    dtype = b.dtype

    beta1 = _norm(b)
    nonzero = beta1 > 0
    safe_beta1 = jnp.where(nonzero, beta1, 1.0)

    class _S(NamedTuple):
        k: jax.Array
        x: jax.Array
        v: jax.Array
        v_prev: jax.Array
        beta: jax.Array
        d: jax.Array
        d_prev: jax.Array
        c: jax.Array
        s: jax.Array
        c_prev: jax.Array
        s_prev: jax.Array
        phi_bar: jax.Array
        active: jax.Array
        iters: jax.Array

    init = _S(
        k=jnp.zeros((), jnp.int32),
        x=jnp.zeros_like(b),
        v=b / safe_beta1[:, None],
        v_prev=jnp.zeros_like(b),
        beta=jnp.zeros((B,), dtype),
        d=jnp.zeros_like(b),
        d_prev=jnp.zeros_like(b),
        c=jnp.ones((B,), dtype),
        s=jnp.zeros((B,), dtype),
        c_prev=jnp.ones((B,), dtype),
        s_prev=jnp.zeros((B,), dtype),
        phi_bar=beta1,
        active=nonzero & (beta1 >= tol),
        iters=jnp.zeros((B,), jnp.int32),
    )

    def cond(st):
        return jnp.any(st.active) & (st.k < max_inner)

    def body(st):
        w = matvec(st.v) - st.beta[:, None] * st.v_prev
        alpha = jnp.sum(st.v * w, axis=-1)
        w = w - alpha[:, None] * st.v
        beta_next = _norm(w)
        safe_bn = jnp.where(beta_next > 0, beta_next, 1.0)
        v_next = w / safe_bn[:, None]

        eps = st.s_prev * st.beta
        delta = st.c_prev * st.beta
        delta2 = st.c * delta + st.s * alpha
        gamma_t = -st.s * delta + st.c * alpha

        gamma = jnp.sqrt(gamma_t**2 + beta_next**2)
        safe_gamma = jnp.where(gamma > 0, gamma, 1.0)
        c_new = jnp.where(gamma > 0, gamma_t / safe_gamma, 1.0)
        s_new = jnp.where(gamma > 0, beta_next / safe_gamma, 0.0)

        tau = c_new * st.phi_bar
        phi_bar_new = -s_new * st.phi_bar

        d_new = (
            st.v - delta2[:, None] * st.d - eps[:, None] * st.d_prev
        ) / safe_gamma[:, None]
        x_new = st.x + tau[:, None] * d_new

        m = st.active[:, None]
        still = st.active & (jnp.abs(phi_bar_new) >= tol) & (gamma > 0)
        return _S(
            k=st.k + 1,
            x=jnp.where(m, x_new, st.x),
            v=jnp.where(m, v_next, st.v),
            v_prev=jnp.where(m, st.v, st.v_prev),
            beta=jnp.where(st.active, beta_next, st.beta),
            d=jnp.where(m, d_new, st.d),
            d_prev=jnp.where(m, st.d, st.d_prev),
            c=jnp.where(st.active, c_new, st.c),
            s=jnp.where(st.active, s_new, st.s),
            c_prev=jnp.where(st.active, st.c, st.c_prev),
            s_prev=jnp.where(st.active, st.s, st.s_prev),
            phi_bar=jnp.where(st.active, phi_bar_new, st.phi_bar),
            active=still,
            iters=st.iters + st.active.astype(jnp.int32),
        )

    final = lax.while_loop(cond, body, init)
    return final.x, final.iters


def _cg_cycle(matvec, b, tol, max_inner, M=None):
    """One (preconditioned) CG cycle from zero, batched."""
    B, n = b.shape
    M = M if M is not None else (lambda v: v)

    class _S(NamedTuple):
        k: jax.Array
        x: jax.Array
        r: jax.Array
        z: jax.Array
        p: jax.Array
        rz: jax.Array
        active: jax.Array
        iters: jax.Array

    z0 = M(b)
    init = _S(
        k=jnp.zeros((), jnp.int32),
        x=jnp.zeros_like(b),
        r=b,
        z=z0,
        p=z0,
        rz=jnp.sum(b * z0, axis=-1),
        active=_norm(b) >= tol,
        iters=jnp.zeros((B,), jnp.int32),
    )

    def cond(st):
        return jnp.any(st.active) & (st.k < max_inner)

    def body(st):
        Ap = matvec(st.p)
        pAp = jnp.sum(st.p * Ap, axis=-1)
        safe = jnp.where(pAp > 0, pAp, 1.0)
        alpha = jnp.where(pAp > 0, st.rz / safe, 0.0)
        x_new = st.x + alpha[:, None] * st.p
        r_new = st.r - alpha[:, None] * Ap
        z_new = M(r_new)
        rz_new = jnp.sum(r_new * z_new, axis=-1)
        safe_rz = jnp.where(st.rz != 0, st.rz, 1.0)
        beta = rz_new / safe_rz
        p_new = z_new + beta[:, None] * st.p

        m = st.active[:, None]
        still = st.active & (_norm(r_new) >= tol) & (pAp > 0)
        return _S(
            k=st.k + 1,
            x=jnp.where(m, x_new, st.x),
            r=jnp.where(m, r_new, st.r),
            z=jnp.where(m, z_new, st.z),
            p=jnp.where(m, p_new, st.p),
            rz=jnp.where(st.active, rz_new, st.rz),
            active=still,
            iters=st.iters + st.active.astype(jnp.int32),
        )

    final = lax.while_loop(cond, body, init)
    return final.x, final.iters


# --------------------------------------------------------------------------
# Outer refinement loop (shared by both methods).
# --------------------------------------------------------------------------


def _refined_solve(cycle_fn, matvec, b, tol, maxiter, cycle, stall_ratio,
                   inner_matvec=None, inner_dtype=None):
    """Outer refinement loop. With ``inner_matvec``/``inner_dtype`` set,
    runs MIXED-PRECISION iterative refinement: inner Krylov cycles use
    the (cheap, low-precision) inner operator on the downcast residual,
    while the outer loop recomputes the TRUE residual r = b - A x with
    the full-precision ``matvec`` and accumulates x in b.dtype. Each
    cycle contracts the residual by roughly the inner solve's relative
    accuracy, so a handful of f32 cycles reach f64-level residuals
    with most matvecs at f32."""
    b = jnp.atleast_2d(b)
    B, n = b.shape
    if maxiter is None:
        maxiter = n

    class _S(NamedTuple):
        x: jax.Array
        r: jax.Array
        rnorm: jax.Array
        total: jax.Array  # (B,) iterations
        active: jax.Array

    r0n = _norm(b)
    init = _S(
        x=jnp.zeros_like(b),
        r=b,
        rnorm=r0n,
        total=jnp.zeros((B,), jnp.int32),
        active=r0n >= tol,
    )

    def cond(st):
        return jnp.any(st.active)

    def body(st):
        # Zero out RHS of inactive rows so the cycle skips them.
        budget = maxiter - jnp.max(jnp.where(st.active, st.total, 0))
        max_inner = jnp.minimum(cycle, jnp.maximum(budget, 1))
        rhs = jnp.where(st.active[:, None], st.r, 0.0)
        if inner_matvec is not None:
            # scale the residual block to O(1) before downcasting so
            # tiny late-refinement residuals survive the cast
            scale = jnp.max(jnp.abs(rhs))
            safe_scale = jnp.where(scale > 0, scale, 1.0)
            rhs_lo = (rhs / safe_scale).astype(inner_dtype)
            # stop inner rows near the inner dtype's floor
            inner_tol = (
                jnp.asarray(1e-7, dtype=inner_dtype)
                * jnp.max(_norm(rhs_lo))
            )
            dx_lo, iters = cycle_fn(
                inner_matvec, rhs_lo, inner_tol, max_inner
            )
            dx = dx_lo.astype(b.dtype) * safe_scale
        else:
            dx, iters = cycle_fn(matvec, rhs, tol, max_inner)
        x_new = st.x + dx
        r_new = b - matvec(x_new)
        rn_new = _norm(r_new)

        better = rn_new < st.rnorm
        x_keep = jnp.where(better[:, None], x_new, st.x)
        r_keep = jnp.where(better[:, None], r_new, st.r)
        rn_keep = jnp.where(better, rn_new, st.rnorm)

        total = st.total + iters
        # Stop rows that: converged, stalled (cycle failed to cut the
        # residual by stall_ratio => at the fp accuracy floor), or
        # exhausted the iteration budget.
        progressing = rn_new < stall_ratio * st.rnorm
        active = (
            st.active
            & (rn_keep >= tol)
            & progressing
            & (total < maxiter)
        )
        return _S(
            x=x_keep, r=r_keep, rnorm=rn_keep, total=total, active=active
        )

    final = lax.while_loop(cond, body, init)
    err = final.rnorm
    return SolveResult(
        x=final.x,
        iterations=final.total,
        error=err,
        converged=err < tol,
    )


def batched_minres(
    matvec: Callable,
    b: jax.Array,
    tol: float = 1e-4,
    maxiter: Optional[int] = None,
    cycle: int = 100,
    stall_ratio: float = 0.99,
    inner_matvec: Optional[Callable] = None,
    inner_dtype=None,
) -> SolveResult:
    """Solve A x = b for symmetric A, batched over the leading axis of
    ``b`` (B, n); ``matvec`` maps (B, n) -> (B, n). ``tol`` is an
    absolute residual 2-norm (reference semantics,
    runlmc/approx/iterative.py:36-42). ``inner_matvec``/``inner_dtype``
    enable mixed-precision refinement (see _refined_solve)."""
    return _refined_solve(
        _minres_cycle, matvec, b, tol, maxiter, cycle, stall_ratio,
        inner_matvec=inner_matvec, inner_dtype=inner_dtype,
    )


def batched_cg(
    matvec: Callable,
    b: jax.Array,
    tol: float = 1e-4,
    maxiter: Optional[int] = None,
    precond: Optional[Callable] = None,
    cycle: int = 100,
    stall_ratio: float = 0.99,
    inner_matvec: Optional[Callable] = None,
    inner_dtype=None,
) -> SolveResult:
    """Conjugate gradients for SPD A, batched; optional SPD
    preconditioner (the reference exposes a never-used
    ``K.preconditioner`` hook, runlmc/approx/iterative.py:47)."""

    def cycle_fn(mv, rhs, tol_, max_inner):
        return _cg_cycle(mv, rhs, tol_, max_inner, M=precond)

    return _refined_solve(
        cycle_fn, matvec, b, tol, maxiter, cycle, stall_ratio,
        inner_matvec=inner_matvec, inner_dtype=inner_dtype,
    )


def solve(
    matvec: Callable,
    b: jax.Array,
    method: str = "minres",
    tol: float = 1e-4,
    maxiter: Optional[int] = None,
) -> SolveResult:
    """Dispatching front-end mirroring ``Iterative.solve`` (reference
    runlmc/approx/iterative.py:24): ``method`` in {'minres', 'cg'}.
    Accepts b of shape (n,) or (B, n); always returns batched results."""
    if method == "minres":
        return batched_minres(matvec, b, tol=tol, maxiter=maxiter)
    if method == "cg":
        return batched_cg(matvec, b, tol=tol, maxiter=maxiter)
    raise ValueError("unknown method %r" % (method,))
