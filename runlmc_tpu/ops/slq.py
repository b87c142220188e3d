"""Stochastic Lanczos quadrature (SLQ) log-determinant estimation.

For an SPD operator K available only through matvecs,

    log det K = tr(log K) ~= (n / N) sum_i  e1^T log(T_i) e1 * ||z_i||^2/n

where T_i is the k-step Lanczos tridiagonalization of K started from a
Rademacher probe z_i (Ubaru, Chen & Saad 2017). This is the fast logdet
for FFT-mode grids, where no direct factorization exists — the
reference lists Lanczos logdet as roadmap work (reference README.md:86)
and falls back to an O(n^3) dense Cholesky for reporting
(runlmc/models/interpolated_llgp.py:262-276).

Structure: ALL probes run one fused batched Lanczos
recurrence (one batched matvec per iteration — the same fusion as the
batched Krylov solvers in ops/solvers.py), the tiny (k, k) tridiagonal
eigenproblems are batched on device, and the whole estimator jits.

This is an ESTIMATE: stochastic error ~ O(1/sqrt(N)) relative to
tr(log K)'s probe variance, plus Lanczos quadrature error that decays
geometrically in k for well-conditioned K. Use the Woodbury logdet
(lmc/woodbury.py) when a dense-mode factorization is available.
"""

import jax
import jax.numpy as jnp
from jax import lax


def lanczos_tridiag(matvec, v0, k):
    """k-step Lanczos, batched over the leading axis of ``v0`` (B, n),
    rows assumed unit-norm. Returns (alphas (B, k), betas (B, k-1)).
    After an invariant-subspace breakdown (beta ~ 0), remaining alphas
    are set to 1 and betas to 0: the trailing identity block's
    eigenvectors have zero first component, so quadrature weights for
    the spurious directions vanish exactly."""
    B = v0.shape[0]
    dtype = v0.dtype
    eps = jnp.asarray(1e-8 if dtype == jnp.float32 else 1e-14, dtype)

    def body(carry, _):
        v_prev, v, beta, alive = carry
        w = matvec(v) - beta[:, None] * v_prev
        alpha = jnp.sum(w * v, axis=-1)
        w = w - alpha[:, None] * v
        beta_n = jnp.sqrt(jnp.sum(w * w, axis=-1))
        alive_n = alive & (beta_n > eps)
        safe = jnp.where(beta_n > 0, beta_n, 1.0)
        v_next = jnp.where(alive_n[:, None], w / safe[:, None], 0.0)
        alpha_out = jnp.where(alive, alpha, 1.0)
        beta_out = jnp.where(alive_n, beta_n, 0.0)
        return (v, v_next, beta_out, alive_n), (alpha_out, beta_out)

    init = (
        jnp.zeros_like(v0),
        v0,
        jnp.zeros((B,), dtype),
        jnp.ones((B,), bool),
    )
    _, (alphas, betas) = lax.scan(body, init, None, length=k)
    return alphas.T, betas[:-1].T  # (B, k), (B, k-1)


def _slq_impl(matvec, n, key, n_probes, k, dtype):
    z = (
        jax.random.bernoulli(key, 0.5, (n_probes, n)).astype(dtype) * 2.0
        - 1.0
    )
    v0 = z / jnp.sqrt(jnp.asarray(n, dtype))
    alphas, betas = lanczos_tridiag(matvec, v0, k)
    T = (
        jax.vmap(jnp.diag)(alphas)
        + jax.vmap(lambda b: jnp.diag(b, 1))(betas)
        + jax.vmap(lambda b: jnp.diag(b, -1))(betas)
    )
    lam, U = jnp.linalg.eigh(T)  # (B, k), (B, k, k)
    tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)
    log_lam = jnp.log(jnp.maximum(lam, tiny))
    tau2 = U[:, 0, :] ** 2  # first-row components squared
    per_probe = jnp.sum(tau2 * log_lam, axis=-1)  # e1^T log(T) e1
    return n * jnp.mean(per_probe)


def slq_logdet(matvec, n, key, n_probes=15, k=40, dtype=jnp.float64):
    """Estimate ``log det K`` for the SPD operator ``matvec`` of size
    ``n`` using ``n_probes`` Rademacher probes and ``k`` Lanczos steps.
    ``matvec`` must map (B, n) -> (B, n) (batched). Jittable — wrap the
    call site in ``jax.jit`` (the model does).

    Defaults are CALIBRATED against dense logdets of SKI LMC operators
    across conditioning 6.6e2 .. 6.5e6 (tests/test_slq.py::
    test_slq_accuracy_sweep; CPU f64, n=180, 5 seeds): with k=40 and 15
    probes the relative error band is 0.3-0.6% (max observed 0.6%)
    at every conditioning level. Quadrature error is negligible past
    k ~ 20 (k=10 degrades to ~4% at cond 1e6+, k=80 matches k=40 to 4
    decimals); the residual error is probe variance, shrinking as
    1/sqrt(n_probes) (45 probes: ~0.36% mean)."""
    return _slq_impl(matvec, n, key, n_probes, k, dtype)
