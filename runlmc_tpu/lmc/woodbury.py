"""On-device direct Woodbury factorization of the SKI covariance
(dense grid mode) — the replacement for the reference's per-step pool of
MINRES solves (runlmc/lmc/stochastic_deriv.py:39-52) and its pooled
prediction solves (runlmc/models/interpolated_llgp.py:358-397).

With the grid kernel materialized (grid.py 'dense' mode), write

    K = sum_g W_g K_UU_g W_g^T + diag(eps)  =  V V^T + D,
    V = [ W_g F_g ]_g,   F_g = chol(K_UU_g + delta_g I)  (Dm_g x Dm_g),

and Woodbury gives a closed-form inverse and determinant:

    K^-1 = D^-1 - D^-1 V C^-1 V^T D^-1,   C = I + V^T D^-1 V,
    log det K = log det C + sum_i log D_ii.

Everything here runs under jit ON DEVICE — build, solve, logdet. The
factorization is float-dtype-generic; the training step builds it in
float32 every optimizer step and certifies the reference's 1e-4
residual tolerance by running a handful of float64 PCG iterations with
the f32 factor as preconditioner (:func:`woodbury_pcg`). No (Dm, Dm)
or (n, n) matrix crosses to the host.

Numerical notes:
- Cholesky jitter escalates through fixed scales (jit-compatible: all
  candidates are computed, the first finite one wins). The jitter
  perturbs the PRECONDITIONER only — the refinement loop measures true
  residuals against the exact operator.
- C has eigenvalues >= 1 but condition ~ lambda_max(K_UU)/eps; at very
  small learned noise the f32 C assembly can lose definiteness, which
  the escalation absorbs at some preconditioner-quality cost. PCG then
  stalls at its precision floor and keeps the best iterate (mirroring
  the reference's logged-but-tolerated MINRES non-convergence,
  runlmc/approx/iterative.py:54-58).
- W_g applications use the per-output dense interpolation blocks (dense
  matmuls); the per-output grams W_d^T W_d feeding C are precomputed
  host-side at model build (parameter-independent).
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from runlmc_tpu.ops.solvers import batched_cg

_HI = jax.lax.Precision.HIGHEST


# Default for chol_jittered's Jacobi equilibration (module-level so
# experiments/benchmarks can A/B it without threading a parameter
# through every call site).
EQUILIBRATE_DEFAULT = True


def chol_jittered(A, scales=(1e-6, 1e-4, 1e-2), equilibrate=None):
    """Cholesky of ``A + delta*diag-scale`` with escalating jitter,
    jit-safe AND autodiff-safe, with Jacobi equilibration.

    ``equilibrate=True`` factorizes the Jacobi-scaled matrix
    S A S (S = diag(A)^-1/2) and returns the de-scaled factor
    S^-1 chol(S A S) — still lower-triangular, a drop-in factor of A.
    Equilibration is what keeps the FLOAT32 factorization alive on
    GRADED matrices: mid-training LMC transients put coregionalization
    amplitudes (and hence capacitance rows) decades apart, and the f32
    Cholesky of the raw matrix degrades to a useless preconditioner at
    a conditioning the scaled matrix handles easily (weather's
    mid-training solve collapses, residual ~ ||y||, round 3). The
    jitter is then relative to the UNIT diagonal of the scaled matrix,
    i.e. per-row-proportional on A rather than uniform — larger rows
    absorb proportionally larger jitter, which is exactly the right
    perturbation for graded matrices.

    The scale search runs on a gradient-stopped copy inside a
    ``lax.while_loop`` that stops at the FIRST scale whose factor is
    finite (XLA's cholesky yields NaNs rather than raising on an
    indefinite input) — in the overwhelmingly common case where the
    smallest scale succeeds, the search costs one probe factorization,
    not one per scale. The returned factor is then ONE differentiable
    cholesky at the chosen scale — selecting between candidate factors
    with ``jnp.where`` would leak NaN cotangents from the failed
    candidates' cholesky VJPs (the exact-objective training path
    differentiates through this)."""
    if equilibrate is None:
        equilibrate = EQUILIBRATE_DEFAULT
    eye = jnp.eye(A.shape[0], dtype=A.dtype)
    if equilibrate:
        d0 = jnp.diagonal(A)
        tiny = jnp.asarray(1e-30, dtype=A.dtype)
        s = jax.lax.rsqrt(jnp.maximum(jnp.abs(d0), tiny))
        A = A * s[:, None] * s[None, :]
        d = jnp.asarray(1.0, dtype=A.dtype)
    else:
        s = None
        d = jnp.abs(jnp.mean(jnp.diagonal(A)))
    A_ng = jax.lax.stop_gradient(A)
    d_ng = jax.lax.stop_gradient(d)
    scales_arr = jnp.asarray(np.asarray(scales), dtype=A.dtype)
    # XLA's blocked cholesky may run internal matmuls at the DEFAULT
    # matmul precision — TF32 for f32 on GPUs, ~1e-3 relative — which
    # would floor the factorization error far above the learned noise
    # (~1e-3 on fx2007). Force full-precision multiplies.
    with jax.default_matmul_precision("highest"):

        def _ok(i):
            cand = jnp.linalg.cholesky(
                A_ng + (scales_arr[i] * d_ng) * eye
            )
            return jnp.all(jnp.isfinite(cand))

        idx = jax.lax.while_loop(
            lambda i: (i < len(scales) - 1) & ~_ok(i),
            lambda i: i + 1,
            jnp.zeros((), jnp.int32),
        )
        L = jnp.linalg.cholesky(A + (scales_arr[idx] * d) * eye)
    if equilibrate:
        L = L / s[:, None]
    return L


class DeviceWoodbury(NamedTuple):
    """Factorized SKI covariance; a pytree of device arrays — pass it
    through jit boundaries as an argument."""

    Fs: Tuple  # per-group (Dm_g, Dm_g) lower Cholesky of K_UU_g
    L_C: jax.Array  # (k, k) lower Cholesky of C, k = sum_g Dm_g
    noise_n: jax.Array  # (n,) per-data-point noise
    W_blocks: Tuple  # per-group tuple of per-output (n_d, m_g) blocks
    logdet: jax.Array  # device scalar: log det of the factorized K

    @property
    def dtype(self):
        return self.L_C.dtype

    def _wt(self, g, x):
        """W_g^T x: (..., n) -> (..., Dm_g)."""
        blocks = self.W_blocks[g]
        off, parts = 0, []
        for b in blocks:
            xd = jax.lax.slice_in_dim(x, off, off + b.shape[0], axis=-1)
            parts.append(jnp.einsum("nm,...n->...m", b, xd, precision=_HI))
            off += b.shape[0]
        return jnp.concatenate(parts, axis=-1)

    def _w(self, g, u):
        """W_g u: (..., Dm_g) -> (..., n)."""
        blocks = self.W_blocks[g]
        m = blocks[0].shape[1]
        return jnp.concatenate(
            [
                jnp.einsum(
                    "nm,...m->...n", b, u[..., d * m : (d + 1) * m],
                    precision=_HI,
                )
                for d, b in enumerate(blocks)
            ],
            axis=-1,
        )

    def _vt(self, x):
        """V^T x: (..., n) -> (..., k)."""
        parts = [
            jnp.einsum("ik,...i->...k", f, self._wt(g, x), precision=_HI)
            for g, f in enumerate(self.Fs)
        ]
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, -1)

    def _v(self, t):
        """V t: (..., k) -> (..., n)."""
        out, off = 0.0, 0
        for g, f in enumerate(self.Fs):
            kg = f.shape[1]
            tg = t[..., off : off + kg]
            out = out + self._w(
                g, jnp.einsum("ik,...k->...i", f, tg, precision=_HI)
            )
            off += kg
        return out

    def _cho_solve_C(self, s):
        """C^-1 s for s (..., k). Triangular solves may be blocked
        matmuls — force full-precision multiplies (see
        chol_jittered)."""
        flat = s.reshape(-1, s.shape[-1])
        with jax.default_matmul_precision("highest"):
            sol = jax.scipy.linalg.cho_solve(
                (self.L_C, True), flat.T
            ).T
        return sol.reshape(s.shape)

    def solve(self, rhs):
        """K^-1 rhs for rhs (..., n): closed form, no iteration."""
        r = rhs / self.noise_n
        t = self._cho_solve_C(self._vt(r))
        return r - self._v(t) / self.noise_n

    def matvec(self, x):
        """K x (the factorized operator, for residual checks)."""
        return self._v(self._vt(x)) + self.noise_n * x


def build_device_woodbury(
    groups, noise_eps, noise_n, wtw, jitter=(1e-6, 1e-4, 1e-2, 1e-1),
    c_jitter=(0.0, 1e-6, 1e-3, 1e-1), equilibrate=None,
):
    """Factor the SKI covariance entirely on device (jittable).

    The DEFAULT jitter ladders extend to 1e-1 relative: at
    conditioning that defeats f32 even at 1e-2/1e-3 jitter (weather
    late in training), a heavily-jittered factor is a crude but FINITE
    preconditioner — outer PCG refinement against the exact operator
    still contracts, where a NaN factor would force the identity
    fallback and stall. Callers factorizing for an OBJECTIVE (where
    jitter perturbs the model being trained, exact_ski_mll) pass their
    own tighter ladders.

    :param groups: dense-mode ``GroupState`` tuple (``KUU_dense`` and
        ``W_blocks`` set — grid.py).
    :param noise_eps: (D,) constrained per-output noise.
    :param noise_n: (n,) per-data-point noise.
    :param wtw: per-group (D, m_g, m_g) stacked per-output interpolation
        grams W_d^T W_d (``GridData.WtW``, host-precomputed).
    :param jitter: escalating relative jitter scales for the K_UU
        Cholesky factors (see :func:`chol_jittered`).
    :param c_jitter: same for the capacitance matrix C.
    :param equilibrate: Jacobi-equilibration mode for both Cholesky
        factorizations (see :func:`chol_jittered`); ``None`` defers to
        ``EQUILIBRATE_DEFAULT``. Equilibration is what keeps f32 alive
        on GRADED matrices (weather mid-training), but on
        well-balanced matrices the de-scaling round-trip can cost a
        fraction of a digit — synth run 1's trajectory measures worst
        relative residual 0.35 equilibrated while the raw probe
        certifies at 0.081 at the same parameters — so the
        in-training escalation ladder probes the FLIPPED mode before
        abandoning the exact objective. The raw mode is also more
        FRAGILE: compiled inside a scanned chunk, the raw f32
        Cholesky at that scale can degrade where the eager probe
        succeeds (fusion/layout numerics on the conditioning cliff),
        which is why equilibration stays the default and the flip is
        only a rescue rung.
    """
    for g in groups:
        if g.KUU_dense is None or g.W_blocks is None:
            raise ValueError(
                "device Woodbury factorization requires dense grid mode"
            )
    dtype = noise_n.dtype
    Fs = tuple(
        chol_jittered(g.KUU_dense, scales=jitter, equilibrate=equilibrate)
        for g in groups
    )
    inv_eps = (1.0 / noise_eps).astype(dtype)

    def diag_block(F, G):
        # C_gg = sum_d eps_d^-1 F[d-rows]^T (W_d^T W_d) F[d-rows]
        D = G.shape[0]
        m = G.shape[1]
        Fd = F.reshape(D, m, F.shape[1])
        T1 = jnp.einsum("dij,djk->dik", G, Fd, precision=_HI)
        return jnp.einsum(
            "d,dik,dil->kl", inv_eps, Fd, T1, precision=_HI
        )

    def cross_block(ga, gb, Fa, Fb):
        # C_ab = sum_d eps_d^-1 Fa[d-rows]^T (W_ad^T W_bd) Fb[d-rows]
        ma = groups[ga].W_blocks[0].shape[1]
        mb = groups[gb].W_blocks[0].shape[1]
        out = 0.0
        for d, (wa, wb) in enumerate(
            zip(groups[ga].W_blocks, groups[gb].W_blocks)
        ):
            G_ab = jnp.einsum("ni,nj->ij", wa, wb, precision=_HI)
            Fad = Fa[d * ma : (d + 1) * ma]
            Fbd = Fb[d * mb : (d + 1) * mb]
            out = out + inv_eps[d] * jnp.einsum(
                "ik,ij,jl->kl", Fad, G_ab, Fbd, precision=_HI
            )
        return out

    nblocks = len(groups)
    if nblocks == 1:
        C = diag_block(Fs[0], wtw[0])
    else:
        rows = [[None] * nblocks for _ in range(nblocks)]
        for a in range(nblocks):
            rows[a][a] = diag_block(Fs[a], wtw[a])
            for b in range(a + 1, nblocks):
                rows[a][b] = cross_block(a, b, Fs[a], Fs[b])
        for a in range(nblocks):
            for b in range(a):
                rows[a][b] = rows[b][a].T
        C = jnp.block(rows)
    C = C + jnp.eye(C.shape[0], dtype=dtype)
    L_C = chol_jittered(C, scales=c_jitter, equilibrate=equilibrate)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_C))) + jnp.sum(
        jnp.log(noise_n)
    )
    return DeviceWoodbury(
        Fs=Fs,
        L_C=L_C,
        noise_n=noise_n,
        W_blocks=tuple(g.W_blocks for g in groups),
        logdet=logdet,
    )


def kinv_diag(wb: DeviceWoodbury):
    """diag(K^-1) from the Woodbury factorization:
    [K^-1]_ii = 1/d_i - ||L_C^-1 V_i||^2 / d_i^2 with V = [W_g F_g]_g.
    Materializes V (n, k) once — fine at benchmark scales (n * k a few
    tens of millions)."""
    parts = []
    for g, F in enumerate(wb.Fs):
        blocks = wb.W_blocks[g]
        m = blocks[0].shape[1]
        Vg = jnp.concatenate(
            [
                jnp.einsum(
                    "nm,mk->nk", b, F[d * m : (d + 1) * m], precision=_HI
                )
                for d, b in enumerate(blocks)
            ],
            axis=0,
        )  # (n, k_g), rows in global data order
        parts.append(Vg)
    V = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)
    with jax.default_matmul_precision("highest"):
        T = jax.scipy.linalg.solve_triangular(wb.L_C, V.T, lower=True)
    s = jnp.sum(T * T, axis=0)
    d = wb.noise_n
    return 1.0 / d - s / (d * d)


def loo_zsq(wb: DeviceWoodbury, y):
    """Mean squared leave-one-out standardized residual of the
    factorized GP (Sundararajan & Keerthi 2001 / GPML eqs. 5.10-5.12):

        mu_loo,i  = y_i - alpha_i / [K^-1]_ii,
        var_loo,i = 1 / [K^-1]_ii,
        z_i       = (y_i - mu_loo,i) / sqrt(var_loo,i)
                  = alpha_i / sqrt([K^-1]_ii).

    For a well-calibrated model E[z^2] ~= 1; a model that drove its
    predictive variances overconfidently small shows mean z^2 >> 1.
    This is the platform-independent statistic behind the 'auto'
    objective's overconfidence guard (the measured weather failure:
    the deterministic exact objective optimizes the MLL onto an
    optimum whose held-out NLPD is 21 vs the stochastic path's 1.4 —
    visible in-sample as exploding LOO z^2, no held-out data needed).
    """
    alpha = wb.solve(y)
    tiny = jnp.asarray(jnp.finfo(y.dtype).tiny, y.dtype)
    diag = jnp.maximum(kinv_diag(wb), tiny)
    return jnp.mean(alpha * alpha / diag)


def woodbury_precond(wb: DeviceWoodbury):
    """An ``M^-1``-apply for :func:`runlmc_tpu.ops.solvers.batched_cg`:
    scales each residual ROW to O(1) (rows converge at different rates;
    a global scale would crush nearly-converged rows into float32
    denormals), applies the factor in its own (low) precision, and
    casts back.

    Rows whose factor-apply comes back non-finite (a degenerate f32
    factorization — conditioning past what even escalated jitter can
    absorb) fall back to the IDENTITY preconditioner: CG then degrades
    to slow-but-sound unpreconditioned iterations instead of being
    poisoned by NaNs into returning x=0 with zero gradient."""

    def apply(r):
        scale = jnp.max(jnp.abs(r), axis=-1, keepdims=True)
        safe = jnp.where(scale > 0, scale, 1.0)
        out = wb.solve((r / safe).astype(wb.dtype)).astype(r.dtype)
        ok = jnp.all(jnp.isfinite(out), axis=-1, keepdims=True)
        return jnp.where(ok, out * safe, r)

    return apply


def woodbury_pcg(matvec, wb: DeviceWoodbury, b, tol, maxiter=None,
                 cycle=10, inner_matvec=None, stall_ratio=0.99):
    """Solve ``K x = b`` (batched over leading axis) by CG
    preconditioned with a (typically float32) direct Woodbury factor.
    With the factor near-exact this converges in a handful of
    iterations; the outer refinement cycles (every ``cycle``
    iterations) recompute true residuals and keep the best iterate
    (ops/solvers.py).

    ``inner_matvec``: optional operator apply AT THE FACTOR'S dtype.
    When given, the CG cycles run entirely in that (f32) precision on
    the downcast residual and only the outer true-residual
    recomputation pays a ``b``-dtype matvec — one per cycle instead of
    one per iteration, while outer refinement still drives the TRUE
    residual to ``tol``.
    """
    if inner_matvec is not None and b.dtype != wb.dtype:
        return batched_cg(
            matvec, b, tol=tol, maxiter=maxiter,
            precond=woodbury_precond(wb), cycle=cycle,
            inner_matvec=inner_matvec, inner_dtype=wb.dtype,
            stall_ratio=stall_ratio,
        )
    return batched_cg(
        matvec, b, tol=tol, maxiter=maxiter, precond=woodbury_precond(wb),
        cycle=cycle, stall_ratio=stall_ratio,
    )
