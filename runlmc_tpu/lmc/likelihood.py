"""LMC likelihoods: exact dense path + stochastic matrix-free gradients.

The reference hand-derives dK/dtheta per hyperparameter and loops over
O(Q D (r+1) + sum_q p_q + D) derivative operators
(runlmc/lmc/likelihood.py:20-134, exact_deriv.py, stochastic_deriv.py).
Here both paths are *autodiff*:

- **Exact** (oracle / small n / reported log-likelihood): materialize the
  dense LMC kernel, Cholesky-factor it, and let JAX differentiate the
  closed-form MLL. One ``jax.value_and_grad`` replaces the reference's
  entire gradient-assembly machinery.

- **Stochastic matrix-free** (the training hot path): gradients of the
  MLL are

      dLL/dt = 1/2 (alpha^T dK/dt alpha - tr(K^-1 dK/dt)),
      alpha = K^-1 y,

  with the trace estimated by Hutchinson probes r_i ~ Rademacher:
  tr(K^-1 dK/dt) ~= mean_i (K^-1 r_i)^T dK/dt r_i (Cutajar 2016; parity:
  runlmc/lmc/stochastic_deriv.py:69-78). We build a *surrogate scalar*

      s(theta) = 1/2 alpha_d^T K(theta) alpha_d
                 - 1/(2 N) sum_i z_i^T K(theta) r_i,

  where alpha_d = stopgrad(K^-1 y) and z_i = stopgrad(K^-1 r_i) come from
  ONE batched multi-RHS solve. Then grad(s) is exactly the stochastic
  MLL gradient estimate — for every hyperparameter at once, via autodiff
  through the fused Fourier-space matvec. The 1 + N solves that the
  reference scatters over a process pool (stochastic_deriv.py:39-52)
  become one batched (and mesh-shardable) Krylov solve.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from runlmc_tpu.lmc.grid import build_kski
from runlmc_tpu.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu.lmc.woodbury import build_device_woodbury, woodbury_pcg
from runlmc_tpu.ops.solvers import batched_cg, batched_minres


# --------------------------------------------------------------------------
# Data flattening (host-side)
# --------------------------------------------------------------------------


class FlatData(NamedTuple):
    """Stacked multi-output data: the reference keeps ragged per-output
    lists (multigp.py); fixed shapes want one concatenated design."""

    X: np.ndarray  # (n, P)
    y: np.ndarray  # (n,)
    lens: tuple  # per-output lengths (static)
    output_idx: np.ndarray  # (n,) int32, which output each row belongs to


def flatten_data(Xs, Ys):
    Xs = [np.asarray(X, dtype=float) for X in Xs]
    Xs = [X.reshape(-1, 1) if X.ndim == 1 else X for X in Xs]
    lens = tuple(len(X) for X in Xs)
    X = np.concatenate(Xs, axis=0) if Xs else np.zeros((0, 1))
    y = np.concatenate([np.asarray(Y, dtype=float) for Y in Ys])
    oidx = np.repeat(np.arange(len(Xs), dtype=np.int32), lens)
    return FlatData(X=X, y=y, lens=lens, output_idx=oidx)


# --------------------------------------------------------------------------
# Exact dense path
# --------------------------------------------------------------------------


def pairwise_dists(Xa, Xb, dims):
    """Euclidean distances between rows of Xa, Xb restricted to ``dims``
    (parity: ExactLMCLikelihood._gen_dists, likelihood.py:170-177)."""
    a = Xa[:, list(dims)]
    b = Xb[:, list(dims)]
    d2 = jnp.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    return jnp.sqrt(jnp.maximum(d2, 0.0))


def cross_kernel(spec: LMCKernelSpec, raw_params, Xa, oidx_a, Xb, oidx_b):
    """Dense LMC cross-covariance K[a, b] (no noise) — parity:
    ExactLMCLikelihood.kernel_from_indices (likelihood.py:179-200)."""
    K = 0.0
    for active_dim, kidxs in spec.active_dims.items():
        dists = pairwise_dists(Xa, Xb, active_dim)
        for q in kidxs:
            a = spec.coreg_vec(raw_params, q)
            aa = jnp.matmul(a.T, a, precision=jax.lax.Precision.HIGHEST)
            Bq = aa + jnp.diag(spec.coreg_diag(raw_params, q))
            scale = Bq[oidx_a][:, oidx_b]  # (na, nb) block scaling
            K = K + scale * spec.eval_kernel(raw_params, q, dists)
    return K


def exact_dense_K(spec: LMCKernelSpec, raw_params, X, oidx):
    """Full dense LMC kernel with noise (parity: ExactLMCLikelihood
    construction, likelihood.py:137-151)."""
    K = cross_kernel(spec, raw_params, X, oidx, X, oidx)
    noise = spec.noise(raw_params)[oidx]
    return K + jnp.diag(noise)


def exact_mll(spec: LMCKernelSpec, raw_params, X, oidx, y):
    """Exact marginal log-likelihood
    -1/2 (y^T K^-1 y + log det K + n log 2 pi); autodiff it for the
    oracle gradient path (replaces ExactDeriv, exact_deriv.py:9-23)."""
    K = exact_dense_K(spec, raw_params, X, oidx)
    # XLA's blocked cholesky/trisolve run internal matmuls at default
    # precision (TF32 for f32 on GPUs) — force full-precision multiplies
    with jax.default_matmul_precision("highest"):
        L = jnp.linalg.cholesky(K)
        alpha = jax.scipy.linalg.cho_solve((L, True), y)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    n = y.shape[0]
    return -0.5 * (y @ alpha + logdet + n * jnp.log(2 * jnp.pi))


def exact_chol(spec, raw_params, X, oidx):
    K = exact_dense_K(spec, raw_params, X, oidx)
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.cholesky(K)


# --------------------------------------------------------------------------
# Stochastic matrix-free path
# --------------------------------------------------------------------------


def rademacher_probes(key, n_probes, n, dtype):
    """Fresh +-1 probes per step (parity: stochastic_deriv.py:35)."""
    return (
        jax.random.bernoulli(key, 0.5, (n_probes, n)).astype(dtype) * 2.0
        - 1.0
    )


def sharded_solve(solver_call, rhs, rhs_sharding):
    """Run a batched solver with the RHS batch sharded over a mesh axis.

    Each device runs its own COMPLETE solver loop (Krylov or
    Woodbury-PCG) on its local RHS rows via ``shard_map`` — the rows
    are independent systems of the same operator, so there are no
    collectives inside the loop and per-shard iteration counts diverge
    freely. The operator state (grid symbols / Woodbury factor) is
    closed over and replicated. This is the mesh replacement for the
    reference's ``pool.starmap`` over per-RHS scipy solves
    (runlmc/lmc/stochastic_deriv.py:51-52). The batch is zero-padded up
    to the shard count (a zero row converges instantly) and sliced
    back.

    ``rhs_sharding=None`` runs the solver unsharded (single device).
    On a multi-axis mesh (e.g. ('probe', 'grid')), the grid-sized axes
    inside the operator carry their own GSPMD constraints
    (grid.GridPlan.grid_shard), which cannot appear inside a shard_map
    body — there the whole solve runs under GSPMD with the RHS batch
    constrained over 'probe' and XLA partitioning the loop.
    """
    if rhs_sharding is None:
        return solver_call(rhs)

    if len(rhs_sharding.mesh.axis_names) > 1:
        rhs = jax.lax.with_sharding_constraint(rhs, rhs_sharding)
        return solver_call(rhs)

    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map

    mesh = rhs_sharding.mesh
    axis = rhs_sharding.spec[0]
    n_shards = mesh.shape[axis]
    B = rhs.shape[0]
    pad = (-B) % n_shards
    if pad:
        rhs = jnp.concatenate(
            [rhs, jnp.zeros((pad, rhs.shape[1]), rhs.dtype)], axis=0
        )

    def local(b):
        res = solver_call(b)
        return res.x, res.iterations, res.error, res.converged

    x, iters, err, conv = shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(P(axis, None), P(axis), P(axis), P(axis)),
        check_vma=False,
    )(rhs)
    from runlmc_tpu.ops.solvers import SolveResult

    return SolveResult(
        x=x[:B], iterations=iters[:B], error=err[:B],
        converged=conv[:B],
    )


class StochasticAux(NamedTuple):
    alpha: jax.Array  # (n,) K^-1 y
    solve_iters: jax.Array  # mean solver iterations (scalar)
    solve_error: jax.Array  # mean reconstruction error (scalar)
    quad: jax.Array  # y^T alpha (normal quadratic, for reporting)


def _shard_data_rows(x, data_shard, axis=-1):
    """Constrain one axis (the data axis, default last) of ``x`` over
    the mesh data-parallel axis."""
    if data_shard is None:
        return x
    from jax.sharding import NamedSharding, PartitionSpec

    mesh, name = data_shard
    dims = [None] * x.ndim
    dims[axis] = name
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, PartitionSpec(*dims))
    )


def exact_ski_mll(
    spec: LMCKernelSpec,
    raw_params,
    grid_data,
    lens,
    y,
    jitter=(1e-6, 1e-4, 1e-2),
    c_jitter=(0.0, 1e-6, 1e-3),
    data_shard=None,
    equilibrate=None,
):
    """EXACT marginal log-likelihood of the dense-grid-mode SKI model,
    differentiated through the on-device Woodbury factorization.

    The model is K~ = sum_g W_g (K_UU_g + delta_g I) W_g^T + diag(eps):
    the direct factorization (woodbury.py) gives its log-determinant and
    quadratic form in closed form, and autodiff through the Cholesky
    factors yields the exact gradient of K~'s MLL — no Hutchinson
    probes, no Krylov iterations, no trace-estimator variance. This
    replaces the entire stochastic machinery the reference needs
    (stochastic_deriv.py:12-78): the reference's CPU cannot afford a
    (Dm)^3 factorization per optimizer step, an accelerator can at
    benchmark grid sizes, so the unbiased-but-noisy estimator is
    unnecessary there. (The stochastic surrogate remains the path for
    fft-mode grids too large to factorize.)

    Returns ``(mll, StochasticAux)`` — aux carries the (detached) alpha,
    a relative residual certifying the factorization's solve quality,
    and solve_iters=0 (direct solve). Differentiate with
    ``jax.grad(..., has_aux=True)``.

    ``data_shard``: optional ``(Mesh, axis_name)`` — shards the data
    axis (the rows of the interpolation blocks, y, and the noise
    vector) over the named mesh axis. The per-output gram contractions
    then partition over data rows with one psum each (the capacitance
    assembly uses the host-precomputed W^T W grams and stays
    replicated, as does the small Cholesky); this is the multi-chip
    data-parallel layout for large n.
    """
    from runlmc_tpu.lmc.grid import build_kski as _build

    if data_shard is not None:
        grid_data = tuple(
            gd.replace(
                W_blocks=tuple(
                    _shard_data_rows(b, data_shard, axis=0)
                    for b in gd.W_blocks
                )
            )
            for gd in grid_data
        )
        y = _shard_data_rows(y, data_shard)
    K = _build(spec, raw_params, grid_data, lens)
    noise_n = _shard_data_rows(K.noise_n, data_shard)
    wb = build_device_woodbury(
        K.groups,
        spec.noise(raw_params),
        noise_n,
        tuple(gd.WtW for gd in grid_data),
        jitter=jitter,
        c_jitter=c_jitter,
        equilibrate=equilibrate,
    )
    hi = jax.lax.Precision.HIGHEST
    alpha = wb.solve(y)
    quad = jnp.einsum("n,n->", y, alpha, precision=hi)
    n = y.shape[0]
    mll = -0.5 * (wb.logdet + quad + n * jnp.log(2 * jnp.pi).astype(y.dtype))

    alpha_d = jax.lax.stop_gradient(alpha)
    resid = jax.lax.stop_gradient(wb.matvec(alpha_d)) - y
    err = jnp.linalg.norm(resid) / jnp.maximum(
        jnp.linalg.norm(y), jnp.asarray(1e-30, y.dtype)
    )
    aux = StochasticAux(
        alpha=alpha_d,
        solve_iters=jnp.zeros((), jnp.float32),
        solve_error=jax.lax.stop_gradient(err),
        quad=jax.lax.stop_gradient(quad),
    )
    return mll, aux


def f32_factorization_residual(spec, raw_params, grid_data32, lens, y,
                               equilibrate=None):
    """Self-consistency residual ||K~ (K~^-1 y) - y|| / ||y|| of the
    FLOAT32 Woodbury factorization at the given parameters — the same
    diagnostic :func:`exact_ski_mll` reports per training step
    (aux.solve_error). The model's ``objective='auto'`` probes this
    once at build time and compares against the calibrated
    EXACT_RESIDUAL_THRESHOLD = 0.25 (tests/test_exact_residual.py):
    problems whose conditioning already defeats the f32 factorization
    at the INITIAL parameters train with the stochastic objective,
    whose model-dtype Krylov solves self-refine; problems that certify
    (fx2007: ~7.6e-6; weather m=500: ~9.5e-4 — weather certifies at
    init and only breaches by ~optimizer step 10, where the
    IN-TRAINING escalation in InterpolatedLLGP.optimize catches it)
    get the deterministic exact objective at f32 speed.

    The probe factorizes with the SAME tight jitter ladders the exact
    objective trains with (exact_ski_mll defaults) — a laxer ladder
    would let a heavily-jittered probe factor under-report the residual
    the training path will actually see at marginal conditioning."""
    params32 = jax.tree.map(
        lambda a: jnp.asarray(a, dtype=jnp.float32), raw_params
    )
    K32 = build_kski(spec, params32, grid_data32, lens)
    wb = build_device_woodbury(
        K32.groups,
        spec.noise(params32),
        K32.noise_n,
        tuple(gd.WtW for gd in grid_data32),
        jitter=(1e-6, 1e-4, 1e-2),
        c_jitter=(0.0, 1e-6, 1e-3),
        equilibrate=equilibrate,
    )
    y32 = jnp.asarray(y, dtype=jnp.float32)
    alpha = wb.solve(y32)
    r = wb.matvec(alpha) - y32
    return jnp.linalg.norm(r) / jnp.maximum(
        jnp.linalg.norm(y32), jnp.asarray(1e-30, jnp.float32)
    )


def stochastic_surrogate_from_solves(
    spec: LMCKernelSpec, raw_params, grid_data, lens, alpha, zs, probes
):
    """The differentiable tail of :func:`stochastic_mll_surrogate`:
    the surrogate scalar

        s(theta) = 1/2 alpha^T K(theta) alpha
                   - 1/(2 N) sum_i z_i^T K(theta) r_i

    given already-computed (detached) solutions ``alpha = K^-1 y`` and
    ``zs = K^-1 r_i``. Exposed separately so the certified training
    rescue can obtain the solutions through the model's full
    host-driven solver ladder and still get the gradient from one
    small jitted program.

    The contraction runs at the dtype of the ``grid_data`` artifacts:
    passing a lower-precision twin (f32 fft) computes the gradient at
    that precision and autodiff upcasts it through the parameter cast
    — see ``diff_data`` in :func:`stochastic_mll_surrogate`."""
    cdtype = jnp.asarray(grid_data[0].dists).dtype
    params_c = jax.tree.map(lambda a: a.astype(cdtype), raw_params)
    K = build_kski(spec, params_c, grid_data, lens)
    operands = jnp.concatenate(
        [jax.lax.stop_gradient(alpha)[None], probes], axis=0
    ).astype(cdtype)
    applied = K.matvec(operands)
    hi = jax.lax.Precision.HIGHEST  # no TF32 for f32 dots on GPUs
    quad_term = 0.5 * jnp.einsum(
        "n,n->", operands[0], applied[0], precision=hi
    )
    zs_c = jax.lax.stop_gradient(zs).astype(cdtype)
    trace_term = (
        jnp.einsum("in,in->", zs_c, applied[1:], precision=hi)
        / probes.shape[0]
    )
    return quad_term - 0.5 * trace_term


def stochastic_mll_surrogate(
    spec: LMCKernelSpec,
    raw_params,
    grid_data,
    lens,
    y,
    probes,
    tol=1e-4,
    maxiter=None,
    method="minres",
    grid_data32=None,
    rhs_sharding=None,
    inner_data32=None,
    cycle=None,
    stall_ratio=None,
    diff_data=None,
):
    """Scalar whose autodiff gradient is the stochastic MLL gradient.

    Returns (surrogate, StochasticAux). Differentiate with
    ``jax.grad(..., has_aux=True)``. The surrogate's *value* is not the
    log-likelihood (use :func:`exact_mll` or a logdet estimator for
    reporting); only its gradient is meaningful.

    ``grid_data32``: float32 DENSE-mode grid artifacts for the per-step
    Woodbury preconditioner factor — the exact fine grid
    (:func:`runlmc_tpu.lmc.grid.to_dense_f32`, all-dense models: the
    solve is then near-direct) or the coarsened twin
    (:func:`runlmc_tpu.lmc.grid.precond_dense_f32`, large-grid models:
    PCG then takes tens of iterations). Either way the refinement loop
    certifies TRUE residuals against the model-dtype operator. When
    absent, plain batched Krylov (MINRES/CG) runs as in the reference.

    ``inner_data32``: optional float32 artifacts of the FINE operator
    (:func:`runlmc_tpu.lmc.grid.fine_fft_f32`) for the inner Krylov
    cycles; defaults to the ``grid_data32`` operator itself (correct
    when that IS the fine grid; a coarse preconditioner must pass the
    fine f32 operator here or inner iterations converge to the wrong
    system).

    ``rhs_sharding``: optional ``NamedSharding`` constraining the
    right-hand-side batch layout — the mesh data-parallel axis
    (replaces the reference's pool.starmap over solves,
    stochastic_deriv.py:51-52).

    ``diff_data``: optional grid artifacts for the DIFFERENTIABLE
    covariance application (defaults to ``grid_data``). 'tiled'-mode
    models pass the f32 fft fine twin here: the gradient contraction
    (and its backward pass) then runs through the f32 FFT instead of
    the 'tiled' gather — whose backward is a scatter-add over Q*m^2
    elements. Gradient rounding from the downcast is ~1e-6 relative,
    orders below the 15-probe
    estimator's own 0.6-10% noise band
    (tests/test_large_grid.py::test_f32_diff_gradient_accuracy).
    """
    # Solve K^-1 [y, r_1..r_N] with gradients blocked: the solver loop is
    # not differentiated (and need not be — the estimator only needs the
    # solutions as constants).
    solve_params = jax.lax.stop_gradient(raw_params)
    K_ng = build_kski(spec, solve_params, grid_data, lens)
    rhs = jnp.concatenate([y[None], probes], axis=0)

    if grid_data32 is not None:
        # Direct path: per-step f32 factorization + PCG certification.
        params32 = jax.tree.map(
            lambda a: jnp.asarray(a, dtype=jnp.float32), solve_params
        )
        K32 = build_kski(spec, params32, grid_data32, lens)
        wb = build_device_woodbury(
            K32.groups,
            spec.noise(params32),
            K32.noise_n,
            tuple(gd.WtW for gd in grid_data32),
        )
        if inner_data32 is not None:
            inner_mv = build_kski(
                spec, params32, inner_data32, lens
            ).matvec
        else:
            inner_mv = K32.matvec

        def solver_call(b):
            # inner CG cycles at f32 (fine f32 matvec + f32 Woodbury
            # preconditioner); only the outer true-residual
            # refinement pays a model-dtype matvec per cycle
            return woodbury_pcg(
                K_ng.matvec, wb, b, tol=tol, maxiter=maxiter,
                inner_matvec=inner_mv,
                cycle=10 if cycle is None else cycle,
                stall_ratio=0.99 if stall_ratio is None else stall_ratio,
            )

    else:
        solver = batched_minres if method == "minres" else batched_cg

        def solver_call(b):
            return solver(
                K_ng.matvec, b, tol=tol, maxiter=maxiter,
                cycle=100 if cycle is None else cycle,
                stall_ratio=0.99 if stall_ratio is None else stall_ratio,
            )

    res = sharded_solve(solver_call, rhs, rhs_sharding)
    sols = jax.lax.stop_gradient(res.x)
    alpha = sols[0]
    zs = sols[1:]

    surrogate = stochastic_surrogate_from_solves(
        spec, raw_params,
        grid_data if diff_data is None else diff_data,
        lens, alpha, zs, probes,
    )

    aux = StochasticAux(
        alpha=alpha,
        solve_iters=jnp.mean(res.iterations.astype(jnp.float32)),
        solve_error=jnp.mean(res.error),
        quad=jnp.einsum(
            "n,n->", y, alpha, precision=jax.lax.Precision.HIGHEST
        ),
    )
    return surrogate, aux


def log_prior_term(prior_specs, raw_params):
    """Sum of prior log-densities + transform log-Jacobians over the raw
    parameter pytree (parity: runlmc/parameterization/model.py:79-105).

    ``prior_specs``: list of (path, prior, transform) where ``path`` is a
    tuple of pytree keys addressing a leaf of ``raw_params``.
    """
    total = 0.0
    for path, prior, transform in prior_specs:
        leaf = raw_params
        for k in path:
            leaf = leaf[k]
        value = transform.forward(jnp.asarray(leaf))
        total = (
            total
            + jnp.sum(prior.lnpdf(value))
            + jnp.sum(transform.log_jacobian(jnp.asarray(leaf)))
        )
    return total
