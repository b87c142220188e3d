"""InterpolatedLLGP — the flagship model: matrix-free SKI LMC multi-output
GP (functional parity: runlmc/models/interpolated_llgp.py:29-443).

Structure:

- ONE jitted gradient step: probe generation, the (1 + n_it)-RHS batched
  Krylov solve, and autodiff of the stochastic MLL surrogate all fuse
  into a single XLA program (the reference runs a process pool of scipy
  solves plus Python gradient-assembly loops per step).
- Parameters are a raw pytree; the optimizer sees a flat vector via
  ``ravel_pytree`` (the analog of paramz's ``param_array``).
- Prediction modes 'exact' / 'on-the-fly' / 'precompute' mirror the
  reference's (interpolated_llgp.py:317-397), with the per-column /
  per-grid-point pooled solves replaced by single batched solver calls.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from runlmc_tpu import config
from runlmc_tpu.lmc import likelihood as lk
from runlmc_tpu.lmc.grid import (
    build_kski,
    fine_fft_f32,
    make_grids,
    precond_dense_f32,
    to_dense_f32,
)
from runlmc_tpu.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu.lmc.woodbury import (
    build_device_woodbury,
    loo_zsq as wb_loo_zsq,
    woodbury_pcg,
)
from runlmc_tpu.metrics import Metrics
from runlmc_tpu.models.multigp import MultiGP
from runlmc_tpu.models.optimization import EVAL_NORM, AdaDelta
from runlmc_tpu.ops.interpolation import multi_interpolant
from runlmc_tpu.ops.slq import slq_logdet
from runlmc_tpu.ops.solvers import batched_cg, batched_minres
from runlmc_tpu.params import IDENTITY, POSITIVE
from runlmc_tpu.priors import check_domain

_LOG = logging.getLogger(__name__)

# Exact-objective residual threshold: the largest per-step factorized-
# solve relative residual at which the float32 exact gradient is still
# trustworthy. CALIBRATED by tests/test_exact_residual.py, which sweeps
# conditioning (noise 1e-1..1e-6) and measures the f32 gradient's
# cosine/relative error against the f64 exact-SKI gradient: residual
# 2e-2 keeps the gradient within 0.4% (cosine 0.999994); 0.38 is 12%
# off (cosine 0.993). 0.25 therefore bounds the gradient error at
# roughly the top of the reference's OWN 15-probe stochastic-estimator
# error band (0.6-10% relative, reference
# grad-grid/out/extracted_summary.csv) — training tolerates it by
# construction (AdaDelta + the rolling-max stop rule are designed for
# estimator noise), and the synth benchmark confirms it empirically
# (exact training at residual ~0.22 reproduces reference quality,
# SMSE 0.1246 vs 0.1244). Chunks whose worst residual exceeds this
# escalate (platform-aware, see optimize()).
EXACT_RESIDUAL_THRESHOLD = 0.25

# Overconfidence guard for the AUTO-selected exact objective: before
# committing to the deterministic exact objective, train a TWIN on
# data with a few contiguous blocks held out per output and measure
# the standardized squared error z^2 = (y - mu)^2 / var on those
# blocks (~1 when calibrated). The block structure is essential:
# weather's measured pathology (exact objective -> held-out NLPD 10-21
# vs the stochastic trajectory's 1.4) is GAP-EXTRAPOLATION
# overconfidence and is invisible to any in-sample statistic — the
# same pathological fit measures LOO z^2 = 0.94 (calibrated!) because
# interleaved single-point holdout never exercises the gaps.
# Calibration (CPU f64, full benchmark configs, seed 1234): fx2007's
# exact fit validates at z^2 = 0.80 with 0% zero variances and keeps
# the exact objective (end-to-end SMSE 0.2000, NLPD -3.676); weather
# breaches BOTH criteria — z^2 = 62.3 and 86.3% of held-out
# variances clamped to zero — demotes, and lands on the stochastic
# trajectory's quality (SMSE 0.0550, NLPD 1.42 vs the undemoted exact
# optimum's NLPD 10.4). The zero-variance fraction is the decisive
# signal; the z^2 threshold sits ~60x above healthy. On breach,
# optimize() demotes 'auto' to the stochastic objective before the
# main training (tests/test_models.py::test_auto_objective_guard*).
VALIDATION_ZSQ_THRESHOLD = 50.0
VALIDATION_ZEROVAR_THRESHOLD = 0.05
VALIDATION_HOLDOUT_FRAC = 0.06
# Iteration cap for the guard's twin training (see
# _validate_exact_objective). Calibrated on the measured weather
# pathology (benchmarks/guard_calibration.py, CPU f64): the breach
# signal is NOT early-visible — held-out z^2 is non-monotone over
# training (15.6 -> 4.3 -> 0.84 -> 3.0 -> 14.3 at iters 5/10/15/25/42)
# and the decisive zero-variance fraction only jumps (0% -> 29.6%) at
# iteration ~42,
# when the noise collapses near the twin's own stopping point (the
# rolling-max rule ended it at 42 of max 100). A cap below ~42 would
# make the guard validate the weather pathology (false negative), so
# the cap sits above the measured breach point with margin and only
# bounds the worst case; in practice the twin's stopping rule ends
# training first and the guard costs about one extra naturally-stopped
# training run (weather: 42 iters / 161 s CPU; fx2007: 21 iters, no
# false positive at any count).
VALIDATION_GUARD_MAX_IT = 60


class InterpolatedLLGP(MultiGP):
    """Matrix-free LMC multi-output GP with SKI covariance approximation.

    :param Xs, Ys: per-output ragged data (see :class:`MultiGP`)
    :param functional_kernel: an :class:`LMCKernelSpec`
    :param lo, hi, m: optional per-dim grid bounds / sizes (autogrid
        defaults, parity interpolated_llgp.py:128-132)
    :param prediction: 'on-the-fly' | 'precompute' | 'exact'
    :param trace_iterations: Hutchinson probes per gradient (default 15)
    :param tolerance: Krylov solve tolerance (default 1e-4)
    :param solver: 'minres' (reference default) or 'cg'
    :param grid_mode: 'auto' | 'fft' | 'dense' | 'tiled' — how
        grid-kernel matvecs run. 'dense' materializes K_UU per group
        once per parameter update and uses dense matmuls; 'fft' runs
        them in Fourier space; 'tiled' is the exact first-row
        contraction (ops/bttb.py); 'auto' picks 'dense' for grids up to
        DENSE_MAX_GRID points and 'fft' beyond
    :param objective: 'exact' | 'stochastic' | 'auto'. The training
        objective. 'exact' (dense grid mode only): the exact MLL of the
        factorized SKI model, differentiated through the per-step
        on-device float32 Woodbury factorization — deterministic,
        probe-free, no Krylov loop (likelihood.exact_ski_mll). 'auto'
        picks 'exact' when every grid group is dense-mode AND a
        build-time probe of the f32 factorization residual at the
        initial parameters certifies below the calibrated
        EXACT_RESIDUAL_THRESHOLD (likelihood.
        f32_factorization_residual); otherwise 'stochastic': the
        reference-parity Hutchinson trace-estimator surrogate with
        batched model-dtype solves (always sound; the only option for
        fft-mode grids).
    :param metrics: record per-step diagnostics incl. exact-gradient
        comparison (slow; parity interpolated_llgp.py:228-244)
    :param mesh: optional ``jax.sharding.Mesh``; when given, the
        (1 + trace_iterations)-RHS solve batch is sharded over the
        mesh's first axis inside the jitted training step — the
        replacement for the reference's process pool
        (stochastic_deriv.py:51-52). One device = same program,
        no constraint.
    :param seed: seed for parameter init and probe RNG
    :param dtype: computation dtype (None = follow jax x64 setting)
    """

    EVAL_NORM = EVAL_NORM
    VALIDATION_GUARD_MAX_IT = VALIDATION_GUARD_MAX_IT

    def __init__(
        self,
        Xs,
        Ys,
        normalize=True,
        lo=None,
        hi=None,
        m=None,
        name="lmc",
        metrics=False,
        prediction="on-the-fly",
        trace_iterations=15,
        tolerance=1e-4,
        solver="minres",
        functional_kernel=None,
        seed=0,
        dtype=None,
        grid_mode="auto",
        objective="auto",
        exact_precision="f32",
        mesh=None,
        max_procs=None,  # accepted for API compatibility; parallelism
        # is the device mesh, not processes
    ):
        super().__init__(Xs, Ys, normalize=normalize, name=name)
        if functional_kernel is None:
            raise ValueError("functional_kernel must be provided")
        # raw (un-normalized) observations + ctor args: the 'auto'
        # objective's validation guard builds a twin model on
        # block-held-out data (see optimize())
        self._raw_Ys = [np.asarray(Y, dtype=float) for Y in Ys]
        self._ctor = dict(
            normalize=normalize, lo=lo, hi=hi, m=m,
            trace_iterations=trace_iterations, tolerance=tolerance,
            solver=solver, seed=seed, dtype=dtype,
            grid_mode=grid_mode, exact_precision=exact_precision,
            functional_kernel=functional_kernel,
        )
        if prediction not in self._prediction_methods():
            raise ValueError(
                "Variance prediction method {} unrecognized".format(
                    prediction
                )
            )
        del max_procs

        self.prediction = prediction
        self.spec: LMCKernelSpec = functional_kernel.with_input_dim(
            self.input_dim
        )
        self.dtype = dtype or (
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        )
        self.n_probes = int(trace_iterations)
        self.tolerance = float(tolerance)
        self.solver = solver
        # Optimizer steps fused per device chunk: longer chunks amortize
        # the host round trip, shorter ones waste fewer tail steps at
        # the stop boundary and re-run less after a breach (a breached
        # chunk re-runs from its first breached step). Not yet measured
        # on the H100.
        self.chunk_len = 10
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            # The 'grid' axis (if any) shards grid-sized tensors via
            # GSPMD constraints inside the operator; the FIRST non-grid
            # axis shards the (1 + n_probes)-RHS solve batch — the
            # replacement for the reference's pool.starmap over solves
            # (stochastic_deriv.py:51-52). A mesh whose ONLY axis is
            # 'grid' therefore gets no RHS sharding: the solver runs
            # un-shard_mapped and XLA partitions the loop through the
            # operator's own grid constraints (shard_map bodies cannot
            # contain with_sharding_constraint).
            batch_axis = next(
                (a for a in mesh.axis_names if a != "grid"), None
            )
            if batch_axis is not None:
                self._rhs_sharding = NamedSharding(
                    mesh, PartitionSpec(batch_axis, None)
                )
                # the exact objective has no probe batch; its
                # data-parallel axis is the data rows themselves
                # (likelihood._shard_data_rows)
                self._data_shard = (mesh, batch_axis)
            else:
                self._rhs_sharding = None
                self._data_shard = None
        else:
            self._rhs_sharding = None
            self._data_shard = None

        self.data = lk.flatten_data(self.Xs, self.Ys)
        self.y = jnp.asarray(self.data.y, dtype=self.dtype)
        self.X = jnp.asarray(self.data.X, dtype=self.dtype)
        self.oidx = jnp.asarray(self.data.output_idx)
        grid_data, self.grid_axes = make_grids(
            self.spec, self.Xs, lo, hi, m, mode=grid_mode
        )
        if mesh is not None and "grid" in mesh.axis_names:
            # multi-device axis: shard fft-mode grid matvecs' Fourier axis
            # over the mesh's 'grid' axis (dense-mode groups are capped
            # at DENSE_MAX_GRID points and stay replicated)
            import dataclasses as _dc

            grid_data = [
                gd.replace(
                    plan=_dc.replace(gd.plan, grid_shard=(mesh, "grid"))
                )
                if gd.plan.mode == "fft"
                else gd
                for gd in grid_data
            ]
        self.grid_data = tuple(
            gd.replace(
                coarse=None,  # preconditioner-only; see precond_data32
                dists=jnp.asarray(gd.dists, dtype=self.dtype),
                interp=gd.interp.replace(
                    weights=jnp.asarray(
                        gd.interp.weights, dtype=self.dtype
                    )
                ),
                idx_map=(
                    None
                    if gd.idx_map is None
                    else jnp.asarray(gd.idx_map)
                ),
                W_blocks=(
                    None
                    if gd.W_blocks is None
                    else tuple(
                        jnp.asarray(b, dtype=self.dtype)
                        for b in gd.W_blocks
                    )
                ),
                WtW=(
                    None
                    if gd.WtW is None
                    else jnp.asarray(gd.WtW, dtype=self.dtype)
                ),
            )
            for gd in grid_data
        )
        # float32 dense-grid artifacts: inputs to the per-step direct
        # Woodbury factorization (converted from host numpy, one batch)
        if all(gd.plan.mode == "dense" for gd in grid_data):
            self.grid_data32 = to_dense_f32(tuple(grid_data))
            # the preconditioner factor IS the exact fine f32 grid, and
            # the f32 inner operator is the same dense artifacts
            self.precond_data32 = self.grid_data32
            self.inner_data32 = self.grid_data32
        else:
            self.grid_data32 = None
            # large-grid groups: coarse dense twin feeds the Woodbury
            # preconditioner; fine f32 fft twin feeds the inner cycles
            self.precond_data32 = precond_dense_f32(tuple(grid_data))
            self.inner_data32 = fine_fft_f32(tuple(grid_data))
        if objective not in ("auto", "exact", "stochastic"):
            raise ValueError("unknown objective %r" % (objective,))
        if objective == "exact" and self.grid_data32 is None:
            raise ValueError(
                "objective='exact' requires every grid group in dense "
                "mode (grid_mode='dense', or small enough grids under "
                "'auto')"
            )
        # 'auto' objective resolution is deferred until parameters
        # exist: it PROBES the f32 factorization residual at the
        # initial parameters (see below).
        self.objective = objective
        if exact_precision not in ("f32", "model"):
            raise ValueError(
                "unknown exact_precision %r" % (exact_precision,)
            )
        # 'f32': the per-step factorization runs in float32 (the fast
        # path; adequate whenever the learned noise stays well above
        # f32 roundoff amplified by the system's conditioning).
        # 'model': factorize at the model dtype with tight jitter —
        # for small-noise regimes (e.g. fx2007 learns noise ~1e-4-1e-5,
        # where f32 factorization error acts as an effective noise
        # floor and measurably degrades SMSE).
        self.exact_precision = exact_precision
        for gd in self.grid_data:
            _LOG.info(
                "InterpolatedLLGP %s generated grid (n=%d, m=%d) for "
                "active dims %s",
                name,
                len(self.data.y),
                int(np.prod(gd.plan.sizes)),
                gd.plan.active_dim,
            )

        raw = self.spec.init_raw_params(seed=seed)
        self.params = jax.tree.map(
            lambda a: jnp.asarray(a, dtype=self.dtype), raw
        )
        flat, unravel = ravel_pytree(self.params)
        self._unravel = unravel
        self.n_params = flat.shape[0]

        # Jacobi-equilibration mode for the Woodbury factorizations
        # (None = woodbury.EQUILIBRATE_DEFAULT). Equilibration rescues
        # graded matrices (weather mid-training) but costs a fraction
        # of a digit on well-balanced ones; when the exact objective's
        # residual breaches mid-training, the escalation ladder probes
        # the FLIPPED mode once before abandoning the exact objective
        # (measured on synth run 1, seed 1234: equilibrated worst
        # residual 0.35 breaches; the flipped factorization certifies
        # at 0.081 and finishes exact, faster than the stochastic
        # demotion, with identical SMSE either way. The flipped mode
        # was SLOWER per step than the equilibrated one (the raw f32
        # Cholesky is fragile inside the scanned chunk program and the
        # in-program rescue fires), so the flip is strictly a rescue
        # rung, never the default.)
        self._equilibrate = None
        self._equilibrate_flip_tried = False

        if self.objective == "auto":
            # Objective auto-selection: the exact (direct-factorization)
            # objective is the flagship — deterministic, probe-free, one
            # f32 factorization per step — but it is only sound where
            # the f32 factorization certifies. Probe its residual once
            # at the initial parameters: above EXACT_RESIDUAL_THRESHOLD
            # (calibrated, tests/test_exact_residual.py) the problem's
            # conditioning already defeats f32 at the INITIAL
            # parameters and training uses the stochastic objective,
            # whose model-dtype Krylov solves self-refine to tolerance
            # at any conditioning. (The probe certifies init-time
            # conditioning only — weather m=500 probes at ~9.5e-4 and
            # passes, then degrades to ~0.27 by optimizer step 10; the
            # in-training escalation below catches that case.)
            if self.grid_data32 is None:
                self.objective = "stochastic"
            else:
                # EAGER, not one jitted program: op-by-op dispatch keeps
                # each compiled piece small and cross-process cacheable
                res = float(
                    lk.f32_factorization_residual(
                        self.spec, self.params, self.grid_data32,
                        self.data.lens, self.y,
                    )
                )
                if res > EXACT_RESIDUAL_THRESHOLD:
                    # one more probe with the Jacobi equilibration
                    # flipped before giving up on the exact objective
                    # (see self._equilibrate above)
                    import runlmc_tpu.lmc.woodbury as _wb
                    res_flip = float(
                        lk.f32_factorization_residual(
                            self.spec, self.params, self.grid_data32,
                            self.data.lens, self.y,
                            equilibrate=not _wb.EQUILIBRATE_DEFAULT,
                        )
                    )
                    if res_flip <= EXACT_RESIDUAL_THRESHOLD:
                        _LOG.info(
                            "objective='auto': default-equilibration "
                            "probe residual %.2e breaches but the "
                            "flipped mode certifies at %.2e — using "
                            "exact with equilibrate=%s",
                            res, res_flip, not _wb.EQUILIBRATE_DEFAULT,
                        )
                        self._equilibrate = not _wb.EQUILIBRATE_DEFAULT
                        self._equilibrate_flip_tried = True
                        res = res_flip
                self.objective = (
                    "exact"
                    if res <= EXACT_RESIDUAL_THRESHOLD
                    else "stochastic"
                )
                # auto-selected exact runs the post-training LOO
                # overconfidence guard (see optimize())
                self._auto_exact_guard = self.objective == "exact"
                _LOG.info(
                    "objective='auto': f32 factorization probe residual "
                    "%.2e (threshold %g) -> %s objective",
                    res, EXACT_RESIDUAL_THRESHOLD, self.objective,
                )

        if not hasattr(self, "_auto_exact_guard"):
            self._auto_exact_guard = False
        self._key = jax.random.PRNGKey(seed)
        self._prior_specs = []
        self.metrics = Metrics() if metrics else None
        self._cache = {}
        # per-parameter-setting solve diagnostics (residuals, iteration
        # counts, escalations) for the latest prediction/reporting
        # solves — the benchmark harness surfaces these in its JSON
        self.prediction_report = {}
        self._version = 0
        self._build_jit()
        _LOG.info("InterpolatedLLGP %s fully initialized", name)

    # --------------------------------------------------------------- utils

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _bump(self):
        self._version += 1
        self._cache.clear()
        self.prediction_report = {}

    def set_params(self, params):
        self.params = params
        self._bump()

    @property
    def param_array(self):
        """Flat raw-parameter vector (the analog of paramz
        ``param_array``)."""
        flat, _ = ravel_pytree(self.params)
        return np.asarray(flat)

    @param_array.setter
    def param_array(self, x):
        self.set_params(self._unravel(jnp.asarray(x, dtype=self.dtype)))

    def _solver_fn(self):
        return batched_minres if self.solver == "minres" else batched_cg

    # ----------------------------------------------------------------- jit

    def _build_jit(self):
        """Construct the jitted compute functions.

        All data-sized arrays (grid data, y, X, output indices) are
        passed as ARGUMENTS, never closures — large closure-captured
        arrays become HLO constants embedded in every program.
        """
        spec = self.spec
        lens = self.data.lens
        n = int(self.y.shape[0])
        tol = self.tolerance
        method = self.solver
        n_probes = self.n_probes
        unravel = self._unravel
        prior_specs = tuple(self._prior_specs)
        rhs_sharding = self._rhs_sharding

        objective_mode = self.objective
        exact_precision = self.exact_precision
        data_shard = self._data_shard
        equilibrate_mode = self._equilibrate
        # 'tiled' models route the DIFFERENTIABLE covariance application
        # through the f32 fft fine twin — the tiled gather's backward is
        # a scatter-add over Q*m^2 elements (see
        # stochastic_mll_surrogate's diff_data note). Dense/fft-mode
        # models keep the model-dtype gradient path.
        f32_diff = any(gd.plan.mode == "tiled" for gd in self.grid_data)

        def _grad(x_flat, key, grid_data, grid_data32, inner32, y,
                  rescue=False):
            params = unravel(x_flat)

            if objective_mode == "exact":
                # Exact MLL of the factorized SKI model, computed and
                # differentiated through the per-step direct Woodbury
                # factorization — in float32 ('f32') or at the model
                # dtype with tight jitter ('model', for small-noise
                # regimes). Deterministic: `key` is unused (DCE'd).
                if exact_precision == "f32":
                    gd, cdtype = grid_data32, jnp.float32
                    jit_scales = (1e-6, 1e-4, 1e-2)
                    c_scales = (0.0, 1e-6, 1e-3)
                else:
                    gd, cdtype = grid_data, y.dtype
                    if cdtype == jnp.float64:
                        jit_scales = (1e-12, 1e-9, 1e-6)
                        c_scales = (0.0, 1e-12, 1e-9)
                    else:
                        jit_scales = (1e-6, 1e-4, 1e-2)
                        c_scales = (0.0, 1e-6, 1e-3)
                params_c = jax.tree.map(
                    lambda a: a.astype(cdtype), params
                )

                def objective(p):
                    mll, aux = lk.exact_ski_mll(
                        spec, p, gd, lens,
                        y.astype(cdtype), jitter=jit_scales,
                        c_jitter=c_scales, data_shard=data_shard,
                        equilibrate=equilibrate_mode,
                    )
                    if prior_specs:
                        mll = mll + lk.log_prior_term(prior_specs, p)
                    return -mll, aux

                (_, aux), g = jax.value_and_grad(
                    objective, has_aux=True
                )(params_c)
                gflat, _ = ravel_pytree(g)
                return gflat.astype(x_flat.dtype), aux

            probes = lk.rademacher_probes(key, n_probes, n, y.dtype)

            # In-training escalation for the stochastic objective
            # (round-3 verdict item 2): the rescue program re-runs a
            # breached chunk with PLAIN model-dtype Krylov — no
            # preconditioner, no f32 inner cycles. A training-solve
            # breach means the f32 factor failed (degraded dense
            # factorization, or a coarse factor whose fine-grid
            # mismatch exceeds the learned noise); in exactly that
            # regime the preconditioner SMEARS the SKI spectrum
            # (rank-Dm cluster + a noise-eigenvalue cluster) that plain
            # Krylov exploits — measured at noise 2e-5: plain f64 CG
            # converges in 29 iterations where the coarse-PCG stalls at
            # ||r|| ~ 10 ||b|| indefinitely. Long unrestarted cycles
            # (restarts discard the Krylov space — fine for f32 drift
            # control, fatal for convergence on ill-conditioned
            # systems), near-1 stall ratio, enlarged iteration budget.
            # The budget is CAPPED at 500: the SKI spectrum bounds
            # plain-Krylov convergence far below n (weather m=2500
            # needs ~280 iterations at init), and the cap bounds the
            # length of one device execution, which the host cannot
            # interrupt.
            rescue_budget = min(4 * n, 500)
            solver_opts = (
                dict(
                    grid_data32=None,
                    inner_data32=None,
                    cycle=rescue_budget,
                    stall_ratio=0.999,
                    maxiter=rescue_budget,
                )
                if rescue
                else dict(grid_data32=grid_data32, inner_data32=inner32)
            )

            def objective(p):
                s, aux = lk.stochastic_mll_surrogate(
                    spec, p, grid_data, lens, y, probes,
                    tol=tol, method=method,
                    rhs_sharding=rhs_sharding,
                    diff_data=inner32 if f32_diff else None,
                    **solver_opts,
                )
                if prior_specs:
                    s = s + lk.log_prior_term(prior_specs, p)
                return -s, aux

            (_, aux), g = jax.value_and_grad(objective, has_aux=True)(
                params
            )
            gflat, _ = ravel_pytree(g)
            return gflat, aux

        grad_fn = jax.jit(_grad, static_argnames=("rescue",))

        model_dtype = self.dtype

        @jax.jit
        def probes_fn(key):
            return lk.rademacher_probes(key, n_probes, n, model_dtype)

        def _grad_from_solves(x_flat, probes, alpha, zs, grid_data,
                              inner32):
            """Gradient of the negative (penalized) stochastic
            surrogate given ladder-certified solutions — the
            contraction half of the rung-2 training rescue."""
            params = unravel(x_flat)

            def obj(p):
                s = lk.stochastic_surrogate_from_solves(
                    spec, p, inner32 if f32_diff else grid_data, lens,
                    alpha, zs, probes,
                )
                if prior_specs:
                    s = s + lk.log_prior_term(prior_specs, p)
                return -s

            g = jax.grad(obj)(params)
            gflat, _ = ravel_pytree(g)
            return gflat.astype(x_flat.dtype)

        grad_from_solves_fn = jax.jit(_grad_from_solves)

        chunk_len = self.chunk_len

        def _chunk(x0, gms0, sms0, stp0, key, start, hp, grid_data,
                   grid_data32, inner32, y, rescue=False,
                   n_steps=chunk_len):
            """`chunk_len` full AdaDelta iterations fused into one XLA
            program (lax.scan): the gradient (incl. the per-step direct
            factorization), the climin-style update rule and the
            per-step grad norms all stay on device; only the tiny
            per-step stacked outputs cross the transport once per chunk.
            The host replays the stopping rule retroactively
            (AdaDelta.minimize_chunked).

            Probe keys are fold_in(run_key, GLOBAL iteration index), so
            the probe sequence is independent of chunk boundaries — a
            checkpointed run resumed mid-stream reproduces the
            uninterrupted probe stream bit-exactly."""
            step_rate, decay, momentum, offset = hp

            def body(carry, i):
                x, gms, sms, stp = carry
                sub = jax.random.fold_in(key, start + i)
                step1 = stp * momentum
                x1 = x - step1
                g, aux = _grad(x1, sub, grid_data, grid_data32, inner32,
                               y, rescue=rescue)
                gms_n = decay * gms + (1.0 - decay) * g * g
                step2 = (
                    jnp.sqrt(sms + offset)
                    / jnp.sqrt(gms_n + offset)
                    * g
                    * step_rate
                )
                x2 = x1 - step2
                stp_n = step1 + step2
                sms_n = decay * sms + (1.0 - decay) * stp_n * stp_n
                gnorm = jnp.max(jnp.abs(g))
                out = (x2, gms_n, sms_n, stp_n, gnorm,
                       aux.solve_iters, aux.solve_error)
                return (x2, gms_n, sms_n, stp_n), out

            _, outs = jax.lax.scan(
                body, (x0, gms0, sms0, stp0),
                jnp.arange(n_steps),
            )
            return outs

        chunk_fn = jax.jit(
            _chunk, static_argnames=("rescue", "n_steps")
        )

        @jax.jit
        def woodbury_fn(params, grid_data):
            """Direct factorization of K_SKI at the model's full
            precision (escalation path + near-exact logdet; dense grid
            mode)."""
            K = build_kski(spec, params, grid_data, lens)
            tight = (
                (1e-12, 1e-9, 1e-6)
                if K.noise_n.dtype == jnp.float64
                else (1e-6, 1e-4, 1e-2)
            )
            c_tight = (
                (0.0, 1e-12, 1e-9)
                if K.noise_n.dtype == jnp.float64
                else (0.0, 1e-6, 1e-3)
            )
            return build_device_woodbury(
                K.groups,
                spec.noise(params),
                K.noise_n,
                tuple(gd.WtW for gd in grid_data),
                jitter=tight,
                c_jitter=c_tight,
                equilibrate=equilibrate_mode,
            )

        @jax.jit
        def woodbury32_fn(params, grid_data32):
            """Float32 factorization of K_SKI — the PCG preconditioner
            for prediction-time solves (the same program the exact
            training step runs per iteration); the model-dtype
            factorization is the escalation path."""
            params32 = jax.tree.map(
                lambda a: jnp.asarray(a, dtype=jnp.float32), params
            )
            K32 = build_kski(spec, params32, grid_data32, lens)
            return build_device_woodbury(
                K32.groups,
                spec.noise(params32),
                K32.noise_n,
                tuple(gd.WtW for gd in grid_data32),
                equilibrate=equilibrate_mode,
            )

        # Per-round Krylov budget for certified solves. Solves are
        # driven by a HOST loop over bounded device executions: a
        # single data-dependent while_loop with maxiter=n can run for
        # many minutes at degraded conditioning, and the host can
        # neither observe nor stop it. State (x, rhs) stays
        # device-resident between rounds — the host only reads scalar
        # residual norms.
        ROUND_BUDGET = 100

        @jax.jit
        def wb_pcg_round_fn(params, grid_data, inner32, wb, rhs, x):
            """ONE bounded refinement round of the certified solve:
            correct K dx = r from the current iterate, keep the better
            of (x, x + dx) per row by TRUE residual. CG cycles are
            preconditioned by the (typically f32) Woodbury factor —
            exact-fine for dense-mode models, the coarse twin for
            large grids; inner cycles run at f32 speed when f32 fine
            artifacts exist."""
            K = build_kski(spec, params, grid_data, lens)
            inner = None
            if inner32 is not None and wb.dtype == jnp.float32:
                params32 = jax.tree.map(
                    lambda a: jnp.asarray(a, dtype=jnp.float32), params
                )
                K32 = build_kski(spec, params32, inner32, lens)
                inner = K32.matvec
            r = rhs - K.matvec(x)
            rn0 = jnp.sqrt(jnp.sum(r * r, axis=-1))
            res = woodbury_pcg(K.matvec, wb, r, tol=tol,
                               maxiter=ROUND_BUDGET, inner_matvec=inner)
            x_new = x + res.x
            r_new = rhs - K.matvec(x_new)
            rn_new = jnp.sqrt(jnp.sum(r_new * r_new, axis=-1))
            better = rn_new < rn0
            x_keep = jnp.where(better[:, None], x_new, x)
            return x_keep, jnp.minimum(rn_new, rn0), res.iterations

        dtype = self.dtype

        @jax.jit
        def slq_logdet_fn(params, grid_data, key):
            K = build_kski(spec, params, grid_data, lens)
            return slq_logdet(
                K.matvec, n, key, n_probes=max(n_probes, 15), k=40,
                dtype=dtype,
            )

        @jax.jit
        def krylov_round_fn(params, grid_data, rhs, x):
            """ONE bounded round of plain model-dtype MINRES from the
            current iterate (escalation rung 2, host-driven like
            wb_pcg_round_fn — see the ROUND_BUDGET note). Rung 2 only
            fires after the f32-preconditioned solve stalled — in that
            regime f32 inner cycles share the preconditioner's
            precision floor, while the SKI spectrum (rank-Dm cluster +
            noise cluster) often lets plain model-dtype Krylov make
            progress. The RHS batch is sliced to <= 64 rows by the
            caller, so the 150-iteration per-round budget keeps one
            execution bounded on the gather operator while giving each
            round real Krylov depth (restart-shallow 30-iteration
            rounds floored ~4x above tolerance at weather m=2500)."""
            K = build_kski(spec, params, grid_data, lens)
            r = rhs - K.matvec(x)
            rn0 = jnp.sqrt(jnp.sum(r * r, axis=-1))
            res = batched_minres(
                K.matvec, r, tol=tol, maxiter=150, cycle=150,
                stall_ratio=0.999,
            )
            x_new = x + res.x
            r_new = rhs - K.matvec(x_new)
            rn_new = jnp.sqrt(jnp.sum(r_new * r_new, axis=-1))
            better = rn_new < rn0
            x_keep = jnp.where(better[:, None], x_new, x)
            return x_keep, jnp.minimum(rn_new, rn0), res.iterations

        @jax.jit
        def kski_fn(params, grid_data):
            return build_kski(spec, params, grid_data, lens)

        @jax.jit
        def grid_alpha_fn(params, alpha, grid_data):
            K = build_kski(spec, params, grid_data, lens)
            return tuple(
                g.grid_matvec(g.interp.rmatvec(alpha)) for g in K.groups
            )

        dtype = self.dtype

        @jax.jit
        def native_variance_fn(params):
            k0 = jnp.stack(
                [
                    spec.eval_kernel(params, q, jnp.zeros((), dtype))
                    for q in range(spec.Q)
                ]
            )
            coregs = jnp.stack(
                [
                    jnp.square(spec.coreg_vec(params, q)).sum(0)
                    + spec.coreg_diag(params, q)
                    for q in range(spec.Q)
                ],
                axis=1,
            )  # (D, Q)
            return jnp.matmul(
                coregs, k0, precision=jax.lax.Precision.HIGHEST
            ) + spec.noise(params)

        @jax.jit
        def exact_chol_fn(params, X, oidx):
            return lk.exact_chol(spec, params, X, oidx)

        @jax.jit
        def predict_mean_fn(params, alpha, test_interps, grid_data):
            K = build_kski(spec, params, grid_data, lens)
            mean = 0.0
            for g, ti in zip(K.groups, test_interps):
                mean = mean + ti.matvec(
                    g.grid_matvec(g.interp.rmatvec(alpha))
                )
            return mean

        @jax.jit
        def exact_value_and_grad_fn(x_flat, X, oidx, y):
            params = unravel(x_flat)

            def objective(p):
                ll = lk.exact_mll(spec, p, X, oidx, y)
                if prior_specs:
                    ll = ll + lk.log_prior_term(prior_specs, p)
                return -ll

            val, g = jax.value_and_grad(objective)(params)
            gflat, _ = ravel_pytree(g)
            return val, gflat

        self._jit_grad = grad_fn
        self._jit_chunk = chunk_fn
        self._jit_probes = probes_fn
        self._jit_grad_from_solves = grad_from_solves_fn
        self._jit_woodbury = woodbury_fn
        self._jit_woodbury32 = woodbury32_fn
        self._jit_wb_pcg_round = wb_pcg_round_fn
        self._jit_krylov_round = jax.jit(krylov_round_fn)
        self._jit_slq_logdet = slq_logdet_fn
        self._jit_kski = kski_fn
        self._jit_grid_alpha = grid_alpha_fn
        self._jit_native_variance = native_variance_fn
        self._jit_exact_chol = exact_chol_fn
        self._jit_exact_value_and_grad = exact_value_and_grad_fn
        self._jit_predict_mean = predict_mean_fn

    # ---------------------------------------------------------- priors API

    def set_prior(self, path, prior):
        """Place a prior on the constrained value of the parameter leaf at
        ``path`` (tuple of pytree keys, e.g. ``('noise',)`` or
        ``('kernels', 'q0', 'inv_lengthscale')``). Parity:
        PriorizableLeaf.set_prior (priorizable.py:41-78)."""
        transform = self._transform_for_path(path)
        check_domain(prior, transform)
        self._prior_specs.append((tuple(path), prior, transform))
        self._build_jit()
        self._bump()

    def _transform_for_path(self, path):
        if path[0] in ("noise", "coreg_diags"):
            return POSITIVE
        if path[0] == "coreg_vecs":
            return IDENTITY
        if path[0] == "kernels":
            q = int(path[1][1:])
            pspec = self.spec.kernels[q].param_spec()
            return pspec[path[2]][1]
        raise KeyError(path)

    # ------------------------------------------------------------ training

    def optimize(self, optimizer=None, state=None, **kwargs):
        """Run AdaDelta (default, reference-parity stopping rule) on the
        stochastic MLL gradient. Extra kwargs construct the default
        optimizer. KeyboardInterrupt cleanly stops with current params
        (parity: multigp.py:194-197).

        ``state``: optional optimizer state (from a previous ``info``
        dict's ``'state'`` or a checkpoint's ``opt_state``) to resume
        an interrupted run; the returned info dict always carries the
        final resumable ``'state'``."""
        if optimizer is None:
            optimizer = AdaDelta(**kwargs)
        if self.metrics is not None:
            self.metrics = Metrics()

        # Overconfidence guard for the AUTO-selected exact objective
        # (round-3 verdict item 3): before committing, validate the
        # exact objective on block-held-out data — weather's measured
        # pathology (exact -> held-out NLPD 10-21 vs stochastic's 1.4)
        # is gap-extrapolation overconfidence that NO in-sample
        # statistic sees (its LOO z^2 is 0.94). On breach, demote to
        # the stochastic objective for the main training.
        if (
            self._auto_exact_guard
            and self.objective == "exact"
            and state is None
        ):
            self._auto_exact_guard = False  # run once
            import time as _t

            _t0 = _t.time()
            z2v, zfrac = self._validate_exact_objective(optimizer)
            _LOG.info(
                "objective='auto': held-out-block validation guard "
                "took %.1fs (one capped twin training run)",
                _t.time() - _t0,
            )
            if (
                z2v > VALIDATION_ZSQ_THRESHOLD
                or zfrac > VALIDATION_ZEROVAR_THRESHOLD
            ):
                _LOG.warning(
                    "objective='auto': exact objective fails the "
                    "held-out-block calibration check (z^2 %.3g > %g "
                    "or zero-variance fraction %.2f > %g) — using the "
                    "stochastic objective",
                    z2v, VALIDATION_ZSQ_THRESHOLD, zfrac,
                    VALIDATION_ZEROVAR_THRESHOLD,
                )
                self.objective = "stochastic"
                self._build_jit()
            else:
                _LOG.info(
                    "objective='auto': exact objective validates on "
                    "held-out blocks (z^2 %.3g, zero-var %.2f)",
                    z2v, zfrac,
                )

        def fprime(x_flat):
            x = jnp.asarray(x_flat, dtype=self.dtype)
            self._debug_dump_params(x_flat)
            g, aux = self._jit_grad(
                x, self._next_key(), self.grid_data, self.precond_data32,
                self.inner_data32, self.y,
            )
            if self.metrics is not None:
                self._record_metrics(x_flat, g, aux)
            return np.asarray(g, dtype=float)

        # The run key is part of the resumable optimizer state: probe
        # keys are fold_in(run_key, global_iter), so a resumed run
        # continues the exact probe stream of the uninterrupted run.
        if state is not None and "rng_key" in state:
            run_key = jnp.asarray(np.asarray(state["rng_key"]))
        else:
            run_key = self._next_key()

        import time as _time

        chunk_stats = {"steps": 0, "seconds": 0.0, "iters": [],
                       "errors": [], "rescued_chunks": 0}
        # Futility latch for the in-training rescue: once BOTH rescue
        # rungs fail to reach the calibrated gradient bound on a chunk
        # (a degenerate trajectory whose conditioning defeats every
        # solver rung), later breached chunks of the SAME run skip the
        # attempts — the rescues were not being adopted, so repeating
        # them only multiplies wall-clock (seen on the weather m=500
        # degenerate run).
        rescue_futile = {"flag": False}

        def run_chunk(x, gms, sms, step, start_iter, stop_probe=None):
            """One device-side chunk of AdaDelta steps.

            ``stop_probe``: optional callable from the optimizer
            replaying its stopping rule over a prefix of certified
            grad norms (AdaDelta.minimize_chunked) — lets a breached
            chunk skip rescue work on steps beyond the stop point."""
            self._debug_dump_params(x)
            hp = jnp.asarray(
                [
                    optimizer.step_rate,
                    optimizer.decay,
                    optimizer.momentum,
                    optimizer.offset,
                ],
                dtype=self.dtype,
            )
            args = (
                jnp.asarray(x, dtype=self.dtype),
                jnp.asarray(gms, dtype=self.dtype),
                jnp.asarray(sms, dtype=self.dtype),
                jnp.asarray(step, dtype=self.dtype),
                run_key,
                jnp.asarray(start_iter, dtype=jnp.int32),
                hp,
                self.grid_data,
                self.precond_data32,
                self.inner_data32,
                self.y,
            )
            t0 = _time.time()
            outs = self._jit_chunk(*args)
            xs, gmss, smss, steps, gns, iters, errs = jax.device_get(outs)

            def _worst_of(e):
                w = float(np.max(np.asarray(e, dtype=float)))
                # NaN residual = NaN objective/factorization; a NaN
                # compares False against every threshold, so treat it
                # as an unconditional breach
                return w if np.isfinite(w) else float("inf")

            worst = _worst_of(errs)
            rescue_needed = (
                self.objective == "stochastic" and worst > self.tolerance
            )
            if rescue_needed and stop_probe is not None:
                # The stop rule may already fire within the CERTIFIED
                # prefix of the chunk (breaches cluster at the
                # degenerate training tail — round-4's weather m=2500
                # breach sat entirely past the stop point). Replaying
                # the rule over the certified prefix's grad norms is
                # sound (those gradients are accurate); if it stops
                # there, the breached steps are discarded by the host
                # replay anyway — skip the rescue and truncate so the
                # recorded residuals describe only ADOPTED steps.
                errs_pre = np.asarray(errs, dtype=float)
                bad_pre = (
                    (errs_pre > self.tolerance) | ~np.isfinite(errs_pre)
                )
                j0_pre = int(np.argmax(bad_pre))
                stop_j = (
                    stop_probe(np.asarray(gns[:j0_pre], dtype=float))
                    if j0_pre > 0
                    else None
                )
                if stop_j is not None:
                    _LOG.info(
                        "chunk breach (residual %e) occurs past the "
                        "stopping point (chunk step %d) — discarding "
                        "the breached tail instead of rescuing it",
                        worst, stop_j,
                    )
                    keep = stop_j + 1
                    (xs, gmss, smss, steps, gns, iters, errs) = tuple(
                        a[:keep]
                        for a in (xs, gmss, smss, steps, gns, iters,
                                  errs)
                    )
                    worst = _worst_of(errs)
                    rescue_needed = False
            if rescue_needed and rescue_futile["flag"]:
                _LOG.warning(
                    "chunk worst solve residual %e exceeds tolerance; "
                    "rescue already proved futile on this trajectory "
                    "— tolerating inexact gradients (reference "
                    "parity: iterative.py:54-58)",
                    worst,
                )
                rescue_needed = False
            if rescue_needed:
                # IN-TRAINING ESCALATION (stochastic objective): the
                # chunk's solves stalled above tolerance — its
                # gradients are inexact (in the worst case, noise:
                # weather round-3 logged chunk residuals ~ ||y||, i.e.
                # failed solves). Rung 1 re-runs the SAME chunk
                # (identical start state and probe keys) through the
                # rescue program: plain long-cycle Krylov, near-1
                # stall ratio. Keep whichever run certified better.
                # SKIPPED for 'tiled' models: their O(m^2) gather-path
                # matvec makes a stuck breach burn the full 500-
                # iteration budget per step; the rung-2 certified
                # ladder below subsumes its plain-Krylov strategy with
                # host-driven bounded rounds and warm-started
                # preconditioned first attempts.
                chunk_stats["rescued_chunks"] += 1
                use_rung1 = not any(
                    gd.plan.mode == "tiled" for gd in self.grid_data
                )
                _LOG.warning(
                    "chunk worst solve residual %e exceeds the %g "
                    "tolerance — re-running with the escalated solver "
                    "(%s)",
                    worst, self.tolerance,
                    "plain-Krylov rescue program" if use_rung1
                    else "certified-ladder rescue",
                )
                # Re-run FROM THE FIRST BREACHED STEP only (everything
                # before it is already certified, and its state/probe
                # stream is identical by construction), step-by-step
                # (n_steps=1) so each XLA execution stays bounded: the
                # rescue's long Krylov budget inside the full chunk
                # scan would be a single multi-minute device program.
                # The rescue passes the W-block-stripped grid data:
                # the gather-path operator is a smaller program to
                # compile than the W-block einsum one.
                errs_np = np.asarray(errs, dtype=float)
                if use_rung1:
                    bad = (
                        (errs_np > self.tolerance)
                        | ~np.isfinite(errs_np)
                    )
                    j0 = int(np.argmax(bad))
                    if j0 == 0:
                        st = args[:4]
                    else:
                        st = tuple(
                            jnp.asarray(a[j0 - 1], dtype=self.dtype)
                            for a in (xs, gmss, smss, steps)
                        )
                    pieces = []
                    adopt_bound_pre = self._gradient_adopt_bound
                    for j in range(j0, len(gns)):
                        o = self._jit_chunk(
                            *st,
                            run_key,
                            jnp.asarray(
                                int(np.asarray(start_iter)) + j,
                                jnp.int32,
                            ),
                            hp,
                            self._grid_data_rescue,
                            self.precond_data32,
                            self.inner_data32,
                            self.y,
                            rescue=True,
                            n_steps=1,
                        )
                        st = (o[0][-1], o[1][-1], o[2][-1], o[3][-1])
                        pieces.append(jax.device_get(o))
                        if j == j0 and _worst_of(
                            np.asarray(pieces[-1][6], dtype=float)
                        ) > adopt_bound_pre:
                            # the FIRST rescued step already misses
                            # the calibrated bound: every later step
                            # evolves from its garbage state, so the
                            # stream can never be adopted — bail
                            # before paying for the rest (each step
                            # burns a full plain-Krylov budget)
                            _LOG.warning(
                                "plain-Krylov rescue failed the "
                                "calibrated bound on its first step "
                                "— skipping the remaining re-runs",
                            )
                            pieces = None
                            break
                    if pieces is not None:
                        plain = (xs, gmss, smss, steps, gns, iters,
                                 errs)
                        r2 = tuple(
                            np.concatenate(
                                [np.asarray(plain[k][:j0])]
                                + [p[k] for p in pieces]
                            )
                            for k in range(7)
                        )
                        worst2 = _worst_of(r2[6])
                    else:
                        r2 = None
                        worst2 = float("inf")
                else:
                    r2 = None
                    worst2 = float("inf")
                # Adopt the rescue only when its solves meet the
                # CALIBRATED gradient-accuracy bound: tolerance, or a
                # relative residual of 2e-2 (tests/test_exact_residual
                # calibration: residual 2e-2 keeps the gradient within
                # 0.4% — below the 15-probe estimator's own noise).
                # The solve-error metric is a mean of row residual
                # norms whose rows are probes of norm sqrt(n), so the
                # absolute form of that bound is 2e-2 * sqrt(n). A
                # rescue that lands merely-smaller-but-still-garbage
                # would swap one inexact gradient stream for a
                # different one, silently changing the training
                # trajectory for no accuracy gain (measured on weather
                # m=500: adopting a 126 -> 25 "improvement" steered
                # training into a far worse-conditioned optimum than
                # tolerating the original noisy steps).
                adopt_bound = self._gradient_adopt_bound
                if worst2 <= adopt_bound and worst2 <= worst:
                    # adopt only a rescue that BOTH meets the calibrated
                    # bound and actually certifies better than the plain
                    # chunk — never swap gradient streams for no gain
                    (xs, gmss, smss, steps, gns, iters, errs) = r2
                    worst = worst2
                if worst > self.tolerance:
                    # RUNG 2 (round-5): the in-program plain-Krylov
                    # rescue is budget-capped and
                    # preconditioner-free; when it still breaches,
                    # re-run the breached steps with solves from the
                    # FULL certified solver ladder — the same
                    # host-driven bounded-round machinery
                    # (_solve_certified: f32-Woodbury PCG ->
                    # model-dtype cycles -> plain-Krylov rounds) that
                    # certifies prediction residuals — and gradients
                    # from one small jitted contraction.
                    _LOG.warning(
                        "escalated chunk still above tolerance "
                        "(residual %e) — re-running breached steps "
                        "with certified-ladder solves",
                        worst,
                    )
                    r3 = self._rescue_steps_certified(
                        args[:4],
                        (xs, gmss, smss, steps, gns, iters, errs),
                        int(np.asarray(start_iter)), hp, run_key,
                    )
                    worst3 = _worst_of(r3[6])
                    if worst3 <= adopt_bound and worst3 <= worst:
                        (xs, gmss, smss, steps, gns, iters, errs) = r3
                        worst = worst3
                if worst > self.tolerance:
                    if worst <= adopt_bound:
                        # above the solve tolerance but within the
                        # CALIBRATED gradient-accuracy bound
                        # (2e-2 * sqrt(n): gradient within 0.4%,
                        # below the 15-probe estimator's own noise —
                        # tests/test_exact_residual.py)
                        _LOG.info(
                            "escalated chunk residual %e is above the "
                            "%g solve tolerance but WITHIN the "
                            "calibrated gradient-accuracy bound %g — "
                            "gradients remain estimator-grade",
                            worst, self.tolerance, adopt_bound,
                        )
                    else:
                        _LOG.warning(
                            "escalated chunk still above the "
                            "calibrated bound %g (residual %e) — "
                            "gradients for those steps are inexact",
                            adopt_bound, worst,
                        )
                        # every rung failed to reach the calibrated
                        # bound: stop attempting rescues on this
                        # trajectory (see rescue_futile above)
                        rescue_futile["flag"] = True
            chunk_stats["seconds"] += _time.time() - t0
            chunk_stats["steps"] += len(gns)
            chunk_stats["iters"].extend(np.asarray(iters, float))
            chunk_stats["errors"].extend(np.asarray(errs, float))
            if (
                self.objective != "stochastic"
                and worst > EXACT_RESIDUAL_THRESHOLD
            ):
                # Exact mode reports the factorized solve's raw
                # relative residual. Below EXACT_RESIDUAL_THRESHOLD the
                # f32 gradient is calibrated-accurate
                # (tests/test_exact_residual.py); above it the
                # factorization is degrading (the learned noise has
                # shrunk past what f32 resolves at this conditioning —
                # measured on weather: init probe 9.5e-4 but 0.27 by
                # step ~10), so ESCALATE the remaining steps. The
                # escalation target is platform-aware
                # (config.native_f64): the model-dtype factorization
                # where the platform factorizes f64 natively (CPU and
                # GPU — exact gradients), and the stochastic objective
                # where it does not (its model-dtype Krylov solves
                # with the f32 factor as preconditioner self-refine
                # using matvecs only).
                f64_native = (
                    self.dtype == jnp.float64 and config.native_f64()
                )
                if self.exact_precision == "f32" and f64_native:
                    _LOG.warning(
                        "exact-objective residual %e exceeded the "
                        "calibrated %g threshold — escalating training "
                        "to exact_precision='model' for the remaining "
                        "steps",
                        worst, EXACT_RESIDUAL_THRESHOLD,
                    )
                    self.exact_precision = "model"
                    self._build_jit()
                elif self.objective == "exact":
                    # Before abandoning the exact objective entirely,
                    # probe the factorization with the Jacobi
                    # equilibration FLIPPED at the current parameters:
                    # equilibration is a numerical strategy, not a
                    # property of the model, and which mode preserves
                    # more f32 digits depends on the matrix's grading
                    # (weather's graded capacitance needs it; synth
                    # run 1's eager flipped probe certifies at 0.081
                    # where the equilibrated chunk measured 0.35).
                    # One eager probe costs one factorization, and an
                    # adopted flip finishes the run exact — faster than
                    # the stochastic demotion on synth run 1, at
                    # identical SMSE. (The flipped steps
                    # are slower than equilibrated ones — the raw f32
                    # Cholesky is fragile inside the scanned chunk and
                    # the in-program rescue fires — so the flip is a
                    # rescue rung only, never the default.)
                    flipped_ok = False
                    if (
                        not self._equilibrate_flip_tried
                        and self.grid_data32 is not None
                        and self._all_dense
                    ):
                        self._equilibrate_flip_tried = True
                        import runlmc_tpu.lmc.woodbury as _wb
                        cur = (
                            self._equilibrate
                            if self._equilibrate is not None
                            else _wb.EQUILIBRATE_DEFAULT
                        )
                        params_now = self._unravel(
                            jnp.asarray(
                                np.asarray(xs)[-1], dtype=self.dtype
                            )
                        )
                        res_flip = float(
                            lk.f32_factorization_residual(
                                self.spec, params_now,
                                self.grid_data32, self.data.lens,
                                self.y, equilibrate=not cur,
                            )
                        )
                        if res_flip <= EXACT_RESIDUAL_THRESHOLD:
                            _LOG.warning(
                                "exact-objective residual %e exceeded "
                                "the calibrated %g threshold, but the "
                                "equilibration-flipped factorization "
                                "certifies at %e — flipping "
                                "equilibrate to %s and keeping the "
                                "exact objective",
                                worst, EXACT_RESIDUAL_THRESHOLD,
                                res_flip, not cur,
                            )
                            self._equilibrate = not cur
                            self._build_jit()
                            flipped_ok = True
                        else:
                            _LOG.info(
                                "equilibration-flipped probe also "
                                "breaches (%e) — demoting",
                                res_flip,
                            )
                    if not flipped_ok:
                        _LOG.warning(
                            "exact-objective residual %e exceeded the "
                            "calibrated %g threshold with no "
                            "affordable higher-precision "
                            "factorization on this platform (%s) — "
                            "switching training to the stochastic "
                            "objective for the remaining steps",
                            worst, EXACT_RESIDUAL_THRESHOLD,
                            jax.default_backend(),
                        )
                        self.objective = "stochastic"
                        self._build_jit()
                else:
                    _LOG.warning(
                        "solve residual %e exceeds the calibrated %g "
                        "threshold — gradients for those steps are "
                        "inexact",
                        worst, EXACT_RESIDUAL_THRESHOLD,
                    )
            return xs, gmss, smss, steps, gns

        x0 = self.param_array
        use_chunked = (
            self.metrics is None and isinstance(optimizer, AdaDelta)
        )
        try:
            if use_chunked:
                x_opt, info = optimizer.minimize_chunked(
                    x0, run_chunk, state=state
                )
                info["state"]["rng_key"] = np.asarray(run_key)
                # per-step breakdown (includes the up-to-chunk_len
                # device steps per jit call; wasted tail steps at the
                # stop boundary count toward seconds, not n_iter)
                info["device_seconds"] = chunk_stats["seconds"]
                info["device_steps"] = chunk_stats["steps"]
                info["mean_solve_iters"] = float(
                    np.mean(chunk_stats["iters"])
                )
                info["max_solve_error"] = float(
                    np.max(chunk_stats["errors"])
                )
                info["rescued_chunks"] = chunk_stats["rescued_chunks"]
                _LOG.info(
                    "optimize: %d device steps in %.2fs (%.1f ms/step; "
                    "mean solve iters %.1f, worst residual %.2e)",
                    chunk_stats["steps"], chunk_stats["seconds"],
                    1e3 * chunk_stats["seconds"]
                    / max(chunk_stats["steps"], 1),
                    info["mean_solve_iters"], info["max_solve_error"],
                )
            else:
                x_opt, info = optimizer.minimize(
                    x0, fprime, state=state
                )
        except KeyboardInterrupt:
            print(
                "{}: KeyboardInterrupt caught, terminating "
                "optimization.".format(self.name)
            )
            raise
        self.param_array = x_opt
        return info

    def _validation_split(self):
        """Per-output train/validation split with CONTIGUOUS held-out
        blocks (two per output, at the 1/3 and 2/3 positions of each
        series, ~VALIDATION_HOLDOUT_FRAC of the points). Contiguity is
        what makes the guard sensitive to gap-extrapolation
        overconfidence — interleaved or single-point holdout measures
        calibrated (LOO z^2 ~ 1) on fits whose gap predictions are
        wildly overconfident."""
        Xs_tr, Ys_tr, Xs_va, Ys_va = [], [], [], []
        for X, Y in zip(self.Xs, self._raw_Ys):
            n_i = len(X)
            blk = max(1, int(n_i * VALIDATION_HOLDOUT_FRAC / 2))
            mask = np.ones(n_i, dtype=bool)
            for pos in (n_i // 3, (2 * n_i) // 3):
                mask[pos : pos + blk] = False
            Xs_tr.append(np.asarray(X)[mask])
            Ys_tr.append(Y[mask])
            Xs_va.append(np.asarray(X)[~mask])
            Ys_va.append(Y[~mask])
        return Xs_tr, Ys_tr, Xs_va, Ys_va

    def _validate_exact_objective(self, optimizer):
        """Train a TWIN model with the exact objective on the
        block-reduced data and measure held-out standardized squared
        error (z^2, ~1 when calibrated) plus the zero-variance
        fraction. Returns ``(z2, zero_var_frac)``."""
        Xs_tr, Ys_tr, Xs_va, Ys_va = self._validation_split()
        ctor = dict(self._ctor)
        twin = InterpolatedLLGP(
            Xs_tr, Ys_tr, objective="exact",
            name=self.name + "-guard", **ctor,
        )
        # Replicate the main run's full optimizer configuration (a twin
        # trained under different hyperparameters would validate a
        # different training regime), capped at
        # VALIDATION_GUARD_MAX_IT — see the constant's calibration
        # note: the breach signal only appears near the twin's natural
        # stopping point, so the cap bounds the worst case rather than
        # shortcutting the guard, and the guard's unavoidable cost
        # (about one extra naturally-stopped training run) is logged.
        opt_kwargs = {}
        if isinstance(optimizer, AdaDelta):
            opt_kwargs = dict(
                step_rate=optimizer.step_rate,
                decay=optimizer.decay,
                momentum=optimizer.momentum,
                offset=optimizer.offset,
                max_it=optimizer.max_it,
                min_grad_ratio=optimizer.min_grad_ratio,
                permitted_drops=optimizer.permitted_drops,
            )
        opt_kwargs["max_it"] = min(
            opt_kwargs.get("max_it", 100), self.VALIDATION_GUARD_MAX_IT
        )
        twin.optimize(optimizer=AdaDelta(**opt_kwargs))
        mus, vs = twin.predict(Xs_va)
        z2s, n_zero, n_tot = [], 0, 0
        for mu, v, yv in zip(mus, vs, Ys_va):
            v = np.asarray(v)
            mu = np.asarray(mu)
            n_tot += len(v)
            zero = v <= 0
            n_zero += int(zero.sum())
            ok = ~zero
            if ok.any():
                z2s.append(((yv[ok] - mu[ok]) ** 2) / v[ok])
        z2 = float(np.mean(np.concatenate(z2s))) if z2s else float("inf")
        zfrac = n_zero / max(n_tot, 1)
        return z2, zfrac

    def loo_zsq(self):
        """Mean squared leave-one-out standardized residual of the
        current fit (~1 when calibrated; see
        :func:`runlmc_tpu.lmc.woodbury.loo_zsq`). The model-dtype
        factorization needs dense grid mode; beyond the dense cap the
        statistic comes from the f32 factor (the coarse twin), whose
        own error is far below the >>1 signal this detects. Off the
        platforms of :func:`runlmc_tpu.config.native_f64` an f64 model
        uses the f32 factor as well."""
        f64_native = self.dtype == jnp.float64 and config.native_f64()
        wb = (
            self._woodbury()
            if f64_native and self._all_dense
            else self._woodbury32()
        )
        return float(wb_loo_zsq(wb, self.y.astype(wb.dtype)))

    def _debug_dump_params(self, x_flat):
        """DEBUG-level dump of every (constrained-space-relevant raw)
        hyperparameter at the current optimizer point (observability
        parity: reference interpolated_llgp.py:209-224 logs all
        hyperparameters per step)."""
        if not _LOG.isEnabledFor(logging.DEBUG):
            return
        params = self._unravel(jnp.asarray(x_flat, dtype=self.dtype))
        leaves, _ = jax.tree_util.tree_flatten_with_path(params)
        _LOG.debug("%s hyperparameters:", self.name)
        for path, leaf in leaves:
            _LOG.debug(
                "    %s %s",
                jax.tree_util.keystr(path),
                np.array2string(np.asarray(leaf), precision=4),
            )

    def _record_metrics(self, x_flat, g, aux):
        self.metrics.iterations.append(float(aux.solve_iters))
        self.metrics.solv_error.append(float(aux.solve_error))
        approx_norm = float(np.linalg.norm(np.asarray(g), EVAL_NORM))
        val, exact_g = self._jit_exact_value_and_grad(
            jnp.asarray(x_flat, dtype=self.dtype),
            self.X, self.oidx, self.y,
        )
        exact_norm = float(np.linalg.norm(np.asarray(exact_g), EVAL_NORM))
        diff = float(
            np.linalg.norm(np.asarray(g) - np.asarray(exact_g), EVAL_NORM)
        )
        self.metrics.grad_norms.append(approx_norm)
        self.metrics.grad_error.append(diff / max(exact_norm, 1e-300))
        self.metrics.log_likely.append(-float(val))

    # ----------------------------------------------------------- reporting

    @property
    def _all_dense(self):
        return all(gd.plan.mode == "dense" for gd in self.grid_data)

    @property
    def _gradient_adopt_bound(self):
        """Calibrated gradient-accuracy residual bound for TRAINING
        solves: tolerance, or an absolute 2e-2 * sqrt(n) (probes have
        norm sqrt(n); relative residual 2e-2 keeps the gradient within
        0.4% — below the 15-probe estimator's own noise band,
        tests/test_exact_residual.py)."""
        return max(
            self.tolerance, 2e-2 * float(np.sqrt(len(self.data.y)))
        )

    @property
    def _grid_data_rescue(self):
        """Fine grid data with the dense W blocks stripped — the
        compile-cheap gather-path operator the rescue programs use
        (see run_chunk)."""
        return tuple(gd.replace(W_blocks=None) for gd in self.grid_data)

    def _rescue_steps_certified(self, st0, plain, start_iter, hp,
                                run_key):
        """RUNG-2 training rescue: re-run every step of a chunk from
        its first breached step with solves obtained through the full
        certified solver ladder (:meth:`_solve_certified` — host-driven
        bounded rounds, the machinery that certifies prediction
        residuals at tolerance), gradients from the jitted
        solution-contraction program, and the AdaDelta update replayed
        on host (float64 numpy — identical arithmetic to the device
        chunk's update rule). Probe streams stay
        ``fold_in(run_key, global_iter)``, so only solve accuracy
        differs from the plain chunk.

        ``st0``: device chunk-entry state (x, gms, sms, step);
        ``plain``: the 7-tuple of stacked per-step chunk outputs.
        Returns the same 7-tuple layout with breached steps re-run.
        """
        xs, gmss, smss, steps, gns, iters, errs = plain
        errs_np = np.asarray(errs, dtype=float)
        bad = (errs_np > self.tolerance) | ~np.isfinite(errs_np)
        j0 = int(np.argmax(bad))
        if j0 == 0:
            st = tuple(np.asarray(a, dtype=float) for a in st0)
        else:
            st = tuple(
                np.asarray(a[j0 - 1], dtype=float)
                for a in (xs, gmss, smss, steps)
            )
        x, gms, sms, stp = st
        step_rate, decay, momentum, offset = (
            float(v) for v in np.asarray(hp)
        )
        params_before = self.param_array
        pieces = []
        try:
            for j in range(j0, len(np.asarray(gns))):
                it_g = start_iter + j
                step1 = stp * momentum
                x1 = x - step1
                probes = self._jit_probes(
                    jax.random.fold_in(run_key, it_g)
                )
                # the ladder's jitted rounds read self.params; the
                # param swap also invalidates the cached f32 factor so
                # the preconditioner rebuilds at this step's params
                self.param_array = x1
                rhs = jnp.concatenate([self.y[None], probes], axis=0)
                what = "train-rescue[iter %d]" % it_g
                # bounded ladder: target the calibrated gradient-
                # accuracy bound with a small round budget — training
                # needs estimator-grade gradients; grinding a
                # degenerate transient to solver-grade 1e-4 costs
                # minutes per step for no training benefit (see
                # _solve_certified_slice docstring)
                sols, worst_j = self._solve_certified(
                    rhs, what, tol=self._gradient_adopt_bound,
                    max_rounds=5,
                )
                if worst_j > self._gradient_adopt_bound:
                    # The rescued stream is only ADOPTED by run_chunk
                    # when every step meets the calibrated bound; the
                    # first step that can't reach it within the
                    # bounded ladder makes the remaining ladder work
                    # provably wasted — return the plain stream now
                    # (one step's ladder cost instead of the whole
                    # tail's; the weather m=500 degenerate transient
                    # is exactly this case).
                    _LOG.warning(
                        "%s: bounded ladder could not reach the "
                        "calibrated bound %g (residual %e) — "
                        "abandoning the certified re-run for this "
                        "chunk",
                        what, self._gradient_adopt_bound, worst_j,
                    )
                    return plain
                rep = self.prediction_report.get(what, {})
                g = np.asarray(
                    self._jit_grad_from_solves(
                        jnp.asarray(x1, dtype=self.dtype), probes,
                        sols[0], sols[1:], self.grid_data,
                        self.inner_data32,
                    ),
                    dtype=float,
                )
                gms = decay * gms + (1.0 - decay) * g * g
                step2 = (
                    np.sqrt(sms + offset) / np.sqrt(gms + offset)
                    * g * step_rate
                )
                x = x1 - step2
                stp = step1 + step2
                sms = decay * sms + (1.0 - decay) * stp * stp
                pieces.append((
                    x, gms, sms, stp, float(np.max(np.abs(g))),
                    float(rep.get("iterations", 0.0)), float(worst_j),
                ))
        finally:
            self.param_array = params_before
        out = []
        for k in range(7):
            head = np.asarray(plain[k][:j0], dtype=float)
            tail = np.stack(
                [np.asarray(p[k], dtype=float) for p in pieces]
            )
            out.append(np.concatenate([head, tail]))
        return tuple(out)

    def warm_rescue(self, key=None, ladder=True):
        """Compile (and once execute) the escalated rescue programs at
        the CURRENT parameters, so a mid-training breach does not pay
        their one-off XLA compiles inside the timed/production path:
        the rung-1 rescue-chunk program and (``ladder=True``) the
        rung-2 certified-ladder pieces (the bounded solve rounds at
        the training batch shape + the solution-contraction gradient).
        No model state is mutated."""
        x = jnp.asarray(self.param_array, dtype=self.dtype)
        z = jnp.zeros_like(x)
        hp = jnp.asarray([1.0, 0.9, 0.5, 1e-4], dtype=self.dtype)
        o = self._jit_chunk(
            x, z, z, z,
            key if key is not None else jax.random.PRNGKey(0),
            jnp.asarray(0, jnp.int32), hp,
            self._grid_data_rescue, self.precond_data32,
            self.inner_data32, self.y,
            rescue=True, n_steps=1,
        )
        jax.block_until_ready(o)
        if ladder:
            probes = self._jit_probes(
                key if key is not None else jax.random.PRNGKey(0)
            )
            rhs = jnp.concatenate([self.y[None], probes], axis=0)
            report_before = dict(self.prediction_report)
            sols, _ = self._solve_certified(rhs, "warm-rescue-ladder")
            self.prediction_report = report_before
            g = self._jit_grad_from_solves(
                x, probes, sols[0], sols[1:], self.grid_data,
                self.inner_data32,
            )
            jax.block_until_ready(g)

    def _woodbury(self):
        """Model-dtype Woodbury factorization of K_SKI (dense grid
        mode): the ESCALATION preconditioner and the near-exact logdet.
        Prediction normally runs off :meth:`_woodbury32`."""
        if "woodbury" not in self._cache:
            self._cache["woodbury"] = self._jit_woodbury(
                self.params, self.grid_data
            )
        return self._cache["woodbury"]

    def _woodbury32(self):
        """Float32 Woodbury factor — the default prediction-time PCG
        preconditioner; milliseconds to build. Exact-fine for dense
        grid mode, the coarsened twin for large (fft/tiled) grids."""
        if "woodbury32" not in self._cache:
            self._cache["woodbury32"] = self._jit_woodbury32(
                self.params, self.precond_data32
            )
        return self._cache["woodbury32"]

    # Certified solves process the RHS batch in slices of this many
    # rows: per-iteration device cost scales with the batch, so slicing
    # both bounds each XLA execution AND lets the escalation rounds
    # afford real Krylov depth per round (one compile — slices share a
    # shape; zero-padded tail rows converge instantly). ``None`` =
    # auto: 128 for all-dense models (fewer dispatches at small grids),
    # 64 beyond the dense cap (escalation rounds there run
    # ROUND_BUDGET-deep Krylov on the slice, so the slice bounds one
    # execution's length). Neither value is yet measured on the H100.
    SOLVE_SLICE = None

    @property
    def _solve_slice(self):
        if self.SOLVE_SLICE is not None:
            return int(self.SOLVE_SLICE)
        return 128 if self._all_dense else 64

    def _solve_certified(self, rhs, what, tol=None, max_rounds=None):
        B = int(rhs.shape[0])
        S = self._solve_slice
        if B <= S:
            return self._solve_certified_slice(
                rhs, what, tol=tol, max_rounds=max_rounds
            )
        pad = (-B) % S
        if pad:
            rhs_p = jnp.concatenate(
                [rhs, jnp.zeros((pad, rhs.shape[1]), rhs.dtype)], axis=0
            )
        else:
            rhs_p = rhs
        sols = []
        worst = 0.0
        n_slices = rhs_p.shape[0] // S
        for i in range(n_slices):
            x, w = self._solve_certified_slice(
                rhs_p[i * S : (i + 1) * S],
                "%s[%d/%d]" % (what, i + 1, n_slices),
                tol=tol, max_rounds=max_rounds,
            )
            sols.append(x)
            worst = max(worst, w)
        # merge the per-slice reports into one entry for `what`
        slice_reports = [
            self.prediction_report.pop(k)
            for k in list(self.prediction_report)
            if k.startswith(what + "[")
        ]
        self.prediction_report[what] = {
            "residual": worst,
            "iterations": max(
                d["iterations"] for d in slice_reports
            ),
            "escalated": any(d["escalated"] for d in slice_reports),
            "rhs": B,
        }
        return jnp.concatenate(sols, axis=0)[:B], worst

    def _solve_certified_slice(self, rhs, what, tol=None,
                                max_rounds=None):
        """K^-1 rhs (batched, model dtype) with an auto-escalating
        solver ladder, every rung checking TRUE residuals:

        1. f32-Woodbury-preconditioned CG (inner cycles at f32,
           model-dtype outer refinement);
        2. on stall — for dense-grid models on platforms that factorize
           f64 natively (:func:`runlmc_tpu.config.native_f64`: CPU and
           GPU), the model-dtype Woodbury preconditioner; otherwise
           model-dtype cycles with the f32 factor, then a long plain
           Krylov solve in bounded rounds;
        3. CRITICAL log with the best iterate (parity with the
           reference's tolerated MINRES non-convergence,
           iterative.py:54-58).

        Returns (solutions, worst abs residual); per-call diagnostics
        recorded in ``self.prediction_report``.

        ``tol`` (default ``self.tolerance``) and ``max_rounds``
        (default 30 per rung) bound the ladder: the TRAINING rescue
        passes the calibrated gradient-accuracy bound and a small
        round budget — training needs estimator-grade gradients, not
        solver-grade residuals, and an unbounded ladder on a
        degenerate transient burns minutes per step (on the weather
        m=500 mid-training breach the full ladder ground the residual
        126 -> 0.68 when 2.51 already certifies the gradient)."""
        tol = self.tolerance if tol is None else float(tol)
        rung_rounds = 30 if max_rounds is None else int(max_rounds)

        def _worst(e):
            w = float(jnp.max(e))
            # NaN compares False vs thresholds — treat as a breach
            return w if np.isfinite(w) else float("inf")

        def _rounds(round_call, rhs, max_rounds=None, x0=None):
            """Host-driven bounded refinement rounds (see
            wb_pcg_round_fn / krylov_round_fn): loop until tolerance,
            stall (two rounds without 1% progress), or the round
            budget; device arrays never leave the device between
            rounds."""
            x = jnp.zeros_like(rhs) if x0 is None else x0
            iters_total = 0.0
            prev = float("inf")
            stalled = 0
            worst = float("inf")
            for _ in range(rung_rounds if max_rounds is None
                           else max_rounds):
                x, rnorm, iters = round_call(rhs, x)
                iters_total += float(jnp.max(iters))
                worst = _worst(rnorm)
                if worst <= tol:
                    break
                if worst > 0.99 * prev:
                    stalled += 1
                    if stalled >= 2:
                        break
                else:
                    stalled = 0
                prev = min(prev, worst)
            return x, iters_total, worst

        wb32 = self._woodbury32()
        x, iters, err = _rounds(
            lambda b, x0: self._jit_wb_pcg_round(
                self.params, self.grid_data, self.inner_data32, wb32,
                b, x0,
            ),
            rhs,
        )
        worst = err
        escalated = False
        if worst > tol:
            escalated = True
            f64_native = (
                self.dtype == jnp.float64 and config.native_f64()
            )
            if f64_native and self._all_dense:
                _LOG.warning(
                    "%s: f32-preconditioned solve stalled at residual "
                    "%e (tolerance %g) — escalating to the model-dtype "
                    "factorization",
                    what, worst, tol,
                )
                wb_md = self._woodbury()
                x2, it2, err2 = _rounds(
                    lambda b, x0: self._jit_wb_pcg_round(
                        self.params, self.grid_data, None, wb_md, b, x0,
                    ),
                    rhs,
                )
            else:
                _LOG.warning(
                    "%s: f32-preconditioned solve stalled at residual "
                    "%e (tolerance %g) — escalating to MODEL-dtype "
                    "cycles with the f32 factor (model-dtype "
                    "factorization %s)",
                    what, worst, tol,
                    "unavailable for non-dense grids"
                    if not self._all_dense
                    else "unaffordable on %s" % jax.default_backend(),
                )
                # Rung 1.5: keep the f32 Woodbury preconditioner but
                # run the CG cycles at the MODEL dtype (inner32=None).
                # Rung 1's stall floor is usually the f32 INNER
                # OPERATOR's own matvec rounding (~1e-5 relative),
                # which bounds how much one refinement cycle can
                # correct; model-dtype cycles with the same f32 factor
                # sidestep that floor at the price of a model-dtype
                # matvec per iteration. Warm-started from rung 1.
                x2, it2, err2 = _rounds(
                    lambda b, x0: self._jit_wb_pcg_round(
                        self.params, self.grid_data, None, wb32, b, x0,
                    ),
                    rhs,
                    x0=x,
                )
                if err2 > tol:
                    # Rung 2: plain model-dtype Krylov on the
                    # W-block-stripped operator (the smaller program to
                    # compile). Warm-started from the best iterate.
                    _LOG.warning(
                        "%s: preconditioned model-dtype cycles still "
                        "at residual %e — final plain-Krylov rung",
                        what, err2,
                    )
                    gd_rescue = self._grid_data_rescue
                    x2b, it2b, err2b = _rounds(
                        lambda b, x0: self._jit_krylov_round(
                            self.params, gd_rescue, b, x0,
                        ),
                        rhs,
                        x0=x2 if err2 <= worst else x,
                    )
                    if err2b <= err2:
                        x2, it2, err2 = x2b, it2 + it2b, err2b
            # keep whichever rung certified better; the reported
            # iteration count accumulates across rungs either way
            w2 = err2 if np.isfinite(err2) else float("inf")
            if w2 <= worst:
                x, iters, worst = x2, iters + it2, w2
            else:
                iters = iters + it2
        if worst > tol:
            _LOG.critical(
                "%s (n = %d) did not converge: reconstruction error %e",
                what, self.y.shape[0], worst,
            )
        self.prediction_report[what] = {
            "residual": worst,
            "iterations": float(np.max(np.asarray(iters))),
            "escalated": escalated,
            "rhs": int(rhs.shape[0]),
        }
        return x, worst

    def _alpha(self):
        if "alpha" not in self._cache:
            # every grid mode now has a Woodbury preconditioner (exact
            # f32 for dense grids, the coarse twin beyond the dense
            # cap), so alpha is always a certified solve
            sols, _ = self._solve_certified(self.y[None], "alpha")
            self._cache["alpha"] = sols[0]
        return self._cache["alpha"]

    def _chol(self):
        if "chol" not in self._cache:
            self._cache["chol"] = self._jit_exact_chol(self.params, self.X, self.oidx)
        return self._cache["chol"]

    def K(self):
        """Dense exact kernel (quadratic; reporting/debug only — parity:
        interpolated_llgp.py:252-260)."""
        return np.asarray(
            lk.exact_dense_K(self.spec, self.params, self.X, self.oidx)
        )

    def log_det_K(self):
        """Exact-Cholesky log determinant (reporting only, O(n^3) —
        parity: interpolated_llgp.py:262-276)."""
        diag = np.asarray(jnp.diagonal(self._chol()))
        if np.any(diag <= 0) or np.any(~np.isfinite(diag)):
            _LOG.critical(
                "Log determinant nonpositive, returning -inf"
            )
            return -np.inf
        return float(2.0 * np.log(diag).sum())

    def normal_quadratic(self):
        """y^T K_SKI^-1 y (parity: interpolated_llgp.py:278-285)."""
        return float(self.y @ self._alpha())

    def ski_log_det(self):
        """Log det of the SKI covariance, never materializing an
        (n, n) matrix. Dense grid mode on platforms that factorize the
        model dtype natively (f64 on CPU and GPU —
        :func:`runlmc_tpu.config.native_f64` — or f32 models anywhere):
        the matrix determinant lemma on the on-device Woodbury
        factorization — exact up to the factorization's relative-1e-12
        Cholesky jitter. Otherwise, and in FFT grid mode: a stochastic
        Lanczos quadrature ESTIMATE
        (ops/slq.py, deterministic probes per parameter setting, only
        model-dtype MATVECS; calibrated relative error band 0.3-0.6%
        at k=40 / >=15 probes across conditioning up to ~1e7 —
        slq_logdet docstring + tests/test_slq.py sweep). The
        reference has no fast-logdet path
        (its roadmap lists Lanczos logdet, reference README.md:86); it
        reports the O(n^3) dense-kernel logdet instead."""
        native = self.dtype != jnp.float64 or config.native_f64()
        if self._all_dense and native:
            return float(self._woodbury().logdet)
        if "slq_logdet" not in self._cache:
            self._cache["slq_logdet"] = float(
                self._jit_slq_logdet(
                    self.params, self.grid_data, jax.random.PRNGKey(0)
                )
            )
        return self._cache["slq_logdet"]

    def ski_log_likelihood(self):
        """Marginal log-likelihood of the SKI model itself:
        -1/2 (ski_log_det + y^T K_SKI^-1 y + n log 2 pi). Matrix-free
        and cheap at any n; exact in dense grid mode, logdet-estimated
        (SLQ) in fft mode."""
        nll = float(self.ski_log_det()) + self.normal_quadratic()
        nll += len(self.data.y) * np.log(2 * np.pi)
        return -0.5 * nll

    # Default size cutoff for log_likelihood(exact=None): above this n
    # the exact O(n^3) logdet is a 2 GB Cholesky per parameter setting
    # (e.g. weather, n=15,789) for a reporting-only quantity, so the
    # default switches to the SKI logdet. Pass ``exact=True/False`` to
    # pin the definition regardless of n.
    LARGE_N_EXACT_REPORT = 5000

    def log_likelihood(self, exact=None):
        """-1/2 (log det K + y^T K^-1 y + n log 2pi) (parity:
        interpolated_llgp.py:287-290).

        :param exact: which log-determinant definition to use.
            ``True``: the reference's exact dense-kernel Cholesky logdet
            (O(n^3) — the quantity the reference reports at every n).
            ``False``: the SKI-model logdet (:meth:`ski_log_det` —
            Woodbury, near-exact in dense grid mode; an SLQ estimate in
            fft mode). ``None`` (default): ``True`` for
            n <= ``LARGE_N_EXACT_REPORT``, else ``False``, with a
            WARNING naming the definition used — comparisons across n
            should pass ``exact`` explicitly so the definition cannot
            switch silently.
        """
        n = len(self.data.y)
        if exact is None:
            exact = n <= self.LARGE_N_EXACT_REPORT
            if not exact:
                _LOG.warning(
                    "log_likelihood: n=%d > %d, reporting the SKI "
                    "logdet (%s) instead of the O(n^3) exact logdet; "
                    "pass exact=True/False to pin the definition",
                    n, self.LARGE_N_EXACT_REPORT,
                    "Woodbury, near-exact" if self._all_dense
                    else "Lanczos-quadrature estimate",
                )
        if exact:
            nll = self.log_det_K() + self.normal_quadratic()
        else:
            nll = float(self.ski_log_det()) + self.normal_quadratic()
        nll += n * np.log(2 * np.pi)
        return -0.5 * nll

    def exact_log_likelihood_and_grad(self):
        """Fully-exact MLL value and flat gradient (dense autodiff path —
        the oracle the reference calls ExactLMCLikelihood)."""
        val, g = self._jit_exact_value_and_grad(
            jnp.asarray(self.param_array, dtype=self.dtype),
            self.X, self.oidx, self.y,
        )
        return -float(val), -np.asarray(g)

    def stochastic_grad(self):
        """One stochastic-gradient evaluation (of the MINIMIZED objective,
        i.e. the negative penalized MLL), flat."""
        g, _ = self._jit_grad(
            jnp.asarray(self.param_array, dtype=self.dtype),
            self._next_key(),
            self.grid_data,
            self.precond_data32,
            self.inner_data32,
            self.y,
        )
        return np.asarray(g)

    # ---------------------------------------------------------- prediction

    def _prediction_methods(self):
        return {
            "on-the-fly": self._var_predict_on_the_fly,
            "precompute": self._var_predict_precompute,
            "exact": self._var_predict_exact,
        }

    def _test_interps(self, Xs):
        return tuple(
            multi_interpolant(
                [np.asarray(X)[:, list(gd.plan.active_dim)] for X in Xs],
                axes,
            ).replace_weights_dtype(self.dtype)
            for gd, axes in zip(self.grid_data, self.grid_axes)
        )

    def _raw_predict(self, Xs):
        lens = [len(X) for X in Xs]
        test_interps = self._test_interps(Xs)

        if self.prediction != "exact":
            # Certified path for EVERY grid mode: Woodbury-
            # preconditioned CG against the model-dtype operator (the
            # f32 factor is exact-fine for dense grids, the coarse
            # twin beyond the dense cap) — every solve's TRUE residual
            # is certified below tolerance, with escalation if the
            # preconditioner stalls. The observation solve (alpha)
            # rides in the SAME batched call as the test columns: one
            # program, one shape — repeat predictions reuse the
            # compiled program instead of paying a second XLA compile
            # for a batch-size-off-by-one solve.
            if self.prediction == "on-the-fly":
                K_test_X = self._cross_kernel(Xs)
                if K_test_X.shape[0]:
                    rhs = jnp.concatenate([self.y[None], K_test_X], 0)
                    sols, _ = self._solve_certified(
                        rhs, "explained-variance"
                    )
                    alpha = sols[0]
                    self._cache["alpha"] = alpha
                    explained = np.asarray(
                        jnp.sum(K_test_X * sols[1:], axis=1)
                    )
                else:
                    alpha = self._alpha()
                    explained = np.zeros(0)
            else:  # 'precompute'
                alpha = self._alpha()
                nu = self._precomputed_nu()
                assert len(test_interps) == 1
                explained = np.asarray(
                    test_interps[0].matvec(jnp.asarray(nu))
                )
            mean = np.asarray(
                self._jit_predict_mean(
                    self.params, alpha, test_interps, self.grid_data
                )
            )
            native = np.asarray(self._jit_native_variance(self.params))
            native = np.repeat(native, lens)
            var = np.maximum(native - explained, 0.0)
            ends = np.cumsum(lens)[:-1]
            return np.split(mean, ends), np.split(var, ends)

        # 'exact' dense-Cholesky explained variance (reporting/oracle)
        alpha = self._alpha()
        mean = np.asarray(
            self._jit_predict_mean(
                self.params, alpha, test_interps, self.grid_data
            )
        )
        native = np.asarray(self._jit_native_variance(self.params))
        native = np.repeat(native, lens)
        explained = self._prediction_methods()[self.prediction](
            test_interps, Xs
        )
        var = native - np.asarray(explained)
        var[var < 0] = 0

        ends = np.cumsum(lens)[:-1]
        return np.split(mean, ends), np.split(var, ends)

    def _test_flat(self, Xs):
        td = lk.flatten_data(Xs, [np.zeros(len(X)) for X in Xs])
        return (
            jnp.asarray(td.X, dtype=self.dtype),
            jnp.asarray(td.output_idx),
        )

    def _cross_kernel(self, Xs):
        Xt, ot = self._test_flat(Xs)
        return lk.cross_kernel(
            self.spec, self.params, Xt, ot, self.X, self.oidx
        )

    def _var_predict_exact(self, _, Xs):
        """Dense explained variance via exact Cholesky (parity:
        interpolated_llgp.py:350-356)."""
        K_test_X = self._cross_kernel(Xs)
        L = self._chol()
        with jax.default_matmul_precision("highest"):
            sol = jax.scipy.linalg.cho_solve((L, True), K_test_X.T)
        return np.asarray(jnp.sum(K_test_X * sol.T, axis=1))

    def _var_predict_on_the_fly(self, test_interps, Xs):
        """Certified batched solves against every test column at once
        (parity: interpolated_llgp.py:390-397, which pools one scipy
        solve per test point). Normally short-circuited by the fused
        certified branch of ``_raw_predict``; kept as the standalone
        explained-variance API."""
        K_test_X = self._cross_kernel(Xs)
        if K_test_X.shape[0] == 0:
            return np.zeros(0)
        sols, _ = self._solve_certified(K_test_X, "explained-variance")
        return np.asarray(jnp.sum(K_test_X * sols, axis=1))

    def _precomputed_nu(self):
        """nu_j = [K_UX K^-1 K_XU]_jj for every grid point j, via one
        batched (D m)-RHS solve (parity: interpolated_llgp.py:358-388,
        which pools D*m independent scipy solves)."""
        if "nu" not in self._cache:
            if len(self.grid_data) != 1:
                raise ValueError(
                    "precompute prediction mode unavailable for split "
                    "kernels"
                )
            gd = self.grid_data[0]
            K = self._jit_kski(self.params, self.grid_data)
            g = K.groups[0]
            dm = gd.interp.ncols
            eye = jnp.eye(dm, dtype=self.dtype)
            KUU = g.grid_matvec(eye)  # dense (Dm, Dm), symmetric
            rhs = g.interp.matvec(KUU)  # rows: K_XU columns, (Dm, n)
            sols, _ = self._solve_certified(rhs, "precompute-nu")
            back = g.grid_matvec(g.interp.rmatvec(sols))  # (Dm, Dm)
            self._cache["nu"] = np.asarray(jnp.diagonal(back))
        return self._cache["nu"]

    def _var_predict_precompute(self, test_interps, _):
        nu = self._precomputed_nu()
        assert len(test_interps) == 1
        return np.asarray(test_interps[0].matvec(jnp.asarray(nu)))
