"""Large-grid (beyond-dense-cap) path: coarse-Woodbury-preconditioned
certified solves, 'tiled' exact fine operator, and the in-training
stochastic escalation.

The reference runs any grid size through its CPU f64 FFT matvec
(runlmc/linalg/bttb.py:144-148) with per-solve scipy MINRES; the
rebuild covers the same regime with (a) a COARSENED dense-mode twin of
each oversized grid group whose f32 Woodbury factorization
preconditions every solve (grid.GridData.coarse / precond_dense_f32),
(b) f32 fft inner cycles + model-dtype outer true-residual refinement
(fine_fft_f32 + 'fft'/'tiled' modes), and (c) a rescue re-run of any
training chunk whose solves stall above tolerance.

These tests shrink DENSE_MAX_GRID so a small model genuinely exercises
the coarse path (coarse sizes strictly below fine sizes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from runlmc_tpu import AdaDelta, InterpolatedLLGP, LMCKernelSpec, RBF
from runlmc_tpu.lmc import grid as grid_mod
from runlmc_tpu.lmc.grid import (
    build_kski,
    coarse_sizes,
    fine_fft_f32,
    make_grids,
    precond_dense_f32,
)


@pytest.fixture
def small_cap(monkeypatch):
    """Force the dense AND preconditioner caps low so m=[96] D=2 grids
    go beyond both (the preconditioner twin genuinely coarsens)."""
    monkeypatch.setattr(grid_mod, "DENSE_MAX_GRID", 64)
    monkeypatch.setattr(grid_mod, "PRECOND_MAX_GRID", 64)


def _data(rng, n0=200, n1=150):
    Xs = [np.sort(rng.uniform(0, 1, n0)), np.sort(rng.uniform(0, 1, n1))]
    Ys = [np.sin(8 * x) + 0.05 * rng.standard_normal(len(x)) for x in Xs]
    return Xs, Ys


def _spec():
    return LMCKernelSpec.create(D=2, lmc_kernels=[RBF()], lmc_ranks=[1])


def test_coarse_sizes():
    # proportional shrink under the cap, floor of 4 per dim
    assert coarse_sizes((2504,), 4, cap=8192) == (2048,)
    assert coarse_sizes((68, 68), 5, cap=8192) == (40, 40)
    assert coarse_sizes((10,), 2, cap=8192) == (10,)  # under cap: unchanged
    c = coarse_sizes((100, 100), 2, cap=64)
    assert np.prod(c) * 2 <= 64 or c == (4, 4)


def test_coarse_artifacts_built_for_fft_groups(small_cap, rng):
    Xs, _ = _data(rng)
    spec = _spec().with_input_dim(1)
    grids, _ = make_grids(
        spec, [x.reshape(-1, 1) for x in Xs], m=[96], mode="auto"
    )
    gd = grids[0]
    assert gd.plan.mode == "fft"  # beyond the (shrunk) cap
    assert gd.coarse is not None
    assert gd.coarse.plan.mode == "dense"
    assert np.prod(gd.coarse.plan.sizes) < np.prod(gd.plan.sizes)
    pc = precond_dense_f32(grids)
    assert pc[0].plan.mode == "dense" and pc[0].WtW is not None
    fi = fine_fft_f32(grids)
    assert fi[0].plan.mode == "fft"
    assert fi[0].dists.dtype == jnp.float32


def test_precond_twin_full_resolution_under_cap(monkeypatch, rng):
    """Between DENSE_MAX_GRID and PRECOND_MAX_GRID the preconditioner
    twin keeps the EXACT fine geometry (f32-floor factor quality —
    dense mode's cap is about per-matvec cost, the preconditioner's is
    about the once-per-step f32 Cholesky)."""
    monkeypatch.setattr(grid_mod, "DENSE_MAX_GRID", 64)
    # PRECOND_MAX_GRID stays 16384: 2*100 = 200 fits
    Xs, _ = _data(rng, 60, 50)
    spec = _spec().with_input_dim(1)
    grids, _ = make_grids(
        spec, [x.reshape(-1, 1) for x in Xs], m=[96], mode="auto"
    )
    gd = grids[0]
    assert gd.plan.mode == "fft"
    assert gd.coarse.plan.sizes == gd.plan.sizes
    np.testing.assert_allclose(gd.coarse.dists, gd.dists)


def test_coarse_kski_approximates_fine(small_cap, rng):
    """The coarse operator is a spectrally-close approximation of the
    fine operator (what makes it a good preconditioner)."""
    Xs, _ = _data(rng, 80, 60)
    spec = _spec().with_input_dim(1)
    params = spec.init_raw_params()
    grids, _ = make_grids(
        spec, [x.reshape(-1, 1) for x in Xs], m=[96], mode="fft"
    )
    K_fine = build_kski(spec, params, grids, [80, 60])
    params32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    K_coarse = build_kski(
        spec, params32, precond_dense_f32(grids), [80, 60]
    )
    v = rng.standard_normal(140)
    a = np.asarray(K_fine.matvec(jnp.asarray(v)))
    b = np.asarray(K_coarse.matvec(jnp.asarray(v, dtype=jnp.float32)))
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert rel < 0.05, rel


@pytest.mark.parametrize("mode", ["fft", "tiled"])
def test_large_grid_certified_prediction(small_cap, rng, mode):
    """End-to-end beyond-cap model: training runs, prediction solves
    certify TRUE residuals below tolerance through the coarse
    preconditioner, and quality matches the dense-trained model."""
    Xs, Ys = _data(rng)
    m = InterpolatedLLGP(
        Xs, Ys, functional_kernel=_spec(), m=[96], seed=1, grid_mode=mode
    )
    assert m.objective == "stochastic"  # fft/tiled grids can't go exact
    assert np.prod(m.precond_data32[0].plan.sizes) < np.prod(
        m.grid_data[0].plan.sizes
    )
    m.optimize(optimizer=AdaDelta(max_it=8))
    tx = [np.linspace(0.1, 0.9, 30)] * 2
    mus, vs = m.predict(tx)
    worst = max(d["residual"] for d in m.prediction_report.values())
    assert worst <= m.tolerance, m.prediction_report
    assert all(np.all(np.asarray(v) >= 0) for v in vs)
    # sane quality after only 8 iterations: clearly beats predicting
    # the mean (full-convergence quality is covered by the bench
    # --validate smoke)
    f = np.sin(8 * tx[0])
    smse = np.mean((np.asarray(mus[0]) - f) ** 2) / np.var(f)
    assert smse < 0.6, smse


def test_tiled_matches_fft_solves(small_cap, rng):
    """'tiled' (exact first-row contraction) and 'fft' (Fourier) fine
    operators give the same certified solutions on CPU f64."""
    Xs, Ys = _data(rng, 120, 90)
    sols = {}
    for mode in ("fft", "tiled"):
        m = InterpolatedLLGP(
            Xs, Ys, functional_kernel=_spec(), m=[96], seed=1,
            grid_mode=mode,
        )
        sols[mode] = np.asarray(m._alpha())
    np.testing.assert_allclose(sols["fft"], sols["tiled"], atol=1e-5)


@pytest.mark.parametrize("mode", ["fft", "tiled"])
def test_training_escalation_fires_and_certifies(small_cap, rng, mode,
                                                 caplog):
    """Inject ill-conditioning (tiny noise) so the plain chunk solves
    stall above tolerance, then assert the rescue re-run fires and
    brings the worst chunk residual below tolerance (round-3 verdict
    item 2; reference behavior to beat: iterative.py:54-58 logs
    CRITICAL and moves on). 'fft' exercises the rung-1 in-program
    rescue; 'tiled' models skip straight to the rung-2 certified
    ladder (the rung-1 gather path is O(m^2) per matvec there)."""
    import logging

    from runlmc_tpu.params import POSITIVE

    Xs, Ys = _data(rng)
    m = InterpolatedLLGP(
        Xs, Ys, functional_kernel=_spec(), m=[96], seed=1, grid_mode=mode
    )
    params = dict(m.params)
    params["noise"] = jnp.asarray(
        POSITIVE.inverse(2e-5 * np.ones(2)), dtype=m.dtype
    )
    m.set_params(params)
    with caplog.at_level(logging.WARNING):
        info = m.optimize(optimizer=AdaDelta(max_it=4))
    assert info["rescued_chunks"] >= 1, "escalation did not fire"
    assert info["max_solve_error"] <= m.tolerance, info


def test_f32_diff_gradient_accuracy(small_cap, rng):
    """The beyond-cap training step computes its gradient through the
    f32 fft fine twin (``diff_data``) instead of the model-dtype tiled
    operator (whose scatter-add backward dominated the weather m=2500
    step). With identical probes and solves, the f32-diff gradient must
    agree with the f64 gradient to far below the 15-probe estimator's
    own noise band (0.6-10%, reference grad-grid artifacts)."""
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from runlmc_tpu.lmc import likelihood as lk

    Xs, Ys = _data(rng, 120, 90)
    spec = _spec().with_input_dim(1)
    params = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64), spec.init_raw_params(seed=3)
    )
    grids_host, _ = make_grids(
        spec, [x.reshape(-1, 1) for x in Xs], m=[96], mode="fft"
    )
    lens = tuple(len(x) for x in Xs)
    grids = tuple(
        gd.replace(coarse=None, dists=jnp.asarray(gd.dists))
        for gd in grids_host
    )
    fine32 = fine_fft_f32(grids_host)
    y = jnp.asarray(np.concatenate(Ys))
    probes = lk.rademacher_probes(
        jax.random.PRNGKey(0), 8, len(y), jnp.float64
    )

    def grad_of(diff_data):
        def obj(p):
            s, _ = lk.stochastic_mll_surrogate(
                spec, p, grids, lens, y, probes, tol=1e-6,
                diff_data=diff_data,
            )
            return -s

        g = jax.grad(obj)(params)
        flat, _ = ravel_pytree(g)
        return np.asarray(flat)

    g64 = grad_of(None)
    g32 = grad_of(fine32)
    assert g32.dtype == np.float64  # upcast through the parameter cast
    rel = np.linalg.norm(g64 - g32) / np.linalg.norm(g64)
    assert rel < 1e-3, rel
    cos = g64 @ g32 / (np.linalg.norm(g64) * np.linalg.norm(g32))
    assert cos > 0.99999, cos


def test_rung2_certified_rescue_steps(small_cap, rng):
    """RUNG-2 training rescue: breached chunk steps re-run with
    certified-ladder solves land below tolerance and the re-run
    preserves the chunk layout (prefix untouched, AdaDelta update
    replayed from the breach point)."""
    import jax.numpy as jnp

    from runlmc_tpu.params import POSITIVE

    Xs, Ys = _data(rng)
    m = InterpolatedLLGP(
        Xs, Ys, functional_kernel=_spec(), m=[96], seed=1, grid_mode="fft"
    )
    params = dict(m.params)
    params["noise"] = jnp.asarray(
        POSITIVE.inverse(2e-5 * np.ones(2)), dtype=m.dtype
    )
    m.set_params(params)
    x0 = jnp.asarray(m.param_array, dtype=m.dtype)
    z = jnp.zeros_like(x0)
    hp = jnp.asarray([1.0, 0.9, 0.5, 1e-4], dtype=m.dtype)
    key = jax.random.PRNGKey(7)
    plain = jax.device_get(m._jit_chunk(
        x0, z, z, z, key, jnp.asarray(0, jnp.int32), hp,
        m.grid_data, m.precond_data32, m.inner_data32, m.y,
        n_steps=3,
    ))
    # make sure the scenario is real: at least one step breaches
    errs = np.asarray(plain[6], dtype=float)
    assert np.any(errs > m.tolerance), errs
    x_before = m.param_array.copy()
    out = m._rescue_steps_certified(
        (x0, z, z, z), plain, 0, hp, key
    )
    assert all(len(np.asarray(o)) == 3 for o in out)
    assert np.max(out[6]) <= m.tolerance, out[6]
    j0 = int(np.argmax(errs > m.tolerance))
    if j0 > 0:  # prefix of certified steps is preserved verbatim
        np.testing.assert_array_equal(
            np.asarray(out[0][:j0]), np.asarray(plain[0][:j0])
        )
    # model params restored after the rescue
    np.testing.assert_array_equal(m.param_array, x_before)


def test_rescue_keeps_plain_result_when_better(small_cap, rng):
    """Healthy conditioning: no rescue, residuals already certify."""
    Xs, Ys = _data(rng)
    m = InterpolatedLLGP(
        Xs, Ys, functional_kernel=_spec(), m=[96], seed=1,
        grid_mode="fft", tolerance=1e-2,
    )
    info = m.optimize(optimizer=AdaDelta(max_it=4))
    assert info["rescued_chunks"] == 0
    assert info["max_solve_error"] <= 1e-2
