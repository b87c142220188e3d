"""Calibration of the exact-objective residual diagnostic.

The exact training objective differentiates through a float32 Woodbury
factorization; its aux.solve_error (relative residual of the factorized
solve against the exact operator) is the per-step quality diagnostic.
This test SWEEPS conditioning (via the noise level) and measures how
gradient quality — cosine and relative error of the f32 exact gradient
against the f64 exact-SKI gradient — degrades with that residual. The
production warning/escalation threshold
(InterpolatedLLGP.EXACT_RESIDUAL_THRESHOLD) is derived from the cliff
this test observes: below the threshold the f32 gradient direction is
reliable (cosine >= 0.995, far tighter than the reference's own
15-probe stochastic estimator, whose relative error runs 0.005-0.1 —
reference benchmarks/grad-grid/out/extracted_summary.csv); above it the
factorization is degrading and the trainer escalates precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from runlmc_tpu import InterpolatedLLGP, LMCKernelSpec, RBF, config
from runlmc_tpu.models.interpolated_llgp import EXACT_RESIDUAL_THRESHOLD
from runlmc_tpu.params import POSITIVE


def _models(rng, n=50):
    Xs = [np.sort(rng.uniform(0, 2 * np.pi, (n, 1)), axis=0)
          for _ in range(2)]
    Ys = [np.sin(X[:, 0]) + 0.05 * rng.standard_normal(n) for X in Xs]
    spec = LMCKernelSpec.create(
        D=2, lmc_kernels=[RBF(name="k")], lmc_ranks=[1]
    )
    m32 = InterpolatedLLGP(
        Xs, Ys, functional_kernel=spec, m=[20], seed=2,
        objective="exact", exact_precision="f32",
    )
    m64 = InterpolatedLLGP(
        Xs, Ys, functional_kernel=spec, m=[20], seed=2,
        objective="exact", exact_precision="model",
    )
    return m32, m64


def _grad_at_noise(model, noise):
    params = dict(model.params)
    params["noise"] = jnp.asarray(
        POSITIVE.inverse(noise * np.ones(2)), dtype=model.dtype
    )
    model.set_params(params)
    x = jnp.asarray(model.param_array, dtype=model.dtype)
    g, aux = model._jit_grad(
        x, jax.random.PRNGKey(0), model.grid_data, model.precond_data32,
        model.inner_data32, model.y,
    )
    return np.asarray(g), float(aux.solve_error)


def test_residual_vs_gradient_quality(rng):
    """The calibration sweep: across 6 orders of magnitude of noise
    (hence conditioning), every configuration whose f32 residual
    certifies below EXACT_RESIDUAL_THRESHOLD has an f32 gradient within
    cosine 0.995 and 10% norm of the f64 exact gradient."""
    m32, m64 = _models(rng)
    rows = []
    for noise in [1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6]:
        g32, res32 = _grad_at_noise(m32, noise)
        g64, res64 = _grad_at_noise(m64, noise)
        assert res64 < 1e-6  # the f64 factorization is the oracle here
        cos = float(
            g32 @ g64 / (np.linalg.norm(g32) * np.linalg.norm(g64))
        )
        rel = float(
            np.linalg.norm(g32 - g64) / np.linalg.norm(g64)
        )
        rows.append((noise, res32, cos, rel))

    certified = [r for r in rows if r[1] <= EXACT_RESIDUAL_THRESHOLD]
    # the sweep must actually exercise both sides of the threshold
    assert len(certified) >= 3, rows
    for noise, res, cos, rel in certified:
        assert cos >= 0.995, (noise, res, cos, rel)
        assert rel <= 0.10, (noise, res, cos, rel)


def test_residual_grows_with_conditioning(rng):
    """Sanity: the residual diagnostic actually responds to
    conditioning — tiny noise must produce a larger f32 residual than
    healthy noise (otherwise the diagnostic certifies nothing)."""
    m32, _ = _models(rng)
    _, res_easy = _grad_at_noise(m32, 1e-1)
    _, res_hard = _grad_at_noise(m32, 1e-6)
    assert res_hard > res_easy


def test_illconditioned_prediction_certifies(rng):
    """Prediction on a near-singular model (noise 1e-6, conditioning
    ~1e9 — past the f32 factorization's reliability) must still
    certify its solve residuals below tolerance by escalating through
    the preconditioner ladder (f32 Woodbury-PCG -> model-dtype
    Woodbury-PCG), with no zero-clamped variances from broken solves."""
    m32, _ = _models(rng)
    params = dict(m32.params)
    params["noise"] = jnp.asarray(
        POSITIVE.inverse(1e-6 * np.ones(2)), dtype=m32.dtype
    )
    m32.set_params(params)
    Xt = [np.linspace(0.5, 5.5, 25)[:, None]] * 2
    mus, vs = m32.predict(Xt)
    rep = m32.prediction_report
    # the observation solve rides inside the explained-variance batch
    assert "explained-variance" in rep, rep
    for what, d in rep.items():
        assert d["residual"] <= m32.tolerance, (what, d)
    assert any(d["escalated"] for d in rep.values()), rep
    # a certified solve at near-zero noise means the mean accurately
    # tracks the underlying function (the broken-solve failure mode is
    # a garbage mean, not small variances — those are genuinely ~0
    # when the model interpolates)
    for mu, Xtest in zip(mus, Xt):
        assert np.abs(mu - np.sin(Xtest[:, 0])).mean() < 0.25
    assert all(np.all(v >= 0) for v in vs)


def test_auto_objective_probe(rng, monkeypatch):
    """objective='auto' probes the f32 factorization residual at the
    initial parameters: certifying problems get the exact objective;
    when the probe exceeds the threshold (forced here by shrinking the
    threshold; organically hit by e.g. weather's m=500 grid at ~0.27),
    training falls back to the always-sound stochastic objective."""
    import runlmc_tpu.models.interpolated_llgp as mod

    Xs = [np.sort(rng.uniform(0, 2 * np.pi, (40, 1)), axis=0)
          for _ in range(2)]
    Ys = [np.sin(X[:, 0]) + 0.05 * rng.standard_normal(40) for X in Xs]
    spec = LMCKernelSpec.create(
        D=2, lmc_kernels=[RBF(name="k")], lmc_ranks=[1]
    )
    m = InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[16], seed=1)
    assert m.objective == "exact"  # well-conditioned: probe certifies

    monkeypatch.setattr(mod, "EXACT_RESIDUAL_THRESHOLD", 1e-12)
    m2 = InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[16], seed=1)
    assert m2.objective == "stochastic"  # probe cannot certify


def test_escalation_on_bad_residual(rng):
    """When a chunk's worst residual exceeds the threshold, training
    auto-escalates to exact_precision='model' and finishes with
    certified residuals (the advisor's round-2 medium finding: the
    user tolerance must actually drive exact-mode accuracy)."""
    from runlmc_tpu import AdaDelta

    m32, _ = _models(rng)
    params = dict(m32.params)
    params["noise"] = jnp.asarray(
        POSITIVE.inverse(1e-6 * np.ones(2)), dtype=m32.dtype
    )
    m32.set_params(params)
    _, res = _grad_at_noise(m32, 1e-6)
    if res <= EXACT_RESIDUAL_THRESHOLD:
        pytest.skip("1e-6 noise did not break f32 on this platform")
    info = m32.optimize(optimizer=AdaDelta(max_it=4))
    assert m32.exact_precision == "model"
    assert info["n_iter"] == 4


def test_escalation_targets_stochastic_without_native_f64(
    rng, monkeypatch
):
    """On platforms without native f64 factorization
    (config.native_f64 false), escalation retargets the stochastic
    objective — whose model-dtype Krylov solves self-refine using the
    f32 factor as preconditioner — instead of a model-dtype
    factorization."""
    from runlmc_tpu import AdaDelta

    m32, _ = _models(rng)
    params = dict(m32.params)
    params["noise"] = jnp.asarray(
        POSITIVE.inverse(1e-6 * np.ones(2)), dtype=m32.dtype
    )
    m32.set_params(params)
    _, res = _grad_at_noise(m32, 1e-6)
    if res <= EXACT_RESIDUAL_THRESHOLD:
        pytest.skip("1e-6 noise did not break f32 on this platform")
    monkeypatch.setattr(config, "native_f64", lambda platform=None: False)
    info = m32.optimize(optimizer=AdaDelta(max_it=14))
    assert m32.objective == "stochastic"
    assert info["n_iter"] == 14
    # post-escalation chunks ran the Krylov path (iteration counts
    # appear; the forced cond~1e9 system is beyond ANY solver at
    # maxiter=n — reference parity is to log and continue)
    assert info["mean_solve_iters"] > 0
    assert np.all(np.isfinite(m32.param_array))


def test_equilibration_flip_keeps_exact_objective(rng, monkeypatch):
    """Before demoting exact -> stochastic on a mid-training residual
    breach, the escalation ladder probes the factorization with the
    Jacobi equilibration FLIPPED at the current parameters: which mode
    preserves more f32 digits depends on the matrix's grading
    (measured on synth run 1: 0.35 equilibrated vs a 0.081 flipped
    probe at the same parameters). A certifying flipped probe keeps the exact
    objective (at ~20x less per-step cost than the stochastic Krylov
    demotion target); the probe result is faked here to isolate the
    ladder's control flow from platform numerics."""
    import runlmc_tpu.lmc.likelihood as lklh
    import runlmc_tpu.lmc.woodbury as wb
    from runlmc_tpu import AdaDelta

    m32, _ = _models(rng)
    params = dict(m32.params)
    params["noise"] = jnp.asarray(
        POSITIVE.inverse(1e-6 * np.ones(2)), dtype=m32.dtype
    )
    m32.set_params(params)
    _, res = _grad_at_noise(m32, 1e-6)
    if res <= EXACT_RESIDUAL_THRESHOLD:
        pytest.skip("1e-6 noise did not break f32 on this platform")
    monkeypatch.setattr(config, "native_f64", lambda platform=None: False)
    flipped = not wb.EQUILIBRATE_DEFAULT
    real = lklh.f32_factorization_residual
    calls = []

    def fake(spec, raw_params, gd32, lens, y, equilibrate=None):
        calls.append(equilibrate)
        if equilibrate == flipped:
            return jnp.asarray(1e-6, jnp.float32)
        return real(spec, raw_params, gd32, lens, y,
                    equilibrate=equilibrate)

    monkeypatch.setattr(lklh, "f32_factorization_residual", fake)
    # max_it=4 -> a single chunk: the breach fires once, the flipped
    # probe certifies, and training ends still on the exact objective
    info = m32.optimize(optimizer=AdaDelta(max_it=4))
    assert flipped in calls  # the ladder actually probed the flip
    assert m32.objective == "exact"
    assert m32._equilibrate == flipped
    assert m32._equilibrate_flip_tried
    assert info["n_iter"] == 4


def test_auto_probe_tries_flipped_equilibration(rng, monkeypatch):
    """objective='auto' whose default-mode probe breaches tries the
    equilibration-flipped probe before settling on stochastic; a
    certifying flip selects the exact objective with that mode."""
    import runlmc_tpu.lmc.likelihood as lklh
    import runlmc_tpu.lmc.woodbury as wb

    Xs = [np.sort(rng.uniform(0, 2 * np.pi, (40, 1)), axis=0)
          for _ in range(2)]
    Ys = [np.sin(X[:, 0]) + 0.05 * rng.standard_normal(40) for X in Xs]
    spec = LMCKernelSpec.create(
        D=2, lmc_kernels=[RBF(name="k")], lmc_ranks=[1]
    )
    flipped = not wb.EQUILIBRATE_DEFAULT

    def fake(spec_, raw_params, gd32, lens, y, equilibrate=None):
        return jnp.asarray(
            1e-6 if equilibrate == flipped else 1.0, jnp.float32
        )

    monkeypatch.setattr(lklh, "f32_factorization_residual", fake)
    m = InterpolatedLLGP(
        Xs, Ys, functional_kernel=spec, m=[16], seed=1,
        objective="auto",
    )
    assert m.objective == "exact"
    assert m._equilibrate == flipped
    assert m._equilibrate_flip_tried
