"""Multi-device sharding tests on the virtual 8-device CPU mesh: the
PRODUCT training path (InterpolatedLLGP.optimize with a mesh — probes /
solve batch sharded over the 'probe' axis) and the driver entry points.
The mesh replaces the reference's multiprocessing pool over independent
scipy solves (runlmc/lmc/stochastic_deriv.py:51-52)."""

import jax
import jax.numpy as jnp
import numpy as np

from runlmc_tpu import AdaDelta, InterpolatedLLGP, LMCKernelSpec, RBF
from runlmc_tpu.parallel.mesh import default_mesh


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    g = jax.tree.leaves(out)[0]
    assert np.all(np.isfinite(np.asarray(g)))


def _sincos_model(rng, mesh=None, n=40, tolerance=1e-4,
                  objective="stochastic"):
    Xs = [np.sort(rng.uniform(0, 2 * np.pi, (n, 1)), axis=0)
          for _ in range(2)]
    Ys = [np.sin(X[:, 0]) + 0.05 * rng.standard_normal(n) for X in Xs]
    spec = LMCKernelSpec.create(
        D=2, lmc_kernels=[RBF(name="k")], lmc_ranks=[1]
    )
    return InterpolatedLLGP(
        Xs, Ys, functional_kernel=spec, m=[16], seed=1, mesh=mesh,
        trace_iterations=16, tolerance=tolerance, objective=objective,
    )


def test_mesh_training_matches_single_device(rng):
    """Sharding the solve batch over 8 devices is a layout change, not
    a numerical one. With a tight solver tolerance (so per-row early
    stopping can't introduce tolerance-level iterate differences that
    depend on the local batch composition), the trained parameters
    must match the meshless run."""
    seed_state = rng.bit_generator.state

    rng.bit_generator.state = seed_state
    m1 = _sincos_model(rng, mesh=None, tolerance=1e-11)
    info1 = m1.optimize(optimizer=AdaDelta(max_it=12))

    rng.bit_generator.state = seed_state
    mesh = default_mesh(8, axis_name="probe")
    m8 = _sincos_model(rng, mesh=mesh, tolerance=1e-11)
    info8 = m8.optimize(optimizer=AdaDelta(max_it=12))

    assert info1["n_iter"] == info8["n_iter"]
    np.testing.assert_allclose(
        m1.param_array, m8.param_array, rtol=1e-6, atol=1e-8
    )


def test_probe_grid_mesh_training_matches_single_device(rng):
    """2-D mesh ('probe', 'grid'): probes shard over 'probe', fft-mode
    Fourier axes over 'grid'; still a pure layout change."""
    from runlmc_tpu.parallel.mesh import probe_grid_mesh

    def build(rng, mesh):
        Xs = [np.sort(rng.uniform(0, 2 * np.pi, (40, 1)), axis=0)
              for _ in range(2)]
        Ys = [np.sin(X[:, 0]) + 0.05 * rng.standard_normal(40)
              for X in Xs]
        spec = LMCKernelSpec.create(
            D=2, lmc_kernels=[RBF(name="k")], lmc_ranks=[1]
        )
        return InterpolatedLLGP(
            Xs, Ys, functional_kernel=spec, m=[16], seed=1, mesh=mesh,
            trace_iterations=16, tolerance=1e-11, grid_mode="fft",
        )

    seed_state = rng.bit_generator.state
    rng.bit_generator.state = seed_state
    m1 = build(rng, None)
    info1 = m1.optimize(optimizer=AdaDelta(max_it=8))

    rng.bit_generator.state = seed_state
    m24 = build(rng, probe_grid_mesh(2, 4))
    info24 = m24.optimize(optimizer=AdaDelta(max_it=8))

    assert info1["n_iter"] == info24["n_iter"]
    np.testing.assert_allclose(
        m1.param_array, m24.param_array, rtol=1e-6, atol=1e-8
    )
    mus, _ = m24.predict([np.linspace(1, 5, 7)[:, None]] * 2)
    assert all(np.all(np.isfinite(mu)) for mu in mus)


def test_mesh_exact_objective_matches_single_device(rng):
    """The exact-objective training step (per-step f32 Woodbury
    factorization, no probe batch) shards its DATA axis over the mesh:
    the per-output interpolation-block contractions partition over
    data rows with psums. Sharding only reorders f32 reductions, so
    trained parameters agree to f32-accumulation tolerance."""
    seed_state = rng.bit_generator.state

    rng.bit_generator.state = seed_state
    m1 = _sincos_model(rng, mesh=None, objective="exact")
    assert m1.objective == "exact"
    info1 = m1.optimize(optimizer=AdaDelta(max_it=8))

    rng.bit_generator.state = seed_state
    mesh = default_mesh(8, axis_name="probe")
    m8 = _sincos_model(rng, mesh=mesh, objective="exact")
    info8 = m8.optimize(optimizer=AdaDelta(max_it=8))

    assert info1["n_iter"] == info8["n_iter"]
    # pure f32 reduction-reorder drift, compounded over 8 steps
    np.testing.assert_allclose(
        m1.param_array, m8.param_array, rtol=5e-3, atol=1e-4
    )
    mus, _ = m8.predict([np.linspace(1, 5, 7)[:, None]] * 2)
    assert all(np.all(np.isfinite(mu)) for mu in mus)


def test_mesh_prediction_runs(rng):
    mesh = default_mesh(8, axis_name="probe")
    m8 = _sincos_model(rng, mesh=mesh)
    m8.optimize(optimizer=AdaDelta(max_it=5))
    Xt = [np.linspace(0.5, 5.5, 9)[:, None]] * 2
    mus, vars_ = m8.predict(Xt)
    assert all(np.all(np.isfinite(mu)) for mu in mus)
    assert all(np.all(v >= 0) for v in vars_)


def test_chunked_adadelta_matches_per_step(rng):
    """minimize_chunked must replay the per-step optimizer exactly when
    fed the same gradient stream."""
    from runlmc_tpu.models.optimization import AdaDelta as AD

    dim = 5
    grads = [rng.standard_normal(dim) for _ in range(30)]

    calls = []

    def fprime(x):
        calls.append(np.array(x))
        return grads[len(calls) - 1]

    opt = AD(max_it=17)
    x_ref, info_ref = opt.minimize(np.zeros(dim), fprime)

    # chunked oracle: replay the same update rule on device in chunks
    def run_chunk(x, gms, sms, step, start_iter):
        xs, gmss, smss, steps, gns = [], [], [], [], []
        x, gms, sms, step = map(np.array, (x, gms, sms, step))
        for j in range(4):  # chunk length 4
            i = start_iter + j
            g = grads[i] if i < len(grads) else np.zeros(dim)
            step1 = opt.momentum * step
            x1 = x - step1
            gms = opt.decay * gms + (1 - opt.decay) * g**2
            step2 = (
                np.sqrt(sms + opt.offset)
                / np.sqrt(gms + opt.offset) * g * opt.step_rate
            )
            x = x1 - step2
            step = step1 + step2
            sms = opt.decay * sms + (1 - opt.decay) * step**2
            xs.append(x.copy()); gmss.append(gms.copy())
            smss.append(sms.copy()); steps.append(step.copy())
            gns.append(np.max(np.abs(g)))
        return (np.stack(xs), np.stack(gmss), np.stack(smss),
                np.stack(steps), np.asarray(gns))

    opt2 = AD(max_it=17)
    x_chunk, info_chunk = opt2.minimize_chunked(np.zeros(dim), run_chunk)
    assert info_ref["n_iter"] == info_chunk["n_iter"]
    np.testing.assert_allclose(x_chunk, x_ref, rtol=1e-12)


def test_chunked_stop_probe_semantics(rng):
    """minimize_chunked hands the oracle a stop_probe that replays the
    stopping rule over a prefix of certified grad norms — the oracle
    uses it to skip rescue work on breached steps past the stop point.
    The probe must agree exactly with where the optimizer actually
    stops."""
    from runlmc_tpu.models.optimization import AdaDelta as AD

    dim = 3
    # gradient norms engineered so the rule stops mid-chunk: large
    # norms then tiny ones (each tiny one burns a permitted drop)
    norms = [10.0, 9.0, 8.0, 0.1, 0.1, 0.1, 0.1, 0.1, 5.0, 5.0]
    probes_seen = []

    def run_chunk(x, gms, sms, step, start_iter, stop_probe=None):
        ln = 5
        gns = np.asarray(norms[start_iter:start_iter + ln])
        # record what the probe predicts for the full chunk prefix
        probes_seen.append(stop_probe(gns))
        zeros = np.zeros((len(gns), dim))
        return zeros, zeros, zeros, zeros, gns

    opt = AD(max_it=100, permitted_drops=5, min_grad_ratio=0.1)
    _, info = opt.minimize_chunked(np.zeros(dim), run_chunk)
    # drops: norms 0.1 < 0.1*10 = 1.0 burn drops at iters 4..8 (1-based)
    # -> 5th drop at global iter 8 = chunk 2 index 2
    assert info["n_iter"] == 8
    assert probes_seen[0] is None  # first chunk: no stop in its norms
    assert probes_seen[1] == 2  # second chunk stops at its index 2
    assert len(probes_seen) == 2


def test_pad_and_shard_batch(rng):
    from runlmc_tpu.parallel.mesh import pad_batch, shard_batch

    b = rng.standard_normal((5, 7))
    padded, orig = pad_batch(b, 8)
    assert padded.shape == (8, 7) and orig == 5
    np.testing.assert_allclose(padded[:5], b)

    mesh = default_mesh(8, axis_name="probe")
    sharded = shard_batch(jnp.asarray(padded), mesh)
    assert len(sharded.sharding.device_set) == 8


def test_grid_only_mesh_runs(rng):
    """A single-axis mesh named 'grid' shards grid-sized tensors via
    GSPMD constraints inside the operator — the RHS batch must NOT be
    shard_mapped over that axis (with_sharding_constraint cannot appear
    in a shard_map body; regression for the round-2 advisor finding)."""
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()), ("grid",))
    m = _sincos_model(rng, mesh=mesh)
    assert m._rhs_sharding is None
    info = m.optimize(optimizer=AdaDelta(max_it=4))
    assert info["n_iter"] == 4
    mus, vs = m.predict([np.linspace(1, 5, 7)[:, None]] * 2)
    assert all(np.all(np.isfinite(mu)) for mu in mus)


def test_initialize_single_host_noop(rng, monkeypatch):
    """parallel.initialize() without a coordinator must be a no-op (the
    degenerate single-host mode of the multi-host launch recipe)."""
    import runlmc_tpu.parallel as par

    monkeypatch.delenv("COORD", raising=False)
    monkeypatch.delenv("NPROC", raising=False)
    assert par.initialize() is False
    assert par.is_distributed() is False
    mesh = par.global_mesh(axis_name="probe")
    assert mesh.axis_names == ("probe",)
    assert mesh.devices.size == len(jax.devices())
    mesh2 = par.global_mesh(axis_name="probe", grid_axis=4)
    assert mesh2.axis_names == ("probe", "grid")
    assert mesh2.shape["grid"] == 4


def test_mesh_exact_objective_really_partitions(rng):
    """The sharded exact-objective gradient program must contain
    cross-device collectives (psum of the data-sharded gram
    contractions) — i.e., the mesh genuinely partitions the data axis
    instead of replicating the whole computation."""
    mesh = default_mesh(8, axis_name="probe")
    m8 = _sincos_model(rng, mesh=mesh, objective="exact")
    import jax.numpy as jnp

    x = jnp.asarray(m8.param_array, dtype=m8.dtype)
    key = jax.random.PRNGKey(0)
    lowered = m8._jit_grad.lower(
        x, key, m8.grid_data, m8.precond_data32, m8.inner_data32, m8.y
    )
    hlo = lowered.compile().as_text()
    assert ("all-reduce" in hlo) or ("reduce-scatter" in hlo), (
        "no collectives in the sharded exact-objective program"
    )
