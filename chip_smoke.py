"""Smoke test of InterpolatedLLGP's fit/predict path on a GPU.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python chip_smoke.py                 # phases 1-3, one device
    python chip_smoke.py --only fx2007   # one phase (repeatable)
    python chip_smoke.py --four          # mesh phase only, four devices

Phases, on data generated from ``--seed`` at the published shapes:

1. ``fx2007``: exact objective on the dense grid (D=13, n=3054, m=234).
   Checks the f32 Woodbury MLL and the prediction solve against a host
   numpy float64 reference built from the same SKI matrix, and an f32
   operator matvec against the f64 one (a TF32 canary).
2. ``weather``: stochastic objective on the dense grid (D=4, n=15,789,
   m=500). Checks certified prediction residuals and finite outputs.
3. ``beyond-cap``: the weather shape at m=2500, past DENSE_MAX_GRID:
   f64 FFT grid matvec against the FFT-free 'tiled' contraction, then
   training and certified prediction.
4. ``--four``: the phase-1 model sharded over a 4-device 'probe' mesh and
   the phase-3 model over a 2x2 ('probe', 'grid') mesh, each against the
   same model on one device.

Every phase prints one JSON line (seconds, peak device memory, checks
with values and tolerances). The first line names the card and its
power limit as ``nvidia-smi`` reports them. The last line of a passing
run is ``{"ok": true, "device": {...}}``; a failed check ends the run
with a non-zero exit before it. Without a GPU the script exits non-zero
at once.
"""

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np

# fx2007: 13 currencies over the 251 trading days of 2007; three outputs
# have 50-day holdout windows (the CAD/JPY/AUD windows of the published
# protocol), and ragged drops bring the training set to 3054 points.
FX_D = 13
FX_DAYS = 251
FX_HOLDOUTS = {0: (49, 99), 1: (99, 149), 2: (149, 199)}
FX_DROPS = 59
FX_M = 234

# weather: 4 air-temperature sensors sampled every 5 minutes over 15.5
# days, 15,789 training points in all; sensors 1 and 2 hold out a time
# window each.
WEATHER_N = (3948, 3947, 3947, 3947)
WEATHER_DAYS = 15.5
WEATHER_HOLDOUTS = {1: (10.2, 10.8), 2: (13.5, 14.2)}
WEATHER_M = 500
BEYOND_CAP_M = 2500

MLL_RTOL = 1e-3  # f32 Woodbury factorization's error budget
CANARY_RTOL = 1e-5  # full-f32 matvec; TF32 products give ~1e-3
FFT_RTOL = 1e-10  # f64 FFT against the f64 tiled contraction
MESH_EXACT_RTOL = 1e-8  # no Krylov solve: only psum order differs
MESH_KRYLOV_RTOL = 1e-4  # Krylov stopping may shift by an iteration


# --------------------------------------------------------------------------
# Seeded data at the published shapes
# --------------------------------------------------------------------------


def fx2007_data(seed, D=FX_D, n_drops=FX_DROPS):
    """FX-like series: ``D`` outputs over FX_DAYS integer days, mixing
    two shared random-walk factors into per-currency log rates. Returns
    ``(xss, yss, test_xss, test_yss)``; outputs in FX_HOLDOUTS lose
    their window to the test set, and ``n_drops`` other points are
    dropped at random (missing quotes)."""
    rng = np.random.default_rng(seed)
    days = np.arange(FX_DAYS, dtype=float)
    factors = 0.01 * np.cumsum(rng.standard_normal((2, FX_DAYS)), axis=1)
    own = 0.003 * np.cumsum(rng.standard_normal((D, FX_DAYS)), axis=1)
    levels = np.exp(rng.uniform(-5.0, 1.0, D))
    Y = levels[:, None] * np.exp(rng.standard_normal((D, 2)) @ factors + own)
    test = np.zeros((D, FX_DAYS), dtype=bool)
    for d, (lo, hi) in FX_HOLDOUTS.items():
        if d < D:
            test[d, lo:hi] = True
    keep = ~test
    keep.flat[rng.choice(np.flatnonzero(keep), n_drops, replace=False)] = False
    xss = [days[keep[d]] for d in range(D)]
    yss = [Y[d, keep[d]] for d in range(D)]
    test_xss = [days[test[d]] for d in range(D)]
    test_yss = [Y[d, test[d]] for d in range(D)]
    return xss, yss, test_xss, test_yss


def weather_data(seed, n_train=WEATHER_N):
    """Temperature-like series: a shared daily cycle and slow trend plus
    per-sensor offsets and noise, on a 5-minute lattice over
    WEATHER_DAYS days. Sensor ``d`` keeps ``n_train[d]`` lattice points
    outside its holdout window; the window's points, thinned at the
    same rate, form its test set. Returns ``(xss, yss, test_xss,
    test_yss)``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(WEATHER_DAYS * 288)) / 288.0
    trend = np.cumsum(rng.standard_normal(t.size)) * 0.02
    xss, yss, test_xss, test_yss = [], [], [], []
    for d, n in enumerate(n_train):
        y = (
            15.0 + rng.normal(0.0, 2.0) + trend
            + 4.0 * np.sin(2 * np.pi * t + rng.uniform(0, 0.5))
            + 0.3 * rng.standard_normal(t.size)
        )
        lo, hi = WEATHER_HOLDOUTS.get(d, (np.inf, np.inf))
        held = (t >= lo) & (t <= hi)
        avail = np.flatnonzero(~held)
        tr = np.sort(rng.choice(avail, n, replace=False))
        n_te = int(round(held.sum() * n / avail.size))
        te = np.sort(rng.choice(np.flatnonzero(held), n_te, replace=False))
        xss.append(t[tr])
        yss.append(y[tr])
        test_xss.append(t[te])
        test_yss.append(y[te])
    return xss, yss, test_xss, test_yss


# --------------------------------------------------------------------------
# Models at the published specs
# --------------------------------------------------------------------------


def fx2007_model(seed, D=FX_D, m=FX_M, mesh=None, **kwargs):
    """Q=1 rank-2 RBF LMC, exact objective (bench.py's fx2007 spec)."""
    from runlmc_tpu import RBF, InterpolatedLLGP, LMCKernelSpec

    xss, yss, test_xss, test_yss = fx2007_data(seed, D=D)
    spec = LMCKernelSpec.create(
        D=D, lmc_kernels=[RBF(name="rbf0")], lmc_ranks=[2]
    )
    model = InterpolatedLLGP(
        xss, yss, functional_kernel=spec, m=[m], normalize=True,
        objective="exact", seed=seed, mesh=mesh, **kwargs,
    )
    return model, test_xss


def weather_model(seed, m=WEATHER_M, n_train=WEATHER_N, mesh=None):
    """SLFM rank 2 plus a frozen-scale RBF per sensor, stochastic
    objective (bench.py's weather spec)."""
    from runlmc_tpu import RBF, InterpolatedLLGP, LMCKernelSpec, Scaled

    xss, yss, test_xss, test_yss = weather_data(seed, n_train)
    spec = LMCKernelSpec.create(
        D=len(xss),
        slfm_kernels=[RBF(name="slfm0"), RBF(name="slfm1")],
        indep_gp=[
            Scaled(inner=RBF(name="rbf%d" % i), trainable_scale=False)
            for i in range(len(xss))
        ],
    )
    model = InterpolatedLLGP(
        xss, yss, functional_kernel=spec, m=[m], normalize=True,
        objective="stochastic", seed=seed, mesh=mesh,
    )
    return model, test_xss


# --------------------------------------------------------------------------
# Host float64 reference
# --------------------------------------------------------------------------


def _softplus(x):
    return np.logaddexp(0.0, np.asarray(x, dtype=float))


def host_ski_matrix(model):
    """K = W K_UU W^T + diag(noise) for a Q=1 RBF LMC model, in numpy
    float64 from the host-side grid and the model's raw parameters,
    with no device code: K_UU = B (x) T with B = A^T A + diag(kappa) and
    T the RBF kernel on the grid."""
    from runlmc_tpu.ops.interpolation import interp_output_blocks

    spec = model.spec
    if spec.Q != 1 or spec.kinds != ("lmc",):
        raise ValueError("host reference covers one LMC kernel only")
    A = np.asarray(model.params["coreg_vecs"]["q0"], dtype=float)
    kappa = _softplus(model.params["coreg_diags"]["q0"])
    gamma = _softplus(model.params["kernels"]["q0"]["inv_lengthscale"])
    noise = _softplus(model.params["noise"])
    B = A.T @ A + np.diag(kappa)
    (axis,) = model.grid_axes[0]
    T = np.exp(-0.5 * gamma * np.subtract.outer(axis, axis) ** 2)
    W = np.concatenate(
        interp_output_blocks([np.asarray(X) for X in model.Xs], [axis])
    )  # (n, m): output d's rows interpolate onto its own copy of the grid
    oidx = np.asarray(model.data.output_idx)
    K = (W @ T @ W.T) * B[oidx][:, oidx]
    K[np.diag_indices_from(K)] += noise[oidx]
    return K


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


class CheckFailed(Exception):
    pass


def _check(name, value, tol):
    value = float(value)
    return {"name": name, "value": value, "tol": tol,
            "ok": bool(np.isfinite(value) and value <= tol)}


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _report(phase, t0, checks, **extra):
    """Print the phase's JSON line; raise CheckFailed if a check failed."""
    line = {"phase": phase, "seconds": time.perf_counter() - t0,
            "peak_bytes": _peak_bytes(), "checks": checks, **extra}
    print(json.dumps(line), flush=True)
    failed = [c["name"] for c in checks if not c["ok"]]
    if failed:
        raise CheckFailed("%s: %s" % (phase, ", ".join(failed)))
    return line


def _chunk_memory(model):
    """memory_analysis() of the model's compiled training chunk."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(model.param_array, dtype=model.dtype)
    z = jnp.zeros_like(x)
    hp = jnp.asarray([1.0, 0.9, 0.0, 1e-4], dtype=model.dtype)
    compiled = model._jit_chunk.lower(
        x, z, z, z, jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32), hp,
        model.grid_data, model.precond_data32, model.inner_data32, model.y,
    ).compile()
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: getattr(ma, k) for k in dir(ma) if k.endswith("_in_bytes")}


def _finite(arrays):
    return all(np.all(np.isfinite(np.asarray(a))) for a in arrays)


def _certified_residual(model):
    return max(d["residual"] for d in model.prediction_report.values())


def phase_fx2007(seed, D=FX_D, m=FX_M, max_it=10):
    """Phase 1: exact objective, dense grid; host f64 reference."""
    import jax
    import jax.numpy as jnp

    from runlmc_tpu import AdaDelta
    from runlmc_tpu.lmc import likelihood as lk
    from runlmc_tpu.lmc.grid import build_kski

    t0 = time.perf_counter()
    model, test_xss = fx2007_model(seed, D=D, m=m)
    t_build = time.perf_counter() - t0
    info = model.optimize(optimizer=AdaDelta(max_it=max_it))
    t_opt = time.perf_counter() - t0 - t_build
    mus, vs = model.predict(test_xss)
    t_pred = time.perf_counter() - t0 - t_build - t_opt
    print(json.dumps({"phase": "fx2007", "chunk_memory_analysis":
                      _chunk_memory(model)}), flush=True)

    lens = model.data.lens
    spec = model.spec
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), model.params)
    mll_dev, _ = jax.jit(
        lambda p, gd, y: lk.exact_ski_mll(spec, p, gd, lens, y)
    )(params32, model.grid_data32, model.y.astype(jnp.float32))

    K = host_ski_matrix(model)
    y = np.asarray(model.y, dtype=float)
    _, logdet = np.linalg.slogdet(K)
    quad = y @ np.linalg.solve(K, y)
    mll_host = -0.5 * (logdet + quad + y.size * np.log(2 * np.pi))
    alpha = np.asarray(model._alpha(), dtype=float)

    v = np.random.default_rng(seed).standard_normal((4, y.size))
    mv = jax.jit(
        lambda p, gd, x: build_kski(spec, p, gd, lens).matvec(x)
    )
    kv32 = mv(params32, model.grid_data32, jnp.asarray(v, jnp.float32))
    kv64 = mv(model.params, model.grid_data, jnp.asarray(v))
    checks = [
        _check("mll_rel_err_vs_host_f64",
               abs(float(mll_dev) - mll_host) / abs(mll_host), MLL_RTOL),
        _check("alpha_rel_residual_host_f64",
               np.linalg.norm(K @ alpha - y) / np.linalg.norm(y),
               model.tolerance),
        _check("f32_matvec_rel_err_vs_f64", _rel(kv32, kv64), CANARY_RTOL),
        _check("predictions_finite", 0.0 if _finite(mus + vs) else 1.0, 0.0),
    ]
    return _report(
        "fx2007", t0, checks, n=int(y.size), D=D, m=m,
        n_iter=int(info["n_iter"]), build_s=t_build, optimize_s=t_opt,
        predict_s=t_pred, mll_host=mll_host, mll_device=float(mll_dev),
        objective=model.objective, exact_precision=model.exact_precision,
    )


def phase_weather(seed, m=WEATHER_M, n_train=WEATHER_N, max_it=3,
                  name="weather"):
    """Phases 2 and 3: stochastic objective; certified prediction."""
    import jax
    import jax.numpy as jnp

    from runlmc_tpu import AdaDelta
    from runlmc_tpu.lmc.grid import build_group_state

    t0 = time.perf_counter()
    model, test_xss = weather_model(seed, m=m, n_train=n_train)
    t_build = time.perf_counter() - t0
    modes = [gd.plan.mode for gd in model.grid_data]
    checks = []
    if modes == ["fft"]:
        gd = model.grid_data[0]
        spec = model.spec
        tiled = dataclasses.replace(gd.plan, mode="tiled")

        @jax.jit
        def both(params, dists, interp, u):
            return tuple(
                build_group_state(spec, params, plan, dists, interp)
                .grid_matvec(u)
                for plan in (gd.plan, tiled)
            )

        u = np.random.default_rng(seed).standard_normal(
            (4, gd.interp.ncols)
        )
        fft, ref = both(model.params, gd.dists, gd.interp, jnp.asarray(u))
        checks.append(
            _check("fft_vs_tiled_grid_matvec_rel_err", _rel(fft, ref),
                   FFT_RTOL)
        )
    info = model.optimize(optimizer=AdaDelta(max_it=max_it))
    t_opt = time.perf_counter() - t0 - t_build
    mus, vs = model.predict(test_xss)
    t_pred = time.perf_counter() - t0 - t_build - t_opt
    shapes_ok = all(
        np.shape(mu) == np.shape(x) == np.shape(v)
        for mu, v, x in zip(mus, vs, test_xss)
    )
    checks += [
        _check("max_certified_residual", _certified_residual(model),
               model.tolerance),
        _check("predictions_finite_and_shaped",
               0.0 if _finite(mus + vs) and shapes_ok else 1.0, 0.0),
    ]
    return _report(
        name, t0, checks, n=len(model.data.y), D=len(n_train), m=m,
        grid_modes=modes, n_iter=int(info["n_iter"]), build_s=t_build,
        optimize_s=t_opt, predict_s=t_pred,
        max_train_residual=float(info["max_solve_error"]),
    )


def _fit_predict(model, test_xss, max_it):
    from runlmc_tpu import AdaDelta

    model.optimize(optimizer=AdaDelta(max_it=max_it))
    mus, vs = model.predict(test_xss)
    return (np.asarray(model.param_array),
            np.concatenate([np.concatenate(mus), np.concatenate(vs)]))


def phase_four(seed, fx_D=FX_D, fx_m=FX_M, w_m=BEYOND_CAP_M,
               w_n=WEATHER_N, max_it=(10, 3)):
    """Phase 4: sharded models against the same model on one device,
    one JSON line per model."""
    from runlmc_tpu.parallel import default_mesh, probe_grid_mesh

    # The phase-1 model factorizes at f64 here (exact_precision='model',
    # native on the GPU): at f32 the factorization's own rounding, not
    # the psum order, would set the difference.
    cases = (
        ("fx2007_probe4",
         lambda mesh: fx2007_model(seed, D=fx_D, m=fx_m, mesh=mesh,
                                   exact_precision="model"),
         default_mesh(4, "probe"), max_it[0], MESH_EXACT_RTOL),
        ("beyond_cap_probe2_grid2",
         lambda mesh: weather_model(seed, m=w_m, n_train=w_n, mesh=mesh),
         probe_grid_mesh(2, 2), max_it[1], MESH_KRYLOV_RTOL),
    )
    for name, build, mesh, steps, tol in cases:
        t0 = time.perf_counter()
        single = _fit_predict(*build(None), steps)
        sharded = _fit_predict(*build(mesh), steps)
        _report(name, t0, [
            _check("params_rel_diff", _rel(sharded[0], single[0]), tol),
            _check("predictions_rel_diff", _rel(sharded[1], single[1]),
                   tol),
        ], mesh=dict(mesh.shape))


PHASES = {
    "fx2007": lambda seed: phase_fx2007(seed),
    "weather": lambda seed: phase_weather(seed),
    "beyond-cap": lambda seed: phase_weather(
        seed, m=BEYOND_CAP_M, name="beyond-cap"
    ),
}


def _gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return "; ".join(s.strip() for s in out.splitlines() if s.strip())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", action="append", choices=sorted(PHASES),
                    help="run only this phase (repeatable)")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device mesh phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            "chip_smoke: no GPU (JAX platform %r); refusing to run"
            % devices[0].platform
        )
    n_dev = 4 if args.four else 1
    if len(devices) < n_dev:
        raise SystemExit("chip_smoke: needs %d GPUs, found %d"
                         % (n_dev, len(devices)))
    jax.config.update("jax_enable_x64", True)
    from runlmc_tpu import config

    config.enable_compile_cache()
    print(json.dumps({
        "gpu": _gpu_line(), "platform": devices[0].platform,
        "kind": devices[0].device_kind, "count": len(devices),
        "jax": jax.__version__, "compile_cache": config.compile_cache_dir(),
    }), flush=True)

    try:
        if args.four:
            phase_four(args.seed)
        else:
            for name in args.only or list(PHASES):
                PHASES[name](args.seed)
    except CheckFailed as e:
        raise SystemExit("chip_smoke: check failed in %s" % e)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    main()
