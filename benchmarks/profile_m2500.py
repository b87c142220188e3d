"""Per-stage profile of the beyond-dense-cap training step (weather
m=2500), on the host clock.

Each candidate cost center of one stochastic-objective optimizer step
is timed as its OWN jitted program (all large arrays passed as
arguments, never closures — see interpolated_llgp._build_jit note):

  precond_factorize  per-step f32 Woodbury factorization (exact-fine
                     geometry at m<=PRECOND_MAX_GRID/D)
  tiled_f64_matvec   one model-dtype exact tiled K matvec on the
                     (1+15)-RHS training batch
  fft_f32_matvec     one f32 Fourier fine matvec on the same batch
  solve              the full certified multi-RHS solve (f32 inner
                     cycles + f64 true-residual refinement)
  grad_tiled_f64     the differentiable contraction fwd+bwd through
                     the model-dtype tiled operator (the ROUND-4 path)
  grad_fft_f32       the same contraction through the f32 fft twin
                     (the ROUND-5 `diff_data` path)
  full_step          the production fused chunk program, per step

Prints one JSON line and writes benchmarks/out/profile_m2500.json.

Usage: python benchmarks/profile_m2500.py [--m 2500]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

os.environ.setdefault("JAX_ENABLE_X64", "1")
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from runlmc_tpu import config  # noqa: E402

config.enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(label, fn, reps=3):
    t0 = time.time()
    out = fn()
    jax.block_until_ready(out)
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(reps):
        out = fn()
        jax.block_until_ready(out)
    ms = 1e3 * (time.time() - t0) / reps
    _log("%-20s %8.1f ms   (first call %.1fs)" % (label, ms, compile_s))
    return ms, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=2500)
    args = ap.parse_args()

    from bench import build_weather
    from runlmc_tpu import InterpolatedLLGP
    from runlmc_tpu.lmc import likelihood as lk
    from runlmc_tpu.lmc.grid import build_kski
    from runlmc_tpu.lmc.woodbury import build_device_woodbury, woodbury_pcg

    (xss, yss, _, _, spec, mlist, _, model_opts) = build_weather(args.m)
    t0 = time.time()
    lmc = InterpolatedLLGP(
        xss, yss, functional_kernel=spec, normalize=True, m=mlist,
        seed=1234, **model_opts,
    )
    _log("model built in %.1fs (n=%d, modes=%s)" % (
        time.time() - t0, len(lmc.data.y),
        [gd.plan.mode for gd in lmc.grid_data]))

    spec_ = lmc.spec
    lens = lmc.data.lens
    y = lmc.y
    params = lmc.params
    probes = lmc._jit_probes(jax.random.PRNGKey(0))
    rhs = jnp.concatenate([y[None], probes], axis=0)
    rhs32 = rhs.astype(jnp.float32)
    tol = lmc.tolerance

    stages = {}

    stages["precond_factorize_ms"], wb = timed(
        "precond_factorize",
        lambda: lmc._jit_woodbury32(params, lmc.precond_data32),
    )

    @jax.jit
    def mv(p, gd, b):
        return build_kski(spec_, p, gd, lens).matvec(b)

    stages["tiled_f64_matvec_ms"], _ = timed(
        "tiled_f64_matvec", lambda: mv(params, lmc.grid_data, rhs)
    )

    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    stages["fft_f32_matvec_ms"], _ = timed(
        "fft_f32_matvec", lambda: mv(params32, lmc.inner_data32, rhs32)
    )

    @jax.jit
    def solve_only(p, gd, gd32, in32, b):
        K = build_kski(spec_, p, gd, lens)
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
        K32 = build_kski(spec_, p32, gd32, lens)
        wb = build_device_woodbury(
            K32.groups, spec_.noise(p32), K32.noise_n,
            tuple(g.WtW for g in gd32),
        )
        inner = build_kski(spec_, p32, in32, lens).matvec
        res = woodbury_pcg(
            K.matvec, wb, b, tol=tol, inner_matvec=inner,
            cycle=10, stall_ratio=0.99,
        )
        return res.x, res.iterations, res.error

    stages["solve_ms"], sres = timed(
        "solve",
        lambda: solve_only(
            params, lmc.grid_data, lmc.precond_data32,
            lmc.inner_data32, rhs,
        ),
    )
    sols, iters, errs = sres
    _log("  solve iters max=%d  worst residual %.2e"
         % (int(jnp.max(iters)), float(jnp.max(errs))))
    alpha, zs = sols[0], sols[1:]

    x_flat = jnp.asarray(lmc.param_array, dtype=lmc.dtype)

    def make_grad(diff_name):
        @jax.jit
        def g_fn(xf, diff_gd, pr, al, z):
            p = lmc._unravel(xf)

            def obj(pp):
                return -lk.stochastic_surrogate_from_solves(
                    spec_, pp, diff_gd, lens, al, z, pr
                )

            g = jax.grad(obj)(p)
            return ravel_pytree(g)[0]

        return g_fn

    g_old = make_grad("tiled")
    stages["grad_tiled_f64_ms"], g64 = timed(
        "grad_tiled_f64",
        lambda: g_old(x_flat, lmc.grid_data, probes, alpha, zs),
    )
    g_new = make_grad("fft32")
    stages["grad_fft_f32_ms"], g32 = timed(
        "grad_fft_f32",
        lambda: g_new(x_flat, lmc.inner_data32, probes, alpha, zs),
    )
    rel = float(
        jnp.linalg.norm(g64 - g32) / jnp.maximum(jnp.linalg.norm(g64), 1e-30)
    )
    _log("  grad f32-vs-f64 relative difference %.2e" % rel)

    z = jnp.zeros_like(x_flat)
    hp = jnp.asarray([1.0, 0.9, 0.5, 1e-4], dtype=lmc.dtype)

    def full_step():
        return lmc._jit_chunk(
            x_flat, z, z, z, jax.random.PRNGKey(0),
            jnp.asarray(0, jnp.int32), hp, lmc.grid_data,
            lmc.precond_data32, lmc.inner_data32, lmc.y, n_steps=1,
        )

    stages["full_step_ms"], _ = timed("full_step", full_step, reps=3)

    out = {
        "metric": "m%d_step_profile" % args.m,
        "value": round(stages["full_step_ms"], 1),
        "unit": "ms/step",
        "m": args.m,
        "n": len(lmc.data.y),
        "grad_f32_vs_f64_rel": rel,
        "solve_iters_max": int(jnp.max(iters)),
        "solve_worst_residual": float(jnp.max(errs)),
        **{k: round(v, 2) for k, v in stages.items()},
    }
    print(json.dumps(out))
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "out",
        "profile_m%d.json" % args.m,
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
