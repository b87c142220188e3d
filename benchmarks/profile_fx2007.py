"""fx2007 training-step profile + magic-constant sweep (the training
step and the chunk_len / SOLVE_SLICE constants).

Times, as separate jitted programs with SCALAR/small outputs (so a
large device-to-host copy is not read as compute), on the host clock:

  mll_forward      exact SKI MLL value only (f32 Woodbury factorize +
                   logdet + solve)
  mll_grad         value_and_grad of the same (the production step's
                   gradient; backward through two Cholesky factors)
  chunk_step       the fused production chunk, per step, at chunk_len
                   in {5, 10, 20}  -> data for the chunk_len constant
  predict_slice    certified prediction solve wall-clock at SOLVE_SLICE
                   in {32, 64, 128} -> data for the SOLVE_SLICE constant

Writes benchmarks/out/profile_fx2007.json.

Usage: python benchmarks/profile_fx2007.py
"""

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


def timed(label, fn, reps=5):
    out = fn(0)
    jax.block_until_ready(out)
    t0 = time.time()
    for i in range(1, reps + 1):
        out = fn(i)
        jax.block_until_ready(out)
    ms = 1e3 * (time.time() - t0) / reps
    _log("%-24s %8.2f ms" % (label, ms))
    return ms


def main():
    from bench import build_fx2007
    from runlmc_tpu import AdaDelta, InterpolatedLLGP
    from runlmc_tpu.lmc import likelihood as lk

    (xss, yss, test_xss, _, spec, mlist, opt_opts, model_opts) = (
        build_fx2007()
    )
    lmc = InterpolatedLLGP(
        xss, yss, functional_kernel=spec, normalize=True, m=mlist,
        seed=1234, **model_opts,
    )
    spec_, lens, y32 = lmc.spec, lmc.data.lens, lmc.y.astype(jnp.float32)
    x_flat = jnp.asarray(lmc.param_array, dtype=lmc.dtype)
    out = {"metric": "fx2007_step_profile", "unit": "ms"}

    def scaled(i):
        return x_flat * (1.0 + 1e-9 * i)

    @jax.jit
    def fwd(xf, gd32, yy):
        p = lmc._unravel(xf)
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
        mll, aux = lk.exact_ski_mll(
            spec_, p32, gd32, lens, yy,
            jitter=(1e-6, 1e-4, 1e-2), c_jitter=(0.0, 1e-6, 1e-3),
        )
        return mll, aux.solve_error

    out["mll_forward_ms"] = timed(
        "mll_forward", lambda i: fwd(scaled(i), lmc.grid_data32, y32)
    )

    @jax.jit
    def vgrad(xf, gd32, yy):
        p = lmc._unravel(xf)

        def obj(pp):
            p32 = jax.tree.map(lambda a: a.astype(jnp.float32), pp)
            mll, aux = lk.exact_ski_mll(
                spec_, p32, gd32, lens, yy,
                jitter=(1e-6, 1e-4, 1e-2), c_jitter=(0.0, 1e-6, 1e-3),
            )
            return -mll, aux

        (v, aux), g = jax.value_and_grad(obj, has_aux=True)(p)
        return v, ravel_pytree(g)[0]

    out["mll_grad_ms"] = timed(
        "mll_grad", lambda i: vgrad(scaled(i), lmc.grid_data32, y32)
    )

    # chunk_len sweep: per-step cost of the fused production chunk
    z = jnp.zeros_like(x_flat)
    hp = jnp.asarray([1.0, 0.9, 0.5, 1e-4], dtype=lmc.dtype)
    for ln in (5, 10, 20):
        def chunk(i, ln=ln):
            return lmc._jit_chunk(
                scaled(i), z, z, z, jax.random.PRNGKey(0),
                jnp.asarray(0, jnp.int32), hp, lmc.grid_data,
                lmc.precond_data32, lmc.inner_data32, lmc.y,
                n_steps=ln,
            )

        ms = timed("chunk n_steps=%d" % ln, lambda i: chunk(i), reps=3)
        out["chunk%d_ms_per_step" % ln] = round(ms / ln, 2)

    # SOLVE_SLICE sweep on the real prediction path (certified
    # explained-variance solves over the 3-output holdout columns)
    lmc.predict(test_xss)  # compile at the default slice
    for s in (32, 64, 128):
        lmc.SOLVE_SLICE = s
        lmc._bump()
        lmc.predict(test_xss)  # compile at this slice shape
        t0 = time.time()
        for _ in range(3):
            lmc._bump()
            lmc.predict(test_xss)
        ms = 1e3 * (time.time() - t0) / 3
        _log("%-24s %8.1f ms" % ("predict slice=%d" % s, ms))
        out["predict_slice%d_ms" % s] = round(ms, 1)
    lmc.SOLVE_SLICE = type(lmc).SOLVE_SLICE

    print(json.dumps(out))
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "out",
        "profile_fx2007.json",
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
