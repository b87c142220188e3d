"""representation-cmp: solve wall-clock per grid-kernel representation.

Reproduces the reference's representation comparison
(benchmarks/representation-cmp; baseline numbers in BASELINE.md): a
synthetic N=5000 mixed-kernel LMC system solved via dense Cholesky vs
the 'sum' / 'bt' / 'slfm' matrix-free representations. The three
Fourier-space einsum paths produce identical operators, so this measures
their per-matvec contraction costs.

Usage: python benchmarks/representation_cmp.py [--n 5000] [--configs all]
Writes a markdown table to stdout (plus per-case timings to stderr).
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_config(D, R, Q, n, seed=0):
    import jax
    import jax.numpy as jnp

    from runlmc_tpu import LMCKernelSpec, RBF, Matern32, StdPeriodic
    from runlmc_tpu.lmc import likelihood as lk
    from runlmc_tpu.lmc.grid import build_kski, make_grids
    from runlmc_tpu.ops.solvers import batched_minres

    rng = np.random.default_rng(seed)
    n_per = n // D
    Xs = [np.sort(rng.uniform(0, 1, (n_per, 1)), axis=0) for _ in range(D)]
    Ys = [rng.standard_normal(n_per) for _ in range(D)]
    kern_cycle = [RBF, Matern32, StdPeriodic]
    kerns = [kern_cycle[q % 3](name="k%d" % q) for q in range(Q)]
    spec = LMCKernelSpec.create(
        D=D, lmc_kernels=kerns, lmc_ranks=[R] * Q
    ).with_input_dim(1)
    params = jax.tree.map(jnp.asarray, spec.init_raw_params(seed=seed))
    data = lk.flatten_data(Xs, Ys)
    # follow the x64 setting: the reference protocol is f64 with an
    # ABSOLUTE residual tolerance 1e-4 (iterative.py:36-42); f32
    # stalls above it on the harder configs
    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    y = jnp.asarray(data.y, dtype=dt)

    out = {}
    # dense Cholesky baseline (jitted + warmed like the reps: the
    # comparison is solve wall-clock, not XLA compile time)
    X_j = jnp.asarray(data.X, dt)
    oidx_j = jnp.asarray(data.output_idx)

    @jax.jit
    def chol_solve(p, X, oidx, y):
        K = lk.exact_dense_K(spec, p, X, oidx)
        with jax.default_matmul_precision("highest"):
            L = jnp.linalg.cholesky(K)
            return jax.scipy.linalg.cho_solve((L, True), y)

    jax.block_until_ready(chol_solve(params, X_j, oidx_j, y))
    t0 = time.time()
    jax.block_until_ready(chol_solve(params, X_j, oidx_j, y))
    out["chol"] = time.time() - t0

    for rep in ["sum", "bt", "slfm"]:
        # force fft mode: this benchmark compares the Fourier-space
        # representation contraction paths specifically
        grids, _ = make_grids(spec, Xs, m=[n_per], rep=rep, mode="fft")
        grids = tuple(grids)

        @jax.jit
        def solve(p, grids, y):
            K = build_kski(spec, p, grids, data.lens)
            return batched_minres(
                K.matvec, y[None], tol=1e-4, maxiter=len(data.y)
            )

        res = solve(params, grids, y)  # compile
        jax.block_until_ready(res.x)
        t0 = time.time()
        res = solve(params, grids, y)
        jax.block_until_ready(res.x)
        out[rep] = time.time() - t0
        _log(
            "D%d R%d Q%d %s: %.4fs (%d iters, err %.2e)"
            % (D, R, Q, rep, out[rep], int(res.iterations[0]),
               float(res.error[0]))
        )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000)
    args = ap.parse_args()

    configs = [(2, 2, 10), (10, 1, 10), (10, 10, 1)]
    print("| D | R | Q | chol (s) | sum (s) | bt (s) | slfm (s) |")
    print("|---|---|---|----------|---------|--------|----------|")
    for D, R, Q in configs:
        r = run_config(D, R, Q, args.n)
        print(
            "| %d | %d | %d | %.3f | %.3f | %.3f | %.3f |"
            % (D, R, Q, r["chol"], r["sum"], r["bt"], r["slfm"])
        )


if __name__ == "__main__":
    main()
