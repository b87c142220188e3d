"""grad-grid: exact-vs-stochastic gradient timing and accuracy per
kernel type.

Reproduces the reference's grad-grid benchmark (n=5000, D=10, r=3, Q=1;
BASELINE.md reports 34-41x per-gradient speedup of the SKI/stochastic
path over the exact dense path, with relative gradient L1 errors of
0.6-10% and alpha L2 errors below 1e-6).

Usage: python benchmarks/grad_grid.py [--n 5000] [--kernels rbf,...]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def run_kernel(kern_name, n, D, r, seed=0):
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from runlmc_tpu import LMCKernelSpec, Matern32, RBF, StdPeriodic
    from runlmc_tpu.lmc import likelihood as lk
    from runlmc_tpu.lmc.grid import make_grids, to_dense_f32

    kmap = {
        "rbf": [RBF(name="k0")],
        "matern": [Matern32(name="k0")],
        "periodic": [StdPeriodic(name="k0")],
        "mix": [RBF(name="k0"), Matern32(name="k1"),
                StdPeriodic(name="k2")],
    }
    kerns = kmap[kern_name]
    Q = len(kerns)
    rng = np.random.default_rng(seed)
    n_per = n // D
    Xs = [np.sort(rng.uniform(0, 1, (n_per, 1)), axis=0) for _ in range(D)]
    Ys = [rng.standard_normal(n_per) for _ in range(D)]
    spec = LMCKernelSpec.create(
        D=D, lmc_kernels=kerns, lmc_ranks=[r] * Q
    ).with_input_dim(1)
    params = jax.tree.map(jnp.asarray, spec.init_raw_params(seed=seed))
    grids, _ = make_grids(spec, Xs, m=[n_per])
    grids = tuple(grids)
    # the product training path: direct f32 Woodbury when grids are dense
    grids32 = (
        to_dense_f32(grids)
        if all(g.plan.mode == "dense" for g in grids)
        else None
    )
    data = lk.flatten_data(Xs, Ys)
    y = jnp.asarray(data.y)
    X = jnp.asarray(data.X)
    oidx = jnp.asarray(data.output_idx)

    @jax.jit
    def exact_grad(p):
        g = jax.grad(lambda pp: lk.exact_mll(spec, pp, X, oidx, y))(p)
        return ravel_pytree(g)[0]

    @jax.jit
    def stoch_grad(p, key):
        probes = lk.rademacher_probes(key, 15, y.shape[0], y.dtype)

        def s(pp):
            v, aux = lk.stochastic_mll_surrogate(
                spec, pp, grids, data.lens, y, probes, tol=1e-4,
                grid_data32=grids32,
            )
            return v, aux

        (_, aux), g = jax.value_and_grad(s, has_aux=True)(p)
        return ravel_pytree(g)[0], aux.alpha

    y32 = y.astype(jnp.float32)

    @jax.jit
    def wb_grad(p):
        """The flagship training path: exact MLL of the factorized SKI
        model, autodiff through the per-step f32 Woodbury factorization
        (probe-free, deterministic)."""
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)

        def s(pp):
            mll, aux = lk.exact_ski_mll(spec, pp, grids32, data.lens, y32)
            return -mll, aux

        (_, aux), g = jax.value_and_grad(s, has_aux=True)(p32)
        return ravel_pytree(g)[0], aux.alpha

    # compile
    ge = exact_grad(params)
    gs, alpha = stoch_grad(params, jax.random.PRNGKey(0))
    gw, alpha_wb = wb_grad(params)
    jax.block_until_ready((ge, gs, gw))

    t0 = time.time()
    ge = exact_grad(params)
    jax.block_until_ready(ge)
    t_exact = time.time() - t0

    t0 = time.time()
    gs, alpha = stoch_grad(params, jax.random.PRNGKey(1))
    jax.block_until_ready(gs)
    t_stoch = time.time() - t0

    t0 = time.time()
    gw, alpha_wb = wb_grad(params)
    jax.block_until_ready(gw)
    t_wb = time.time() - t0

    ge_np, gs_np = np.asarray(ge), np.asarray(gs)
    gw_np = -np.asarray(gw, dtype=float)  # wb_grad minimizes -mll
    rel_l1 = np.abs(gs_np - ge_np).sum() / np.abs(ge_np).sum()
    rel_l1_wb = np.abs(gw_np - ge_np).sum() / np.abs(ge_np).sum()

    # alpha accuracy vs the dense exact solve — ON DEVICE: only the
    # (n,) solution crosses to the host, not the (n, n) kernel
    @jax.jit
    def dense_alpha(p):
        K_exact = lk.exact_dense_K(spec, p, X, oidx)
        with jax.default_matmul_precision("highest"):
            return jnp.linalg.solve(K_exact, y)

    alpha_exact = np.asarray(dense_alpha(params))
    rel_alpha = np.linalg.norm(
        np.asarray(alpha) - alpha_exact
    ) / np.linalg.norm(alpha_exact)
    return {
        "exact_s": t_exact,
        "stoch_s": t_stoch,
        "wb_s": t_wb,
        "speedup": t_exact / t_stoch,
        "speedup_wb": t_exact / t_wb,
        "rel_grad_l1": float(rel_l1),
        "rel_grad_l1_wb": float(rel_l1_wb),
        "rel_alpha_l2": float(rel_alpha),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--D", type=int, default=10)
    ap.add_argument("--r", type=int, default=3)
    ap.add_argument(
        "--kernels", default="rbf,matern,periodic,mix"
    )
    args = ap.parse_args()
    print(
        "| kernel | exact grad (s) | stoch grad (s) | speedup | "
        "wb-exact grad (s) | wb speedup | rel grad L1 (stoch/wb) | "
        "rel alpha L2 |"
    )
    print("|---|---|---|---|---|---|---|---|")
    for k in args.kernels.split(","):
        r = run_kernel(k, args.n, args.D, args.r)
        print(
            "| %s | %.3f | %.4f | %.1fx | %.4f | %.1fx | %.4f / %.4f "
            "| %.2e |"
            % (k, r["exact_s"], r["stoch_s"], r["speedup"],
               r["wb_s"], r["speedup_wb"],
               r["rel_grad_l1"], r["rel_grad_l1_wb"],
               r["rel_alpha_l2"])
        )


if __name__ == "__main__":
    main()
