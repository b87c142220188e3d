"""Scaling-efficiency evidence (SURVEY.md section 7 stage 8 /
BASELINE.json north star: >=80% matvec-throughput scaling efficiency).

Two measurements, each printed as a JSON line:

1. ``--mode batch`` (run on the GPU): throughput of the fused
   multi-RHS direct solve vs batch size on one device. The solve batch is
   the framework's data-parallel axis (observations + Hutchinson probes
   + prediction columns); near-flat time vs batch = the hardware is not
   yet saturated and sharding more RHS per step is free.

2. ``--mode mesh`` (run anywhere): the REAL sharded training step
   (InterpolatedLLGP.optimize over a `jax.sharding.Mesh`) at 1..8
   virtual CPU devices with the probe batch held fixed. Re-executes
   itself in subprocesses because XLA's
   --xla_force_host_platform_device_count must be set before jax
   imports. Virtual CPU devices share physical cores, so this validates
   partitioning overhead (efficiency of the sharded program vs the
   unsharded one), not hardware speedup.

Usage:
  python benchmarks/scaling.py --mode batch
  python benchmarks/scaling.py --mode mesh
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_batch_scaling(n=3054, D=13, m=238, seed=0, bmax=512):
    import jax
    import jax.numpy as jnp

    from runlmc_tpu import LMCKernelSpec, RBF
    from runlmc_tpu.lmc import likelihood as lk
    from runlmc_tpu.lmc.grid import build_kski, make_grids, to_dense_f32
    from runlmc_tpu.lmc.woodbury import build_device_woodbury, woodbury_pcg

    rng = np.random.default_rng(seed)
    n_per = n // D
    Xs = [np.sort(rng.uniform(0, 1, (n_per, 1)), axis=0) for _ in range(D)]
    spec = LMCKernelSpec.create(
        D=D, lmc_kernels=[RBF(name="k0")], lmc_ranks=[2]
    ).with_input_dim(1)
    params = jax.tree.map(jnp.asarray, spec.init_raw_params(seed=seed))
    grids, _ = make_grids(spec, Xs, m=[m], mode="dense")
    grids = tuple(grids)
    grids32 = to_dense_f32(grids)
    lens = tuple(n_per for _ in range(D))
    ntot = n_per * D

    @jax.jit
    def solve(p, grids, grids32, b):
        K = build_kski(spec, p, grids, lens)
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
        K32 = build_kski(spec, p32, grids32, lens)
        wb = build_device_woodbury(
            K32.groups, spec.noise(p32), K32.noise_n,
            tuple(g.WtW for g in grids32),
        )
        res = woodbury_pcg(K.matvec, wb, b, tol=1e-4)
        return res.x, res.iterations

    results = []
    base = None
    batches = [b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                           1024, 2048, 4096, 8192) if b <= bmax]
    for B in batches:
        b = jnp.asarray(rng.standard_normal((B, ntot)))
        x, it = solve(params, grids, grids32, b)  # compile
        float(jnp.sum(x))
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            x, it = solve(params, grids, grids32, b)
            float(jnp.sum(x))
        dt = (time.time() - t0) / reps
        thr = B / dt
        if base is None:
            base = thr
        results.append((B, dt, thr))
        _log("B=%3d  %7.1f ms  %8.1f solves/s  (iters %s)"
             % (B, dt * 1e3, thr, int(jnp.max(it))))
    times = {B: dt for B, dt, _ in results}
    # Derived 8-chip mesh efficiency for the probe-sharded solve: the
    # sharded solver runs each device's local RHS rows through a
    # COMPLETE independent solver loop with ZERO intra-loop collectives
    # (likelihood.sharded_solve), so 8 chips at B/8 rows each take the
    # measured single-chip t(B/8) — efficiency = t(B) / (8 t(B/8)).
    # This is the honest real-hardware stand-in for the >=80% scaling
    # north star while only one physical chip is reachable.
    # eff = t(B) / (8 t(B/8)): ~1 once the chip is SATURATED (t linear
    # in B); well below 1 in the unsaturated regime, where one chip
    # absorbs the whole batch in constant time and sharding simply
    # isn't needed — the curve itself shows which regime each B is in.
    derived = {
        "8x@B=%d" % B: round(times[B] / (8 * times[B // 8]), 3)
        for B in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
        if B in times and B // 8 in times
    }
    # Saturation knee: the first B where doubling the batch costs
    # >= 1.7x the time (throughput has flattened — the chip is doing
    # proportional work; beyond here the derived 8x efficiency is the
    # honest scaling number).
    knee = None
    for (B0, t0_, _), (B1, t1, _) in zip(results, results[1:]):
        if t1 / t0_ >= 1.7:
            knee = B1
            break
    print(json.dumps({
        "metric": "solve_batch_scaling",
        "value": round(results[-1][2], 1),
        "unit": "solves/s@B=%d" % results[-1][0],
        "per_batch": [
            {"B": B, "ms": round(dt * 1e3, 2),
             "solves_per_s": round(thr, 1)}
            for B, dt, thr in results
        ],
        "batch_efficiency_vs_B1": round(
            results[-1][2] / (base * results[-1][0]), 3
        ),
        "derived_mesh_efficiency": derived,
        "saturation_knee_B": knee,
    }))


def _mesh_child(n_dev):
    import jax

    from runlmc_tpu import AdaDelta, InterpolatedLLGP, LMCKernelSpec, RBF
    from runlmc_tpu.parallel.mesh import default_mesh

    rng = np.random.default_rng(0)
    D, n_per = 4, 200
    Xs = [np.sort(rng.uniform(0, 1, (n_per, 1)), axis=0) for _ in range(D)]
    Ys = [np.sin(7 * X[:, 0]) + 0.1 * rng.standard_normal(n_per)
          for X in Xs]
    spec = LMCKernelSpec.create(
        D=D, lmc_kernels=[RBF(name="k0")], lmc_ranks=[2]
    )
    mesh = default_mesh(n_dev, axis_name="probe") if n_dev > 1 else None
    lmc = InterpolatedLLGP(
        Xs, Ys, functional_kernel=spec, m=[64], seed=0, mesh=mesh,
        trace_iterations=16,
    )
    lmc.optimize(optimizer=AdaDelta(max_it=1))  # compile warmup
    t0 = time.time()
    info = lmc.optimize(optimizer=AdaDelta(
        max_it=20, permitted_drops=10**9))
    dt = time.time() - t0
    print(json.dumps({
        "devices": n_dev, "seconds": round(dt, 3),
        "iters": info["n_iter"],
        "steps_per_s": round(info["n_iter"] / dt, 2),
    }))


def run_mesh_scaling():
    rows = []
    for n_dev in (1, 2, 4, 8):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=%d" % n_dev
        ).strip()
        env["SCALING_CHILD"] = str(n_dev)
        env["JAX_PLATFORMS"] = "cpu"  # virtual devices, off the GPU
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            env=env, capture_output=True, text=True, timeout=1200,
        )
        if out.returncode != 0:
            _log(out.stderr[-2000:])
            raise RuntimeError("mesh child failed at %d devices" % n_dev)
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        _log("devices=%d %.2fs (%s steps/s)" % (
            n_dev, rows[-1]["seconds"], rows[-1]["steps_per_s"]))
    base = rows[0]["steps_per_s"]
    print(json.dumps({
        "metric": "mesh_step_scaling",
        "value": round(rows[-1]["steps_per_s"] / base, 3),
        "unit": "sharded-8dev steps/s over 1dev",
        "physical_cores": os.cpu_count(),
        "note": "virtual CPU devices share physical cores: every "
        "REPLICATED op (the per-step factorization, the gradient "
        "contractions) executes once per device on the same cores, so "
        "this curve is an upper bound on partition overhead, not a "
        "hardware speedup measurement; on real chips replicated work "
        "is concurrent. The sharded component (the per-RHS solve loop) "
        "runs under shard_map with zero intra-loop collectives.",
        "per_devices": rows,
    }))


def _analyze_child(n_dev):
    """Compile the REAL training-step gradient program at ``n_dev``
    devices and report its per-device FLOP count and collective ops —
    the partition-efficiency measurement that a shared-core virtual
    mesh CAN honestly make (wall-clock on virtual devices cannot)."""
    import re

    import jax
    import jax.numpy as jnp

    from runlmc_tpu import InterpolatedLLGP, LMCKernelSpec, RBF
    from runlmc_tpu.parallel.mesh import default_mesh

    rng = np.random.default_rng(0)
    D, n_per = 4, 400
    Xs = [np.sort(rng.uniform(0, 1, (n_per, 1)), axis=0)
          for _ in range(D)]
    Ys = [np.sin(7 * X[:, 0]) + 0.1 * rng.standard_normal(n_per)
          for X in Xs]
    spec = LMCKernelSpec.create(
        D=D, lmc_kernels=[RBF(name="k0")], lmc_ranks=[2]
    )
    mesh = default_mesh(n_dev, axis_name="probe") if n_dev > 1 else None
    out = {}
    # 'exact' and dense-mode 'stochastic' both run a per-step direct
    # factorization, which is REPLICATED (single-chip-optimal by
    # design); their flop balance quantifies exactly that. The config
    # that scales over the mesh is the matvec-dominated fft-mode
    # stochastic path ('stochastic-fft'): probes shard, the Krylov
    # loop partitions with no intra-loop collectives.
    for objective, grid_mode in (
        ("exact", "auto"), ("stochastic", "auto"),
        ("stochastic-fft", "fft"),
    ):
        lmc = InterpolatedLLGP(
            Xs, Ys, functional_kernel=spec, m=[64], seed=0, mesh=mesh,
            trace_iterations=16, objective=objective.split("-")[0],
            grid_mode=grid_mode,
        )
        x = jnp.asarray(lmc.param_array, dtype=lmc.dtype)
        compiled = lmc._jit_grad.lower(
            x, jax.random.PRNGKey(0), lmc.grid_data, lmc.precond_data32,
            lmc.inner_data32, lmc.y,
        ).compile()
        cost = compiled.cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        hlo = compiled.as_text()
        out[objective] = {
            "flops_per_device": float(cost.get("flops", float("nan"))),
            "collectives": {
                kind: len(re.findall(r"\b%s(?:-start)?\(" % kind, hlo))
                for kind in ("all-reduce", "all-gather",
                             "reduce-scatter", "collective-permute")
            },
        }
    print(json.dumps({"devices": n_dev, "objectives": out}))


def run_mesh_analysis():
    """Partition-efficiency of the sharded training-step programs:
    FLOP-balance efficiency = (1-device FLOPs) / (8 x per-device FLOPs
    of the 8-way program). 1.0 = the mesh splits ALL work; below that,
    the replicated fraction (per-step factorization, parameter-sized
    ops) bounds scaling. This replaces wall-clock on virtual shared-core
    devices, which measures nothing."""
    rows = {}
    for n_dev in (1, 8):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=%d" % n_dev
        ).strip()
        env["SCALING_ANALYZE"] = str(n_dev)
        env["JAX_PLATFORMS"] = "cpu"
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            env=env, capture_output=True, text=True, timeout=1200,
        )
        if out.returncode != 0:
            _log(out.stderr[-2000:])
            raise RuntimeError("analyze child failed at %d" % n_dev)
        rows[n_dev] = json.loads(out.stdout.strip().splitlines()[-1])
        _log("analyzed %d devices" % n_dev)
    result = {"metric": "mesh_flop_balance", "unit": "efficiency",
              "physical_note": (
                  "per-device FLOPs from XLA cost analysis of the "
                  "compiled SPMD program; wall-clock is not "
                  "measurable on shared-core virtual devices. Caveat: "
                  "cost analysis counts a while-loop body ONCE, so the "
                  "sharded Krylov loop is underweighted relative to "
                  "one-time replicated setup — treat these numbers as "
                  "a partition-structure check (how much of the "
                  "PROGRAM is sharded), and --mode batch on the GPU "
                  "as the throughput-scaling evidence"),
              "objectives": {}}
    for objective in ("exact", "stochastic", "stochastic-fft"):
        f1 = rows[1]["objectives"][objective]["flops_per_device"]
        f8 = rows[8]["objectives"][objective]["flops_per_device"]
        eff = f1 / (8.0 * f8)
        result["objectives"][objective] = {
            "flops_1dev": f1,
            "flops_per_device_8dev": f8,
            "flop_balance_efficiency": round(eff, 3),
            "collectives_8dev":
                rows[8]["objectives"][objective]["collectives"],
        }
    result["value"] = result["objectives"]["stochastic-fft"][
        "flop_balance_efficiency"]
    print(json.dumps(result))


def main():
    child = os.environ.get("SCALING_CHILD")
    if child:
        import jax

        jax.config.update("jax_platforms", "cpu")
        _mesh_child(int(child))
        return
    child = os.environ.get("SCALING_ANALYZE")
    if child:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        _analyze_child(int(child))
        return
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--mode", choices=("batch", "mesh", "analyze"), default="batch"
    )
    ap.add_argument("--n", type=int, default=3054)
    ap.add_argument(
        "--m", type=int, default=238,
        help="grid points per output; larger m raises per-solve work "
        "until one chip SATURATES — the regime where mesh sharding "
        "pays and the derived 8x efficiency is meaningful",
    )
    ap.add_argument(
        "--bmax", type=int, default=8192,
        help="largest RHS batch in the sweep (power of two)",
    )
    args = ap.parse_args()
    if args.mode == "batch":
        run_batch_scaling(n=args.n, m=args.m, bmax=args.bmax)
    elif args.mode == "analyze":
        run_mesh_analysis()
    else:
        run_mesh_scaling()


if __name__ == "__main__":
    main()
