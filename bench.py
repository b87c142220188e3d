"""Headline benchmark: fx2007 train wall-clock vs the reference CPU
baseline (BASELINE.md: LLGP 69.11 s mean on 16 Xeon threads).

Reproduces the reference benchmark protocol
(benchmarks/asv/fx2007/fx2007.py:77-86 + benchlib bench_runlmc):
D=13 FX outputs, n~3054, Q=1 rank-2 RBF LMC kernel, m=234 grid,
AdaDelta(min_grad_ratio=0.2, max_it=100), normalize=True; the timed
section is ``optimize()`` only (model construction excluded there;
correspondingly, one-off XLA compilation is warmed up outside the timed
section here). SMSE/NLPD are computed on the CAD/JPY/AUD holdouts.

Prints ONE JSON line:
  {"metric": "fx2007_train_s", "value": <mean seconds>, "unit": "s",
   "vs_baseline": <baseline_seconds / value, i.e. speedup factor >1 is
   better>, ...extras}

Usage: python bench.py [--runs N] [--benchmark fx2007|weather|synth]
"""

import argparse
import json
import sys
import time

import numpy as np

# float64 end-to-end: Krylov convergence on the ill-conditioned
# (small learned noise) systems of the reference benchmarks requires
# f64 — matching the reference's numpy/scipy precision.
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: amortizes the one-off compile of the
# fused training step across bench invocations on the same machine.
from runlmc_tpu import config  # noqa: E402

config.enable_compile_cache()

BASELINES = {
    # mean train seconds from BASELINE.md (reference hardware)
    "fx2007": 69.11,
    "weather": 73.17,  # m=500 config
    "synth": 161.0,
}


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_fx2007(m=None):
    from runlmc_tpu import LMCKernelSpec, RBF
    from runlmc_tpu.datasets import fx2007

    xss, yss, test_xss, test_yss, _, _ = fx2007()
    # Q=1 R=2 RBF (Alvarez & Lawrence 2010 config; reference
    # standard_tester.alvarez_and_lawrence_gp)
    spec = LMCKernelSpec.create(
        D=len(xss), lmc_kernels=[RBF(name="rbf0")], lmc_ranks=[2]
    )
    # optimizer opts: reference benchmarks/asv/fx2007/fx2007.py:25
    # objective pinned (the auto-probe would pick 'exact' anyway —
    # measured init residual 7.6e-6 — but pinning keeps the probe's
    # one-off compile out of the benchmark's model-build phase)
    return (xss, yss, test_xss, test_yss, spec, [m or 234],
            {"min_grad_ratio": 0.2}, {"objective": "exact"})


def build_weather(m=None):
    from runlmc_tpu import RBF, LMCKernelSpec, Scaled
    from runlmc_tpu.datasets import weather

    xss, yss, test_xss, test_yss, _ = weather()
    # SLFM rank-2 + per-output scaled RBF (reference slfm_gp config)
    spec = LMCKernelSpec.create(
        D=len(xss),
        slfm_kernels=[RBF(name="slfm0"), RBF(name="slfm1")],
        indep_gp=[
            # trainable_scale=False: the reference's Scaled never links
            # its scale Param into the optimized tree (scaled.py:21) —
            # scale stays frozen at 1.0 there
            Scaled(inner=RBF(name="rbf%d" % i), trainable_scale=False)
            for i in range(len(xss))
        ],
    )
    # optimizer opts: reference weather.py:24 passes only verbosity ->
    # AdaDelta defaults (min_grad_ratio=0.1)
    #
    # objective='stochastic' EXPLICITLY: the reference protocol trains
    # weather with the 15-probe stochastic estimator, and its published
    # quality depends on that trajectory — the deterministic exact
    # objective optimizes the MLL harder and lands on an overconfident
    # optimum (measured on CPU f64: held-out NLPD 10-21 vs the
    # stochastic path's 1.4 at comparable SMSE; the reference reports
    # 1.72). The LIBRARY now self-protects: objective='auto' validates
    # the exact objective on held-out blocks and demotes weather to
    # stochastic on its own (measured: guard z^2 62.3 / 86.3%
    # zero-variance -> demote -> SMSE 0.0550, NLPD 1.42) — this pin is
    # therefore redundant for correctness and kept only to skip the
    # guard's extra validation training inside the timed protocol.
    return (xss, yss, test_xss, test_yss, spec, [m or 500], {},
            {"objective": "stochastic"})


def build_synth(m=None):
    from runlmc_tpu import RBF, LMCKernelSpec
    from runlmc_tpu.datasets import synth

    xss, yss, test_xss, test_yss = synth()
    spec = LMCKernelSpec.create(
        D=len(xss),
        slfm_kernels=[RBF(name="slfm0"), RBF(name="slfm1")],
        indep_gp=[RBF(name="rbf%d" % i) for i in range(len(xss))],
    )
    mm = m or 25
    # reference synth.py:53-55: default optimizer opts, tolerance=1e-3.
    # objective pinned 'exact' (it certified in earlier runs: training
    # residuals ~0.22, below the calibrated 0.25 threshold, at
    # reference-parity quality)
    return (xss, yss, test_xss, test_yss, spec, [mm, mm],
            {}, {"tolerance": 1e-3, "objective": "exact"})


BUILDERS = {
    "fx2007": build_fx2007,
    "weather": build_weather,
    "synth": build_synth,
}


# --validate subsampling factors / grid sizes / iteration caps: tiny
# configs that exercise the full pipeline (dataset load -> model ->
# optimize -> predict -> SMSE/NLPD) in seconds, mirroring the
# reference's CI smoke runs (.travis.yml:16-17 `run.sh --validate`).
VALIDATE = {
    "fx2007": dict(subsample=4, m=64, max_it=10, smse_max=1.2),
    "weather": dict(subsample=20, m=64, max_it=10, smse_max=1.2),
    "synth": dict(subsample=30, m=8, max_it=10, smse_max=1.2),
}


def run_once(name, seed, m=None, subsample=None, max_it=100):
    import jax

    from runlmc_tpu import AdaDelta, InterpolatedLLGP
    from runlmc_tpu.utils.evaluation import nlpd, smse

    (xss, yss, test_xss, test_yss, spec, mlist, opt_opts,
     model_opts) = BUILDERS[name](m)
    if subsample:
        xss = [x[::subsample] for x in xss]
        yss = [y[::subsample] for y in yss]
    t0 = time.time()
    lmc = InterpolatedLLGP(
        xss, yss, functional_kernel=spec, normalize=True, m=mlist,
        seed=seed, **model_opts,
    )
    t_build = time.time() - t0
    _log("model built in %.1fs (n=%d)" % (t_build, len(lmc.data.y)))

    # Warm the jit caches outside the timed section (compilation is a
    # one-off per shape; the reference's timed section has no analog of
    # it): run ONE real optimizer step (compiles the actual — possibly
    # preconditioned — training program), then restore params/RNG so
    # the timed run is untouched.
    t0 = time.time()
    key_before = lmc._key
    x_before = lmc.param_array.copy()
    # the warmup step can trigger auto-escalation side effects
    # (objective -> 'stochastic', exact_precision -> 'model'); restore
    # the configuration along with params/RNG so the timed run measures
    # exactly the pinned configuration, and log if a breach fired
    obj_before, prec_before = lmc.objective, lmc.exact_precision
    lmc.optimize(optimizer=AdaDelta(max_it=1))
    if (lmc.objective, lmc.exact_precision) != (obj_before, prec_before):
        _log(
            "warmup step escalated (%s/%s -> %s/%s); warming the "
            "escalated program too, then restoring the pinned "
            "configuration for the timed run"
            % (obj_before, prec_before, lmc.objective,
               lmc.exact_precision)
        )
        # the timed run will hit the same escalation mid-training and
        # rebuild its jit to this configuration — pre-compile it now
        # (the XLA program then loads from the persistent cache instead
        # of compiling inside the timed section)
        t1 = time.time()
        lmc.param_array = x_before
        lmc._key = key_before
        lmc.optimize(optimizer=AdaDelta(max_it=1))
        _log("escalated-config warmup %.1fs" % (time.time() - t1))
        lmc.objective, lmc.exact_precision = obj_before, prec_before
        lmc._build_jit()
    lmc.param_array = x_before
    lmc._key = key_before
    if lmc.objective == "stochastic":
        # compile the escalated rescue-chunk program too, so a
        # mid-training solve breach doesn't pay its one-off compile
        # inside the timed section
        t1 = time.time()
        lmc.warm_rescue()
        _log("rescue-program warmup %.1fs" % (time.time() - t1))
    _log("jit warmup %.1fs" % (time.time() - t0))

    opt = AdaDelta(max_it=max_it, **opt_opts)
    t0 = time.time()
    info = lmc.optimize(optimizer=opt)
    t_train = time.time() - t0
    _log(
        "train %.2fs (%d iterations, %.3fs/iter)"
        % (t_train, info["n_iter"], t_train / info["n_iter"])
    )
    if "device_seconds" in info:
        _log(
            "  breakdown: %d device steps %.2fs (%.0f ms/step), host+"
            "transport %.2fs, mean solve iters %.1f, worst residual "
            "%.1e"
            % (
                info["device_steps"], info["device_seconds"],
                1e3 * info["device_seconds"] / max(info["device_steps"], 1),
                t_train - info["device_seconds"],
                info["mean_solve_iters"], info["max_solve_error"],
            )
        )

    t0 = time.time()
    pred_yss, pred_vss = lmc.predict(test_xss)
    t_pred_first = time.time() - t0
    t0 = time.time()
    pred_yss, pred_vss = lmc.predict(test_xss)
    t_pred = time.time() - t0
    s = smse(test_yss, pred_yss, yss)
    nl = nlpd(test_yss, pred_yss, pred_vss)

    # Solve-quality self-report: the NLPD above is computed on the
    # zero-variance-filtered test set (reference parity,
    # standard_tester.py:218-228) — meaningful only when the filtered
    # fraction is ~0, so the benchmark must surface it, along with the
    # certified prediction-solve residuals and the learned noise floor
    # (the conditioning driver).
    n_zero = sum(int((np.asarray(v) <= 0).sum()) for v in pred_vss)
    n_test = sum(len(np.asarray(v)) for v in pred_vss)
    rep = lmc.prediction_report
    pred_residual = max(
        (d["residual"] for d in rep.values()), default=float("nan")
    )
    escalated = any(d.get("escalated") for d in rep.values())
    noise = np.asarray(lmc.spec.noise(lmc.params))
    _log(
        "predict %.2fs (first %.2fs incl compile) smse %.4f nlpd %.4f "
        "zero-var %d/%d residual %.1e%s noise[min/med] %.1e/%.1e"
        % (t_pred, t_pred_first, s, nl, n_zero, n_test, pred_residual,
           " (escalated)" if escalated else "", noise.min(),
           float(np.median(noise)))
    )
    return {
        "train_s": t_train,
        "pred_s": t_pred,
        "build_s": t_build,
        "iters": info["n_iter"],
        "smse": s,
        "nlpd": nl,
        "zero_var_frac": n_zero / max(n_test, 1),
        "pred_residual": pred_residual,
        "escalated": escalated,
        "noise_min": float(noise.min()),
        "noise_med": float(np.median(noise)),
        "train_residual": float(info.get("max_solve_error", float("nan"))),
    }


def run_validate(name):
    """Tiny smoke run asserting quality sanity (wired into the test
    suite via tests/test_bench_validate.py so the benchmark pipeline
    cannot silently rot)."""
    cfg = VALIDATE[name]
    r = run_once(
        name, seed=0, m=cfg["m"], subsample=cfg["subsample"],
        max_it=cfg["max_it"],
    )
    assert np.isfinite(r["smse"]) and np.isfinite(r["nlpd"]), r
    assert r["smse"] < cfg["smse_max"], r
    out = {
        "metric": "%s_validate_smse" % name,
        "value": round(float(r["smse"]), 4),
        "unit": "smse",
        "validate": True,
        "train_s": round(r["train_s"], 2),
        "nlpd": round(float(r["nlpd"]), 4),
    }
    print(json.dumps(out))
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--benchmark", default="fx2007", choices=BUILDERS)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument(
        "--validate", action="store_true",
        help="tiny smoke config: subsampled data, few iterations, "
        "quality sanity asserts",
    )
    ap.add_argument(
        "--objective", default=None,
        choices=("auto", "exact", "stochastic"),
        help="override the builder's pinned training objective (e.g. "
        "'auto' to measure the defaults path including the held-out "
        "validation guard)",
    )
    args = ap.parse_args()
    if args.objective:
        base = BUILDERS[args.benchmark]

        def _override(m=None, _base=base):
            built = list(_base(m))
            built[7] = dict(built[7], objective=args.objective)
            return tuple(built)

        BUILDERS[args.benchmark] = _override

    if args.validate:
        run_validate(args.benchmark)
        return

    results = [
        run_once(args.benchmark, seed=1234 + i, m=args.m)
        for i in range(args.runs)
    ]
    train = np.array([r["train_s"] for r in results])
    baseline = BASELINES[args.benchmark]
    if args.benchmark == "weather" and args.m == 1000:
        baseline = 90.46  # the reference's m=1000 row (BASELINE.md)
    elif args.benchmark == "weather" and (args.m or 0) > 1000:
        # no published reference row beyond m=1000; compare against the
        # LARGEST published weather baseline (m=1000, 90.46 s) and let
        # the JSON say so — the reference's BTTB cost grows ~m log m,
        # so this undercounts the true m-matched baseline
        baseline = 90.46
    out = {
        "metric": "%s_train_s" % args.benchmark,
        "value": round(float(train.mean()), 3),
        "unit": "s",
        # speedup factor over the reference CPU baseline (>1 = faster)
        "vs_baseline": round(baseline / float(train.mean()), 3),
        "baseline_s": baseline,
        "m": args.m,
        **({"objective": args.objective} if args.objective else {}),
        "train_se": round(float(train.std() / np.sqrt(len(train))), 3),
        "pred_s": round(float(np.mean([r["pred_s"] for r in results])), 3),
        "smse": round(float(np.mean([r["smse"] for r in results])), 4),
        "nlpd": round(float(np.mean([r["nlpd"] for r in results])), 4),
        "iters": float(np.mean([r["iters"] for r in results])),
        "runs": args.runs,
        # quality self-report (see run_once): the NLPD is only at
        # reference parity when zero_var_frac ~ 0 and the prediction
        # solves certified their residuals
        "zero_var_frac": round(
            float(np.mean([r["zero_var_frac"] for r in results])), 4
        ),
        "pred_residual": float(
            np.max([r["pred_residual"] for r in results])
        ),
        "noise_min": float(np.min([r["noise_min"] for r in results])),
        "escalated_runs": int(sum(r["escalated"] for r in results)),
        "per_run": [
            {k: (round(float(r[k]), 5) if isinstance(r[k], float)
                 else r[k])
             for k in ("train_s", "smse", "nlpd", "zero_var_frac",
                       "pred_residual", "noise_min", "iters")}
            for r in results
        ],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
