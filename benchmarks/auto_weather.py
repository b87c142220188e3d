"""End-to-end weather benchmark at objective='auto' — the DEFAULTS
path a customer gets, including the held-out-block validation guard's
true cost (round-4 verdict item 6: the recorded benchmarks pinned
objectives and never paid it).

Flow: build (auto probes the f32 factorization and selects 'exact'),
optimize (the guard trains a capped twin on block-held-out data,
detects the weather gap-extrapolation pathology, demotes to
'stochastic', then the main training runs), predict, SMSE/NLPD.

The timed section is optimize()+predict end-to-end from a fresh
model; the guard's own wall-clock (including its one-off twin
compiles) is reported separately from the main training via the
model's INFO log timing. Writes benchmarks/out/auto_weather.json.

Usage: python benchmarks/auto_weather.py [--m 500]
"""

import argparse
import json
import logging
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


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=500)
    args = ap.parse_args()

    from bench import build_weather
    from runlmc_tpu import AdaDelta, InterpolatedLLGP
    from runlmc_tpu.utils.evaluation import nlpd, smse

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    (xss, yss, test_xss, test_yss, spec, mlist, opt_opts, model_opts) = (
        build_weather(args.m)
    )
    model_opts = dict(model_opts, objective="auto")

    t0 = time.time()
    lmc = InterpolatedLLGP(
        xss, yss, functional_kernel=spec, normalize=True, m=mlist,
        seed=1234, **model_opts,
    )
    t_build = time.time() - t0
    _log("model built in %.1fs; auto resolved to objective=%r "
         "(guard pending: %s)"
         % (t_build, lmc.objective, lmc._auto_exact_guard))

    guard_s = {}
    orig = InterpolatedLLGP._validate_exact_objective

    def timed_guard(self, optimizer):
        t = time.time()
        out = orig(self, optimizer)
        guard_s["seconds"] = time.time() - t
        return out

    InterpolatedLLGP._validate_exact_objective = timed_guard
    try:
        t0 = time.time()
        info = lmc.optimize(optimizer=AdaDelta(**opt_opts))
        t_opt = time.time() - t0
    finally:
        InterpolatedLLGP._validate_exact_objective = orig

    t0 = time.time()
    pred_yss, pred_vss = lmc.predict(test_xss)
    t_pred = time.time() - t0
    s = smse(test_yss, pred_yss, yss)
    nl = nlpd(test_yss, pred_yss, pred_vss)
    n_zero = sum(int((np.asarray(v) <= 0).sum()) for v in pred_vss)
    n_test = sum(len(np.asarray(v)) for v in pred_vss)

    gsec = guard_s.get("seconds", 0.0)
    out = {
        "metric": "auto_weather_end_to_end_s",
        "value": round(t_opt + t_pred, 2),
        "unit": "s (optimize incl guard + predict, fresh model, "
                "compiles included)",
        "m": args.m,
        "objective_final": lmc.objective,
        "guard_s": round(gsec, 2),
        "guard_fraction_of_optimize": round(gsec / max(t_opt, 1e-9), 3),
        "main_train_s": round(t_opt - gsec, 2),
        "pred_s": round(t_pred, 2),
        "build_s": round(t_build, 2),
        "iters": int(info["n_iter"]),
        "smse": round(float(s), 4),
        "nlpd": round(float(nl), 4),
        "zero_var_frac": round(n_zero / max(n_test, 1), 4),
        "train_residual": float(info.get("max_solve_error", float("nan"))),
    }
    print(json.dumps(out))
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "out",
        "auto_weather.json",
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
