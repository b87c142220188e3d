"""Calibration of VALIDATION_GUARD_MAX_IT — round-4 verdict item 6.

The 'auto' objective's overconfidence guard trains a TWIN model with
the exact objective on block-held-out data and measures the held-out
z^2 statistic + zero-variance fraction. Round 4 trained the twin to
the full max_it, silently doubling the defaults-path training cost.
This script measures how early the breach signal is visible on the
REAL measured pathology (weather: exact objective -> gap-extrapolation
overconfidence, held-out NLPD 10-21) and on the healthy counterpart
(fx2007: exact objective validates and is kept), by training each
benchmark's guard twin incrementally (AdaDelta resumable state) and
recording (z^2, zero-variance fraction, breach?) at increasing
iteration counts.

CPU-only (f64; the guard itself is platform-independent).
Writes benchmarks/out/guard_calibration.json.

Usage: python benchmarks/guard_calibration.py [--quick]
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

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure(name, checkpoints):
    from bench import BUILDERS
    from runlmc_tpu import AdaDelta, InterpolatedLLGP
    from runlmc_tpu.models.interpolated_llgp import (
        VALIDATION_ZEROVAR_THRESHOLD,
        VALIDATION_ZSQ_THRESHOLD,
    )

    (xss, yss, _, _, spec, mlist, opt_opts, model_opts) = BUILDERS[name]()
    model_opts = dict(model_opts)
    # the guard only runs for the auto-selected exact objective; build
    # the MAIN model with the pinned stochastic/exact objective out of
    # the way so we can drive the twin ourselves
    model_opts["objective"] = "exact"
    main = InterpolatedLLGP(
        xss, yss, functional_kernel=spec, normalize=True, m=mlist,
        seed=1234, **model_opts,
    )
    Xs_tr, Ys_tr, Xs_va, Ys_va = main._validation_split()
    ctor = dict(main._ctor)
    twin = InterpolatedLLGP(
        Xs_tr, Ys_tr, objective="exact", name=name + "-guard", **ctor,
    )

    def held_out_stats():
        mus, vs = twin.predict(Xs_va)
        z2s, n_zero, n_tot = [], 0, 0
        for mu, v, yv in zip(mus, vs, Ys_va):
            v, mu = np.asarray(v), np.asarray(mu)
            n_tot += len(v)
            zero = v <= 0
            n_zero += int(zero.sum())
            ok = ~zero
            if ok.any():
                z2s.append(((yv[ok] - mu[ok]) ** 2) / v[ok])
        z2 = float(np.mean(np.concatenate(z2s))) if z2s else float("inf")
        return z2, n_zero / max(n_tot, 1)

    rows = []
    state = None
    t_cum = 0.0
    for it in checkpoints:
        t0 = time.time()
        info = twin.optimize(
            optimizer=AdaDelta(max_it=it, **opt_opts), state=state
        )
        t_cum += time.time() - t0
        state = info["state"]
        z2, zfrac = held_out_stats()
        breach = (
            z2 > VALIDATION_ZSQ_THRESHOLD
            or zfrac > VALIDATION_ZEROVAR_THRESHOLD
        )
        rows.append({
            "iters": info["n_iter"], "z2": round(z2, 3),
            "zero_var_frac": round(zfrac, 4), "breach": breach,
            "cumulative_train_s": round(t_cum, 2),
        })
        _log("%s @ %3d iters: z^2 %10.3g  zero-var %6.2f%%  %s (%.1fs)"
             % (name, info["n_iter"], z2, 100 * zfrac,
                "BREACH" if breach else "ok", t_cum))
        if info["n_iter"] < it:
            break  # stopping rule ended training early
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="weather only, fewer checkpoints")
    args = ap.parse_args()
    checkpoints = [5, 10, 15, 25, 50, 100]
    if args.quick:
        checkpoints = [5, 10, 25]
    out = {"metric": "guard_calibration", "unit": "iters-to-signal",
           "benchmarks": {}}
    names = ["weather"] if args.quick else ["weather", "fx2007"]
    for name in names:
        out["benchmarks"][name] = measure(name, checkpoints)
    w = out["benchmarks"]["weather"]
    first_breach = next((r["iters"] for r in w if r["breach"]), None)
    out["value"] = first_breach
    out["note"] = (
        "weather = the measured pathology (must breach early); fx2007 "
        "= healthy (must never breach). VALIDATION_GUARD_MAX_IT is "
        "sound iff it is >= the weather first-breach iteration with "
        "margin, and fx2007 shows no false positive at that cap."
    )
    print(json.dumps(out))
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "out",
        "guard_calibration.json",
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
