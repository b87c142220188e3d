"""Continuous benchmark tracking across commits (the reference's asv
layer: asv.conf.json + asvrun.sh publish fx2007/weather time/SMSE/NLPD
per commit; reference benchmarks/asv/*/[fx2007|weather].py).

Runs the three benchmark configs in --validate scale (CPU-runnable, so
CI can execute it) and appends one JSON line per metric to
``benchmarks/out/history.jsonl`` keyed by commit hash and timestamp.
Full-scale device numbers land in the same history through
``--record`` (a bench.py output file).

Usage:
  python benchmarks/track.py                 # validate-scale, append
  python benchmarks/track.py --record f.json # append a bench.py output
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HISTORY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "out", "history.jsonl")


def _commit():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except Exception:
        return "unknown"


def _append(rec):
    os.makedirs(os.path.dirname(HISTORY), exist_ok=True)
    with open(HISTORY, "a") as f:
        f.write(json.dumps(rec) + "\n")


def record_file(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            rec.update(commit=_commit(), ts=round(time.time(), 1),
                       scale="full")
            _append(rec)
            print(json.dumps(rec))


def run_validate_tracking():
    # validate scale is a CI smoke — pin CPU so the tracking run never
    # occupies (or queues behind) the accelerator; full-scale numbers
    # arrive via --record from real bench.py runs
    import jax

    jax.config.update("jax_platforms", "cpu")
    import bench

    commit = _commit()
    for name in ("fx2007", "weather", "synth"):
        r = bench.run_validate(name)
        rec = {
            "commit": commit,
            "ts": round(time.time(), 1),
            "scale": "validate",
            "benchmark": name,
            "train_s": round(float(r["train_s"]), 3),
            "smse": round(float(r["smse"]), 4),
            "nlpd": round(float(r["nlpd"]), 4),
            "iters": int(r["iters"]),
        }
        _append(rec)
        print(json.dumps(rec))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", default=None,
                    help="append a bench.py JSON output file to history")
    args = ap.parse_args()
    if args.record:
        record_file(args.record)
    else:
        run_validate_tracking()


if __name__ == "__main__":
    main()
