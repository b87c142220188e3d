#!/bin/bash
# Style gate (reference analog: style.sh running pylint). Uses ruff when
# available (CI); falls back to a byte-compile pass locally.
set -e
cd "$(dirname "$0")"
if command -v ruff >/dev/null 2>&1; then
    ruff check runlmc_tpu tests benchmarks bench.py chip_smoke.py __graft_entry__.py \
        --select E9,F63,F7,F82,F401,F811,F841 --line-length 100
else
    echo "ruff unavailable; byte-compile check only"
    python -m compileall -q runlmc_tpu tests benchmarks bench.py chip_smoke.py \
        __graft_entry__.py
fi
echo "style OK"
