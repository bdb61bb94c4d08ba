#!/usr/bin/env bash
# The single-pod dry-run sweep: every (arch x shape) cell of
# `repro_torch.launch.dryrun --all`, JOBS traces at a time, each process
# with the rest of a BUDGET_S-second budget (a cell that does not finish in
# it is listed as cut).  Each cell's JSON and op log land in build/dryrun/;
# the logs, the JSONs and the report are copied to OUT.
#
# Usage (from the repository root; the fake tensors lie on the card unless
# DEVICE=cpu):
#   bash scripts/dryrun_sweep.sh [OUT] [BUDGET_S] [JOBS]
set -u
OUT=${1:-build/dryrun-sweep}
BUDGET_S=${2:-1680}
JOBS=${3:-7}
DEVICE=${DEVICE:-cuda}
mkdir -p "$OUT"
start=$(date +%s)
PYTHONPATH=src python -c '
from repro_torch.configs import SHAPES, get_config, list_archs, shape_applicable
for a in list_archs():
    for s in SHAPES:
        if shape_applicable(get_config(a), s)[0]:
            print(a, s)' > "$OUT/cells.txt"
export OUT BUDGET_S DEVICE start
xargs -P "$JOBS" -L 1 sh -c '
  left=$(( BUDGET_S - ($(date +%s) - start) ))
  [ $left -gt 30 ] || { echo "[cut ] $0 $1: no time left"; exit 0; }
  s=$(date +%s)
  PYTHONPATH=src timeout $left python -m repro_torch.launch.dryrun --arch $0 --shape $1 \
      --device $DEVICE > "$OUT/$0__$1.log" 2>&1
  echo "[rc=$?] $0 $1 $(( $(date +%s) - s ))s"' < "$OUT/cells.txt"
cp build/dryrun/*.json "$OUT/" 2>/dev/null
PYTHONPATH=src python -m benchmarks.torch_roofline
PYTHONPATH=src python -m benchmarks.torch_report --out "$OUT/REPORT.md"
echo "sweep $(( $(date +%s) - start ))s"
