#!/bin/sh
# Readings for the limits of correct, on the card: perfbench/calibrate.py
# per cell, one JSON line a reading, under chiprun_out/perfbench/calib/.
# Arguments: <tag> then "<workload>:<seeds>:<controls>:<faults>[:<seconds>]" ...
# (<faults> may be "-" for none; <seconds> is the window of a served run).
set -u
out=chiprun_out/perfbench/calib/$1
mkdir -p "$out"
shift
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for spec in "$@"; do
  set -- $(echo "$spec" | tr ':' ' ')
  t=$(date +%s)
  f=${4:-}; [ "$f" = "-" ] && f=""
  python3 perfbench/calibrate.py --workload "$1" --seeds "$2" --controls "$3" \
    --faults "$f" --seconds "${5:-2}" > "$out/$1.jsonl" 2> "$out/$1.err"
  echo "== $1 rc=$? wall=$(( $(date +%s) - t ))s"
  grep -v '^USDT' "$out/$1.err" | tail -5
  cut -c1-1500 "$out/$1.jsonl"
done
