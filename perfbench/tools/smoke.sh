#!/bin/sh
# Each cell once, short, on the card: python3 perfbench/run.py per cell,
# logs under chiprun_out/perfbench/.
set -u
out=chiprun_out/perfbench/${1:-smoke}
mkdir -p "$out"
shift
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for spec in "$@"; do
  set -- $(echo "$spec" | tr ':' ' ')
  name=$1; seed=$2; secs=$3; tr=$4
  t=$(date +%s)
  python3 perfbench/run.py --workload "$name" --seed "$seed" --seconds "$secs" --trace "$tr" \
    > "$out/$name.$seed.$tr.out" 2> "$out/$name.$seed.$tr.err"
  rc=$?
  echo "== $name seed=$seed trace=$tr rc=$rc wall=$(( $(date +%s) - t ))s"
  tail -c 3000 "$out/$name.$seed.$tr.err" | grep -v "^USDT\|SyncActivity" | tail -12
  tail -n 1 "$out/$name.$seed.$tr.out" | cut -c1-2500
done
