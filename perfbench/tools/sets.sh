#!/bin/sh
# The two full sets of one cell on the card, each run a process of its own:
# set A and set B over the same six seeds, then three traced runs on seeds
# of their own. Result lines go to chiprun_out/perfbench/sets/<cell>.jsonl
# ({"set", "seed", "trace", "rc", "wall_s", "line"}), standard error of each
# run beside them.
# Arguments: <workload> <seconds> <first seed>
set -u
cell=$1; secs=$2; s0=$3
out=chiprun_out/perfbench/sets
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
  t=$(date +%s)
  python3 perfbench/run.py --workload "$cell" --seed "$2" --seconds "$secs" --trace "$3" \
    > "$out/$cell.$1.$2.out" 2> "$out/$cell.$1.$2.err"
  rc=$?
  python3 - "$1" "$2" "$3" "$rc" "$(( $(date +%s) - t ))" "$out/$cell.$1.$2.out" >> "$out/$cell.jsonl" <<'PY'
import json, sys
s, seed, tr, rc, wall, path = sys.argv[1:]
lines = open(path).read().strip().splitlines()
line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
print(json.dumps({"set": s, "seed": int(seed), "trace": int(tr), "rc": int(rc),
                  "wall_s": int(wall), "line": line}))
PY
  tail -n 1 "$out/$cell.jsonl" | cut -c1-400
}
for s in A B; do
  for i in 1 2 3 4 5 6; do run $s $((s0 + i)) 0; done
done
for i in 7 8 9; do run T $((s0 + i)) 1; done
