#!/usr/bin/env python3
"""``cli bench`` on each of its routes, on the H100.

Run from the root of a checkout on a machine with one card:

    python3 tools/torch_bench_routes.py [--rounds N]

It runs ``python -m ray_marching_tpu_torch.cli bench`` once per route
(default, ``--no-fast``, ``--backward unroll``, ``--backward implicit``,
``--pallas``), each in a process of its own as a user runs it, the routes
in turns (forward order, then reversed, ``--rounds`` times; the first run
builds the kernels). From each run it keeps the two JSON lines, the CPU
leg's rays/s (its progress line) and the seconds the command took. Prints
one JSON line and writes it to ``chiprun_out/bench_routes.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUTES = {
    "default": [],
    "--no-fast": ["--no-fast"],
    "--backward unroll": ["--backward", "unroll"],
    "--backward implicit": ["--backward", "implicit"],
    "--pallas": ["--pallas"],
}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run_route(flags):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ray_marching_tpu_torch.cli",
                          "bench", *flags], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    sys.stderr.write(out.stderr)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or len(lines) < 2:
        raise RuntimeError(f"cli bench {flags}: rc {out.returncode}, "
                           f"stdout {lines}")
    cpu = re.search(r"CPU leg done: ([0-9.e+]+) rays/s", out.stderr)
    return {"headline": json.loads(lines[-1]), "forward": json.loads(lines[-2]),
            "cpu_rays_per_sec": float(cpu.group(1)) if cpu else None,
            "seconds": seconds}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    names = list(ROUTES)
    order = []
    for _ in range(args.rounds):
        order += names + names[::-1]
    runs = {name: [] for name in names}
    for name in order:
        run = run_route(ROUTES[name])
        runs[name].append(run)
        print(f"{name} on {card}: {json.dumps(run)}", flush=True)
    result = {"card": card, "order": order, "runs": runs}
    out = ROOT / "chiprun_out" / "bench_routes.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
