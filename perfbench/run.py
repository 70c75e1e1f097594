"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the traffic's ``kind`` picks its runner
(:mod:`perfbench.harness.train` or :mod:`perfbench.harness.serve`). The
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics, read by ``metrics/<name>.py``, with ``--trace 1``),
``device``, with ``--trace 1`` also ``breakdown``, and last ``compared``,
each number that decides ``correct`` beside its limit, which also close
standard error.

Exits 3 without printing a result when the card or cards the cell asks for
are missing, and 4 when JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "ray_marching_tpu"}


def runners():
    from perfbench.harness import serve, train

    return {"train_fit": train.run, "serve_orbit": serve.run}


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``ray_marching_tpu_torch`` is not ``ray_marching_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no card"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def run_cell(cell, seed, seconds, trace, device, t0):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return runners()[cell.traffic["kind"]](cell, seed, seconds, trace,
                                           torch.device(device), t0)


def metrics_of(cell, result, trace) -> dict:
    from perfbench.harness.spec import reader

    out = {}
    if not trace:
        for m in cell.end_to_end:
            value = (result.setup_s if m["name"] == "setup_s"
                     else result.e2e[m["name"]])
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = reader(m["name"])(result.summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def report(cell, result, trace, device_info) -> dict:
    from perfbench.harness.compare import judge

    correct, compared = judge(result.numbers, cell.limits)
    line = {"correct": correct, "attempted": result.attempted,
            "failed": result.failed,
            "metrics": metrics_of(cell, result, trace),
            "device": dict(device_info,
                           memory_peak_bytes=result.memory_peak_bytes)}
    if trace:
        s = result.summary
        line["device"].update(busy_s=s.busy_s, window_s=s.span_s)
        line["breakdown"] = s.breakdown()
    line["compared"] = compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 3
    # One host thread for torch's CPU work: the loop is one process
    # launching kernels, and idle pool threads spinning beside it slow it.
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips}
    line = report(cell, result, bool(args.trace), info)
    print(f"card: {card_line()}", file=sys.stderr)
    notes = dict(result.notes)
    if line["correct"]:
        notes.pop("detail", None)
    print(f"notes: {json.dumps(notes, default=str)}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
