"""One traced run of a cell, split by the program's spans (on the card):

    python3 perfbench/tools/span_split.py --workload <name> --seed <n> --seconds <s>

Runs the cell as ``perfbench/run.py --trace 1`` does, each traced cycle
reduced by :func:`perfbench.harness.span_readers.reduce_events` (the
harness's reduction with the program's spans kept), and prints, as the last
line of standard output, one JSON object: the run's ``correct``, its
per-layer ``metrics``, ``device``, the traced ``units`` and ``span_ms`` (the
traced span per step or frame), ``readings``
(:func:`perfbench.harness.span_readers.readings`: ``host_ms``,
``idle_host_ms``, ``wrapper_host_ms`` and, in a fit, ``bwd_glue_device_ms``,
per step or frame), and ``split``
(:func:`perfbench.harness.span_readers.split`): per step or frame, for each
span name (``null``: none), its count and host ms, the device ms and records
it launched innermost, the part of them outside the program's kernels, and
the device idle under it. A training cell adds ``backward_by_phase``: the
device ms of the records autograd launched inside ``rm.optimize.backward``
(outside the kernel wrappers), by the program span that held the forward
operation they differentiate (matched by autograd's sequence number), and
the backward nodes that launched most.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


from perfbench.harness.span_readers import innermost  # noqa: E402

EVALUATE = "autograd::engine::evaluate_function: "


def backward_by_phase(events) -> tuple:
    """``({forward span: device ms}, {backward node: device ms})`` of one
    cycle's chrome-trace events, for the records whose launching call lies
    innermost in ``rm.optimize.backward``."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans, calls, fwd, nodes, dev = [], {}, {}, [], []
    for e in timed:
        cat, name = str(e.get("cat", "")).lower(), str(e.get("name", ""))
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        args = e.get("args") or {}
        seq = args.get("Sequence number")
        if cat == "user_annotation" and name.startswith("rm."):
            spans.append((name, a, b))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            calls[args["correlation"]] = a
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((name, b - a, args.get("correlation")))
        elif cat == "cpu_op" and name.startswith(EVALUATE):
            nodes.append((name[len(EVALUATE):], a, b, seq))
        elif cat == "cpu_op" and seq is not None:
            fwd[seq] = min(fwd.get(seq, a), a)
    by_phase, by_node = {}, {}
    for name, dur, corr in dev:
        t = calls.get(corr)
        held = None if t is None else innermost(spans, t)
        if held is None or held[0] != "rm.optimize.backward":
            continue
        node = innermost(nodes, t)
        phase = "no autograd node"
        if node is not None:
            start = fwd.get(node[3])
            inner = None if start is None else innermost(spans, start)
            phase = inner[0] if inner else "no forward span"
            by_node[node[0]] = by_node.get(node[0], 0.0) + dur * 1e-3
        by_phase[phase] = by_phase.get(phase, 0.0) + dur * 1e-3
    return by_phase, by_node


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench import run
    from perfbench.harness import span_readers
    from perfbench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("span_split: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    torch.set_num_threads(1)
    # Each traced cycle reduced with the program's spans kept, and its raw
    # events beside it, to follow autograd's nodes back to their forward
    # operations.
    raw = []
    with span_readers.in_the_tracer(raw):
        result = run.run_cell(cell, args.seed, args.seconds, True, "cuda",
                              T0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "card": run.card_line()}
    line = run.report(cell, result, True, info)
    s = result.summary
    phases, nodes = {}, {}
    for events, cycle in raw:
        if s.kind == "train" and any(cycle is c for c in s.cycles):
            for total, part in zip((phases, nodes),
                                   backward_by_phase(events)):
                for k, v in part.items():
                    total[k] = total.get(k, 0.0) + v / s.units
    top = dict(sorted(nodes.items(), key=lambda kv: -kv[1])[:12])
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "correct": line["correct"], "metrics": line["metrics"],
        "device": line["device"], "units": s.units,
        "span_ms": 1e3 * s.span_s / s.units if s.units else None,
        "readings": span_readers.readings(s),
        "split": {str(k): v for k, v in span_readers.split(s).items()},
        "backward_by_phase": phases, "backward_nodes": top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
