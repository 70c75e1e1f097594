"""The traced run's device trace: torch.profiler over single steps or
frames of the window, one profiler cycle each, reduced to what the
per-layer readers need.

One call per cycle, each ended by the step's own synchronising read: a
cycle over several calls has been seen to lose a whole kernel's records. A
cycle that holds fewer records of the program's forward or backward kernel
than its launch counters moved is discarded and the next step traced in its
place, at most ``max_dropped`` times.

A cycle's span runs from its first host or device event to its last, and
holds one step. A cycle of a pipelined loop, whose frames overlap on the
card, is read between the starts of its first and last forward kernels
(``clip``): whole frame periods, one a kernel start, with the device
records that start inside them. The device is busy where a kernel, copy or
set runs; an idle stretch is named after the innermost host operation
running at its middle.
"""

from __future__ import annotations

import json
import re
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function"}
_IDENT = re.compile(r"^(?:void\s+)?([A-Za-z_][\w:]*)")


def ident(name: str) -> str:
    """A kernel's bare name: ``void render_bwd_kernel<float, ...>(...)`` ->
    ``render_bwd_kernel``."""
    m = _IDENT.match(name)
    return m.group(1).split("::")[-1] if m else name


def is_forward(name: str) -> bool:
    """The program's forward kernels (``ops/csrc/render_fwd.cu``)."""
    return ident(name).startswith("render_fwd")


def is_backward(name: str) -> bool:
    """The program's backward kernel (``ops/csrc/render_bwd.cu``)."""
    return ident(name).startswith("render_bwd")


def is_port_kernel(name: str) -> bool:
    """Any hand-written CUDA kernel of the program (forward, backward,
    march)."""
    i = ident(name)
    return i.endswith("_kernel") and (i.startswith("render_fwd")
                                      or i.startswith("render_bwd")
                                      or i.startswith("march"))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Cycle:
    """One traced stretch of ``units`` steps or frames; times in seconds."""

    span_s: float
    busy_s: float
    device: list  # (name, cat, seconds)
    gaps: list  # (host op name, seconds)
    units: int = 1


def reduce_events(events, clip=None) -> Cycle:
    """A cycle from chrome-trace events (``ts``, ``dur`` in µs); with
    ``clip``, a kernel predicate, only the periods between the starts of
    the kernels it names."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((e.get("name", "?"), cat, a, b))
        elif cat in HOST_CATS:
            host.append((e.get("name", "?"), a, b))
    units = 1
    if clip is None:
        ends = [x[2:] for x in dev] + [x[1:] for x in host]
        if not ends:
            return Cycle(0.0, 0.0, [], [], 0)
        lo, hi = min(a for a, _ in ends), max(b for _, b in ends)
    else:
        starts = sorted(a for n, c, a, _ in dev
                        if c == "kernel" and clip(n))
        if len(starts) < 2:
            return Cycle(0.0, 0.0, [], [], 0)
        lo, hi, units = starts[0], starts[-1], len(starts) - 1
        dev = [x for x in dev if lo <= x[2] < hi]
    busy = _union([(max(a, lo), min(b, hi)) for _, _, a, b in dev])
    gaps, t = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > t:
            mid = 0.5 * (t + a)
            inner = [h for h in host if h[1] <= mid <= h[2]]
            name = (max(inner, key=lambda h: h[1])[0] if inner
                    else "host outside torch operations")
            gaps.append((name, (a - t) * 1e-6))
        t = max(t, b)
    return Cycle(span_s=(hi - lo) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 device=[(n, c, (b - a) * 1e-6) for n, c, a, b in dev],
                 gaps=gaps, units=units)


@dataclass
class Summary:
    """What the readers read: kept cycles, the cell's work and peaks."""

    kind: str
    cycles: list
    work: dict
    peaks: dict

    @property
    def units(self) -> int:
        return sum(c.units for c in self.cycles)

    @property
    def span_s(self) -> float:
        return sum(c.span_s for c in self.cycles)

    @property
    def busy_s(self) -> float:
        return sum(c.busy_s for c in self.cycles)

    def device_seconds(self, pred=lambda name: True, kernels_only=False):
        return sum(s for c in self.cycles for n, cat, s in c.device
                   if pred(n) and (cat == "kernel" or not kernels_only))

    def records(self, pred=lambda name: True, kernels_only=True) -> int:
        return sum(1 for c in self.cycles for n, cat, _ in c.device
                   if pred(n) and (cat == "kernel" or not kernels_only))

    def least_seconds(self, item: str) -> float:
        return self.work[item].least_seconds(self.peaks)

    def breakdown(self, top=10) -> dict:
        ops, gaps = {}, {}
        for c in self.cycles:
            for n, _, s in c.device:
                ops[n[:160]] = ops.get(n[:160], 0.0) + s
            for n, s in c.gaps:
                gaps[n[:160]] = gaps.get(n[:160], 0.0) + s
        ranked = (lambda d: [[k, v] for k, v in
                             sorted(d.items(), key=lambda kv: -kv[1])[:top]])
        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


class Tracer:
    """Profiles one stretch of work per cycle: ``begin()`` before it,
    ``end(expected, clip)`` after its synchronising read, where
    ``expected`` maps a kernel predicate to the launches the program's
    counters saw (and ``clip`` is :func:`reduce_events`')."""

    def __init__(self, cycles: int, max_dropped: int = 3):
        self.want, self.max_dropped = cycles, max_dropped
        self.kept, self.dropped = [], 0
        self._prof = None

    @property
    def done(self) -> bool:
        return len(self.kept) >= self.want

    def begin(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()

    def discard(self):
        """End a cycle without keeping it: set-up traces one step or frame
        this way, since the profiler's first cycle initializes its device
        tracing, which takes seconds."""
        prof, self._prof = self._prof, None
        prof.stop()

    def end(self, expected: dict, clip=None):
        prof, self._prof = self._prof, None
        prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "cycle.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        cycle = reduce_events(events, clip)
        kernels = [e.get("name", "") for e in events
                   if e.get("ph") == "X"
                   and str(e.get("cat", "")).lower() == "kernel"]
        short = {k: n for k, (pred, n) in expected.items()
                 if sum(map(pred, kernels)) < n}
        if short and self.dropped < self.max_dropped:
            self.dropped += 1
            print(f"trace: cycle discarded, records short of launches "
                  f"{short}", file=sys.stderr)
            return
        self.kept.append(cycle)
