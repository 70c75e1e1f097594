"""The program's own spans (``ray_marching_tpu_torch/spans.py``: ``rm.*``
``record_function`` ranges) in a traced cycle, and what is read from them,
each for one kind of traced work (``train``: fit steps; ``serve``: served
frames), per step or frame.

The spans arrive in the profiler's trace beside the device records, on one
clock. :func:`reduce_events` is :func:`perfbench.harness.trace.reduce_events`
with them kept: the cycle's spans cut to it, its idle stretches, and for
each device record the spans open when the host call that launched it
began, matched by ``correlation``. ``perfbench/tools/span_split.py`` puts
it in the traced run's place (:func:`in_the_tracer`). A reader returns
``None`` where no cycle holds a program span (a program without them, or a
cycle reduced without them), never 0.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

from perfbench.harness import trace
from perfbench.harness.trace import (DEVICE_CATS, HOST_CATS, Cycle, _union,
                                     is_port_kernel)
from perfbench.harness.trace import reduce_events as _reduce

#: The program's spans: ``record_function`` ranges whose names start so.
SPAN_PREFIX = "rm."
#: Host calls that launch device work, matched to it by ``correlation``.
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
#: The span of one step or frame, and the one wait inside it the program
#: intends: ``optimize``'s loss read and the viewer's event wait.
STEP = {"train": "rm.optimize.step", "serve": "rm.viewer.frame"}
WAIT = {"train": "rm.optimize.sync", "serve": "rm.viewer.wait"}
BACKWARD = "rm.optimize.backward"
WRAPPER = "rm.kernel."


@dataclass
class SpanCycle(Cycle):
    """A :class:`Cycle` with the program's spans beside its records."""

    # The program's spans that overlap the cycle, (name, start, end) in
    # seconds from its start, cut to it; on any thread.
    spans: list = field(default_factory=list)
    # Parallel to ``device``: the names of the spans open at the start of
    # each record's launching host call, outermost first (none without a
    # call).
    launched_in: list = field(default_factory=list)
    # The device's idle stretches, (start, end) as ``spans``.
    idle: list = field(default_factory=list)


def reduce_events(events, clip=None) -> SpanCycle:
    """:func:`perfbench.harness.trace.reduce_events`' cycle of ``events``,
    with the same window, records and readings, and the program's spans
    beside it."""
    base = _reduce(events, clip)
    dev, ends, calls, marks = [], [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        args = e.get("args") or {}
        name = e.get("name", "?")
        if cat in DEVICE_CATS:
            dev.append((name, cat, a, b, args.get("correlation")))
        elif cat in HOST_CATS:
            ends.append((a, b))
            if cat in LAUNCH_CATS and "correlation" in args:
                calls[args["correlation"]] = a
            if cat == "user_annotation" and str(name).startswith(SPAN_PREFIX):
                marks.append((name, a, b))
    if base.units == 0:
        return SpanCycle(**vars(base))
    if clip is None:
        ends += [x[2:4] for x in dev]
        lo, hi = min(a for a, _ in ends), max(b for _, b in ends)
    else:
        starts = sorted(a for n, c, a, _, _ in dev
                        if c == "kernel" and clip(n))
        lo, hi = starts[0], starts[-1]
        dev = [x for x in dev if lo <= x[2] < hi]
    busy = _union([(max(a, lo), min(b, hi)) for _, _, a, b, _ in dev])
    idle, t = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > t:
            idle.append(((t - lo) * 1e-6, (a - lo) * 1e-6))
        t = max(t, b)
    spans, launched_in = program_spans(marks, calls, [x[4] for x in dev],
                                       lo, hi)
    return SpanCycle(**vars(base), spans=spans, launched_in=launched_in,
                     idle=idle)


@contextmanager
def in_the_tracer(raw=None):
    """Within, the harness's traced cycles (``trace.Tracer.end``) are
    reduced by :func:`reduce_events`, with the spans kept; with ``raw``, a
    list, each cycle's events and its reduction are appended to it."""

    def reduce(events, clip=None):
        cycle = reduce_events(events, clip)
        if raw is not None:
            raw.append((events, cycle))
        return cycle

    trace.reduce_events = reduce
    try:
        yield
    finally:
        trace.reduce_events = _reduce


def program_spans(marks, calls, corr, lo, hi):
    """The program's spans ``marks`` ((name, start, end) in µs) that
    overlap ``[lo, hi]``, cut to it, in seconds from ``lo``; and for each
    device record's correlation id in ``corr`` the names of the spans open
    at the start of its launching host call (``calls``: id -> start),
    outermost (earliest started, longest) first, on any thread: autograd
    runs a backward's launches on a thread of its own, inside the span the
    step's thread holds open."""
    by_start = sorted(marks, key=lambda m: (m[1], -m[2]))
    spans = [(n, (max(a, lo) - lo) * 1e-6, (min(b, hi) - lo) * 1e-6)
             for n, a, b in by_start if a < hi and b > lo]
    launched_in = []
    for k in corr:
        t = calls.get(k)
        launched_in.append(() if t is None else
                           tuple(n for n, a, b in by_start if a <= t <= b))
    return spans, launched_in


def _spanned(s, kind) -> bool:
    return (s is not None and s.kind == kind and s.units > 0
            and any(getattr(c, "spans", None) for c in s.cycles))


def _named(cycle, name):
    return _union([(a, b) for n, a, b in cycle.spans if n == name])


def _intersect(xs, ys):
    """The overlap of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _outside_wait(cycle, kind, intervals):
    """Seconds of ``intervals`` inside the step or frame span and outside
    its wait span."""
    inside = _intersect(_union(intervals), _named(cycle, STEP[kind]))
    return _length(inside) - _length(_intersect(inside,
                                                _named(cycle, WAIT[kind])))


def host_ms(s, kind):
    """Host time per step or frame in the step or frame span, less the
    time in its wait: the host's own work, the issue of the device's work
    included."""
    if not _spanned(s, kind):
        return None
    return 1e3 * sum(_outside_wait(c, kind, [(0.0, c.span_s)])
                     for c in s.cycles) / s.units


def idle_host_ms(s, kind):
    """Device idle per step or frame that falls inside the step or frame
    span and outside its wait: idle the host's issue leaves."""
    if not _spanned(s, kind):
        return None
    return 1e3 * sum(_outside_wait(c, kind, c.idle)
                     for c in s.cycles) / s.units


def wrapper_host_ms(s, kind):
    """Host time per step or frame in the kernel wrappers' spans
    (``rm.kernel.*``), on any thread: checks, buffers, allocations and the
    C entry with its launch."""
    if not _spanned(s, kind):
        return None
    return 1e3 * sum(b - a for c in s.cycles for n, a, b in c.spans
                     if n.startswith(WRAPPER)) / s.units


def bwd_glue_device_ms(s, kind="train"):
    """Device time per step of the records other than the program's CUDA
    kernels whose launch falls inside ``rm.optimize.backward``: autograd
    through the shading, the ray stack and the posing, and the backward
    wrapper's own sums."""
    if kind != "train" or not _spanned(s, kind):
        return None
    return 1e3 * sum(sec for c in s.cycles
                     for (n, _, sec), opened in zip(c.device, c.launched_in)
                     if BACKWARD in opened and not is_port_kernel(n)
                     ) / s.units


#: What :func:`readings` gives, by the kinds each reads.
READERS = {"host_ms": host_ms, "idle_host_ms": idle_host_ms,
           "wrapper_host_ms": wrapper_host_ms,
           "bwd_glue_device_ms": bwd_glue_device_ms}


def readings(s) -> dict:
    """Each reader's value for the summary's kind, under
    ``<reader>.<kind>``; a reader with nothing to read is left out."""
    if s is None:
        return {}
    out = {f"{name}.{s.kind}": f(s, s.kind) for name, f in READERS.items()}
    return {k: v for k, v in out.items() if v is not None}


def innermost(intervals, t):
    """Of ``(name, start, end, ...)`` entries, the one open at ``t`` that
    started last (of two that started together, the shorter), or None."""
    inner = [x for x in intervals if x[1] <= t <= x[2]]
    return max(inner, key=lambda x: (x[1], -x[2])) if inner else None


def split(s) -> dict:
    """Per step or frame, for each span name (``None``: no span): its
    count and host ms (the spans that overlap the cycles, cut to them), the
    device ms and records it launched innermost, the program's kernels
    among those records and the device ms of the others, and the device
    idle under it innermost."""
    if s is None or s.units <= 0:
        return {}
    rows = {}

    def row(name):
        return rows.setdefault(name, dict(
            count=0.0, host_ms=0.0, device_ms=0.0, records=0.0,
            kernels=0.0, glue_device_ms=0.0, idle_ms=0.0))

    for c in s.cycles:
        spans = getattr(c, "spans", [])
        for n, a, b in spans:
            r = row(n)
            r["count"] += 1
            r["host_ms"] += 1e3 * (b - a)
        launched = getattr(c, "launched_in", None) or [()] * len(c.device)
        for (n, _, sec), opened in zip(c.device, launched):
            r = row(opened[-1] if opened else None)
            r["device_ms"] += 1e3 * sec
            r["records"] += 1
            if is_port_kernel(n):
                r["kernels"] += 1
            else:
                r["glue_device_ms"] += 1e3 * sec
        for a, b in getattr(c, "idle", []):
            cuts = sorted({a, b} | {x for sp in spans for x in sp[1:]
                                    if a < x < b})
            for u, v in zip(cuts, cuts[1:]):
                held = innermost(spans, 0.5 * (u + v))
                row(held and held[0])["idle_ms"] += 1e3 * (v - u)
    return {n: {k: v / s.units for k, v in r.items()}
            for n, r in rows.items()}
