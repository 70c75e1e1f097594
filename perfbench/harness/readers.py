"""What the per-layer readers (``metrics/<name>.py``) compute, each for one
kind of traced work (``train``: fit steps; ``serve``: served frames). A
reader returns ``None`` where the trace holds nothing of its kind to read,
never 0."""

from __future__ import annotations

from perfbench.harness.trace import is_backward, is_forward, is_port_kernel

KERNELS = {"forward": is_forward, "backward": is_backward}


def _of(s, kind) -> bool:
    return s is not None and s.kind == kind and s.units > 0


def kernel_roofline(s, kind, kernel):
    """Share of its roofline that the program's ``kernel`` ("forward",
    ``render_fwd*``; "backward", ``render_bwd*``) reaches: the least time
    of its work (harness/yardstick.py) over its device time by kernel
    name."""
    if not _of(s, kind):
        return None
    seconds = s.device_seconds(KERNELS[kernel], kernels_only=True)
    if seconds <= 0:
        return None
    return 100.0 * s.least_seconds(kernel) * s.units / seconds


def glue_device_ms(s, kind):
    """Device time per step or frame of everything that is not one of the
    program's hand-written CUDA kernels: torch's kernels around them
    (posing, shading, the loss, autograd, the optimizer, quantizing),
    copies and sets."""
    if not _of(s, kind):
        return None
    return 1e3 * s.device_seconds(lambda n: not is_port_kernel(n)) / s.units


def launches(s, kind):
    """Device kernels per step or frame, the program's and torch's,
    counted in the trace (a cycle short of the program's own launch
    counters is traced again)."""
    if not _of(s, kind):
        return None
    return s.records(kernels_only=True) / s.units


def device_idle_share(s, kind):
    """Share of the traced span in which no kernel, copy or set ran on the
    device."""
    if not _of(s, kind) or s.span_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.span_s)


def mfu(s, kind, work):
    """The whole step's or frame's share of the chip's peak: the least time
    of its ``work`` (harness/yardstick.py) over the traced span."""
    if not _of(s, kind) or s.span_s <= 0:
        return None
    return 100.0 * s.least_seconds(work) * s.units / s.span_s
