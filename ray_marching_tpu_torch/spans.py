"""The program's spans on the ``torch.profiler`` timeline.

``with span(name):`` records ``name`` as a ``record_function`` range while a
profiler records on the calling thread (autograd's device threads inherit
that state), so a span lands in the same trace, on the same clock, as the
device records of the work it covers: ``cli profile``'s trace or any
``torch.profiler`` run. With no profiler recording it returns one shared
no-op: the cost is the flag test. Names are the constants below; a kernel
wrapper's name carries its route, so its spans count the launches per step.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled

OPTIMIZE_STEP = "rm.optimize.step"
OPTIMIZE_RENDER = "rm.optimize.render"
OPTIMIZE_LOSS = "rm.optimize.loss"
OPTIMIZE_BACKWARD = "rm.optimize.backward"
OPTIMIZE_UPDATE = "rm.optimize.update"
OPTIMIZE_SYNC = "rm.optimize.sync"
RENDER_POSE = "rm.render.pose"
RENDER_MARCH = "rm.render.march"
RENDER_SHADE = "rm.render.shade"
VIEWER_FRAME = "rm.viewer.frame"
VIEWER_INPUT = "rm.viewer.input"
VIEWER_RENDER = "rm.viewer.render"
VIEWER_COPY = "rm.viewer.copy"
VIEWER_WAIT = "rm.viewer.wait"
VIEWER_SINK = "rm.viewer.sink"
#: The kernel wrappers' spans by kind and MLP route ("thread" is the
#: per-thread route, "refill" its lane-refill entry).
KERNEL_FWD = {
    "serve": {"tc": "rm.kernel.fwd.serve.tc",
              "thread": "rm.kernel.fwd.serve.simt",
              "refill": "rm.kernel.fwd.serve.refill"},
    "train": {"tc": "rm.kernel.fwd.train.tc",
              "thread": "rm.kernel.fwd.train.simt"},
}
KERNEL_BWD = {
    "hist": {"tc": "rm.kernel.bwd.hist.tc",
             "thread": "rm.kernel.bwd.hist.simt"},
    "recompute": {"tc": "rm.kernel.bwd.recompute.tc",
                  "thread": "rm.kernel.bwd.recompute.simt"},
    "two_level": {"tc": "rm.kernel.bwd.two_level.tc",
                  "thread": "rm.kernel.bwd.two_level.simt"},
    "march": {"tc": "rm.kernel.bwd.march.tc",
              "thread": "rm.kernel.bwd.march.simt"},
}
KERNEL_MARCH = {"tc": "rm.kernel.march.tc", "thread": "rm.kernel.march.simt",
                "refill": "rm.kernel.march.refill"}


def span(name: str):
    """A context manager that records ``name`` while a profiler records."""
    if not _recording():
        return _OFF
    return record_function(name)
