"""The port's spans (``ray_marching_tpu_torch/spans.py``) on a CPU
``torch.profiler`` trace: the no-op when nothing records, the nesting of
``optimize``'s and the viewer's spans, the kernel wrappers' route-named
spans one a launch, and the gradient norm ``optimize`` now computes only
for its metrics file."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ray_marching_tpu_torch import spans
from ray_marching_tpu_torch.control import InputSnapshot, SessionState
from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.graph import map_params, param_paths
from ray_marching_tpu_torch.viewer import ScriptedInput, run_viewer

PX = 3.45e-6
W, H, STEPS = 16, 12, 8
Q0 = [[0.0, 0.0, 1.0, 0.0]]
T0 = [[0.0, 0.2, 2.5]]
NAMES = {v for k, v in vars(spans).items() if k.isupper()
         and isinstance(v, str)}
NAMES |= {n for table in (spans.KERNEL_FWD, spans.KERNEL_BWD)
          for names in table.values() for n in names.values()}
NAMES |= set(spans.KERNEL_MARCH.values())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _renderer(dtype=torch.float32):
    cfg = RenderConfig(px_width=W, px_height=H, focal_length=PX * H,
                       sensor_width=PX * W, sensor_height=PX * H,
                       marching_steps=STEPS)
    return FastRenderer(registry.make_scene("test_scene2"), cfg, dtype=dtype,
                        device="cpu")


def _target(r):
    """test_scene2 with every parameter 5 % larger."""
    bigger = map_params(r.init_params, lambda v: v * 1.05)
    with torch.no_grad():
        return r.render(bigger, r._tensor(Q0), r._tensor(T0))


def _traced(fn):
    """``fn()`` under a CPU profiler: the program's spans, (name, start,
    end) in µs, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("rm.")]
    return sorted(out, key=lambda s: s[1])


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _named(found, name):
    return [s for s in found if s[0] == name]


def test_no_profiler_gives_the_shared_noop(monkeypatch):
    """With nothing recording, ``span()`` tests the flag once and returns
    the one shared no-op; ``record_function`` is never called."""
    made, tested = [], []
    monkeypatch.setattr(spans, "record_function", made.append)
    recording = spans._recording
    monkeypatch.setattr(spans, "_recording",
                        lambda: tested.append(1) or recording())
    assert not torch._C._autograd._profiler_enabled()
    first = spans.span(spans.OPTIMIZE_STEP)
    second = spans.span(spans.KERNEL_FWD["train"]["tc"])
    assert first is second is spans._OFF
    with first:
        pass
    assert made == [] and len(tested) == 2
    # The patched name is the one span() calls while a profiler records.
    with profile(activities=[ProfilerActivity.CPU]):
        spans.span(spans.OPTIMIZE_STEP)
    assert made == [spans.OPTIMIZE_STEP]


def test_optimize_spans_nest_per_step():
    r = _renderer()
    target = _target(r)
    cfg = InverseConfig(steps=2, learning_rate=1e-3)
    found = _traced(lambda: optimize(r, target, Q0, T0, cfg))
    assert {n for n, _, _ in found} <= NAMES
    steps = _named(found, spans.OPTIMIZE_STEP)
    assert len(steps) == 2
    for step in steps:
        inner = [s for s in found if s is not step and _inside(s, step)]
        by = {n: _named(inner, n) for n in NAMES}
        for name in (spans.OPTIMIZE_RENDER, spans.OPTIMIZE_LOSS,
                     spans.OPTIMIZE_BACKWARD, spans.OPTIMIZE_UPDATE,
                     spans.OPTIMIZE_SYNC, spans.RENDER_POSE,
                     spans.RENDER_MARCH, spans.RENDER_SHADE):
            assert len(by[name]) == 1, name
        render = by[spans.OPTIMIZE_RENDER][0]
        for name in (spans.RENDER_POSE, spans.RENDER_MARCH,
                     spans.RENDER_SHADE):
            assert _inside(by[name][0], render), name
        fwd = [s for s in inner if s[0].startswith("rm.kernel.fwd.")]
        bwd = [s for s in inner if s[0].startswith("rm.kernel.bwd.")]
        assert [s[0] for s in fwd] == [spans.KERNEL_FWD["train"]["thread"]]
        assert [s[0] for s in bwd] == [spans.KERNEL_BWD["hist"]["thread"]]
        assert _inside(fwd[0], by[spans.RENDER_MARCH][0])
        assert _inside(bwd[0], by[spans.OPTIMIZE_BACKWARD][0])
    # Nothing of a step's phases lies outside its step span.
    phases = [s for s in found if s[0].startswith(("rm.optimize.",
                                                   "rm.render.",
                                                   "rm.kernel."))
              and s[0] != spans.OPTIMIZE_STEP]
    assert all(any(_inside(s, step) for step in steps) for s in phases)


def test_viewer_spans():
    r = _renderer()
    frames = []
    snaps = [InputSnapshot(mouse_ndc=(0.02, 0.0))] * 3
    found = _traced(lambda: run_viewer(
        r, ScriptedInput(snaps), lambda i, image, s: frames.append(i),
        session=SessionState(marching_steps=STEPS), print_fps=False))
    assert frames == [0, 1, 2]
    count = {n: len(_named(found, n)) for n in NAMES}
    # Three frames, and the fourth pass of the loop that reads the quit.
    assert count[spans.VIEWER_FRAME] == 4
    assert count[spans.VIEWER_INPUT] == 4
    for name in (spans.VIEWER_RENDER, spans.VIEWER_COPY, spans.VIEWER_WAIT,
                 spans.VIEWER_SINK, spans.KERNEL_FWD["serve"]["thread"]):
        assert count[name] == 3, name
    frame_spans = _named(found, spans.VIEWER_FRAME)
    for name in (spans.VIEWER_INPUT, spans.VIEWER_RENDER,
                 spans.VIEWER_COPY):
        assert all(any(_inside(s, f) for f in frame_spans)
                   for s in _named(found, name)), name
    for s in _named(found, spans.KERNEL_FWD["serve"]["thread"]):
        assert any(_inside(s, v) for v in _named(found, spans.VIEWER_RENDER))


def test_grad_norm_is_the_norm_of_the_steps_gradients(tmp_path):
    """``grad_norm`` of the metrics file against each step's gradient
    computed apart, by ``torch.autograd.grad`` at the parameters the step
    started from (the frozen pose's gradient is zero)."""
    r = _renderer(torch.float64)
    target = _target(r)
    starts = [map_params(r.init_params, torch.Tensor.clone)]

    def callback(step, loss, state):
        starts.append(map_params(state["params"],
                                 lambda v: v.detach().clone()))

    path = tmp_path / "metrics.jsonl"
    optimize(r, target, Q0, T0,
             InverseConfig(steps=2, learning_rate=1e-3,
                           metrics_path=str(path)),
             callback=callback)
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [rec["step"] for rec in records] == [0, 1]
    for rec, start in zip(records, starts):
        params = map_params(start, lambda v: v.requires_grad_(True))
        leaves = list(param_paths(params).values())
        image = r.render(params, r._tensor(Q0), r._tensor(T0))
        loss = torch.mean((image - target) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        assert rec["grad_norm"] == pytest.approx(norm, rel=1e-9)
        assert rec["loss"] == pytest.approx(float(loss.detach()), rel=1e-12)
