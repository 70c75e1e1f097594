"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (its look for a card skipped) on the CPU at a small
size, with the cell's own limits, once for each fault the cell can have.
One chip, so no exchange between chips to leave out."""

import types

import pytest
import torch

from perfbench.harness import serve, train
from perfbench.harness.compare import judge
from perfbench.tests.conftest import small_cell

CPU = torch.device("cpu")
#: Sizes at which every leaf of the sound run has a gradient above
#: round-off (below them a view can miss the capsule, and the median leaf's
#: gradient that the gaps are measured against is round-off itself).
TRAIN = [("scene2_train_4k", 384, 216), ("siren_w256_train_512", 64, 64)]
SEED = 2**31 + 5


def _judge(cell, res):
    return judge(res.numbers, cell.limits)[0]


def _no_step(monkeypatch):
    """Adam's step returns the state unchanged."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _reset_moments(monkeypatch):
    """Adam's moments set to zero before each of its steps."""
    step = torch.optim.Adam.step

    def reset(self, closure=None):
        for st in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    st[key].zero_()
        return step(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", reset)


def _half_batch(monkeypatch):
    """The loss's mean over half of the batch, the rest left out: half of
    the views, or of one view's rows."""
    from ray_marching_tpu_torch.optim import inverse

    def mean(x, *a, **k):
        x = x[: x.shape[0] // 2] if x.shape[0] > 1 else x[:, : x.shape[1] // 2]
        return torch.mean(x, *a, **k)

    proxy = types.SimpleNamespace(**{n: getattr(torch, n) for n in dir(torch)
                                     if not n.startswith("__")})
    proxy.mean = mean
    monkeypatch.setattr(inverse, "torch", proxy)


def _altered_image(monkeypatch):
    """Every intensity one level brighter where the frame is produced."""
    from ray_marching_tpu_torch.render.fast import FastRenderer

    render = FastRenderer.render
    monkeypatch.setattr(FastRenderer, "render",
                        lambda self, *a, **k: render(self, *a, **k) + 1 / 255)


@pytest.mark.parametrize("fault", [_no_step, _reset_moments, _half_batch,
                                   _altered_image],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name,w,h", TRAIN)
def test_training_fault_is_not_correct(monkeypatch, name, w, h, fault):
    cell = small_cell(name, w, h)
    sound = train.run(cell, SEED, 0.0, False, CPU, 0.0)
    assert _judge(cell, sound)
    fault(monkeypatch)
    res = train.run(cell, SEED, 0.0, False, CPU, 0.0)
    assert not _judge(cell, res), res.numbers


def _frozen_pose(monkeypatch):
    """Every frame rendered at the first pose: the state never advances."""
    from ray_marching_tpu_torch.render.fast import FastRenderer

    render, first = FastRenderer.render, {}

    def stuck(self, params, q, t, **k):
        first.setdefault("pose", (q.clone(), t.clone()))
        return render(self, params, *first["pose"], **k)

    monkeypatch.setattr(FastRenderer, "render", stuck)


def _still_camera(monkeypatch):
    """The viewer's camera never turns: its pose step returns the state
    unchanged."""
    from ray_marching_tpu_torch import viewer

    monkeypatch.setattr(viewer, "apply_input",
                        lambda state, snap, cfg=None: state)


def _half_frame(monkeypatch):
    """The bottom half of each frame's rows left out (black)."""
    from ray_marching_tpu_torch import viewer

    quantize = viewer.quantize

    def half(img, *a):
        out = quantize(img, *a)
        out[:, out.shape[1] // 2:] = 0
        return out

    monkeypatch.setattr(viewer, "quantize", half)


def _altered_bytes(monkeypatch):
    """Two levels added to the top eighth of each frame's bytes."""
    from ray_marching_tpu_torch import viewer

    quantize = viewer.quantize

    def bump(img, *a):
        out = quantize(img, *a)
        rows = max(out.shape[1] // 8, 1)
        out[:, :rows] = torch.clamp(out[:, :rows].int() + 2, 0, 255).to(
            out.dtype)
        return out

    monkeypatch.setattr(viewer, "quantize", bump)


@pytest.mark.parametrize("fault", [_frozen_pose, _still_camera, _half_frame,
                                   _altered_bytes],
                         ids=lambda f: f.__name__.strip("_"))
def test_serving_fault_is_not_correct(monkeypatch, fault):
    cell = small_cell("siren_w256_serve_512", 64, 64)
    sound = serve.run(cell, SEED, 0.3, False, CPU, 0.0)
    assert _judge(cell, sound)
    fault(monkeypatch)
    res = serve.run(cell, SEED, 0.3, False, CPU, 0.0)
    assert not _judge(cell, res), res.numbers
