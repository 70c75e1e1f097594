"""The reference agrees with the program at a small size on the CPU (the
program's plain versions there): frames, the loss, the gradients and the
Adam updates, for both configurations."""

import pytest
import torch

from perfbench.harness import port, poses, serve, train
from perfbench.reference.render import Reference
from perfbench.tests.conftest import small_cell

CPU = torch.device("cpu")
CASES = [("scene2_train_4k", 128, 72), ("siren_w256_train_512", 48, 48)]


def _nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split("/")
        for p in head:
            d = d.setdefault(p, {})
        d[last] = v
    return out


@pytest.mark.parametrize("name,w,h", CASES)
def test_frame_loss_and_gradient(name, w, h):
    cell = small_cell(name, w, h)
    cfg = cell.config
    views = poses.views(12345, cfg["pose"], cell.traffic["views"],
                        cell.traffic["view_spacing"])
    target = train.make_target(cfg, views, CPU)
    r = port.build_renderer(
        dict(cfg, render=dict(cfg["render"], num_cameras=len(views))), CPU)
    live = {k: v.detach().clone().requires_grad_(True)
            for k, v in port.flat(port.initial_params(cfg, r)).items()}
    q, t = port.poses_tensor(views, torch.float32, CPU)
    image = r.render(_nest(live), q, t, mode=cfg["render"]["mode"],
                     degree=cfg["render"]["degree"])
    loss = torch.mean((image - target) ** 2)
    loss.backward()

    field, params = train.reference_start(cfg, CPU)
    ref = Reference(field, cfg["render"], torch.float32, CPU, 1 << 12)
    torch.testing.assert_close(ref.render(params, views), image.detach(),
                               rtol=0, atol=1e-6)
    ref_loss, grads = ref.loss_and_grad(params, views, target)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    scale = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        torch.testing.assert_close(live[k].grad, g, rtol=1e-4,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("name,w,h", CASES)
def test_three_steps_agree(name, w, h):
    """The harness's own run: optimize's first steps (losses, first
    gradient, parameters after Adam) against the reference's. Leaves whose
    gradient is round-off (the room's walls, flat under mode 0) take Adam
    steps of either sign on either side, which moves the later losses by
    about 1e-5."""
    cell = small_cell(name, w, h)
    res = train.run(cell, 2**31 + 17, 0.0, False, CPU, 0.0)
    assert res.attempted >= 1 and res.failed == 0
    assert res.numbers["loss_gap"] < 1e-4
    assert res.numbers["grad_gap"] < 1e-4
    assert res.numbers["adam_gap"] < 1e-5
    assert res.notes["detail"]["change_gap"] < 1e-3


def test_served_frames_agree():
    cell = small_cell("siren_w256_serve_512", 48, 48)
    res = serve.run(cell, 2**33 + 5, 1.0, False, CPU, 0.0)
    assert res.attempted >= 1 and res.failed == 0
    assert res.notes["detail"]["frame_px_off"] == [0.0] * len(
        res.notes["judged_frames"])
    assert res.numbers["frame_excess"] < 1e-3
    assert res.numbers["pose_gap"] < 1e-6
