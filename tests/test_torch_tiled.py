"""The port's tiled renderer (``render/tiled.py``) against its one-pass
FastRenderer and against the JAX package's TiledRenderer, f64 on the CPU.

Tolerances are tests/test_tiled.py's: images rtol 1e-9, atol 1e-11 (NaN
equal to NaN), losses rtol 1e-12, strip-summed gradients rtol 1e-9, atol
1e-12 against the one-pass gradient of the same package. Against JAX:
images rtol 1e-9, atol 1e-11 on stable pixels and gradients rtol 1e-7,
atol 1e-9 relative to a leaf's largest entry (tests/test_torch_train.py;
the packages differ by an ulp per op). The strips' ray planes, computed on
the device from the sensor axes, equal the one-pass numpy grid bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.render.tiled import TiledRenderer as JaxTiledRenderer
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.camera import _pixel_center_grid
from ray_marching_tpu_torch.cli import main as cli_main
from ray_marching_tpu_torch.parallel.fast_sharding import _check_rows
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.render.shaders import MODES
from ray_marching_tpu_torch.render.tiled import TWO_PASS_MODES, TiledRenderer
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

PX = 3.45e-6
W, H = 64, 40
Q = np.asarray([[0.1, 0.03, 0.99, 0.03]])
Q = Q / np.linalg.norm(Q)
T = np.asarray([[0.1, 0.2, 2.0]])


def _kw(w=W, h=H, steps=12, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h,
                marching_steps=steps, **kw)


def make_pair(strip=12, steps=10, scene="test_scene2", **kw):
    cfg = RenderConfig(**_kw(steps=steps, **kw))
    f = FastRenderer(treg.make_scene(scene), cfg, dtype=torch.float64,
                     grid_dtype=np.float64, device="cpu")
    tr = TiledRenderer(treg.make_scene(scene), cfg, strip_height=strip,
                       dtype=torch.float64, grid_dtype=np.float64,
                       device="cpu")
    return f, tr


def _require_grad(tree):
    if isinstance(tree, dict):
        return {k: _require_grad(v) for k, v in tree.items()}
    return tree.clone().requires_grad_(True)


def _assert_close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), equal_nan=True,
                               **tol)


@pytest.mark.parametrize("mode", range(8))
def test_tiled_matches_full_all_modes(mode):
    """strip 12 over h = 40: 4 strips, the last with 8 extrapolated rows,
    which the crop and the statistics' mask must drop."""
    f, tr = make_pair()
    assert tr.num_strips == 4
    a = f.render(f.init_params, Q, T, mode=mode, degree=2)
    b = tr.render(tr.init_params, Q, T, mode=mode, degree=2)
    assert b.shape == a.shape and b.device.type == "cpu"
    _assert_close(b, a, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("strip", [10, 999])
def test_tiled_dividing_strip_and_single_strip(strip):
    f, tr = make_pair(strip=strip)
    assert tr.num_strips == (4 if strip == 10 else 1)
    for mode in (1, 5, "shaded"):
        _assert_close(tr.render(tr.init_params, Q, T, mode=mode, degree=2),
                      f.render(f.init_params, Q, T, mode=mode, degree=2),
                      rtol=1e-9, atol=1e-11)


def test_strip_planes_equal_the_one_pass_grid():
    """Every strip's ray planes, built on the device from the sensor axes,
    are the one-pass numpy grid's rows bit for bit (f32 and f64 grids); the
    validity plane covers exactly the strip's real pixels."""
    for grid in (np.float32, np.float64):
        cfg = RenderConfig(**_kw(w=37, h=23))
        tr = TiledRenderer(treg.make_scene("test_scene2"), cfg,
                           strip_height=8, dtype=torch.float64,
                           grid_dtype=grid, device="cpu")
        pos, dirs = _pixel_center_grid(cfg.camera_config, grid)
        for s in range(tr.num_strips):
            pos0, dir0, valid, rows = tr._strip_planes(s)
            r0 = 8 * s
            n = rows * 37
            assert rows == min(8, 23 - r0) and int(valid.sum()) == n
            for i in range(3):
                for got, want in ((pos0[i], pos), (dir0[i], dirs)):
                    flat = got.reshape(-1)
                    assert torch.equal(flat[:n], torch.as_tensor(
                        want[r0:r0 + rows, :, i].reshape(-1).astype(
                            np.float64)))
                    assert not bool(flat[n + 37 * (8 - rows):].any())


@pytest.mark.parametrize("mode", sorted(TWO_PASS_MODES))
def test_two_pass_modes_match_jax_tiled(mode):
    """The merged two-pass bounds: the port's TiledRenderer against JAX's
    (interpret-mode Pallas) on stable pixels."""
    m = MODES.index(mode)
    _, tr = make_pair()
    jtr = JaxTiledRenderer(jreg.make_scene("test_scene2"),
                           JaxRenderConfig(**_kw(steps=10)), strip_height=12,
                           dtype=jnp.float64, grid_dtype=np.float64,
                           interpret=True)
    want = jtr.render(jtr.init_params, jnp.asarray(Q), jnp.asarray(T),
                      mode=m, degree=2)
    got = tr.render(tr.init_params, Q, T, mode=m, degree=2).numpy()
    f, _ = make_pair()
    origin, dirs = f._pose_planes(*f._pose(Q, T))
    hit, _ = f._march_planes(f.init_params, origin, dirs, 10)
    stable = f._assemble([((hit[3].abs() < 1e-2) & (
        (hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2) < 100)).double()]) > 0.5
    mask = np.broadcast_to(stable.numpy(), got.shape)
    assert mask.mean() > 0.3
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-9, atol=1e-11)


def test_tiled_render_all_modes_matches_full():
    """All 8 modes and the lighting modes from two marches per strip equal
    the one-pass ``render_all_modes``."""
    f, tr = make_pair()
    want = f.render_all_modes(f.init_params, Q, T, degree=2, extras=True)
    got = tr.render_all_modes(tr.init_params, Q, T, degree=2, extras=True)
    assert set(got) == set(want) == set(MODES) | {"occlusion", "shaded"}
    for name in want:
        _assert_close(got[name], want[name], rtol=1e-9, atol=1e-11,
                      err_msg=name)


def _full_loss(f, params, q, t, target, mode, alpha_target=None,
               alpha_weight=1.0, loss_fn=None):
    if alpha_target is None:
        img = f.render(params, q, t, mode=mode, degree=2)
    else:
        img, alpha = f.render_with_alpha(params, q, t, mode=mode, degree=2)
    if loss_fn is None:
        loss = torch.mean((torch.nan_to_num(img, nan=0.0) - target) ** 2)
    else:
        loss = torch.sum(loss_fn(img, target)) / target.numel()
    if alpha_target is not None:
        loss = loss + alpha_weight * torch.mean((alpha - alpha_target) ** 2)
    return loss


CASES = {
    "plain": dict(mode=0),
    "normal_mode": dict(mode=4),
    "with_pose": dict(mode=0, with_pose=True),
    "alpha_target": dict(mode=0, alpha=True),
    "loss_fn": dict(mode=4, loss_fn=True),
}


def _l1(img, tgt):
    return torch.abs(torch.nan_to_num(img, nan=0.0) - tgt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grad_matches_one_pass(case):
    """Strip-summed loss and gradients equal the one-pass renderer's value
    and ``backward()`` (exact for modes without a whole-image
    normalization)."""
    c = CASES[case]
    f, tr = make_pair(steps=8)
    rng = np.random.default_rng(5)
    target = torch.as_tensor(rng.uniform(0, 1, (1, H, W, 3)))
    alpha_target = (torch.as_tensor(rng.uniform(0, 1, (1, H, W, 1)))
                    if c.get("alpha") else None)
    loss_fn = _l1 if c.get("loss_fn") else None
    params = _require_grad(f.init_params)
    q = torch.tensor(Q, requires_grad=True)
    t = torch.tensor(T, requires_grad=True)
    want = _full_loss(f, params, q, t, target, c["mode"], alpha_target, 0.5,
                      loss_fn)
    want.backward()
    got_l, got_g = tr.loss_and_grad(
        tr.init_params, Q, T, target, mode=c["mode"], degree=2,
        with_pose=c.get("with_pose", False), loss_fn=loss_fn,
        alpha_target=alpha_target, alpha_weight=0.5)
    np.testing.assert_allclose(float(got_l), float(want.detach()), rtol=1e-12)
    if c.get("with_pose"):
        got_g, gq, gt = got_g
        _assert_close(gq, q.grad, rtol=1e-9, atol=1e-12)
        _assert_close(gt, t.grad, rtol=1e-9, atol=1e-12)
    wantg = tgraph.param_paths(params)
    gotg = tgraph.param_paths(got_g)
    assert set(gotg) == set(wantg)
    for k, v in wantg.items():
        _assert_close(gotg[k], v.grad, rtol=1e-9, atol=1e-12, err_msg=k)
    assert any(float(v.abs().max()) > 0 for v in gotg.values())


def test_loss_of_a_two_pass_mode_is_exact():
    """distance: the loss with the merged bounds held constant equals the
    one-pass loss (its gradient is not finite in either package: the
    arg-min pixel's ``x ** (1 / 2.33)`` has an infinite slope at 0)."""
    f, tr = make_pair(steps=8)
    target = torch.as_tensor(np.random.default_rng(6).uniform(0, 1,
                                                              (1, H, W, 3)))
    want = _full_loss(f, f.init_params, Q, T, target, 1)
    got_l, got_g = tr.loss_and_grad(tr.init_params, Q, T, target, mode=1,
                                    degree=2)
    np.testing.assert_allclose(float(got_l), float(want), rtol=1e-12)
    assert set(tgraph.param_paths(got_g)) == set(
        tgraph.param_paths(tr.init_params))


@pytest.mark.parametrize("case", ["plain", "with_pose", "alpha_target"])
def test_loss_and_grad_matches_jax_tiled(case):
    """The port's strip-summed loss and gradients against JAX's
    TiledRenderer.loss_and_grad (weights on stable pixels only)."""
    f, tr = make_pair(steps=6)
    jtr = JaxTiledRenderer(jreg.make_scene("test_scene2"),
                           JaxRenderConfig(**_kw(steps=6)), strip_height=12,
                           dtype=jnp.float64, grid_dtype=np.float64,
                           interpret=True)
    origin, dirs = f._pose_planes(*f._pose(Q, T))
    hit, _ = f._march_planes(f.init_params, origin, dirs, 6)
    stable = f._assemble([((hit[3].abs() < 1e-2) & (
        (hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2) < 100)).double()]).numpy()
    assert stable.mean() > 0.2
    # The render itself as target, perturbed on stable pixels only: the
    # loss then weights no diverged ray.
    rng = np.random.default_rng(8)
    img = f.render(f.init_params, Q, T, mode=0, degree=2).numpy()
    target = np.nan_to_num(img) + 0.1 * rng.normal(size=img.shape) * stable
    kw = dict(mode=0, degree=2, with_pose=case == "with_pose")
    if case == "alpha_target":
        kw.update(alpha_target=rng.uniform(0, 1, (1, H, W, 1)) * stable,
                  alpha_weight=0.5)
    got_l, got = tr.loss_and_grad(tr.init_params, Q, T, target, **kw)
    want_l, want = jtr.loss_and_grad(jtr.init_params, jnp.asarray(Q),
                                     jnp.asarray(T), target, **kw)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-9)
    if case == "with_pose":
        got, gq, gt = got
        want, wq, wt = want
        for a, b in ((gq, wq), (gt, wt)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                       atol=1e-9 * max(1.0, float(
                                           np.abs(np.asarray(b)).max())))
    gotg, wantg = tgraph.param_paths(got), jgraph.param_paths(want)
    assert set(gotg) == set(wantg)
    for k, v in wantg.items():
        v = np.asarray(v)
        np.testing.assert_allclose(gotg[k].numpy().reshape(v.shape), v,
                                   rtol=1e-7,
                                   atol=1e-9 * max(1.0, float(np.abs(v).max())),
                                   err_msg=k)


class _SizedMesh:
    """What ``fast_sharding._check_rows`` reads of a ``DeviceMesh``."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def test_tiled_rejects_bad_strip_height_and_mesh():
    cfg = RenderConfig(**_kw(w=16, h=8, steps=4))
    for bad in (0, -5):
        with pytest.raises(ValueError, match="strip_height"):
            TiledRenderer(treg.make_scene("single_sphere"), cfg,
                          strip_height=bad, device="cpu")
    tr = TiledRenderer(treg.make_scene("single_sphere"), cfg, device="cpu",
                       strip_height=3)
    # A mesh whose ranks cannot split a strip's rows into whole 8-row
    # groups, as JAX's _check_rows rejects it (TiledRenderer(mesh=...) pads
    # its strips for its own mesh; tests/test_torch_parallel_train.py runs
    # one over two ranks).
    with pytest.raises(ValueError, match="row_multiple=16"):
        _check_rows(tr.fast, _SizedMesh(2))
    q, t = tr.default_pose()
    assert q.shape == (1, 4) and t.shape == (1, 3)
    assert tr.jitted(mode=4)(tr.init_params, q, t).shape == (1, 8, 16, 3)


def _png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return (int.from_bytes(data[16:20], "big"),
            int.from_bytes(data[20:24], "big"))


def test_cli_render_strip_height(tmp_path):
    out = tmp_path / "strip.png"
    cli_main(["render", "--device", "cpu", "--scene", "test_scene2",
              "--mode", "shaded", "--width", "40", "--height", "24",
              "--steps", "8", "--strip-height", "10", "--cmap-fourier",
              "-o", str(out)])
    assert _png_size(out) == (40, 24)


@pytest.mark.parametrize("strip", [None, "8"])
def test_cli_gallery(tmp_path, strip):
    """``gallery`` writes one PNG per mode: the 8 and the lighting modes
    (``--no-extras``: the 8 only), one-pass or in strips."""
    args = ["gallery", "--device", "cpu", "--width", "24", "--height", "16",
            "--steps", "6"] + (["--strip-height", strip] if strip else [])
    cli_main(args + ["-o", str(tmp_path / "all")])
    names = {p.stem for p in (tmp_path / "all").glob("*.png")}
    assert names == set(MODES) | {"occlusion", "shaded"}
    assert _png_size(tmp_path / "all" / "shaded.png") == (24, 16)
    cli_main(args + ["-o", str(tmp_path / "eight"), "--no-extras"])
    assert {p.stem for p in (tmp_path / "eight").glob("*.png")} == set(MODES)
