"""The port's FastRenderer against the JAX FastRenderer (Pallas kernel in
interpret mode) and against the golden reference images, f64 on the CPU.

Tolerances: rtol 1e-9, atol 1e-11 on stable pixels (rays that converged,
|d| < 1e-2, and stayed within |p| < 10), as tests/test_fast_golden.py holds
the JAX renderer to the reference. Both renderers run the same IEEE op
sequence; the golden images come from the PyTorch reference in f64.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.cli import main as cli_main
from ray_marching_tpu_torch.io.image import write_png
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.render.shaders import MODES
from ray_marching_tpu_torch.scene import registry as treg

GOLDEN = Path(__file__).parent / "golden" / "scene2_room.npz"
PX = 3.45e-6


def _cfg_kwargs(w, h, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, **kw)


def _render_both(scene, w, h, q, t, degree=2, **kw):
    """Both renderers' 8 modes, plus the stable-pixel mask from JAX's hit
    planes."""
    jr = JaxFastRenderer(jreg.make_scene(scene),
                         JaxRenderConfig(**_cfg_kwargs(w, h, **kw)),
                         dtype=jnp.float64, grid_dtype=np.float64)
    tr = FastRenderer(treg.make_scene(scene),
                      RenderConfig(**_cfg_kwargs(w, h, **kw)),
                      dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    jq, jt = jnp.asarray(q), jnp.asarray(t)
    want = {k: np.asarray(v) for k, v in
            jr.render_all_modes(jr.init_params, jq, jt, degree=degree).items()}
    got = {k: v.numpy() for k, v in
           tr.render_all_modes(tr.init_params, q, t, degree=degree).items()}
    origin, dirs = jr._pose_planes(jq, jt)
    hit, _ = jr._march_planes(jr.init_params, origin, dirs,
                              jr.config.marching_steps)
    hit = [np.asarray(p) for p in hit]
    stable = (np.abs(hit[3]) < 1e-2) & (
        np.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2) < 10)
    mask = np.asarray(jr._assemble([jnp.asarray(stable)]))
    return want, got, mask, tr


def _assert_modes_close(want, got, mask, mode):
    name = MODES[mode]
    m = np.broadcast_to(mask, want[name].shape)
    assert m.mean() > 0.9
    np.testing.assert_allclose(got[name][m], want[name][m], rtol=1e-9,
                               atol=1e-11, equal_nan=True, err_msg=name)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def single(golden):
    """96×64 test_scene2 at the golden fixture's generic pose."""
    q = golden["meta_orientation"][None]
    t = golden["meta_translation"][None]
    return _render_both("test_scene2", 96, 64, q, t, marching_steps=32)


@pytest.fixture(scope="module")
def two_cameras(golden):
    q = np.concatenate([golden["meta_orientation"][None],
                        [[0.9914449, 0.0, 0.1305262, 0.0]]])
    t = np.concatenate([golden["meta_translation"][None], [[0.3, 0.1, -2.2]]])
    return _render_both("test_scene2", 40, 24, q, t, marching_steps=24,
                        num_cameras=2)


@pytest.fixture(scope="module")
def bounce(golden):
    """One reflection bounce, with the early exit on."""
    q = golden["meta_orientation"][None]
    t = golden["meta_translation"][None]
    return _render_both("test_scene2", 40, 24, q, t, marching_steps=24,
                        reflection_bounces=1, tau=1e-3)


@pytest.mark.parametrize("mode", range(8))
def test_matches_jax_fast_renderer(single, mode):
    want, got, mask, _ = single
    _assert_modes_close(want, got, mask, mode)


@pytest.mark.parametrize("mode", range(8))
def test_matches_jax_two_cameras(two_cameras, mode):
    want, got, mask, _ = two_cameras
    assert got[MODES[mode]].shape == (2, 24, 40, 3)
    _assert_modes_close(want, got, mask, mode)


@pytest.mark.parametrize("mode", range(8))
def test_matches_jax_reflection_bounce(bounce, mode):
    want, got, mask, _ = bounce
    _assert_modes_close(want, got, mask, mode)


@pytest.mark.parametrize("mode", range(8))
def test_golden_scene2_room(single, golden, mode):
    """Port straight against the reference-produced fixture."""
    _, got, _, _ = single
    want = golden[f"image_{mode}"]
    mask = np.broadcast_to(golden["stable_mask"], want.shape)
    np.testing.assert_allclose(got[MODES[mode]][mask], want[mask], rtol=1e-9,
                               atol=1e-11, equal_nan=True,
                               err_msg=f"scene2_room mode={mode}")


def test_render_equals_render_all_modes(single, golden):
    _, got, _, tr = single
    q = golden["meta_orientation"][None]
    t = golden["meta_translation"][None]
    for mode in (0, 7, 15):  # mode % 8 wraps like the reference
        img = tr.render(tr.init_params, q, t, mode=mode, degree=2)
        np.testing.assert_array_equal(img.numpy(), got[MODES[mode % 8]])


def test_image_to_planes_inverts_assemble(two_cameras):
    _, got, _, tr = two_cameras
    img = torch.as_tensor(got["normal"])
    planes = tr.image_to_planes(img)
    assert planes.shape == (3, tr.rows, 128)
    assert torch.equal(tr._assemble(list(planes)), img)


def test_default_device_needs_cuda():
    """The default device is the card; without one the constructor raises
    instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = RenderConfig(**_cfg_kwargs(16, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastRenderer(treg.make_scene("test_scene2"), cfg)


@pytest.mark.parametrize("what", ["implicit", "cmap_fourier", "occlusion",
                                  "alpha", "extras"])
def test_unported_options_raise(what):
    """What the port does not run yet raises NotImplementedError; what the
    training slice ported (``backward="implicit"``, ``render_with_alpha``)
    now runs, and only rejects what the JAX package rejects too."""
    scene = treg.make_scene("test_scene2")
    kw = _cfg_kwargs(16, 8)
    if what == "implicit":
        with pytest.raises(ValueError, match="unroll|implicit"):
            FastRenderer(scene, RenderConfig(backward="adjoint", **kw),
                         dtype=torch.float64, device="cpu")
        r = FastRenderer(scene, RenderConfig(backward="implicit", **kw),
                         dtype=torch.float64, device="cpu")
        q, t = r.default_pose()
        assert r.render(r.init_params, q, t).shape == (1, 8, 16, 3)
        return
    if what == "alpha":
        r = FastRenderer(scene, RenderConfig(reflection_bounces=1, **kw),
                         dtype=torch.float64, device="cpu")
        q, t = r.default_pose()
        with pytest.raises(ValueError, match="reflection bounces"):
            r.render_with_alpha(r.init_params, q, t)
        return
    if what == "cmap_fourier":
        kw["cmap_fourier"] = True
    with pytest.raises(NotImplementedError, match="not ported"):
        r = FastRenderer(scene, RenderConfig(**kw), dtype=torch.float64,
                         device="cpu")
        q, t = r.default_pose()
        if what == "occlusion":
            r.render(r.init_params, q, t, mode="occlusion")
        elif what == "extras":
            r.render_all_modes(r.init_params, q, t, extras=True)


def test_cli_render_writes_png(tmp_path):
    out = tmp_path / "frame.png"
    cli_main(["render", "--device", "cpu", "--width", "24", "--height", "16",
              "--mode", "normal", "--steps", "8", "-o", str(out)])
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == 24  # IHDR width
    assert int.from_bytes(data[20:24], "big") == 16


def test_write_png_maps_nan_to_black(tmp_path):
    import zlib

    img = torch.full((1, 2, 3, 3), float("nan"), dtype=torch.float64)
    img[0, 0, 0] = 1.0
    path = write_png(tmp_path / "nan.png", img)
    raw = path.read_bytes()
    idat = raw.index(b"IDAT")
    size = int.from_bytes(raw[idat - 4:idat], "big")
    pixels = zlib.decompress(raw[idat + 4:idat + 4 + size])
    assert pixels[:4] == b"\x00\xff\xff\xff"  # filter byte, white pixel
    assert set(pixels[4:10]) == {0}
