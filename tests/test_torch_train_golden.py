"""The port's gradients straight against the reference-produced
``composite_512`` fixture (f64, 512×512, 48 steps, on the CPU through the
kernels' plain versions), as tests/test_fast_golden.py holds the JAX
FastRenderer: modes 0, 2, 3, 6, 7 at rtol 1e-7, atol 1e-9. For mode 5
(laplacian) the reference's own gradient is all-NaN: whole-graph autograd
manufactures 0·inf inside the march of diverged rays. The step-by-step
backward routes cotangents with selects and does not, which
test_gradient_mode5_finite pins on the march itself.

The public ``render(mode=5)`` gradient of the port on this fixture is NaN
all the same, where the JAX package's is finite: the laplacian shader has an
infinite slope where lap equals +max|lap| exactly, in both packages
(test_mode5_shader_slope_at_max_ties_like_jax), and which pixels tie there is
decided by the last bit (test_mode5_ties_side_by_side holds the two tie sets
beside each other).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.graph import param_paths

GOLDEN = Path(__file__).parent / "golden" / "composite_512.npz"
PX_SIZE = 3.45e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (its fixture included): the suite
    runs in several workers, whose torch threads otherwise fight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    g = np.load(GOLDEN)
    w, h = int(g["meta_width"]), int(g["meta_height"])
    cfg = RenderConfig(
        px_width=w, px_height=h, focal_length=PX_SIZE * h,
        sensor_width=PX_SIZE * w, sensor_height=PX_SIZE * h,
        marching_steps=int(g["meta_steps"]),
        normals_eps=float(g["meta_normals_eps"]),
    )
    r = FastRenderer(registry.make_scene(str(g["meta_scene"])), cfg,
                     dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    return g, r


def _leaves(g, r):
    def leafify(tree):
        return {k: leafify(v) if isinstance(v, dict)
                else v.clone().requires_grad_(True) for k, v in tree.items()}

    params = leafify(r.init_params)
    q = torch.tensor(g["meta_orientation"][None], requires_grad=True)
    t = torch.tensor(g["meta_translation"][None], requires_grad=True)
    return params, q, t


def _collect(params, q, t):
    """Gradients by golden key; a leaf the loss does not reach (the vignette
    shader reads no scene parameter) has gradient zero."""
    flat = dict(param_paths(params), camera_orientation=q,
                camera_translation=t)
    return {k: torch.zeros_like(v) if v.grad is None else v.grad
            for k, v in flat.items()}


def _gradients(g, r, mode):
    params, q, t = _leaves(g, r)
    image = r.render(params, q, t, mode=mode, degree=int(g["meta_degree"]))
    (image * torch.as_tensor(g["loss_weights"])).sum().backward()
    return _collect(params, q, t)


@pytest.mark.parametrize("mode", [0, 2, 3, 6, 7])
def test_gradient_golden(fixture, mode):
    g, r = fixture
    assert mode in set(g["meta_grad_modes"].tolist())
    flat = _gradients(g, r, mode)
    for path, got in flat.items():
        want = g[f"grad_{mode}/{path}"]
        np.testing.assert_allclose(
            got.numpy().reshape(want.shape), want, rtol=1e-7, atol=1e-9,
            equal_nan=True, err_msg=f"composite_512 mode={mode} param={path}")
    golden_keys = {k.split("/", 1)[1] for k in g.files
                   if k.startswith(f"grad_{mode}/")}
    assert golden_keys == set(flat)


def test_gradient_mode5_finite(fixture):
    """About half of this frame's rays diverge (|p| ~ 1e13). Given the
    laplacian shader's cotangents, the march's backward gives finite
    gradients for every leaf and the pose, where the reference's are NaN.

    The shader itself can hand over a NaN: where lap equals +max|lap|
    exactly, (1 − lap/max)/2 is 0 and the γ-power's slope there is
    infinite. Which diverged pixels tie for the maximum, and with which
    sign, is decided by the last bit of positions of magnitude 1e13 and so
    differs between the CPU, the card and the JAX package (whose own run
    happens to tie on the negative side only, so that its whole pipeline
    stays finite). Those cotangents are therefore checked to sit on such
    ties only, and left out."""
    g, r = fixture
    assert all(np.isnan(g[k]).all() for k in g.files
               if k.startswith("grad_5/")), "fixture no longer all-NaN"
    params, q, t = _leaves(g, r)
    orientation, translation = r._pose(q, t)
    origin, dirs = r._pose_planes(orientation, translation)
    hit, final_dirs = r._march_planes(params, origin, dirs,
                                      r.config.marching_steps)
    image = r._assemble(r._shade(5, int(g["meta_degree"]), orientation,
                                 origin, final_dirs, hit))
    loss = (image * torch.as_tensor(g["loss_weights"])).sum()
    cots = torch.autograd.grad(loss, hit, allow_unused=True)
    cots = [torch.zeros_like(h) if c is None else c
            for h, c in zip(hit, cots)]
    lap = hit[7].detach()
    far = torch.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2).detach()
    assert float(far.max()) > 1e12
    top = lap.abs() == lap[r._valid_b].abs().max()
    for i, c in enumerate(cots):
        bad = ~torch.isfinite(c)
        assert not bad.any() or (i == 7 and bool(top[bad].all())), i
    torch.autograd.backward(hit, [torch.nan_to_num(c, nan=0.0, posinf=0.0,
                                                   neginf=0.0) for c in cots])
    for path, got in _collect(params, q, t).items():
        assert bool(torch.isfinite(got).all()), path
    assert float(_collect(params, q, t)["blend_k"].abs()) > 0


def _max_ties(lap, valid):
    """Flat indices of the valid pixels where |lap| equals its maximum, and
    the sign of lap there."""
    top = np.abs(lap[valid]).max()
    idx = np.flatnonzero(((np.abs(lap) == top) & valid).reshape(-1))
    return idx, np.sign(lap.reshape(-1)[idx]).astype(int)


@pytest.mark.parametrize("side", ["positive", "negative"])
def test_mode5_shader_slope_at_max_ties_like_jax(side):
    """Given the same planes, the two laplacian shaders hand back the same
    cotangents. Where lap == +max|lap|, (1 − lap/max)/2 is 0 and the
    γ-power's slope infinite: the cotangent is non-finite there, and on
    every other pixel tied for max|lap| too, because the select backward of
    the maximum hands its NaN cotangent to all the tied pixels. When the
    maximum is attained on the negative side only, all is finite."""
    w, h = 16, 8
    kw = dict(px_width=w, px_height=h, focal_length=PX_SIZE * h,
              sensor_width=PX_SIZE * w, sensor_height=PX_SIZE * h,
              marching_steps=4)
    jr = JaxFastRenderer(jreg.make_scene("test_scene2"),
                         JaxRenderConfig(**kw), dtype=jnp.float64,
                         grid_dtype=np.float64, interpret=True)
    tr = FastRenderer(registry.make_scene("test_scene2"), RenderConfig(**kw),
                      dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    rng = np.random.default_rng(5)
    planes = rng.normal(size=(8, tr.rows, 128))
    weights = rng.normal(size=(1, h, w, 3))
    lap = planes[7]
    lap[0, 3] = lap[0, 40] = -9.0
    if side == "positive":
        lap[0, 17] = lap[0, 90] = 9.0
    q = np.asarray([[1.0, 0.0, 0.0, 0.0]])
    dirs = tuple(planes[i] for i in range(3))

    def j_loss(jlap):
        hit = [jnp.asarray(planes[i]) for i in range(7)] + [jlap]
        jd = tuple(jnp.asarray(d) for d in dirs)
        img = jr._assemble(jr._shade(5, 1, jnp.asarray(q), jd, jd, hit))
        return jnp.sum(img * weights)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(lap)))
    tlap = torch.tensor(lap, requires_grad=True)
    td = tuple(torch.as_tensor(d) for d in dirs)
    hit = [torch.as_tensor(planes[i]) for i in range(7)] + [tlap]
    img = tr._assemble(tr._shade(5, 1, torch.as_tensor(q), td, td, hit))
    (img * torch.as_tensor(weights)).sum().backward()
    got = tlap.grad.numpy()
    valid = tr._valid_b.numpy()
    bad = ~np.isfinite(got) & valid
    np.testing.assert_array_equal(bad, ~np.isfinite(want) & valid)
    ties = (np.abs(lap) == 9.0) & valid
    np.testing.assert_array_equal(bad, ties & (side == "positive"))
    assert bad.sum() == (4 if side == "positive" else 0)
    ok = valid & ~bad & (np.abs(lap) != 9.0)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=1e-14)


def test_mode5_ties_side_by_side(fixture):
    """The tie pixels of max|lap| on composite_512, the JAX package's beside
    the port's. The JAX forward ties on the negative side only, which is
    why its whole mode-5 gradient is finite
    (tests/test_fast_golden.py::test_fast_gradient_mode5_finite). The port's
    forward differs from it in the last bits of the Laplacian (it is
    (d − mean4)·6/eps², rounding amplified 2400×), so its tie set is
    another one; its public ``render(mode=5)`` gradient is finite exactly
    when none of its ties is on the positive side, and NaN otherwise."""
    g, r = fixture
    jr = JaxFastRenderer(
        jreg.make_scene(str(g["meta_scene"])),
        JaxRenderConfig(**{f: getattr(r.config, f) for f in (
            "px_width", "px_height", "focal_length", "sensor_width",
            "sensor_height", "marching_steps", "normals_eps")}),
        dtype=jnp.float64, grid_dtype=np.float64, interpret=True)
    jq = jnp.asarray(g["meta_orientation"], jnp.float64)[None]
    jt = jnp.asarray(g["meta_translation"], jnp.float64)[None]
    origin, dirs = jr._pose_planes(jq, jt)
    jhit, _ = jr._march_planes(jr.init_params, origin, dirs,
                               r.config.marching_steps)
    params, q, t = _leaves(g, r)
    orientation, translation = r._pose(q, t)
    origin, dirs = r._pose_planes(orientation, translation)
    with torch.no_grad():
        hit, _ = r._march_planes(params, origin, dirs, r.config.marching_steps)
    valid = r._valid_b.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jr._valid_b))
    j_idx, j_sign = _max_ties(np.asarray(jhit[7]), valid)
    t_idx, t_sign = _max_ties(hit[7].numpy(), valid)
    print(f"max|lap| ties, JAX:  {dict(zip(j_idx.tolist(), j_sign.tolist()))}")
    print(f"max|lap| ties, port: {dict(zip(t_idx.tolist(), t_sign.tolist()))}")
    # The same maximum in both; it is attained on many pixels.
    assert (np.abs(np.asarray(jhit[7])[valid]).max()
            == np.abs(hit[7].numpy()[valid]).max())
    assert len(j_idx) >= 1 and len(t_idx) >= 1
    assert (j_sign < 0).all(), "the JAX forward now ties on the positive side"
    grads = _gradients(g, r, 5)
    finite = all(bool(torch.isfinite(v).all()) for v in grads.values())
    assert finite == bool((t_sign < 0).all())
