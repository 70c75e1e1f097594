"""The port's lighting modes (``render/lighting.py``) and Fourier colourmap
(``render/shaders.py``) against the JAX package, f64 on the CPU.

Tolerances. The lighting functions at random points: rtol 1e-12, atol
1e-13 (the same componentwise operations; the packages differ by an ulp
per op at most). The frozen fixture ``tests/fixtures/lighting_extra.npz``:
JAX's own tolerances (tests/test_lighting.py), 1e-9/1e-10 for the
plane-native renderer and 1e-12/1e-13 for the modular one, except the
modular ``shaded`` image, held at 1e-9/1e-10 as well: one of its 3,072
pixels lies 1.06e-11 (2e-11 relative) off the fixture, because torch's
vectorized ``sqrt`` on the CPU is not always correctly rounded where XLA's
is (0.67 % of random f64 arguments are an ulp off, measured), and the
16-step shadow march of that pixel carries the ulp. Images against JAX
and between the port's renderers: rtol 1e-9, atol 1e-11 on stable pixels;
gradients of a weighted pixel sum: rtol 1e-7, atol 1e-9 relative to a
leaf's largest entry (tests/test_torch_train.py's tolerances).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.render import lighting as jlight
from ray_marching_tpu.render import shaders as jshaders
from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.cli import _parse_mode
from ray_marching_tpu_torch.render import lighting, shaders
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

PX = 3.45e-6
FIXTURE = Path(__file__).parent / "fixtures" / "lighting_extra.npz"
Q = np.asarray([[1.0, 0.0, 0.0, 0.0]])
T = np.asarray([[0.0, 0.3, -2.0]])


def _cfg_kwargs(w, h, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, **kw)


def _points(n, seed):
    """Random points around test_scene's shapes and random unit normals."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.5, 1.5, size=(3, n))
    v = rng.normal(size=(3, n))
    return p, v / np.linalg.norm(v, axis=0)


def _lighting_pair(name, config):
    """The named lighting function of both packages on test_scene."""
    _, j_sdf, j_params = jgraph.compile_scene(jreg.make_scene("test_scene"),
                                              jnp.float64)
    _, t_sdf, t_params = tgraph.compile_scene(treg.make_scene("test_scene"),
                                              torch.float64)
    if name == "ambient_occlusion":
        def call(mod, sdf, params, p, n):
            return mod.ambient_occlusion(sdf, params, p, n, step=0.1)
    elif name == "soft_shadow":
        def call(mod, sdf, params, p, n):
            return mod.soft_shadow(sdf, params, p, n, (1.0, 0.29, 0.3))
    else:
        def call(mod, sdf, params, p, n):
            cfg = config[mod is lighting]
            return mod.shaded_intensity(sdf, params, p, n, cfg)
    return ((lambda p, n: call(jlight, j_sdf, j_params, p, n)),
            (lambda p, n: call(lighting, t_sdf, t_params, p, n)), t_params,
            t_sdf)


@pytest.mark.parametrize("name", ["ambient_occlusion", "soft_shadow",
                                  "shaded_intensity"])
def test_lighting_functions_match_jax(name):
    """f64 at 4,000 random points and unit normals: values in [0, 1] and
    equal to JAX's to 1e-12; values strictly between 0 and 1 are reached."""
    config = {False: JaxRenderConfig(ao_step=0.08, shadow_steps=12),
              True: RenderConfig(ao_step=0.08, shadow_steps=12)}
    jfn, tfn, _, _ = _lighting_pair(name, config)
    p, n = _points(4000, 11)
    want = np.asarray(jfn(tuple(jnp.asarray(c) for c in p),
                          tuple(jnp.asarray(c) for c in n)))
    got = tfn(tuple(torch.as_tensor(c) for c in p),
              tuple(torch.as_tensor(c) for c in n)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert ((got > 0.0) & (got < 1.0)).mean() > 0.02


def test_lighting_gradients_reach_the_arg_min_sample_only():
    """The shadow's running minimum and clamps are where-selects: a
    gradient with respect to the points matches JAX's (1e-7), and where
    the shadow is clamped to 1 or 0 it is exactly zero."""
    jfn, tfn, _, _ = _lighting_pair("soft_shadow", None)
    p, n = _points(500, 12)
    jp = tuple(jnp.asarray(c) for c in p)
    jn = tuple(jnp.asarray(c) for c in n)
    want = jax.grad(lambda x: jnp.sum(jfn((x, jp[1], jp[2]), jn)))(jp[0])
    x = torch.as_tensor(p[0]).requires_grad_(True)
    val = tfn((x, torch.as_tensor(p[1]), torch.as_tensor(p[2])),
              tuple(torch.as_tensor(c) for c in n))
    (got,) = torch.autograd.grad(val.sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=1e-9 * float(np.abs(want).max()))
    clamped = ((val == 0.0) | (val == 1.0)).detach().numpy()
    assert clamped.any() and (got.numpy()[clamped] == 0.0).all()


def test_lighting_unit_behaviour():
    """Open ground is fully open (AO exactly 1), a sphere over the plane
    occludes, a blocked light gives a hard shadow and an open one none."""
    scene = tgraph.Union(children=(
        tgraph.Plane(),
        tgraph.Affine(tgraph.Sphere(radius=0.5), (1.0, 0.0, 0.0, 0.0),
                      (1.0, 0.0, 0.0)),
    ))
    _, sdf, params = tgraph.compile_scene(scene, torch.float64)

    def at(*v):
        return tuple(torch.tensor([c], dtype=torch.float64) for c in v)

    n = at(1.0, 0.0, 0.0)
    assert float(lighting.ambient_occlusion(sdf, params, at(0.0, 50.0, 0.0),
                                            n, step=0.1)) == 1.0
    assert 0.0 <= float(lighting.ambient_occlusion(
        sdf, params, at(0.0, 0.0, 0.0), n, step=0.1)) < 1.0
    _, sdf2, params2 = tgraph.compile_scene(
        tgraph.Affine(tgraph.Sphere(radius=0.5), (1.0, 0.0, 0.0, 0.0),
                      (2.0, 0.0, 0.0)), torch.float64)
    origin = at(0.0, 0.0, 0.0)
    assert float(lighting.soft_shadow(sdf2, params2, origin, n,
                                      (1.0, 0.0, 0.0))) == 0.0
    assert float(lighting.soft_shadow(sdf2, params2, origin, n,
                                      (0.0, 1.0, 0.0))) == 1.0
    assert 0.0 < float(lighting.soft_shadow(sdf2, params2, origin, n,
                                            (1.0, 0.29, 0.0))) < 1.0


def test_normalized_light_rejects_zero():
    with pytest.raises(ValueError, match="nonzero"):
        lighting.normalized_light((0.0, 0.0, 0.0))
    assert lighting.normalized_light((0.0, 3.0, 4.0)) == (0.0, 0.6, 0.8)


def test_cli_parses_extra_modes():
    assert _parse_mode("shaded") == "shaded"
    assert _parse_mode("occlusion") == "occlusion"
    assert _parse_mode("spin") == 7
    assert _parse_mode("3") == 3


# -- the renderers -------------------------------------------------------------


def _fixture_renderer(cls):
    fx = np.load(FIXTURE)
    w, h = int(fx["width"]), int(fx["height"])
    px = float(fx["px_size"])
    cfg = RenderConfig(px_width=w, px_height=h, focal_length=px * h,
                       sensor_width=px * w, sensor_height=px * h,
                       marching_steps=int(fx["steps"]))
    return fx, cls(treg.make_scene("test_scene"), cfg, dtype=torch.float64,
                   grid_dtype=np.float64, device="cpu")


@pytest.mark.parametrize("mode", lighting.EXTRA_MODES)
@pytest.mark.parametrize("renderer", ["fast", "modular"])
def test_lighting_frozen_fixture(renderer, mode):
    """Both renderers against the frozen f64 fixture (48×64 test_scene)."""
    fx, r = _fixture_renderer(FastRenderer if renderer == "fast"
                              else Renderer)
    img = r.jitted(mode=mode)(r.init_params, fx["pose_q"], fx["pose_t"])
    tight = renderer == "modular" and mode == "occlusion"
    np.testing.assert_allclose(img.numpy(), fx[mode],
                               rtol=1e-12 if tight else 1e-9,
                               atol=1e-13 if tight else 1e-10)
    assert float(img.std()) > 0.01


def _stable(jr, q, t):
    origin, dirs = jr._pose_planes(q, t)
    hit, _ = jr._march_planes(jr.init_params, origin, dirs,
                              jr.config.marching_steps)
    hit = [np.asarray(p) for p in hit]
    stable = (np.abs(hit[3]) < 1e-2) & (
        np.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2) < 10)
    return np.asarray(jr._assemble([jnp.asarray(stable)]))


def _require_grad(tree):
    if isinstance(tree, dict):
        return {k: _require_grad(v) for k, v in tree.items()}
    return tree.clone().requires_grad_(True)


def test_shaded_image_and_gradient_match_jax_fast_renderer():
    """``shaded`` through the port's FastRenderer (the kernels' plain
    versions) against JAX's FastRenderer (interpret-mode Pallas), f64
    16×12, 14 steps: the image on stable pixels, and d sum(image · w) /
    d (every leaf) with w on stable pixels only."""
    w, h = 16, 12
    kw = _cfg_kwargs(w, h, marching_steps=14)
    jr = JaxFastRenderer(jreg.make_scene("test_scene"), JaxRenderConfig(**kw),
                         dtype=jnp.float64, grid_dtype=np.float64,
                         interpret=True)
    tr = FastRenderer(treg.make_scene("test_scene"), RenderConfig(**kw),
                      dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    jq, jt = jnp.asarray(Q), jnp.asarray(T)
    mask = _stable(jr, jq, jt)
    assert mask.sum() >= 20
    wt = np.random.default_rng(3).normal(size=(1, h, w, 3)) * mask
    jimg = np.asarray(jr.render(jr.init_params, jq, jt, mode="shaded"))
    params = _require_grad(tr.init_params)
    img = tr.render(params, Q, T, mode="shaded")
    m3 = np.broadcast_to(mask, img.shape)
    np.testing.assert_allclose(img.detach().numpy()[m3], jimg[m3],
                               rtol=1e-9, atol=1e-11)
    (img * torch.as_tensor(wt)).sum().backward()
    want = jgraph.param_paths(jax.grad(
        lambda p: jnp.sum(jr.render(p, jq, jt, mode="shaded") * wt))(
            jr.init_params))
    got = tgraph.param_paths(params)
    assert set(got) == set(want)
    moved = 0
    for path, wv in want.items():
        wv = np.asarray(wv)
        g = got[path].grad.numpy().reshape(wv.shape)
        assert np.isfinite(g).all(), path
        scale = max(1.0, float(np.abs(wv).max()))
        np.testing.assert_allclose(g, wv, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=path)
        moved += int(np.abs(g).max() > 0)
    assert moved >= len(want) // 2


def test_render_all_modes_extras_bundle():
    """``extras=True`` gives 10 images from one march on both renderers;
    the lighting images equal the single-mode renders bit for bit (the same
    operations on the same hit points), and the two renderers agree."""
    kw = _cfg_kwargs(32, 20, marching_steps=10)
    fast = FastRenderer(treg.make_scene("test_scene"), RenderConfig(**kw),
                        dtype=torch.float64, grid_dtype=np.float64,
                        device="cpu")
    mod = Renderer(treg.make_scene("test_scene"), RenderConfig(**kw),
                   dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    want = set(shaders.MODES) | set(lighting.EXTRA_MODES)
    bundles = {}
    for r in (fast, mod):
        images = r.render_all_modes(r.init_params, Q, T, degree=2,
                                    extras=True)
        assert set(images) == want
        for mode in lighting.EXTRA_MODES:
            single = r.render(r.init_params, Q, T, mode=mode)
            assert torch.equal(images[mode], single), mode
        bundles[r] = images
    for mode in lighting.EXTRA_MODES:
        np.testing.assert_allclose(bundles[fast][mode].numpy(),
                                   bundles[mod][mode].numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=mode)


def test_fourier_cmap_coeffs_match_jax():
    """The port's least-squares fit over its own copy of the colourmap
    equals JAX's (1e-12), and evaluates back to the table within 1/255."""
    got = shaders.fourier_cmap_coeffs()
    want = np.asarray(jshaders.fourier_cmap_coeffs())
    assert got.shape == (1 + 2 * shaders.FOURIER_HARMONICS, 3)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    k = 4096
    ang = (np.arange(k) + 0.5) * (2 * np.pi / k) - np.pi
    re, im = torch.as_tensor(np.cos(ang)), torch.as_tensor(np.sin(ang))
    cols = shaders.angle_colouring_fourier(re, im, got, 1)
    table = shaders.load_cyclic_cmap(torch.float64).numpy()
    assert np.abs(np.stack([c.numpy() for c in cols], -1) - table).max() \
        < 1 / 255


@pytest.mark.parametrize("degree", [2, -1])
def test_spin_cmap_fourier_fast_modular_and_jax(degree):
    """A ``spin`` frame with ``cmap_fourier``: the port's FastRenderer
    against its Renderer and against JAX's Renderer (f64 40×24, stable
    pixels), and the Fourier hue near the gather's."""
    kw = _cfg_kwargs(40, 24, marching_steps=14, cmap_fourier=True)
    fast = FastRenderer(treg.make_scene("test_scene2"), RenderConfig(**kw),
                        dtype=torch.float64, grid_dtype=np.float64,
                        device="cpu")
    mod = Renderer(treg.make_scene("test_scene2"), RenderConfig(**kw),
                   dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    jr = JaxRenderer(jreg.make_scene("test_scene2"), JaxRenderConfig(**kw),
                     dtype=jnp.float64, grid_dtype=np.float64)
    jf = JaxFastRenderer(jreg.make_scene("test_scene2"),
                         JaxRenderConfig(**kw), dtype=jnp.float64,
                         grid_dtype=np.float64, interpret=True)
    q = np.asarray([[0.99144486, 0.0, 0.13052619, 0.0]])
    t = np.asarray([[0.3, 0.1, -1.8]])
    mask = np.broadcast_to(_stable(jf, jnp.asarray(q), jnp.asarray(t)),
                           (1, 24, 40, 3))
    assert mask.mean() > 0.5
    a = fast.render(fast.init_params, q, t, mode=7, degree=degree).numpy()
    b = mod.render(mod.init_params, q, t, mode=7, degree=degree).numpy()
    c = np.asarray(jr.render(jr.init_params, jnp.asarray(q), jnp.asarray(t),
                             mode=7, degree=degree))
    np.testing.assert_allclose(a[mask], b[mask], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(a[mask], c[mask], rtol=1e-9, atol=1e-11)
    gather = FastRenderer(treg.make_scene("test_scene2"),
                          RenderConfig(**dict(kw, cmap_fourier=False)),
                          dtype=torch.float64, grid_dtype=np.float64,
                          device="cpu")
    g = gather.render(gather.init_params, q, t, mode=7, degree=degree)
    assert np.abs(g.numpy()[mask] - a[mask]).max() < 0.02
