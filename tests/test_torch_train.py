"""The port's training path against the JAX package, f64 on the CPU: the
gradients of ``FastRenderer.render`` / ``render_with_alpha`` with respect to
every scene leaf and the camera pose, and the select backwards of
``rmin``/``rmax``/``where``. tests/test_torch_optimize.py holds the
optimisation loop on top of them.

The JAX side runs its Pallas kernels in interpret mode
(``FastRenderer(..., interpret=True)``); the port runs the kernels' plain
versions through the same ``torch.autograd.Function`` the card uses.

Tolerance of the gradients: rtol 1e-7, atol 1e-9 relative to the largest
entry of a leaf's gradient. Both packages run the same algorithm; the VJP
rules differ by an ulp per op and the sums over the rays run in another
order. Only stable pixels (ray converged, |d| < 1e-2, and |p| < 10) carry a
loss weight: a diverged ray's gradient is astronomically large and would
swamp the rest. test_scene's SmoothUnion takes ``jnp.max`` over the stacked
children in JAX and a ``torch.maximum`` chain in the port; the cotangent
that reaches the max is 1 − Σ softmax, zero up to rounding, so the two
agree within the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu import utils as jutils
from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch import utils as tutils
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

PX = 3.45e-6
Q = np.asarray([[0.99144486, 0.0, 0.13052619, 0.0]])
T = np.asarray([[0.3, 0.1, -1.8]])


def _cfg_kwargs(w, h, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, **kw)


def _renderers(scene, w, h, **kw):
    jr = JaxFastRenderer(jreg.make_scene(scene),
                         JaxRenderConfig(**_cfg_kwargs(w, h, **kw)),
                         dtype=jnp.float64, grid_dtype=np.float64,
                         interpret=True)
    tr = FastRenderer(treg.make_scene(scene),
                      RenderConfig(**_cfg_kwargs(w, h, **kw)),
                      dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    return jr, tr


def _stable_pixels(jr, q, t):
    origin, dirs = jr._pose_planes(q, t)
    hit, _ = jr._march_planes(jr.init_params, origin, dirs,
                              jr.config.marching_steps)
    hit = [np.asarray(p) for p in hit]
    stable = (np.abs(hit[3]) < 1e-2) & (
        np.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2) < 10)
    return np.asarray(jr._assemble([jnp.asarray(stable)]))


def _leaves(tree):
    return tgraph.param_paths(tree)


def _require_grad(tree):
    if isinstance(tree, dict):
        return {k: _require_grad(v) for k, v in tree.items()}
    return tree.clone().requires_grad_(True)


def _assert_grads_close(got, want, label):
    assert set(got) == set(want), label
    for path in want:
        w = np.asarray(want[path])
        g = got[path].numpy().reshape(w.shape)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=f"{label} {path}")


# scene, mode, tau, with alpha, backward
CASES = {
    "scene2_mode0": ("test_scene2", 0, 0.0, False, "unroll"),
    "scene2_tangent": ("test_scene2", 6, 0.0, False, "unroll"),
    "scene2_mode0_tau": ("test_scene2", 0, 1e-3, False, "unroll"),
    "smooth_union_mode0": ("test_scene", 0, 0.0, False, "unroll"),
    "scene2_alpha": ("test_scene2", 0, 0.0, True, "unroll"),
    "scene2_alpha_tau": ("test_scene2", 0, 1e-3, True, "unroll"),
    "scene2_implicit": ("test_scene2", 0, 0.0, False, "implicit"),
    "scene2_alpha_implicit": ("test_scene2", 0, 0.0, True, "implicit"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_gradients_match_jax(case):
    """d sum(render · w) / d (every leaf, q, t) against jax.grad through the
    JAX FastRenderer; with alpha the loss also weights the coverage mask."""
    scene, mode, tau, alpha, backward = CASES[case]
    w, h = 48, 32
    jr, tr = _renderers(scene, w, h, marching_steps=12, tau=tau,
                        backward=backward)
    jq, jt = jnp.asarray(Q), jnp.asarray(T)
    rng = np.random.default_rng(41)
    mask = _stable_pixels(jr, jq, jt)
    assert mask.sum() >= 200, mask.sum()
    wt_img = rng.normal(size=(1, h, w, 3)) * mask
    wt_a = rng.normal(size=(1, h, w, 1)) * mask

    def j_loss(params, q, t):
        if alpha:
            img, a = jr.render_with_alpha(params, q, t, mode=mode, degree=2)
            return jnp.sum(img * wt_img) + jnp.sum(a * wt_a)
        return jnp.sum(jr.render(params, q, t, mode=mode, degree=2) * wt_img)

    jg, jgq, jgt = jax.grad(j_loss, argnums=(0, 1, 2))(jr.init_params, jq, jt)
    want = dict(jgraph.param_paths(jg), camera_orientation=jgq,
                camera_translation=jgt)

    params = _require_grad(tr.init_params)
    q = torch.tensor(Q, requires_grad=True)
    t = torch.tensor(T, requires_grad=True)
    if alpha:
        img, a = tr.render_with_alpha(params, q, t, mode=mode, degree=2)
        loss = ((img * torch.as_tensor(wt_img)).sum()
                + (a * torch.as_tensor(wt_a)).sum())
    else:
        loss = (tr.render(params, q, t, mode=mode, degree=2)
                * torch.as_tensor(wt_img)).sum()
    loss.backward()
    got = {k: v.grad for k, v in _leaves(params).items()}
    got.update(camera_orientation=q.grad, camera_translation=t.grad)
    assert all(v is not None for v in got.values())
    _assert_grads_close(got, want, case)


def test_render_with_alpha_matches_jax():
    jr, tr = _renderers("test_scene2", 48, 32, marching_steps=12)
    jimg, ja = jr.render_with_alpha(jr.init_params, jnp.asarray(Q),
                                    jnp.asarray(T), mode=0, degree=2, beta=0.1)
    img, a = tr.render_with_alpha(tr.init_params, Q, T, mode=0, degree=2,
                                  beta=0.1)
    assert a.shape == (1, 32, 48, 1)
    mask = _stable_pixels(jr, jnp.asarray(Q), jnp.asarray(T))
    np.testing.assert_allclose(a.numpy()[mask], np.asarray(ja)[mask],
                               rtol=1e-9, atol=1e-11)
    m3 = np.broadcast_to(mask, img.shape)
    np.testing.assert_allclose(img.numpy()[m3], np.asarray(jimg)[m3],
                               rtol=1e-9, atol=1e-11)
    with pytest.raises(ValueError, match="reflection bounces"):
        _, tb = _renderers("test_scene2", 16, 8, reflection_bounces=1)
        tb.render_with_alpha(tb.init_params, Q, T)


BENCH_Q = np.asarray([[0.0, 0.0, 1.0, 0.0]])
BENCH_T = np.asarray([[0.0, 0.2, 2.5]])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_open_scene_gradient_overflows_f32_like_jax(dtype):
    """test_scene is open: from the benchmark pose the rays that miss
    every object escape and reach |p| ~ 4e8 in 32 steps. The gradient of a pixel MSE
    through those rays overflows float32, so every scene leaf's gradient is
    non-finite, in the JAX package exactly as in the port; in float64 both
    stay finite. (test_scene2 is a closed room and trains in float32.) This
    pins that the port adds no NaN of its own here and removes none."""
    w, h = 32, 18
    jdt, tdt, npdt = ((jnp.float32, torch.float32, np.float32)
                      if dtype == "float32"
                      else (jnp.float64, torch.float64, np.float64))
    kw = _cfg_kwargs(w, h, marching_steps=32)
    jr = JaxFastRenderer(jreg.make_scene("test_scene"), JaxRenderConfig(**kw),
                         dtype=jdt, grid_dtype=npdt, interpret=True)
    tr = FastRenderer(treg.make_scene("test_scene"), RenderConfig(**kw),
                      dtype=tdt, grid_dtype=npdt, device="cpu")
    jq, jt = jnp.asarray(BENCH_Q, jdt), jnp.asarray(BENCH_T, jdt)

    def j_loss(params):
        img = jr.render(params, jq, jt, mode=0, degree=2)
        return jnp.mean((img - 0.5) ** 2)

    want = {k: np.isfinite(np.asarray(v)).all()
            for k, v in jgraph.param_paths(jax.grad(j_loss)(jr.init_params))
            .items()}
    params = _require_grad(tr.init_params)
    img = tr.render(params, BENCH_Q, BENCH_T, mode=0, degree=2)
    ((img - 0.5) ** 2).mean().backward()
    got = {k: bool(torch.isfinite(v.grad).all())
           for k, v in _leaves(params).items()}
    assert got == want
    assert set(got.values()) == {dtype == "float64"}, got


# -- select backwards -------------------------------------------------------


@pytest.mark.parametrize("name", ["rmin", "rmax"])
@pytest.mark.parametrize("cot", [2.5, float("nan")], ids=["finite", "nan"])
def test_select_reduction_backward_matches_jax(name, cot):
    """Ties split evenly; a NaN cotangent stays on the tied elements and
    every other element keeps an exact zero."""
    x = np.random.default_rng(43).normal(size=(6, 7))
    ext = x.min() if name == "rmin" else x.max()
    x[1, 2] = x[4, 4] = x[5, 0] = ext  # three-way tie with the extremum
    want = jax.vjp(getattr(jutils, name), jnp.asarray(x))[1](
        jnp.asarray(cot))[0]
    tx = torch.tensor(x, requires_grad=True)
    out = getattr(tutils, name)(tx)
    assert float(out) == ext
    out.backward(torch.tensor(cot, dtype=torch.float64))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    assert np.count_nonzero(tx.grad.numpy()) == 4  # the ties only


@pytest.mark.parametrize("fn", ["clamp", "vmin", "vmax"])
def test_where_selects_give_exact_zero_for_nan_cotangent(fn):
    """torch.where's backward is a select: the losing branch gets 0, not
    NaN·0, exactly like the JAX package's where-selects."""
    a = np.asarray([0.5, -2.0, 3.0, 1.0])
    b = np.asarray([1.0, 1.0, 1.0, 1.0])
    cot = np.asarray([np.nan, np.nan, 1.0, np.nan])
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    if fn == "clamp":
        out = tutils.clamp(ta, 0.0, 1.0)
        jout, jvjp = jax.vjp(lambda v: jutils.clamp(v, 0.0, 1.0),
                             jnp.asarray(a))
        want = jvjp(jnp.asarray(cot))
    else:
        out = getattr(tutils, fn)(ta, tb)
        jout, jvjp = jax.vjp(getattr(jutils, fn), jnp.asarray(a),
                             jnp.asarray(b))
        want = jvjp(jnp.asarray(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(torch.tensor(cot))
    got = [ta.grad] + ([tb.grad] if fn != "clamp" else [])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
