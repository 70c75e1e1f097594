"""The port's modular pipeline (``Renderer``) and its building blocks against
the JAX package, f64 on the CPU: the same seeded numpy inputs go through
both.

Tolerances. Images: rtol 1e-9, atol 1e-11 on stable pixels (rays that
converged, |d| < 1e-2, and stayed within |p| < 10), as
tests/test_golden_parity.py holds the JAX renderer to the reference; both
packages run the same IEEE op sequence and differ by an ulp per op at most.
Gradients of a weighted pixel sum: rtol 1e-7, atol 1e-9 (the sums over the
pixels are taken in another order, and the VJP rules round differently by an
ulp per op, carried through the march). The loss weights are zero off the
stable pixels: a diverged ray's gradient is astronomically large and its
rounding would swamp the others. Unit cases: rtol 1e-12.

With ``use_pallas`` the JAX side runs its Pallas march kernel in interpret
mode (patched as tests/test_pallas.py patches it) and the port its kernel's
plain version, the path a CPU tensor takes.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_marching_tpu.ops.pallas_march as j_pallas_march
from ray_marching_tpu import quat as jquat
from ray_marching_tpu.camera import Camera as JaxCamera
from ray_marching_tpu.camera import CameraConfig as JaxCameraConfig
from ray_marching_tpu.render import implicit as jimplicit
from ray_marching_tpu.render import march as jmarch
from ray_marching_tpu.render.normals import NormalsEstimator as JaxNormals
from ray_marching_tpu.render.normals import autodiff_normals as j_autodiff
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch import Renderer as ExportedRenderer
from ray_marching_tpu_torch import quat as tquat
from ray_marching_tpu_torch.camera import Camera, CameraConfig
from ray_marching_tpu_torch.cli import main as cli_main
from ray_marching_tpu_torch.io.checkpoint import load_pytree, save_pytree
from ray_marching_tpu_torch.render import implicit as timplicit
from ray_marching_tpu_torch.render import march as tmarch
from ray_marching_tpu_torch.render.normals import (
    NormalsEstimator,
    autodiff_normals,
)
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.render.shaders import MODES
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

GOLDEN = Path(__file__).parent / "golden"
PX = 3.45e-6
W, H = 64, 48
# A generic pose that looks back at the objects from inside the room.
Q = np.asarray([[0.05, 0.03, 0.99, 0.02]])
Q = Q / np.linalg.norm(Q)
T = np.asarray([[0.1, 0.2, 2.0]])
Q2 = np.concatenate([Q, [[0.9914449, 0.0, 0.1305262, 0.0]]])
T2 = np.concatenate([T, [[0.3, 0.1, 2.2]]])

#: name -> (config overrides, pose). Every configuration the slice ports.
CONFIGS = {
    "plain": (dict(marching_steps=16), (Q, T)),
    "kernel": (dict(marching_steps=16, use_pallas=True), (Q, T)),
    "tau": (dict(marching_steps=16, tau=1e-3), (Q, T)),
    "kernel_tau": (dict(marching_steps=16, tau=1e-3, use_pallas=True), (Q, T)),
    "two_cameras": (dict(marching_steps=12, num_cameras=2), (Q2, T2)),
    "bounce": (dict(marching_steps=16, reflection_bounces=1), (Q, T)),
    "kernel_bounce": (dict(marching_steps=16, reflection_bounces=1,
                           use_pallas=True), (Q, T)),
    "autodiff_normals": (dict(marching_steps=16, use_autodiff_normals=True),
                         (Q, T)),
    "implicit": (dict(marching_steps=16, backward="implicit"), (Q, T)),
    "remat": (dict(marching_steps=12, remat=True), (Q, T)),
}


def _cfg_kwargs(w=W, h=H, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, **kw)


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Route the JAX pipeline's Pallas march through the interpreter."""
    orig = j_pallas_march.pallas_march
    monkeypatch.setattr(
        j_pallas_march, "pallas_march",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _pair(name, scene="test_scene2"):
    kw, pose = CONFIGS[name]
    jr = JaxRenderer(jreg.make_scene(scene),
                     JaxRenderConfig(**_cfg_kwargs(**kw)), dtype=jnp.float64,
                     grid_dtype=np.float64)
    tr = Renderer(treg.make_scene(scene), RenderConfig(**_cfg_kwargs(**kw)),
                  dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    return jr, tr, pose


def _stable(jr, q, t):
    """Traceable: the stable-pixel mask of the JAX renderer's own march."""
    _, _, ray_pos, ray_dirs = jr.camera.pose(q, t)
    p, _ = jr._march(jr.init_params, ray_pos, ray_dirs,
                     jr.config.marching_steps)
    f = jr.sdf_vec(jr.init_params, p)
    return (jnp.abs(f) < 1e-2) & (
        jnp.linalg.norm(p, axis=-1, keepdims=True) < 10.0)


def _jit(jr, fn):
    """``jax.jit(fn)`` for the plain marchers, whose eager dispatch is the
    slow part; the interpreted Pallas kernel is slower to compile under an
    outer jit than to run eagerly."""
    return fn if jr.config.use_pallas else jax.jit(fn)


def _stable_mask(jr, q, t):
    return np.asarray(_jit(jr, lambda q, t: _stable(jr, q, t))(
        jnp.asarray(q), jnp.asarray(t)))


@pytest.fixture(scope="module")
def rendered():
    """All 8 modes of a configuration, both packages, rendered once (inside
    a test, so under the interpreter patch above)."""
    cache = {}

    def get(name):
        if name not in cache:
            jr, tr, (q, t) = _pair(name)
            want, mask = _jit(jr, lambda p, q, t: (
                jr.render_all_modes(p, q, t, degree=2), _stable(jr, q, t)))(
                    jr.init_params, jnp.asarray(q), jnp.asarray(t))
            want = {k: np.asarray(v) for k, v in want.items()}
            got = {k: v.numpy() for k, v in tr.render_all_modes(
                tr.init_params, q, t, degree=2).items()}
            cache[name] = (want, got, np.asarray(mask), tr, (q, t))
        return cache[name]

    return get


IMAGE_CONFIGS = ["plain", "kernel", "kernel_tau", "two_cameras",
                 "kernel_bounce", "implicit"]


@pytest.mark.parametrize("mode", range(8))
@pytest.mark.parametrize("name", IMAGE_CONFIGS)
def test_render_all_modes_matches_jax(rendered, name, mode):
    want, got, mask, tr, _ = rendered(name)
    mname = MODES[mode]
    n = tr.config.num_cameras
    assert got[mname].shape == want[mname].shape == (n, H, W, 3)
    m = np.broadcast_to(mask, want[mname].shape)
    assert m.mean() > 0.5  # the comparison is not vacuous
    np.testing.assert_allclose(got[mname][m], want[mname][m], rtol=1e-9,
                               atol=1e-11, equal_nan=True,
                               err_msg=f"{name} {mname}")


@pytest.mark.parametrize("name", ["plain", "kernel"])
def test_render_equals_render_all_modes(rendered, name):
    _, got, _, tr, (q, t) = rendered(name)
    for mode in (0, 7, 13):  # mode % 8 wraps like the reference
        img = tr.render(tr.init_params, q, t, mode=mode, degree=2)
        np.testing.assert_array_equal(img.numpy(), got[MODES[mode % 8]])
    fn = tr.jitted(mode=4, degree=2)
    np.testing.assert_array_equal(fn(tr.init_params, q, t).numpy(),
                                  got["normal"])


def test_kernel_march_equals_plain_march(rendered):
    """``use_pallas`` changes the marcher, not the picture: the kernel's
    plain version runs the op sequence of the tensor marcher."""
    _, plain, mask, _, _ = rendered("plain")
    _, kernel, _, _, _ = rendered("kernel")
    m = np.broadcast_to(mask, plain["lambertian"].shape)
    np.testing.assert_allclose(kernel["lambertian"][m],
                               plain["lambertian"][m], rtol=1e-12, atol=1e-13)


def _weights(mask, seed):
    w = np.random.default_rng(seed).standard_normal(
        mask.shape[:3] + (3,))
    return w * mask


def _grad_pair(name, mode, alpha=False):
    jr, tr, (q, t) = _pair(name)
    mask = _stable_mask(jr, q, t)
    wt = _weights(mask, 17)
    wa = np.random.default_rng(18).standard_normal(mask.shape)

    def jloss(params, jq, jt):
        if alpha:
            img, a = jr.render_with_alpha(params, jq, jt, mode=mode, degree=2)
            return jnp.sum(img * wt) + jnp.sum(a * wa)
        return jnp.sum(jr.render(params, jq, jt, mode=mode, degree=2) * wt)

    jg, jgq, jgt = _jit(jr, jax.grad(jloss, argnums=(0, 1, 2)))(
        jr.init_params, jnp.asarray(q), jnp.asarray(t))
    want = {k: np.asarray(v) for k, v in jgraph.param_paths(jg).items()}
    want["camera_orientation"] = np.asarray(jgq)
    want["camera_translation"] = np.asarray(jgt)

    params = tgraph.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jr.init_params), torch.float64)
    leaves = tgraph.param_paths(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tq = torch.tensor(q, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    if alpha:
        img, a = tr.render_with_alpha(params, tq, tt, mode=mode, degree=2)
        loss = (img * torch.as_tensor(wt)).sum() + (a * torch.as_tensor(wa)).sum()
    else:
        loss = (tr.render(params, tq, tt, mode=mode, degree=2)
                * torch.as_tensor(wt)).sum()
    loss.backward()
    got = {k: (torch.zeros_like(v) if v.grad is None else v.grad).numpy()
           for k, v in leaves.items()}
    got["camera_orientation"] = tq.grad.numpy()
    got["camera_translation"] = tt.grad.numpy()
    return want, got


#: Modes 0 and 4 for the plain marcher and the kernel, one of the two for
#: every other configuration (each case compiles a JAX gradient).
GRAD_CASES = [("plain", 0), ("plain", 4), ("kernel", 0), ("kernel", 4),
              ("kernel_tau", 0), ("bounce", 4), ("kernel_bounce", 0),
              ("autodiff_normals", 4), ("implicit", 0), ("remat", 4),
              ("two_cameras", 0)]


@pytest.mark.parametrize("name,mode", GRAD_CASES)
def test_gradients_match_jax(name, mode):
    want, got = _grad_pair(name, mode)
    assert set(want) == set(got)
    assert any(np.abs(v).max() > 1e-3 for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-9,
                                   err_msg=f"{name} mode={mode} {k}")


@pytest.mark.parametrize("name", ["plain", "implicit", "tau"])
def test_render_with_alpha_matches_jax(name):
    jr, tr, (q, t) = _pair(name)
    jimg, ja = jr.render_with_alpha(jr.init_params, jnp.asarray(q),
                                    jnp.asarray(t), mode=0, degree=2)
    img, a = tr.render_with_alpha(tr.init_params, q, t, mode=0, degree=2)
    assert a.shape == (1, H, W, 1)
    m = np.broadcast_to(_stable_mask(jr, q, t), img.shape)
    np.testing.assert_allclose(img.numpy()[m], np.asarray(jimg)[m], rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-9,
                               atol=1e-11)


@pytest.mark.parametrize("name", ["plain", "implicit"])
def test_render_with_alpha_gradients_match_jax(name):
    want, got = _grad_pair(name, 0, alpha=True)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-9,
                                   err_msg=f"{name} alpha {k}")


def test_render_with_alpha_rejects_bounces():
    _, tr, (q, t) = _pair("bounce")
    with pytest.raises(ValueError, match="reflection bounces"):
        tr.render_with_alpha(tr.init_params, q, t)


@pytest.mark.parametrize("mode", [0, 4])
def test_golden_scene2_bounce_image(mode):
    """The port straight against the reference-made fixture (512×512, one
    reflection bounce), through the march kernel's plain version."""
    g = np.load(GOLDEN / "scene2_bounce_512.npz")
    w, h = int(g["meta_width"]), int(g["meta_height"])
    cfg = RenderConfig(**_cfg_kwargs(
        w, h, marching_steps=int(g["meta_steps"]),
        normals_eps=float(g["meta_normals_eps"]),
        reflection_bounces=int(g["meta_reflection_bounces"]),
        use_pallas=True))
    r = Renderer(treg.make_scene(str(g["meta_scene"])), cfg,
                 dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    with torch.no_grad():
        img = r.render(r.init_params, g["meta_orientation"][None],
                       g["meta_translation"][None], mode=mode,
                       degree=int(g["meta_degree"])).numpy()
    want = g[f"image_{mode}"]
    mask = np.broadcast_to(g["stable_mask"], want.shape)
    np.testing.assert_allclose(img[mask], want[mask], rtol=1e-9, atol=1e-11,
                               equal_nan=True)


# -- entry points, options, state -------------------------------------------


def test_renderer_is_exported_and_defaults_to_the_card():
    assert ExportedRenderer is Renderer
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(treg.make_scene("test_scene2"),
                 RenderConfig(**_cfg_kwargs(16, 8)))


@pytest.mark.parametrize("which", ["camera", "normals"])
def test_camera_and_normals_default_to_the_card(which):
    """``Camera`` and ``NormalsEstimator`` default to ``"cuda"`` like every
    other entry point: without a card they raise and do not fall back."""
    def build():
        if which == "camera":
            return Camera(CameraConfig(px_width=4, px_height=2)).ray_positions
        return NormalsEstimator(5e-2).offsets

    if torch.cuda.is_available():
        assert build().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


@pytest.mark.parametrize("what", ["cmap_fourier", "occlusion", "extras",
                                  "axis_names", "backward"])
def test_unported_options_raise(what):
    """``axis_names`` (the parallel slice) still raises NotImplementedError;
    ``cmap_fourier``, the ``occlusion`` mode and ``extras=True`` run since
    the lighting slice (tests/test_torch_lighting.py holds their values
    against JAX); a bad ``backward`` is rejected as in JAX."""
    scene = treg.make_scene("test_scene2")
    kw = _cfg_kwargs(16, 8, marching_steps=4)
    if what == "backward":
        with pytest.raises(ValueError, match="unroll|implicit"):
            Renderer(scene, RenderConfig(backward="adjoint", **kw),
                     dtype=torch.float64, device="cpu")
        return
    if what == "cmap_fourier":
        kw["cmap_fourier"] = True
    r = Renderer(scene, RenderConfig(**kw), dtype=torch.float64, device="cpu")
    q, t = r.default_pose()
    if what == "axis_names":
        with pytest.raises(NotImplementedError, match="not ported"):
            r.render(r.init_params, q, t, mode=1, axis_names=("x",))
    elif what == "occlusion":
        img = r.render(r.init_params, q, t, mode="occlusion")
        assert img.shape == (1, 8, 16, 3) and bool(torch.isfinite(img).all())
    elif what == "extras":
        images = r.render_all_modes(r.init_params, q, t, extras=True)
        assert {"occlusion", "shaded"} <= set(images)
    else:
        assert r.cmap_coeffs is not None
        assert r.render(r.init_params, q, t, mode=6).shape == (1, 8, 16, 3)


def test_default_pose_and_init_params_match_jax(tmp_path):
    """The same ``init_params`` leaves, so a checkpoint written from either
    ``Renderer`` loads into the other."""
    jr, tr, _ = _pair("plain")
    jq, jt = jr.default_pose()
    q, t = tr.default_pose()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    jp = jgraph.param_paths(jr.init_params)
    tp = tgraph.param_paths(tr.init_params)
    assert list(jp) == list(tp)
    from ray_marching_tpu.io.checkpoint import load_pytree as j_load
    from ray_marching_tpu.io.checkpoint import save_pytree as j_save

    path = save_pytree(tmp_path / "port.npz", tr.init_params)
    back = jgraph.param_paths(j_load(path, jr.init_params))
    for k in jp:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(jp[k]))
    path = j_save(tmp_path / "jax.npz", jr.init_params)
    back = tgraph.param_paths(load_pytree(path, tr.init_params))
    for k in tp:
        np.testing.assert_array_equal(back[k].numpy(), tp[k].numpy())


@pytest.mark.parametrize("flags", [[], ["--pallas"], ["--fast"],
                                   ["--pallas", "--bounces", "1"],
                                   ["--backward", "implicit",
                                    "--normals-eps", "0.04"]],
                         ids=["modular", "pallas", "fast", "bounce",
                              "implicit"])
def test_cli_render_builds_the_renderer_asked_for(tmp_path, flags):
    out = tmp_path / "frame.png"
    cli_main(["render", "--device", "cpu", "--width", "24", "--height", "16",
              "--steps", "8", "-o", str(out)] + flags)
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == 24


# -- unit cases: the building blocks against their JAX counterparts ----------


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


QUAT_CASES = {
    "cross": lambda m, u, v, p, q: m.cross(u, v),
    "multiply": lambda m, u, v, p, q: m.multiply(p, q),
    "conjugate": lambda m, u, v, p, q: m.conjugate(q),
    "rotation": lambda m, u, v, p, q: m.rotation(u, q),
    "to_versor": lambda m, u, v, p, q: m.to_versor(u * 0.2),
    "normalize": lambda m, u, v, p, q: m.normalize(p),
    "to_so3": lambda m, u, v, p, q: m.to_so3(m.normalize(q)),
}


@pytest.mark.parametrize("fn", sorted(QUAT_CASES))
def test_vector_quat_matches_jax(fn):
    rng = np.random.default_rng(31)
    u, v = rng.normal(size=(2, 5, 7, 3))
    p, q = rng.normal(size=(2, 5, 7, 4))
    j = QUAT_CASES[fn](jquat, *(jnp.asarray(a) for a in (u, v, p, q)))
    t = QUAT_CASES[fn](tquat, *(torch.as_tensor(a) for a in (u, v, p, q)))
    assert tuple(t.shape) == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("grid_dtype", [np.float32, np.float64])
def test_camera_pose_matches_jax(grid_dtype):
    kw = dict(num_cameras=2, px_width=20, px_height=12,
              focal_length=PX * 12, sensor_width=PX * 20,
              sensor_height=PX * 12)
    assert (CameraConfig.from_pixel_pitch(20, 12, num_cameras=2)
            == CameraConfig(**kw))
    jc = JaxCamera(JaxCameraConfig(**kw), dtype=jnp.float64,
                   grid_dtype=grid_dtype)
    tc = Camera(CameraConfig(**kw), dtype=torch.float64,
                grid_dtype=grid_dtype, device="cpu")
    want = jc.pose(jnp.asarray(Q2), jnp.asarray(T2))
    got = tc.pose(torch.as_tensor(Q2), torch.as_tensor(T2))
    assert got[0] is got[2]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-18)


def _scene_and_rays(seed, shape=(3, 11), scene="test_scene2"):
    jvec, _, jparams = jgraph.compile_scene(jreg.make_scene(scene),
                                            jnp.float64)
    tvec, _, tparams = tgraph.compile_scene(treg.make_scene(scene),
                                            torch.float64)
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, shape + (3,))
    v = rng.standard_normal(shape + (3,))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (jvec, jparams), (tvec, tparams), p0, v


def test_normals_estimator_matches_jax():
    (jvec, jparams), (tvec, tparams), p0, _ = _scene_and_rays(41)
    jn, jl = JaxNormals(5e-2, dtype=jnp.float64)(jvec, jparams,
                                                 jnp.asarray(p0))
    tn, tl = NormalsEstimator(5e-2, dtype=torch.float64, device="cpu")(
        tvec, tparams, torch.as_tensor(p0))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-8,
                               atol=1e-8)
    ja = j_autodiff(jvec, jparams, jnp.asarray(p0))
    ta = autodiff_normals(tvec, tparams, torch.as_tensor(p0))
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja),
                               rtol=1e-12, atol=1e-14)


MARCH_CASES = ["march", "march_tau", "with_closest", "with_closest_tau",
               "unrolled", "planes", "planes_tau", "implicit",
               "closest_implicit"]


def _run_march(case, mod, imp, vec, sdf_c, params, p0, v):
    if case == "march":
        return mod.march(vec, params, p0, v, 12)
    if case == "march_tau":
        return mod.march(vec, params, p0, v, 12, tau=1e-3)
    if case == "with_closest":
        return mod.march_with_closest(vec, params, p0, v, 12)
    if case == "with_closest_tau":
        return mod.march_with_closest(vec, params, p0, v, 12, tau=1e-3)
    if case == "unrolled":
        return mod.march_unrolled(vec, params, p0, v, 12)
    if case == "implicit":
        return imp.march_implicit(vec, params, p0, v, 12, 1e-3)
    if case == "closest_implicit":
        return imp.march_with_closest_implicit(vec, params, p0, v, 12)
    tau = 1e-3 if case == "planes_tau" else 0.0
    comps = [a[..., i] for a in (p0, v) for i in range(3)]
    return mod.march_planes(sdf_c, params, *comps, 12, tau=tau)


@pytest.mark.parametrize("case", MARCH_CASES)
def test_march_matches_jax(case):
    (jvec, jparams), (tvec, tparams), p0, v = _scene_and_rays(43)
    _, jc, _ = jgraph.compile_scene(jreg.make_scene("test_scene2"),
                                    jnp.float64)
    tc = tgraph.compile_node(treg.make_scene("test_scene2"))
    want = _run_march(case, jmarch, jimplicit, jvec, jc, jparams,
                      jnp.asarray(p0), jnp.asarray(v))
    got = _run_march(case, tmarch, timplicit, tvec, tc, tparams,
                     torch.as_tensor(p0), torch.as_tensor(v))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-11,
                                   atol=1e-12)


@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_remat_equals_plain_values_and_gradients(tau):
    _, (tvec, tparams), p0, v = _scene_and_rays(45)
    grads = []
    for remat in (False, True):
        params = tgraph.params_from_jax(_to_numpy(tparams), torch.float64)
        leaves = list(tgraph.param_paths(params).values())
        for leaf in leaves:
            leaf.requires_grad_(True)
        p = torch.tensor(p0, requires_grad=True)
        out = tmarch.march(tvec, params, p, torch.as_tensor(v), 10, tau=tau,
                           remat=remat)
        g = torch.autograd.grad((out ** 2).sum(), leaves + [p],
                                allow_unused=True)
        grads.append((out.detach(), g))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def test_march_planes_equals_march_and_reflect_formula():
    _, (tvec, tparams), p0, v = _scene_and_rays(47)
    tc = tgraph.compile_node(treg.make_scene("test_scene2"))
    p, d = torch.as_tensor(p0), torch.as_tensor(v)
    want = tmarch.march(tvec, tparams, p, d, 9)
    got = tmarch.march_planes(tc, tparams, *(a[..., i] for a in (p, d)
                                             for i in range(3)), 9)
    assert torch.equal(torch.stack(got, dim=-1), want)
    n = torch.as_tensor(np.random.default_rng(48).normal(size=p0.shape))
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    r = tmarch.reflect(d, n)
    np.testing.assert_allclose(
        r.numpy(), np.asarray(jmarch.reflect(jnp.asarray(v),
                                             jnp.asarray(n.numpy()))),
        rtol=1e-13, atol=1e-15)
    # A mirror keeps the length and flips the normal component.
    torch.testing.assert_close((r * n).sum(-1), -(d * n).sum(-1))
    torch.testing.assert_close(torch.linalg.norm(r, dim=-1),
                               torch.ones_like(r[..., 0]))


@pytest.mark.parametrize("closest", [False, True], ids=["march", "closest"])
def test_implicit_gradients_match_jax(closest):
    """Camera-like rays (a plane outside the scene looking in), so that most
    converge and the IFT routing has hits to route."""
    (jvec, jparams), (tvec, _), _, _ = _scene_and_rays(49)
    rng = np.random.default_rng(50)
    shape = (6, 9)
    p0 = np.zeros(shape + (3,))
    p0[..., 0] = rng.uniform(-0.8, 0.8, shape)
    p0[..., 1] = rng.uniform(-0.8, 0.8, shape)
    p0[..., 2] = 2.5
    v = np.zeros(shape + (3,))
    v[..., 2] = -1.0
    v[..., 0] = rng.uniform(-0.1, 0.1, shape)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = rng.standard_normal(shape + (3,))
    wm = rng.standard_normal(shape + (1,))

    def jloss(params, p, d):
        if closest:
            ps, mf = jimplicit.march_with_closest_implicit(jvec, params, p, d,
                                                           24)
            return jnp.sum(ps * w) + jnp.sum(mf * wm)
        return jnp.sum(jimplicit.march_implicit(jvec, params, p, d, 24) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jparams, jnp.asarray(p0),
                                           jnp.asarray(v))
    params = tgraph.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), torch.float64)
    leaves = tgraph.param_paths(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tp = torch.tensor(p0, requires_grad=True)
    td = torch.tensor(v, requires_grad=True)
    if closest:
        ps, mf = timplicit.march_with_closest_implicit(tvec, params, tp, td,
                                                       24)
        loss = (ps * torch.as_tensor(w)).sum() + (mf * torch.as_tensor(wm)).sum()
    else:
        loss = (timplicit.march_implicit(tvec, params, tp, td, 24)
                * torch.as_tensor(w)).sum()
    loss.backward()
    want = jgraph.param_paths(jg[0])
    assert any(np.abs(np.asarray(x)).max() > 1e-3 for x in want.values())
    for k, leaf in leaves.items():
        got = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-11, err_msg=k)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg[1]), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jg[2]), rtol=1e-9,
                               atol=1e-11)
