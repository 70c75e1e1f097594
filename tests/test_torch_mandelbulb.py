"""The Mandelbulb in the port against the JAX package, and the lowering door
for custom nodes (CPU, f64 unless stated; inputs from numpy seeds).

- ``scene/fractals.py``'s torch SDF against JAX's ``mandelbulb_sdf`` at rtol
  1e-12: both take the same IEEE operations in the same order, and the one
  libm call (``log``) may differ by an ulp between XLA and torch;
- the generated evaluator (``SdfProgram.evaluate``) equal to the plain SDF
  bit for bit, f32 and f64: the lowering emits the SDF's own operations;
- the generated VJP against ``torch.autograd.grad`` of the evaluator and
  against ``jax.vjp`` of the JAX scene SDF (rtol 1e-9 of the largest
  entry: the adjoint sums in another order than either autograd);
- ``FastRenderer`` (the kernels' plain versions) and ``Renderer`` against
  the JAX renderers at 48×32, 24 steps, by the JAX package's own criterion
  for this chaotic boundary (tests/test_custom_nodes.py): more than 0.98 of
  the pixels within rtol 1e-9;
- the lowering door: ``sel_le``'s NaN rule, a third-party node with its own
  lowering, and one without, which still raises.

The kernels themselves are held against their plain versions by the
``cuda`` test at the end (skipped without a card) and by chip_smoke.py.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.ops.pallas_march import split_params_padded as j_split
from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.scene import fractals as jfractals
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu.scene import serialize as jser
from ray_marching_tpu_torch.ops import backward_kernel as bk
from ray_marching_tpu_torch.ops import march_kernel as mk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.scene import codegen
from ray_marching_tpu_torch.scene import fractals as tfractals
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene import serialize as tser
from ray_marching_tpu_torch.scene.codegen import SdfProgram

PX = 3.45e-6
Q, T = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2, 2.5]])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the driver runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed, n=3000):
    """Random points around the set, then the singular and boundary ones:
    the origin, the z axis (rxy = 0), the bailout sphere |p| = 2, and the
    far field where the bound r - 2^(1/7) takes over."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.6, 1.6, (3, n))
    p[:, :4] = 0.0
    p[0, 4:40] = p[1, 4:40] = 0.0
    u = rng.normal(size=(3, 200))
    p[:, 40:240] = 2.0 * u / np.linalg.norm(u, axis=0)
    p[:, 240:440] = u * rng.uniform(3.0, 20.0, 200) / np.linalg.norm(u,
                                                                      axis=0)
    return p


def _cfg(w, h, steps, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h,
                marching_steps=steps, **kw)


# -- the SDF ------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 1.3])
def test_sdf_matches_jax(scale):
    p = _points(1)
    node_j, node_t = jfractals.Mandelbulb(), tfractals.Mandelbulb()
    want = jfractals.mandelbulb_sdf(node_j)(
        {"scale": jnp.asarray(scale, jnp.float64)}, *map(jnp.asarray, p))
    got = tfractals.mandelbulb_sdf(node_t)(
        {"scale": torch.tensor(scale, dtype=torch.float64)},
        *map(torch.as_tensor, p))
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)


def test_node_fields_and_validation_match_jax():
    assert repr(tfractals.Mandelbulb()) == repr(jfractals.Mandelbulb())
    with pytest.raises(ValueError, match="power must be >= 2"):
        tfractals.mandelbulb_sdf(tfractals.Mandelbulb(power=1))
    with pytest.raises(ValueError, match="power must be >= 2"):
        SdfProgram(tfractals.Mandelbulb(power=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_evaluator_equals_plain_sdf_bitwise(dtype):
    """The lowering emits the plain SDF's operations in its order, so the
    generated evaluator gives the same bits, at perturbed parameters too."""
    scene = treg.make_scene("mandelbulb")
    program = SdfProgram(scene)
    params = tgraph.init_params(scene, dtype)
    params["c1"]["child"]["scale"] = torch.tensor(0.85, dtype=dtype)
    flat, _, _ = split_params_padded(params, dtype)
    pts = [torch.as_tensor(c, dtype=dtype) for c in _points(2)]
    got = program.evaluate(flat, *pts)
    want = program.sdf_c(program.rebuild(flat), *pts)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


def test_vjp_matches_autograd_and_jax():
    """The generated adjoint (the backward kernel's scene_sdf_vjp, on
    tensors) against autograd of the evaluator and jax.vjp of the JAX scene
    SDF: the point cotangents per point, the scale's summed over them."""
    scene = treg.make_scene("mandelbulb")
    program = SdfProgram(scene)
    params = tgraph.init_params(scene, torch.float64)
    params["c1"]["child"]["scale"] = torch.tensor(1.1, dtype=torch.float64)
    flat, _, specs = split_params_padded(params, torch.float64)
    p = _points(3)
    g = np.random.default_rng(4).normal(size=p.shape[1])
    pts = [torch.as_tensor(c).requires_grad_(True) for c in p]
    leaf = flat.clone().requires_grad_(True)
    want = torch.autograd.grad(program.evaluate(leaf, *pts), [leaf] + pts,
                               torch.as_tensor(g))
    d, gx, gy, gz, gp = program.evaluate_vjp(flat, *map(torch.as_tensor, p),
                                             torch.as_tensor(g))
    offset = next(s.offset for s in specs if s.path == "c1/child/scale")
    k = program.scalar_offsets.index(offset)
    got_scale = gp[k].sum()

    jscene = jreg.make_scene("mandelbulb")
    _, jsdf, jparams = jgraph.compile_scene(jscene, jnp.float64)
    jparams["c1"]["child"]["scale"] = jnp.asarray(1.1, jnp.float64)
    jd, vjp = jax.vjp(jsdf, jparams, *map(jnp.asarray, p))
    jgp, *jxyz = vjp(jnp.asarray(g))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-12)
    for got, ref, ref_j in zip((gx, gy, gz), want[1:], jxyz):
        for r in (ref.numpy(), np.asarray(ref_j)):
            np.testing.assert_allclose(got.numpy(), r, rtol=1e-9,
                                       atol=1e-9 * np.abs(r).max())
    for r in (float(want[0][offset]), float(jgp["c1"]["child"]["scale"])):
        assert float(got_scale) == pytest.approx(r, rel=1e-9)


def test_op_counts_pinned():
    """875 ray-dependent ops per evaluation of the scene: the bulb's 820 (10
    before its loop: c = p/s, |c|², the guarded sqrt; 80 per iteration: the
    guarded radii 2+3+2, cos/sin 2+4, the two de Moivre powers 2×21, r^7 by
    4 multiplies and r^8 by one, dr 3, the four bailout selects with the
    new z 4+4+3+1, |z|² 5; 10 after it: the guarded sqrt, the estimate 4,
    the bound, two selects and the scale), the Affine's 33, the room's 21
    and the union's select. The exponentiations leave out the squaring after
    their last bit (JAX computes it and never reads it). Every adjoint op
    counts for the VJP, plus one add per accumulated parameter scalar."""
    program = SdfProgram(treg.make_scene("mandelbulb"))
    assert program.op_counts() == {"add": 195, "mul": 520, "div": 41,
                                   "sqrt": 23, "exp": 0, "log": 1,
                                   "abs_neg": 4, "select": 91}
    assert program.ops_per_eval == 875
    assert len(program.adj_params) == 12
    assert program.vjp_ops_per_eval == 3049
    bulb = SdfProgram(tfractals.Mandelbulb())
    assert bulb.ops_per_eval == 820


# -- scene files and parameters -----------------------------------------------


def test_scene_json_round_trips_with_jax(tmp_path):
    tscene, jscene = treg.make_scene("mandelbulb"), jreg.make_scene(
        "mandelbulb")
    assert repr(tscene) == repr(jscene)
    assert tser.node_to_dict(tscene) == jser.node_to_dict(jscene)
    path = jser.save_scene(tmp_path / "jax.json", jscene)
    assert tser.load_scene(path) == tscene
    path = tser.save_scene(tmp_path / "port.json", tscene)
    assert repr(jser.load_scene(path)) == repr(jscene)


def test_params_and_flat_layout_match_jax():
    jparams = jgraph.init_params(jreg.make_scene("mandelbulb"), jnp.float64)
    jparams["c1"]["child"]["scale"] = jnp.asarray(0.85, jnp.float64)
    tparams = tgraph.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), torch.float64)
    assert float(tparams["c1"]["child"]["scale"]) == 0.85
    jflat, _, jsplit = j_split(jparams, jnp.float64)
    tflat, _, tspecs = split_params_padded(tparams, torch.float64)
    assert [s.offset for s in tspecs] == [s[0] for s in jsplit.specs]
    assert ("c1/child/scale", 256) in [(s.path, s.offset) for s in tspecs]
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))


# -- the lowering door --------------------------------------------------------


@dataclass(frozen=True)
class Slab(tgraph.Node):
    """A third-party leaf: ``y - h`` up to the height ``h``, ``x / 2``
    above it (a select on ``y <= h``, as ``jnp.where`` takes it)."""

    height: float = 0.25


def _slab_sdf(node):
    def evaluate(params, x, y, z):
        return torch.where(y <= params["height"], y - params["height"],
                           x * 0.5)

    return evaluate


def _slab_lower(node, b, prefix, x, y, z):
    h = b.param(codegen.param_path(prefix, "height"))
    return b.sel_le(y, h, b.sub(y, h), b.mul(x, b.const(0.5)))


@dataclass(frozen=True)
class Bare(tgraph.Node):
    """A third-party leaf registered without a lowering."""

    radius: float = 0.5


@pytest.fixture
def third_party_nodes():
    """Slab (with a lowering) and Bare (without), registered for the test
    and taken out of the registries after it."""
    tgraph.register_custom_node(
        Slab, _slab_sdf,
        lambda node, dtype, device="cpu": {
            "height": torch.tensor(node.height, dtype=dtype, device=device)})
    codegen.register_lowering(Slab, _slab_lower)
    tgraph.register_custom_node(
        Bare, lambda node: lambda params, x, y, z: x - params["radius"],
        lambda node, dtype, device="cpu": {
            "radius": torch.tensor(node.radius, dtype=dtype, device=device)})
    yield
    for cls in (Slab, Bare):
        tgraph._CUSTOM_NODES.pop(cls)
    codegen._LOWERINGS.pop(Slab)


@pytest.mark.usefixtures("third_party_nodes")
def test_custom_node_lowering_and_sel_le_nan_rule():
    """A registered node with a lowering runs through SdfProgram, bit for
    bit with its torch SDF; ``sel_le`` takes the false branch where the
    compare is NaN, like ``jnp.where(a <= b, ·, ·)`` (and unlike
    ``sel_gt(a, b, f, t)``), and its adjoint sends the cotangent to the
    chosen branch only."""
    node = Slab()
    program = SdfProgram(node)
    assert any(op[0] == "sel_le" for op in program.ops)
    assert "<=" in program.cuda_source()
    flat, _, _ = split_params_padded(tgraph.init_params(node, torch.float64),
                                     torch.float64)
    x = np.array([0.3, 0.3, 0.3, np.nan])
    y = np.array([0.0, 0.4, np.nan, 0.0])
    z = np.zeros(4)
    pts = [torch.as_tensor(c) for c in (x, y, z)]
    got = program.evaluate(flat, *pts)
    assert torch.equal(got, program.sdf_c(program.rebuild(flat), *pts))
    want = jnp.where(jnp.asarray(y) <= 0.25, jnp.asarray(y) - 0.25,
                     jnp.asarray(x) * 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2] == 0.15  # NaN compare: the false branch, x / 2
    _, gx, gy, _, _ = program.evaluate_vjp(flat, *pts, torch.ones(4,
                                           dtype=torch.float64))
    np.testing.assert_array_equal(gx.numpy()[:3], [0.0, 0.5, 0.5])
    np.testing.assert_array_equal(gy.numpy()[:3], [1.0, 0.0, 0.0])


@pytest.mark.usefixtures("third_party_nodes")
def test_custom_node_without_lowering_raises():
    node = tgraph.Union(children=(tgraph.Sphere(radius=0.5), Bare()))
    with pytest.raises(NotImplementedError,
                       match="Bare: a custom node without a kernel lowering"):
        SdfProgram(node)
    # ... while the modular Renderer without use_pallas runs it.
    r = Renderer(node, RenderConfig(**_cfg(8, 8, 4)), dtype=torch.float64,
                 device="cpu")
    assert torch.isfinite(r.render(r.init_params, Q, T, mode=0,
                                   degree=2)).all()


# -- the renderers ------------------------------------------------------------


def _agree(got, want):
    return float(np.isclose(got, want, rtol=1e-9, atol=1e-11).mean())


def _leaves(tree):
    return {k: _leaves(v) if isinstance(v, dict)
            else v.clone().requires_grad_(True) for k, v in tree.items()}


def test_fast_renderer_and_scale_gradient_match_jax():
    """FastRenderer (the kernels' plain versions) against the JAX
    FastRenderer's XLA march, f64 48×32, 24 steps, mode 0: the frame by the
    JAX package's agree criterion, and d mean(frame) / d scale.

    The gradient's tolerance, 1e-9 relative: a pixel whose ray took another
    path in the two packages could move the mean's gradient arbitrarily, so
    the share of disagreeing pixels is asserted to be 0 first; what remains
    is rounding. JAX runs without jit here, one IEEE operation at a time as
    the port does (compiled, XLA may fuse multiplies and adds, which this
    chaotic gradient magnifies); the two backwards still sum in other
    orders (the port's adjoint per step, JAX's autodiff of the unrolled
    march), and
    along a ray near the fractal the march's derivative grows with every
    step (the estimate's slope along the ray exceeds 1 there): the mean of
    values in [0, 1] has a gradient of -1.05e4, so single pixels move 1e7
    times faster than the scale, and their rounding with them. The measured
    gap is 2.5e-15."""
    kw = _cfg(48, 32, 24)
    jr = JaxFastRenderer(jreg.make_scene("mandelbulb"), JaxRenderConfig(**kw),
                         dtype=jnp.float64, grid_dtype=np.float64,
                         march_impl="xla")
    tr = FastRenderer(treg.make_scene("mandelbulb"), RenderConfig(**kw),
                      dtype=torch.float64, grid_dtype=np.float64,
                      device="cpu")
    with jax.disable_jit():
        want, vjp = jax.vjp(lambda p: jr.render(
            p, jnp.asarray(Q), jnp.asarray(T), mode=0, degree=2),
            jr.init_params)
        (g_want,) = vjp(jnp.full(want.shape, 1.0 / want.size))
    want = np.asarray(want)
    params = _leaves(tr.init_params)
    got = tr.render(params, Q, T, mode=0, degree=2)
    got.mean().backward()
    got = got.detach().numpy()
    assert np.isfinite(got).all()
    # JAX's criterion is more than 0.98; here no pixel disagrees.
    assert _agree(got, want) == 1.0
    g_scale = float(params["c1"]["child"]["scale"].grad)
    assert g_scale == pytest.approx(float(g_want["c1"]["child"]["scale"]),
                                    rel=1e-9)


def test_modular_renderer_matches_jax():
    kw = _cfg(48, 32, 24)
    jr = JaxRenderer(jreg.make_scene("mandelbulb"), JaxRenderConfig(**kw),
                     dtype=jnp.float64)
    want = np.asarray(jr.render(jr.init_params, jnp.asarray(Q),
                                jnp.asarray(T), mode=0, degree=2))
    for use_pallas in (False, True):
        tr = Renderer(treg.make_scene("mandelbulb"),
                      RenderConfig(**kw, use_pallas=use_pallas),
                      dtype=torch.float64, device="cpu")
        got = tr.render(tr.init_params, Q, T, mode=0, degree=2).numpy()
        assert np.isfinite(got).all()
        assert _agree(got, want) > 0.98, use_pallas


@pytest.mark.slow
def test_f32_scale_gradient_at_64_steps_is_unusable_in_both():
    """At tau = 0 the march's derivative grows with every step a ray takes
    near the fractal (the estimate's slope along the ray exceeds 1), so at
    64 steps a few rays' cotangents dominate the scale gradient of a
    frame's MSE, and its value depends on the order of the operations. At
    24×16 the f64 gradients of both packages exceed 1e20 (and lie orders of
    magnitude apart: about 2.6e35 in JAX, 2.4e29 here), and the f32 ones
    are unusable in both: the port's plain version overflows to a
    non-finite value, JAX's is non-finite or beyond 1e20 too (about 3.1e36
    eagerly, 3.7e30 under jit). So the bulb trains at fewer steps
    (chip_smoke.py marches 24, the JAX test's count). Slow: the JAX side
    compiles its gradients for about a minute."""
    kw = _cfg(24, 16, 64)
    grads = {}
    for name, jdtype, tdtype, npdtype in (
            ("f32", jnp.float32, torch.float32, np.float32),
            ("f64", jnp.float64, torch.float64, np.float64)):
        jr = JaxFastRenderer(jreg.make_scene("mandelbulb"),
                             JaxRenderConfig(**kw), dtype=jdtype,
                             grid_dtype=npdtype, march_impl="xla")
        tr = FastRenderer(treg.make_scene("mandelbulb"), RenderConfig(**kw),
                          dtype=tdtype, device="cpu")
        q, t = jnp.asarray(Q, jdtype), jnp.asarray(T, jdtype)
        target = jr.render(jr.init_params, q, t, mode=0, degree=2)
        start = jax.tree_util.tree_map(lambda a: a, jr.init_params)
        start["c1"]["child"]["scale"] = jnp.asarray(0.85, jdtype)
        g_jax = jax.grad(lambda p: jnp.mean(
            (jr.render(p, q, t, mode=0, degree=2) - target) ** 2))(start)
        params = _leaves(tgraph.params_from_jax(
            jax.tree_util.tree_map(np.asarray, start), tdtype))
        torch.mean((tr.render(params, Q, T, mode=0, degree=2)
                    - torch.as_tensor(np.asarray(target))) ** 2).backward()
        grads[name] = (float(g_jax["c1"]["child"]["scale"]),
                       float(params["c1"]["child"]["scale"].grad))
    assert all(abs(v) > 1e20 for v in grads["f64"]), grads
    jax32, port32 = grads["f32"]
    assert not np.isfinite(port32), grads
    assert not np.isfinite(jax32) or abs(jax32) > 1e20, grads


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_bulb_kernels_match_plain(cuda, dtype):
    """The forward, march and backward kernels on the bulb against their
    plain versions at 64×40, 64 steps, tau = 1e-4: the forward's 8 planes
    and the march's 4 bit for bit (as chip_smoke.py finds at 1440×900), the
    recompute bitwise equal to the history, and the backward with the
    history ray by ray and leaf by leaf, as chip_smoke.py holds it: a few
    grazing rays' cotangents grow with every step near the fractal, so a
    limit relative to the frame's largest entry would hold only those rays.
    Each converged ray's 6 cotangents lie within 1e-4 (f32) or 1e-10 (f64)
    of the ray's own largest, on at least 0.99 of them, and each scalar
    leaf's cotangent, summed over the rays within 1e3 times the median
    ray's cotangent, within the same of its own size. A kernel given every
    cotangent moved by up to 1e-3 of itself fails these limits."""
    r = FastRenderer(treg.make_scene("mandelbulb"),
                     RenderConfig(**_cfg(64, 40, 64, tau=1e-4)), dtype=dtype,
                     grid_dtype=np.float64 if dtype == torch.float64
                     else np.float32, device=cuda)
    program = r.program
    q, t = r._pose(Q, T)
    rays = torch.stack(list(sum(r._pose_planes(q, t), ())) + [r._valid], 0)
    flat, _, _ = split_params_padded(r.init_params, dtype, cuda)
    before = (rk.LAUNCHES, mk.LAUNCHES, bk.LAUNCHES)
    got = rk.fused_march_normals(program, flat, rays, 64, 1e-4, 5e-2)
    march = mk.march_planes(program, flat, rays, 64, 1e-4)
    want = rk.reference_march_normals(program, flat, rays, 64, 1e-4, 5e-2)
    want_march = mk.reference_march(program, flat, rays, 64, 1e-4)
    assert torch.equal(got, want) and torch.equal(march, want_march)
    out, ex = rk.march_forward(program, flat, rays, 64, 1e-4, 5e-2,
                               log_hist=True)
    conv = (rays[6] > 0.5) & (out[3].abs() < 1e-3)
    rng = np.random.default_rng(5)
    g = torch.as_tensor(rng.normal(size=(8,) + tuple(rays.shape[1:])),
                        dtype=dtype, device=cuda)
    g_moved = g * torch.as_tensor(1.0 + 1e-3 * rng.uniform(
        -1.0, 1.0, tuple(g.shape)), dtype=dtype, device=cuda)

    def kernel(rays_, cot, hist=True):
        kw = dict(hist=ex["hist"], nlive=ex["nlive"]) if hist else {}
        return bk.fused_backward(program, flat, rays_, cot, 64, 1e-4, 5e-2,
                                 **kw)

    a, b = kernel(rays, g), kernel(rays, g, hist=False)
    plain = bk.reference_backward(program, flat, rays, g, 64, 1e-4, 5e-2)
    torch.cuda.synchronize()
    assert (rk.LAUNCHES, mk.LAUNCHES, bk.LAUNCHES) == (
        before[0] + 2, before[1] + 1, before[2] + 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    tiny = torch.finfo(dtype).tiny
    size = plain[2][:6].abs().amax(0)
    tame_rays = rays.clone()
    tame_rays[6] = ((rays[6] > 0.5)
                    & (size <= 1e3 * size[conv].median())).to(dtype)
    leaves = program.scalar_offsets
    plain_leaves = bk.reference_backward(program, flat, tame_rays, g, 64,
                                         1e-4, 5e-2)[0][leaves]

    def readings(cot):
        """(share of converged rays within rtol, largest leaf difference
        over its own size)."""
        ray = kernel(rays, cot)[2][:6]
        per_ray = ((ray - plain[2][:6]).abs().amax(0)
                   / size.clamp_min(tiny))[conv]
        got_leaves = kernel(tame_rays, cot, hist=False)[0][leaves]
        per_leaf = ((got_leaves - plain_leaves).abs()
                    / plain_leaves.abs().clamp_min(tiny))
        return (float((per_ray <= rtol).double().mean()),
                float(per_leaf.max()))

    share, leaf = readings(g)
    assert share >= 0.99 and leaf <= rtol, (share, leaf)
    share, leaf = readings(g_moved)
    assert share < 0.99 or leaf > rtol, (share, leaf)
