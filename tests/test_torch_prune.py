"""The union bounding-sphere short-circuit (``compile_node(prune=True)``,
``SdfProgram(node, prune=True)``) against the JAX package's, and against the
unpruned SDF, on the CPU.

Tolerances: the bounding spheres and the pruned compile within 1e-12 of
JAX's in f64 (the same expressions; XLA may fuse a sum of squares
differently). Against the unpruned SDF the pruned forms are BITWISE equal in
f32 and f64: a skip happens only where ``lb > d`` and ``d_child >= lb``, so
``vmin(d, d_child)`` is ``d`` with no tie. The 48×32 frames hold JAX's
``FastRenderer`` under the same switch at tests/test_torch_fast.py's image
tolerance (rtol 1e-9, atol 1e-11 on stable pixels).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.ops import backward_kernel as bk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import codegen
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram
from ray_marching_tpu_torch.scene.neural import NeuralSDF

PX = 3.45e-6
#: sha256 of test_scene2's generated source before the short-circuit
#: existed (tests/test_torch_neural_tc.py pins the same digest).
SCENE2_SOURCE = \
    "01995bdb88b485bee773c22c8a51a6079fd70d4f52d88e5ee44821a37bdee8c1"


def _nested(g):
    """Every bounded node kind under guards: an Affine over a SmoothUnion
    with a Rounding, and a Union whose second child is a guarded Union of
    three leaves (a guard inside a guard)."""
    return g.Union(children=(
        g.Onion(child=g.Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
        g.Affine(child=g.SmoothUnion(children=(
            g.Sphere(radius=0.5),
            g.Rounding(child=g.Torus(radius1=1.0, radius2=0.2),
                       rounding=0.05)), blend_k=8.0),
            orientation=(0.9238795, 0.0, 0.3826834, 0.0),
            translation=(0.5, 0.3, -0.2)),
        g.Union(children=(
            g.Sphere(radius=0.3),
            g.Union(children=(
                g.Disk(radius=0.4),
                g.Line(start=(0.0, 1.0, 0.0), end=(0.2, -1.0, 0.1),
                       radius=0.1),
                g.Box(halfsides=(0.1, 0.2, 0.3)))))),
    ))


def _contracting(g):
    """JAX tests/test_scene_graph.py:197's scene."""
    return g.Union(children=(
        g.Sphere(radius=4.0),
        g.Affine(child=g.Union(children=(g.Sphere(radius=1.0),
                                         g.Torus(radius1=0.7, radius2=0.2))),
                 orientation=(1.0, 0.0, 0.0, 0.0),
                 translation=(0.0, 0.0, 0.0)),
    ))


def _scenes(g, reg):
    return {"test_scene2": reg.make_scene("test_scene2"),
            "nested": _nested(g), "contracting": _contracting(g)}


def _both(name):
    """(JAX node, port node, JAX f64 params, port f64 params)."""
    jnode = _scenes(jgraph, jreg)[name]
    tnode = _scenes(tgraph, treg)[name]
    jparams = jgraph.init_params(jnode, jnp.float64)
    return jnode, tnode, jparams, tgraph.params_from_jax(
        jax.device_get(jparams), torch.float64)


def _subtrees(node, path=()):
    yield path, node
    child = getattr(node, "child", None)
    if child is not None:
        yield from _subtrees(child, path + ("child",))
    for i, c in enumerate(getattr(node, "children", ())):
        yield from _subtrees(c, path + (f"c{i}",))


def _at(params, path):
    for key in path:
        params = params[key]
    return params


def _points(seed, n=4096, scale=6.0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-scale, scale, n).astype(dtype) for _ in range(3)]


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["test_scene2", "nested", "contracting"])
def test_leaf_counts_and_bounding_spheres_match_jax(name):
    jnode, tnode, jparams, tparams = _both(name)
    pairs = list(zip(_subtrees(jnode), _subtrees(tnode)))
    assert len(pairs) > 3
    for (path, jn), (_, tn) in pairs:
        assert tgraph.subtree_leaf_count(tn) == jgraph.subtree_leaf_count(jn)
        jfn, tfn = jgraph.bounding_sphere_fn(jn), tgraph.bounding_sphere_fn(tn)
        assert (jfn is None) == (tfn is None), path
        if jfn is None:
            continue
        want = [float(v) for v in jfn(_at(jparams, path))]
        got = [float(v) for v in tfn(_at(tparams, path))]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=str(path))


def test_scenes_without_a_guard_in_either_package():
    """The bulb and neural_demo are unbounded (a custom leaf), the open
    test_scene is bounded but holds no Union: no guard in either package."""
    for scene, bounded in (("mandelbulb", False), ("neural_demo", False),
                           ("test_scene", True)):
        jb = jgraph.bounding_sphere_fn(jreg.make_scene(scene))
        tb = tgraph.bounding_sphere_fn(treg.make_scene(scene))
        assert (jb is not None) == (tb is not None) == bounded, scene
        program = SdfProgram(treg.make_scene(scene), prune=True)
        assert not program.pruned


def test_contracting_quaternion_disables_the_bound():
    """A quaternion inside S^3 gives R = inf in both packages (no skip can
    fire, the pruned forms stay the plain one), and a unit one a finite R
    again."""
    jnode, tnode, jparams, tparams = _both("contracting")
    jfn = jgraph.bounding_sphere_fn(jnode.children[1])
    tfn = tgraph.bounding_sphere_fn(tnode.children[1])
    program = SdfProgram(tnode, prune=True)
    assert program.pruned
    x, y, z = (torch.tensor(c) for c in _points(3, 1024, 12.0))
    for q, finite in (([0.6, 0.6, 0.0, 0.0], False),
                      ([1.0, 0.0, 0.0, 0.0], True)):
        jparams["c1"]["orientation"] = jnp.asarray(q, jnp.float64)
        tparams["c1"]["orientation"] = torch.tensor(q, dtype=torch.float64)
        jr, tr = float(jfn(jparams["c1"])[3]), float(tfn(tparams["c1"])[3])
        assert np.isfinite(jr) == finite and np.isfinite(tr) == finite
        flat, _, _ = split_params_padded(tparams, torch.float64)
        assert np.isfinite(float(program.bound_values(flat)[3])) == finite
        plain = program.sdf_c(tparams, x, y, z)
        assert torch.equal(_bits(tgraph.compile_node(tnode, prune=True)(
            tparams, x, y, z)), _bits(plain))
        assert torch.equal(_bits(program.evaluate_fwd(flat, x, y, z)),
                           _bits(plain))


@pytest.mark.parametrize("name", ["test_scene2", "nested"])
def test_bound_prologue_matches_bounding_sphere_fn(name):
    """The kernels' ``scene_bounds`` (the IR of codegen._lower_bound, on
    tensors) against the port's bounding_sphere_fn of each guarded child, in
    slot order, in f64."""
    _, tnode, _, tparams = _both(name)
    program = SdfProgram(tnode, prune=True)
    flat, _, _ = split_params_padded(tparams, torch.float64)
    got = [float(v) for v in program.bound_values(flat)]
    want = []

    def walk(node, params):
        if getattr(node, "child", None) is not None:
            walk(node.child, params["child"])
        if isinstance(node, tgraph.Union):
            for i, fn in enumerate(tgraph.pruned_children(node)):
                if fn is not None:
                    want.extend(float(v) for v in fn(params[f"c{i}"]))
                walk(node.children[i], params[f"c{i}"])
        elif isinstance(node, tgraph.SmoothUnion):
            for i, c in enumerate(node.children):
                walk(c, params[f"c{i}"])

    walk(tnode, tparams)
    assert len(got) == len(want) == 4 * len(program.guard_ops) > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["test_scene2", "nested", "contracting"])
def test_pruned_compile_matches_jax(name):
    jnode, tnode, jparams, tparams = _both(name)
    x, y, z = _points(11)
    want = np.asarray(jgraph.compile_node(jnode, prune=True)(
        jparams, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    got = tgraph.compile_node(tnode, prune=True)(
        tparams, torch.tensor(x), torch.tensor(y), torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def _near_ties(dtype):
    """Points of test_scene2 where ``lb - d`` of its guard is within a few
    ulp of zero: rays from the origin in the torus' plane (where the child's
    distance is |p| - 1.25, the bound's own radius) and elsewhere, each at
    the root of lb = d_room and 64 ulp either side of it."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    node = treg.make_scene("test_scene2")
    params = tgraph.init_params(node, tdt)
    room = tgraph.compile_node(node.children[0])
    bound = tgraph.bounding_sphere_fn(node.children[1])(params["c1"])
    rng = np.random.default_rng(5)
    theta = rng.uniform(0, 2 * np.pi, 96)
    dirs = np.concatenate([
        np.stack([np.cos(theta), 0 * theta, np.sin(theta)], 1),
        rng.standard_normal((96, 3))])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = torch.tensor(dirs, dtype=tdt)

    def gap(s):
        p = dirs * s[:, None]
        x, y, z = p.unbind(1)
        return (tgraph.guard_lower_bound(bound, x, y, z)
                - room(params["c0"], x, y, z))

    lo = torch.full((len(dirs),), 1.3, dtype=tdt)
    hi = torch.full((len(dirs),), 8.0, dtype=tdt)
    for _ in range(80):
        mid = (lo + hi) / 2
        up = gap(mid) > 0
        hi, lo = torch.where(up, mid, hi), torch.where(up, lo, mid)
    s = [hi]
    for _ in range(64):
        s.append(torch.nextafter(s[-1], torch.full_like(hi, np.inf)))
    s.append(hi)
    for _ in range(64):
        s.insert(0, torch.nextafter(s[0], torch.zeros_like(hi)))
    s = torch.stack(s, 1)
    p = dirs[:, None, :] * s[..., None]
    return [c.reshape(-1) for c in p.unbind(-1)], node, params, bound, room


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["test_scene2", "nested", "contracting"])
def test_pruned_sdf_is_the_unpruned_bitwise(name, dtype):
    """compile_node(prune=True) and SdfProgram.evaluate_fwd against the plain
    SDF, bit for bit, at uniform points, at test_scene2's near-tie points
    (where a too-small shrink of lb would show, in f32 first) and at NaN."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    node = _scenes(tgraph, treg)[name]
    params = tgraph.init_params(node, tdt)
    flat, _, _ = split_params_padded(params, tdt)
    program = SdfProgram(node, prune=True)
    assert program.pruned
    pts = [torch.tensor(c) for c in _points(17, dtype=dtype)]
    if name == "test_scene2":
        near, _, tparams, bound, room = _near_ties(dtype)
        x, y, z = near
        g = (tgraph.guard_lower_bound(bound, x, y, z)
             - room(tparams["c0"], x, y, z))
        # The points straddle the root, down to a few ulp of it.
        assert bool((g > 0).any()) and bool((g <= 0).any())
        ulp = torch.finfo(tdt).eps * 8
        assert float(g.abs().min()) <= 4 * ulp
        pts = [torch.cat([a, b]) for a, b in zip(pts, near)]
    pts = [torch.cat([c, torch.tensor([np.nan, 1.0], dtype=tdt)])
           for c in pts]
    want = program.sdf_c(params, *pts)
    for got in (tgraph.compile_node(node, prune=True)(params, *pts),
                program.evaluate_fwd(flat, *pts),
                program.evaluate(flat, *pts)):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("scene", ["mandelbulb", "neural_demo",
                                   "test_scene2", "test_scene"])
def test_source_unchanged_without_a_guard(scene, monkeypatch):
    """Pruning off, or no child that qualifies (the bulb, neural_demo, the
    open test_scene): the generated source is the unpruned one byte for
    byte, so the build hash and the library are the same."""
    monkeypatch.delenv("RM_TPU_CSG_PRUNE", raising=False)
    node = treg.make_scene(scene)
    plain = SdfProgram(node)
    if scene == "test_scene2":
        assert hashlib.sha256(plain.cuda_source().encode()).hexdigest() == \
            SCENE2_SOURCE
        monkeypatch.setenv("RM_TPU_PRUNE_MIN_LEAVES", "4")
    r = FastRenderer(node, RenderConfig(**_cfg(16, 8)), device="cpu")
    assert not r.program.pruned
    pruned = SdfProgram(node, prune=True)
    assert not pruned.pruned
    assert pruned.cuda_source() == plain.cuda_source()
    assert rk.kernel_key(pruned) == rk.kernel_key(plain)


def test_pruned_source_adds_the_forward_form_only():
    """With a guard the source is the unpruned one followed by the bounds
    prologue and scene_sdf_fwd (its own library); the op counts stay the
    unpruned SDF's, and the guard's test and region are counted apart."""
    node = treg.make_scene("test_scene2")
    plain, pruned = SdfProgram(node), SdfProgram(node, prune=True)
    src = pruned.cuda_source()
    assert src.startswith(plain.cuda_source())
    tail = src[len(plain.cuda_source()):]
    assert "#define SCENE_PRUNE 1" in tail and "scene_bounds(" in tail
    assert tail.count("if (!(") == 1 and "__syncwarp" not in tail
    assert rk.kernel_key(pruned) != rk.kernel_key(plain)
    assert pruned.ops_per_eval == plain.ops_per_eval == 65
    assert pruned.vjp_ops_per_eval == plain.vjp_ops_per_eval
    # lb: 3 sub, 3 mul, 2 add, sqrt, the shrink's mul, sub; and its compare.
    # The region: the sphere, torus and capsule, their two vmins and the
    # union's.
    assert pruned.guard_ops == ((12, 44),)


def _tc_scene(g):
    """A tensor-core MLP leaf before a guarded analytic union."""
    return g.Union(children=(
        g.Onion(child=g.Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
        g.Affine(child=NeuralSDF(hidden=(16, 16), seed=3, scale=0.5,
                                 impl="matmul", activation="sine_fast"),
                 orientation=(1.0, 0.0, 0.0, 0.0),
                 translation=(1.5, 0.0, 0.0)),
        g.Union(children=(g.Sphere(radius=0.5),
                          g.Torus(radius1=1.0, radius2=0.25))),
    ))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tensor_core_scene_meets_the_warp_after_the_guard(dtype):
    """A tensor-core leaf beside a guarded union: the region holds no MLP,
    the warp meets at __syncwarp() after it on the tensor-core
    instantiation, and the pruned evaluator is the unpruned one bit for
    bit."""
    node = _tc_scene(tgraph)
    program = SdfProgram(node, prune=True)
    assert program.pruned and list(program.tc) == [0]
    src = program.cuda_source()
    fwd = src[src.index("T scene_sdf_fwd("):]
    region = fwd[fwd.index("if (!("):fwd.index("if constexpr (TC) __syncwarp();")]
    assert "neural_leaf" not in region
    assert fwd.index("neural_leaf_tc_0(") < fwd.index("if (!(")
    params = tgraph.init_params(node, dtype)
    flat, mats, _ = split_params_padded(params, dtype)
    pts = [torch.tensor(c, dtype=dtype) for c in _points(23, 2048)]
    want = program.evaluate(flat, *pts, mats=mats)
    got = program.evaluate_fwd(flat, *pts, mats=mats)
    assert torch.equal(_bits(got), _bits(want))


def test_guarded_region_refuses_an_mlp_op_or_a_loop():
    node = tgraph.Union(children=(
        tgraph.Sphere(radius=1.0),
        tgraph.Union(children=(tgraph.Sphere(radius=0.5),
                               tgraph.Sphere(radius=0.25))),
        NeuralSDF(hidden=(16,), seed=0)))
    program = SdfProgram(node)

    def builder():
        b = codegen._Builder({s.path: s.offset for s in program.specs},
                             {s.path: s.offset for s in program.mat_specs},
                             prune=True)
        return b, b.sqrt(b.add(b.mul(0, 0), b.mul(1, 1)))

    b, d = builder()
    with pytest.raises(ValueError, match="mlp op or a loop"):
        b.guard(node.children[1], "c1", d, 0, 1, 2,
                lambda bb: bb.mlp(node.children[2], "c2", 0, 1, 2))
    b, d = builder()
    with pytest.raises(ValueError, match="mlp op or a loop"):
        b.guard(node.children[1], "c1", d, 0, 1, 2,
                lambda bb: bb.loop(3, (0,), lambda b2, s: (b2.add(s, s),))[0])
    # Only the bounded child with two leaves qualifies.
    assert [b is not None for b in tgraph.pruned_children(node)] == [
        False, True, False]


def _cfg(w, h, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, marching_steps=32,
                **kw)


Q = [[0.0, 0.0, 1.0, 0.0]]
T = [[0.0, 0.2, 2.5]]


def _frame_and_grad(dtype, path):
    """48×32 test_scene2 frame (mode 0) and the gradient of its mean square
    with respect to every scalar parameter, through the backward's
    ``path``."""
    r = FastRenderer(treg.make_scene("test_scene2"), RenderConfig(**_cfg(48, 32)),
                     dtype=dtype, grid_dtype=np.float64, device="cpu")
    frame = r.render(r.init_params, Q, T, mode=0, degree=2)
    flat, _, _ = split_params_padded(r.init_params, dtype)
    flat = flat.clone().requires_grad_(True)
    params = r.program.rebuild(flat)
    kw = {"history": {}, "recompute": {"bwd_hist": False},
          "two_level": {"bwd_two_level": True}}[path]
    old = (rk.BWD_HIST, rk.BWD_TWO_LEVEL)
    rk.BWD_HIST = kw.get("bwd_hist", True)
    rk.BWD_TWO_LEVEL = kw.get("bwd_two_level", False)
    try:
        loss = r.render(params, Q, T, mode=0, degree=2).square().mean()
        loss.backward()
    finally:
        rk.BWD_HIST, rk.BWD_TWO_LEVEL = old
    assert bk.LAST_PATH["two_level"] == (path == "two_level")
    assert bk.LAST_PATH["use_hist"] == (path == "history")
    return r, frame, flat.grad


@pytest.mark.parametrize("dtype,path", [
    (torch.float32, "history"), (torch.float32, "recompute"),
    (torch.float64, "two_level")])
def test_fast_renderer_frame_and_gradient_bitwise(dtype, path, monkeypatch):
    monkeypatch.setenv("RM_TPU_CSG_PRUNE", "0")
    r0, frame0, grad0 = _frame_and_grad(dtype, path)
    monkeypatch.setenv("RM_TPU_CSG_PRUNE", "1")
    r1, frame1, grad1 = _frame_and_grad(dtype, path)
    assert not r0.program.pruned and r1.program.pruned
    assert torch.equal(_bits(frame1), _bits(frame0))
    assert torch.equal(_bits(grad1), _bits(grad0))
    assert bool(torch.isfinite(grad1).all()) and float(grad1.abs().max()) > 0
    xla = FastRenderer(treg.make_scene("test_scene2"),
                       RenderConfig(**_cfg(16, 8)), dtype=dtype,
                       device="cpu", march_impl="xla")
    assert not xla.program.pruned


def test_fast_renderer_matches_jax_under_the_switch(monkeypatch):
    """Both packages' FastRenderer with RM_TPU_CSG_PRUNE=1, f64, 48×32: the
    pruned forward kernels (JAX's interpreted, with its per-tile while) give
    the same frame."""
    monkeypatch.setenv("RM_TPU_CSG_PRUNE", "1")
    jr = JaxFastRenderer(jreg.make_scene("test_scene2"),
                         JaxRenderConfig(**_cfg(48, 32)),
                         dtype=jnp.float64, grid_dtype=np.float64)
    assert jr.sdf_c_kernel is not jr.sdf_c
    r, got, _ = _frame_and_grad(torch.float64, "history")
    assert r.program.pruned
    want = np.asarray(jr.render(jr.init_params, jnp.asarray(Q),
                                jnp.asarray(T), mode=0, degree=2))
    # Stable pixels (tests/test_torch_fast.py's rule) from the port's hit
    # planes: JAX's second march would cost this file another 9 s.
    with torch.no_grad():
        origin, dirs = r._pose_planes(*r._pose(Q, T))
        hit, _ = r._march_planes(r.init_params, origin, dirs,
                                 r.config.marching_steps)
    stable = (hit[3].abs() < 1e-2) & (
        torch.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2) < 10)
    mask = np.broadcast_to(r._assemble([stable]).numpy(), want.shape)
    assert mask.mean() > 0.9
    np.testing.assert_allclose(got.numpy()[mask], want[mask], rtol=1e-9,
                               atol=1e-11)


def test_tiled_renderer_inherits_the_switch(monkeypatch):
    """TiledRenderer builds its strips' FastRenderer, so it takes the
    switch from there: its frame pruned is the unpruned one, bit for bit."""
    from ray_marching_tpu_torch.render.tiled import TiledRenderer

    frames = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("RM_TPU_CSG_PRUNE", flag)
        r = TiledRenderer(treg.make_scene("test_scene2"),
                          RenderConfig(**_cfg(24, 16)), strip_height=8,
                          device="cpu")
        assert r.fast.program.pruned == (flag == "1")
        frames[flag] = r.render(r.fast.init_params, Q, T, mode=0, degree=2)
    assert torch.equal(_bits(frames["1"]), _bits(frames["0"]))
