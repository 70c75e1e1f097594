"""PyTorch port vs the JAX package: scene primitives, ops, graphs, the flat
parameter layout and the kernel code generator (f64, CPU).

Inputs come from a numpy seed and go through both packages. Tolerance:
1e-12 absolute between the packages (both evaluate the same IEEE op
sequence; XLA may round an op differently by an ulp); the code generator's
tensor backend must equal the port's plain SDF bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.ops.pallas_march import split_params_padded as j_split
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import ops as jops
from ray_marching_tpu.scene import primitives as jprim
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.ops.params import split_params_padded as t_split
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import ops as tops
from ray_marching_tpu_torch.scene import primitives as tprim
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-12
SCENES = ("test_scene", "test_scene2", "single_sphere", "composite")


def _points(seed, n=4096, scale=2.0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(3, n)) * scale
    p[:, :8] = 0.0  # the origin: a singular point for several primitives
    return p


def _both(p):
    return [jnp.asarray(c) for c in p], [torch.as_tensor(c) for c in p]


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _all_nodes_scene(mod):
    """One tree holding all 11 built-in node types (the port's and JAX's
    modules expose the same names and fields)."""
    return mod.Union(children=(
        mod.Plane(),
        mod.Affine(child=mod.Disk(radius=0.4),
                   orientation=(0.9, 0.1, -0.3, 0.2),
                   translation=(0.3, -0.2, 0.5)),
        mod.Rounding(child=mod.Box(halfsides=(0.3, 0.2, 0.1)), rounding=0.05),
        mod.SmoothUnion(children=(
            mod.Torus(radius1=0.6, radius2=0.1),
            mod.Line(start=(0.1, 0.2, 0.3), end=(-0.5, 0.4, 1.0), radius=0.1),
            mod.Onion(child=mod.Sphere(radius=0.3), radius=0.05),
        ), blend_k=9.0),
    ))


def _scene(mod, reg, name):
    return _all_nodes_scene(mod) if name == "all_nodes" else reg.make_scene(name)


PRIMITIVE_PARAMS = {
    "sphere": {"radius": 0.7},
    "box": {"halfsides": [0.3, 0.5, 0.2]},
    "plane": {},
    "line": {"start": [0.2, -0.4, 0.1], "end": [-0.6, 0.3, 0.9], "radius": 0.15},
    "disk": {"radius": 0.45},
    "torus": {"radius1": 0.8, "radius2": 0.2},
}


@pytest.mark.parametrize("name", sorted(PRIMITIVE_PARAMS))
def test_primitive_matches_jax(name):
    p = PRIMITIVE_PARAMS[name]
    jp = {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}
    tp = {k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()}
    (jx, jy, jz), (tx, ty, tz) = _both(_points(1))
    _close(getattr(jprim, name)(jp, jx, jy, jz),
           getattr(tprim, name)(tp, tx, ty, tz))


def test_affine_inverse_query_matches_jax():
    q = np.asarray([0.8, 0.2, -0.5, 0.3])
    t = np.asarray([0.1, -0.7, 0.4])
    (jx, jy, jz), (tx, ty, tz) = _both(_points(2))
    for j, tt in zip(
        jops.affine_inverse_query(jnp.asarray(q), jnp.asarray(t), jx, jy, jz),
        tops.affine_inverse_query(torch.as_tensor(q), torch.as_tensor(t),
                                  tx, ty, tz),
    ):
        _close(j, tt)


@pytest.mark.parametrize("op", ["smooth_union", "union", "rounding", "onion"])
def test_combinator_matches_jax(op):
    rng = np.random.default_rng(3)
    ds = [rng.normal(size=4096) for _ in range(3)]
    ds[1][:16] = ds[0][:16]  # ties: the first child wins
    jd = [jnp.asarray(d) for d in ds]
    td = [torch.as_tensor(d) for d in ds]
    if op == "smooth_union":
        j = jops.smooth_union(jnp.asarray(7.5), jd)
        t = tops.smooth_union(torch.tensor(7.5, dtype=torch.float64), td)
    elif op == "union":
        j, t = jops.union(jd), tops.union(td)
    else:
        j = getattr(jops, op)(jnp.asarray(0.2), jd[0])
        t = getattr(tops, op)(torch.tensor(0.2, dtype=torch.float64), td[0])
    _close(j, t)


@pytest.mark.parametrize("name", SCENES + ("all_nodes",))
def test_scene_sdf_matches_jax(name):
    jnode = _scene(jgraph, jreg, name)
    tnode = _scene(tgraph, treg, name)
    _, jsdf, jparams = jgraph.compile_scene(jnode, jnp.float64)
    _, tsdf, tparams = tgraph.compile_scene(tnode, torch.float64)
    (jx, jy, jz), (tx, ty, tz) = _both(_points(4))
    _close(jsdf(jparams, jx, jy, jz), tsdf(tparams, tx, ty, tz))


@pytest.mark.parametrize("name", SCENES + ("all_nodes",))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_codegen_torch_backend_equals_plain_sdf(name, dtype):
    """Backend (b) runs the generated op list; it must equal the plain SDF
    bit for bit, which pins the generated code's offsets, order and selects."""
    node = _scene(tgraph, treg, name)
    program = SdfProgram(node)
    _, sdf, params = tgraph.compile_scene(node, dtype)
    flat, _, _ = t_split(params, dtype)
    p = torch.as_tensor(_points(5), dtype=dtype)
    p[:, 8:16] = float("nan")
    want = sdf(params, *p)
    got = program.evaluate(flat, *p)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])
    # The plain SDF over the rebuilt flat vector is the kernel's plain form.
    assert torch.equal(program.sdf_c(program.rebuild(flat), *p)[ok], want[ok])


@pytest.mark.parametrize("name", SCENES + ("all_nodes",))
def test_codegen_adjoint_equals_autograd(name):
    """The adjoint op list (what scene_sdf_vjp is emitted from) against
    torch.autograd.grad of the primal evaluator, every node kind: position
    cotangents and the per-scalar parameter cotangents summed over the
    points. Both apply the same rule per op, so f64 agrees to rounding
    (1e-12 relative to the largest entry); points include the origin."""
    node = _scene(tgraph, treg, name)
    program = SdfProgram(node)
    flat, _, _ = t_split(tgraph.init_params(node, torch.float64),
                         torch.float64)
    flat = flat.clone().requires_grad_(True)
    pts = _points(8)
    pts[:, :8] = 1e-3  # near the origin, off the sqrt(0) singularities
    p = [torch.as_tensor(c).requires_grad_(True) for c in pts]
    g = torch.as_tensor(np.random.default_rng(9).normal(size=pts.shape[1]))
    d = program.evaluate(flat, *p)
    want = torch.autograd.grad(d, [flat] + p, g, allow_unused=True)
    got_d, gx, gy, gz, gp = program.evaluate_vjp(
        flat.detach(), *[c.detach() for c in p], g)
    assert torch.equal(got_d, d.detach())
    for got, ref in zip((gx, gy, gz), want[1:]):
        ref = torch.zeros_like(got) if ref is None else ref
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    gflat = torch.zeros_like(flat)
    assert len(gp) == len(program.scalar_offsets)
    for off, t in zip(program.scalar_offsets, gp):
        if t is not None:
            gflat[off] = t.sum()
    ref = torch.zeros_like(gflat) if want[0] is None else want[0]
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(gflat.detach(), ref, rtol=0, atol=1e-12 * scale)
    # Every scalar of the layout has a slot; pads of the segments have none.
    assert program.scalar_offsets == [s.offset + j for s in program.specs
                                      for j in range(s.size)]


@pytest.mark.parametrize("kind", ["abs0", "sqrt0", "sel_tie", "max_tie"])
def test_codegen_adjoint_rules_at_ties(kind):
    """The rules where the derivative is a convention: abs has slope 0 at 0,
    sqrt is infinite at 0, a select gives the losing branch exact zeros (a
    tie keeps the first child), and the smooth-union max splits a tie in
    half like torch.maximum. Each against autograd of the plain SDF."""
    if kind == "abs0":
        node, pt = tgraph.Onion(tgraph.Sphere(radius=0.5), radius=0.1), (0.5, 0.0, 0.0)
    elif kind == "sqrt0":
        node, pt = tgraph.Sphere(radius=0.5), (0.0, 0.0, 0.0)
    elif kind == "sel_tie":
        node = tgraph.Union(children=(tgraph.Sphere(radius=0.5),
                                      tgraph.Sphere(radius=0.5)))
        pt = (0.3, 0.4, 1.0)
    else:
        node = tgraph.SmoothUnion(children=(tgraph.Sphere(radius=0.5),
                                            tgraph.Sphere(radius=0.5)),
                                  blend_k=8.0)
        pt = (0.3, 0.4, 1.0)
    program = SdfProgram(node)
    params = tgraph.init_params(node, torch.float64)
    flat, _, _ = t_split(params, torch.float64)
    flat = flat.clone().requires_grad_(True)
    p = [torch.tensor([c], dtype=torch.float64, requires_grad=True) for c in pt]
    g = torch.tensor([1.5], dtype=torch.float64)
    d = program.sdf_c(program.rebuild(flat), *p)
    want = torch.autograd.grad(d, [flat] + p, g)
    _, gx, gy, gz, gp = program.evaluate_vjp(flat.detach(),
                                            *[c.detach() for c in p], g)
    for got, ref in zip((gx, gy, gz), want[1:]):
        torch.testing.assert_close(got, ref, rtol=1e-14, atol=0,
                                   equal_nan=True)
    for off, t in zip(program.scalar_offsets, gp):
        torch.testing.assert_close(t.sum(), want[0][off], rtol=1e-14, atol=0,
                                   equal_nan=True)


def test_codegen_cuda_source_reads_every_param():
    node = _all_nodes_scene(tgraph)
    program = SdfProgram(node)
    src = program.cuda_source()
    assert ("T scene_sdf(const T* __restrict__ P, const T* __restrict__ M, "
            "T x, T y, T z)") in src
    assert src.count("  const T v") == program.n_primal - 3
    for spec in program.specs:
        for i in range(spec.size):
            assert f"P[{spec.offset + i}]" in src, spec
    assert "fminf" not in src and "fmaxf" not in src
    # The adjoint: one statement per op behind the primal ones, and one
    # accumulator per scalar the output depends on.
    assert ("T scene_sdf_vjp(const T* __restrict__ P, const T* __restrict__ "
            "M, T x, T y, T z, T g,") in src
    assert f"constexpr int SCENE_N_SCALARS = {len(program.scalar_offsets)};" in src
    assert src.count("  const T w") == program.n_primal - 3
    assert src.count("  const T a") == len(program.ops) - program.n_primal - 1
    assert src.count("  gP[") == len(program.adj_params) == 24


def test_codegen_op_count_test_scene2():
    """Hand count of test_scene2's ray-dependent ops per SDF evaluation
    (the kernel's bound uses it): onioned box 27, sphere 7, torus 10,
    capsule 24, unions 3 selects."""
    program = SdfProgram(treg.make_scene("test_scene2"))
    assert program.op_counts() == {
        "add": 25, "mul": 19, "div": 1, "sqrt": 5, "exp": 0, "log": 0,
        "abs_neg": 4, "select": 11,
    }
    assert program.ops_per_eval == 65


@pytest.mark.parametrize("name", SCENES + ("all_nodes",))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_params_and_flat_layout_match_jax(name, dtype):
    jparams = jgraph.init_params(_scene(jgraph, jreg, name),
                                 getattr(jnp, dtype))
    tparams = tgraph.init_params(_scene(tgraph, treg, name),
                                 getattr(torch, dtype))
    jp, tp = jgraph.param_paths(jparams), tgraph.param_paths(tparams)
    assert list(jp) == list(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    jflat, mats, _ = j_split(jparams, getattr(jnp, dtype))
    tflat, tmats, specs = t_split(tparams, getattr(torch, dtype))
    assert mats == () and tmats == ()
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    assert SdfProgram(_scene(tgraph, treg, name)).n_flat == tflat.shape[0]
    assert [s.path for s in specs] == list(tp)


def test_params_from_jax_round_trip():
    jparams = jgraph.init_params(jreg.make_scene("test_scene"), jnp.float64)
    rng = np.random.default_rng(6)
    jparams = jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=np.shape(a)), jparams)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = tgraph.params_from_jax(tree, torch.float64)
    jp, tp = jgraph.param_paths(jparams), tgraph.param_paths(tparams)
    assert list(jp) == list(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # Same values → same SDF in both packages.
    _, jsdf, _ = jgraph.compile_scene(jreg.make_scene("test_scene"))
    tsdf = tgraph.compile_node(treg.make_scene("test_scene"))
    (jx, jy, jz), (tx, ty, tz) = _both(_points(7))
    _close(jsdf(jparams, jx, jy, jz), tsdf(tparams, tx, ty, tz))


@pytest.mark.parametrize("name", ["neural_demo", "mandelbulb"])
def test_custom_node_scenes_build_and_lower(name):
    """Both custom-node scenes are ported now: each builds the JAX
    package's tree, and the kernels' code generator lowers it."""
    assert name in treg.available_scenes()
    assert repr(treg.make_scene(name)) == repr(jreg.make_scene(name))
    assert SdfProgram(treg.make_scene(name)).ops_per_eval > 0


def test_unknown_scene_lists_available():
    with pytest.raises(KeyError, match="test_scene2"):
        treg.make_scene("nope")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port (and chip_smoke.py) in a fresh
    interpreter loads no jax and no ray_marching_tpu module."""
    code = (
        "import sys, pkgutil, importlib, runpy\n"
        "import ray_marching_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('ops.march_kernel', 'render.march', 'render.implicit',\n"
        "          'render.pipeline', 'camera', 'quat', 'parallel.sharding',\n"
        "          'parallel.fast_sharding', 'parallel.multihost'):\n"
        "    assert pkg.__name__ + '.' + m in sys.modules, m\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ray_marching_tpu' or m.startswith('ray_marching_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_sources_name_no_jax():
    files = sorted((REPO / "ray_marching_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "ray_marching_tpu"), \
                    f"{f}: {s}"
