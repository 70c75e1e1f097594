"""The port's neural SDF scenes against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages. Tolerances:
parameters, ``sin_fast`` and the flat parameter layout bit for bit (the same
numpy draws, the same IEEE op sequence, JAX run eagerly: under ``jax.jit``
XLA contracts ``sin_fast``'s multiply-adds into FMAs); the evaluators in
f64 to rtol 1e-12 (``torch.matmul`` and XLA's dot sum in different orders);
renders in f64 to rtol 1e-9 on converged pixels, as tests/test_torch_fast.py
holds the analytic scenes. The JAX side's interpret-mode Pallas kernel is
run eagerly (under an outer ``jax.jit`` it compiles for minutes); at width
256 the JAX side is its XLA march.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.io.checkpoint import load_pytree as j_load_pytree
from ray_marching_tpu.ops.pallas_march import split_params_padded as j_split
from ray_marching_tpu.render import fast as jfast
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import neural as jneural
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu.scene import serialize as jser
from ray_marching_tpu_torch.cli import main as cli_main
from ray_marching_tpu_torch.io.checkpoint import load_pytree
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import (
    mat_specs,
    pack_mats,
    split_params_padded,
)
from ray_marching_tpu_torch.render import fast as tfast
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.scene import codegen
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import neural as tneural
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene import serialize as tser
from ray_marching_tpu_torch.scene.codegen import SdfProgram

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = REPO / "docs" / "neural_fit_w256" / "weights.npz"
SCENE_FILE = REPO / "docs" / "examples" / "neural_demo.json"
NEURAL_CUH = REPO / "ray_marching_tpu_torch" / "ops" / "csrc" / "neural.cuh"
ACTS = ("sine", "sine_fast", "softplus", "tanh")
PX = 3.45e-6
#: View 0 of tools/train_neural_demo.py's poses (the demo's own camera).
DEMO_Q, DEMO_T = [[0.0, 0.0, 1.0, 0.0]], [[0.0, 0.2, 2.2]]
#: Neural frame vs the analytic target it was distilled to (64×64, f32,
#: 24 steps, mode 0): at least this share of the pixels agrees on hitting
#: the object, and the frames differ by at most this mean. chip_smoke.py
#: checks the same thresholds at 512×512; a transposed hidden matrix fails
#: both (tested below).
TARGET_MIN_AGREE = 0.99
TARGET_MAX_MEAN_DIFF = 0.02
#: An object hit: the ray ended within this distance of the origin (the
#: room's walls are 4.9 away).
OBJECT_RADIUS = 1.5


def _w256(mod):
    """The docs/neural_fit_w256 scene (tools/train_neural_demo.py:113-117
    with --hidden 256 --impl matmul --activation sine_fast)."""
    return mod.Union(children=(
        mod.Onion(child=mod.Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
        _neural_mod(mod).NeuralSDF(hidden=(256, 256), seed=11, scale=0.5,
                                   w0=8.0, impl="matmul",
                                   activation="sine_fast")))


def _neural_mod(mod):
    return jneural if mod is jgraph else tneural


def _cfg(w, h, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, **kw)


def _points(seed, n=4096, scale=1.0):
    return np.random.default_rng(seed).normal(size=(3, n)) * scale


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and width-256 matrix products on every core of every
    worker make them fight (a 1.5 s test took 130 s that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- parameters, sin_fast, the evaluators ------------------------------------


@pytest.mark.parametrize("hidden", [(16, 16), (256, 256)])
@pytest.mark.parametrize("act", ["sine", "tanh", "softplus"])
def test_init_neural_params_bitwise(act, hidden):
    kw = dict(hidden=hidden, activation=act, seed=5, w0=6.0, scale=0.4)
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        want = jneural.init_neural_params(jneural.NeuralSDF(**kw), jd)
        got = tneural.init_neural_params(tneural.NeuralSDF(**kw), td)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == td
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sin_fast_bitwise(dtype):
    """Forward bit for bit over |x| <= 300 and at multiples and half-way
    multiples of 2π (rounding half to even); the backward against JAX's
    custom JVP, bit for bit."""
    k = np.arange(-47, 48)
    x = np.concatenate([np.random.default_rng(2).uniform(-300, 300, 20000),
                        (k + 0.5) * 2 * np.pi, k * 2 * np.pi, [0.0, -0.0]])
    x = x.astype(dtype)
    want = np.asarray(jneural.sin_fast(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tneural.sin_fast(torch.as_tensor(x)).numpy(), want)
    _, jvp = jax.jvp(jneural.sin_fast, (jnp.asarray(x),),
                     (jnp.ones_like(jnp.asarray(x)),))
    tx = torch.as_tensor(x).requires_grad_(True)
    tneural.sin_fast(tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jvp))


@pytest.mark.parametrize("hidden", [(4,), (16, 16), (256, 256)])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("impl", ["matmul", "componentwise"])
def test_evaluators_match_jax(impl, act, hidden):
    """f64, rtol 1e-12, on 4096 points (512 for the componentwise
    evaluator, whose cost is one tensor op per weight). The JAX
    componentwise evaluator gets its parameters as numpy arrays (the same
    values): indexing a numpy matrix is no JAX op, which makes the eager
    width-256 run take seconds instead of tens of seconds."""
    kw = dict(hidden=hidden, activation=act, seed=9, impl=impl)
    jnode, tnode = jneural.NeuralSDF(**kw), tneural.NeuralSDF(**kw)
    rng = np.random.default_rng(10)
    jp = jneural.init_neural_params(jnode, jnp.float64)
    # Non-zero biases and a larger last layer, so every term matters.
    jp = {k: (v + rng.normal(size=v.shape) * 0.1 if k[0] == "b" else v)
          for k, v in jp.items()}
    tp = tgraph.params_from_jax(_np_tree(jp), torch.float64)
    pts = _points(11)
    if impl == "componentwise":
        jp, pts = _np_tree(jp), pts[:, :512]
    want = np.asarray(jneural.neural_sdf(jnode)(
        jp, *(jnp.asarray(c) for c in pts)))
    got = tneural.neural_sdf(tnode)(tp, *(torch.as_tensor(c) for c in pts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_evaluator_bf16_operands_f32():
    """matmul_dtype='bfloat16' in f32 with the trained w256 weights: both
    packages round the operands to bf16 the same way; the f32 sums run in
    another order, and where that moves a hidden value across a bf16
    rounding boundary the operand differs by one bf16 ulp. Tolerance 1e-4
    absolute on distances of order 1. The bf16 field itself stays within
    1e-2 of the f32 one."""
    kw = dict(hidden=(256, 256), seed=11, scale=0.5, w0=8.0, impl="matmul",
              activation="sine_fast")
    params = _w256_params(torch.float32)["c1"]
    pts = _points(12).astype(np.float32)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    got = tneural.neural_sdf(tneural.NeuralSDF(matmul_dtype="bfloat16", **kw))(
        params, *(torch.as_tensor(c) for c in pts))
    jnode = jneural.NeuralSDF(matmul_dtype="bfloat16", **kw)
    want = jneural.neural_sdf(jnode)(jp, *(jnp.asarray(c) for c in pts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    full = tneural.neural_sdf(tneural.NeuralSDF(**kw))(
        params, *(torch.as_tensor(c) for c in pts))
    assert float((got - full).abs().max()) < 1e-2


def test_resolve_impl_and_march_impl_predicates():
    nodes = [jreg.make_scene("neural_demo"), _w256(jgraph),
             jreg.make_scene("test_scene2")]
    for hidden in [(4,), (7, 7), (8,), (16, 16), (64, 256)]:
        for impl in ("auto", "matmul", "componentwise"):
            for act in ("sine", "tanh"):
                kw = dict(hidden=hidden, impl=impl, activation=act)
                assert (tneural.resolve_impl(tneural.NeuralSDF(**kw))
                        == jneural.resolve_impl(jneural.NeuralSDF(**kw)))
                nodes.append(jgraph.Affine(child=jneural.NeuralSDF(**kw),
                                           orientation=(1.0, 0.0, 0.0, 0.0),
                                           translation=(0.0, 0.0, 0.0)))
    for jnode in nodes:
        tnode = tser.node_from_dict(jser.node_to_dict(jnode))
        for fn in ("scene_contains_matmul_neural", "max_matmul_neural_width",
                   "scene_has_exact_sine"):
            assert getattr(tfast, fn)(tnode) == getattr(jfast, fn)(jnode), fn
    cfg = RenderConfig(**_cfg(8, 4, marching_steps=2))
    with pytest.raises(ValueError, match="march_impl must be auto|fused|xla"):
        tfast.FastRenderer(treg.make_scene("neural_demo"), cfg, device="cpu",
                           march_impl="pallas")
    for impl, want in (("auto", "fused"), ("fused", "fused"), ("xla", "xla")):
        r = tfast.FastRenderer(treg.make_scene("neural_demo"), cfg,
                               device="cpu", march_impl=impl)
        assert r.march_impl == want


# -- the kernels' inputs and the code generator ------------------------------


def _w256_params(dtype):
    template = tgraph.init_params(_w256(tgraph), dtype)
    return load_pytree(WEIGHTS, template)


@pytest.mark.parametrize("scene", ["neural_demo", "w256"])
def test_split_params_padded_matches_jax(scene):
    if scene == "w256":
        jparams = j_load_pytree(WEIGHTS, jgraph.init_params(_w256(jgraph),
                                                           jnp.float32))
        tparams = _w256_params(torch.float32)
    else:
        jparams = jgraph.init_params(jreg.make_scene(scene), jnp.float32)
        tparams = tgraph.init_params(treg.make_scene(scene), torch.float32)
    jflat, jmats, _ = j_split(jparams, jnp.float32)
    tflat, tmats, specs = split_params_padded(tparams, torch.float32)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    assert len(tmats) == len(jmats) == 3
    for t, j in zip(tmats, jmats):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # The packed buffer holds each matrix row-major at its spec's offset.
    packed = pack_mats(tmats)
    for spec, m in zip(mat_specs(tparams), tmats):
        assert spec.offset % 128 == 0
        np.testing.assert_array_equal(
            packed[spec.offset:spec.offset + spec.size].numpy(),
            m.reshape(-1).numpy())
    assert all(s.path.rsplit("/", 1)[-1][0] != "w" for s in specs)


def _layered_scene():
    """Three hidden layers, componentwise, softplus, behind an Affine."""
    return tgraph.Union(children=(
        tgraph.Sphere(radius=0.3),
        tgraph.Affine(child=tneural.NeuralSDF(hidden=(6, 5, 4),
                                              activation="softplus",
                                              impl="componentwise", seed=3),
                      orientation=(0.9, 0.1, -0.3, 0.2),
                      translation=(0.2, -0.1, 0.3)),
        tneural.NeuralSDF(hidden=(4,), activation="tanh", seed=4,
                          impl="matmul", matmul_dtype="bfloat16"),
    ))


NEURAL_SCENES = {
    "neural_demo": lambda: treg.make_scene("neural_demo"),
    "w256": lambda: _w256(tgraph),
    "layered": _layered_scene,
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(NEURAL_SCENES))
def test_codegen_evaluate_equals_compile_node(name, dtype):
    """The ``mlp`` op runs the port's neural evaluator, so the op list
    equals the plain SDF bit for bit, NaN inputs included."""
    node = NEURAL_SCENES[name]()
    program = SdfProgram(node)
    _, sdf, params = tgraph.compile_scene(node, dtype)
    flat, mats, _ = split_params_padded(params, dtype)
    p = torch.as_tensor(_points(13, n=1024, scale=1.5), dtype=dtype)
    p[:, :8] = float("nan")
    want = sdf(params, *p)
    got = program.evaluate(flat, *p, mats=mats)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])
    assert torch.equal(program.sdf_c(program.rebuild(flat, mats), *p)[ok],
                       want[ok])


def test_codegen_neural_source_and_no_adjoint():
    """The neural leaves' forward and VJP sources, and an op kind without an
    adjoint rule raising."""
    program = SdfProgram(_layered_scene())
    src = program.cuda_source()
    assert '#include "neural.cuh"' in src
    assert src.count("__device__ __noinline__ T neural_leaf_keep_") == 2
    assert src.count("__device__ __noinline__ T neural_leaf_") == 4
    assert src.count("__device__ __noinline__ RmVec3<T> neural_leaf_vjp_") == 2
    for k in (0, 1):
        assert f"neural_leaf_{k}<T>(P, M, " in src
        assert f"neural_leaf_keep_{k}<T>(P, M, " in src
        assert f"neural_leaf_vjp_{k}<T>(P, M, " in src
    assert "rm_mlp_layer<T, 3, 6, RM_ACT_SOFTPLUS, false, false, false>" in src
    assert "rm_mlp_layer<T, 6, 5, RM_ACT_SOFTPLUS, false, false, false>" in src
    assert "rm_mlp_last<T, 5, 4, RM_ACT_SOFTPLUS, false, false, false>" in src
    assert "rm_mlp_last<T, 3, 4, RM_ACT_TANH, true, true, false>" in src
    # The VJP's forward keeps every hidden layer (2 × (6 + 5 + 4) and
    # 2 × 4 values) and the VJP walks them back without recomputing.
    assert "T keep0[30];" in src and "T keep1[8];" in src
    for nin, nout in ((3, 6), (6, 5), (5, 4)):
        assert (f"rm_mlp_layer_keep<T, {nin}, {nout}, RM_ACT_SOFTPLUS, "
                "false, false, false>") in src
        assert f"rm_mlp_vjp_dense<T, {nin}, {nout}, false>" in src
    assert "rm_mlp_layer_keep<T, 3, 4, RM_ACT_TANH, true, true, false>" in src
    assert "rm_mlp_out<T, 4, false, false>" in src
    assert "rm_mlp_out<T, 4, true, true>" in src
    assert "rm_mlp_delta_out<T, 4, false, false>" in src
    assert "rm_mlp_delta_out<T, 4, true, false>" in src
    assert "rm_mlp_vjp_dense<T, 3, 4, true>" in src
    vjp_body = src[src.index("T scene_sdf_vjp("):]
    assert "neural_leaf_0<T>" not in vjp_body
    for k in (0, 1):
        start = src.index(f"RmVec3<T> neural_leaf_vjp_{k}(")
        body = src[start:src.index("\n}\n", start)]
        assert "rm_mlp_layer" not in body and "rm_mlp_last" not in body
    assert "const RmSink<T>& sink) {" in src
    assert program.n_mats == 6
    # The leaves' biases go to the sink, the radii through the scalar path.
    radii = {program._compact[leaf.radius] for leaf in program.mlps}
    biases = {program._compact[b] + j for leaf in program.mlps
              for b, n in zip(leaf.bias, leaf.sizes[1:]) for j in range(n)}
    assert radii <= set(program.acc_scalars)
    assert not biases & set(program.acc_scalars)
    analytic = SdfProgram(treg.make_scene("test_scene2"))
    assert analytic.acc_scalars == list(range(len(analytic.scalar_offsets)))
    assert "RmSink" not in analytic.cuda_source()
    assert "neural.cuh" in rk.KERNEL_SOURCES
    # An op kind without an adjoint rule raises instead of falling through
    # to the select rule.
    b = codegen._Builder({})
    b._push(("rint", 0), True)
    with pytest.raises(ValueError, match="no adjoint rule for op kind"):
        codegen._append_adjoint(b, 3)


def test_neural_cuh_constants_match_scene_neural():
    text = NEURAL_CUH.read_text()
    consts = {m[0]: float.fromhex(m[1]) for m in re.findall(
        r"#define (RM_\w+) (-?0x[0-9a-f.]+p[-+]\d+)", text)}
    assert consts.pop("RM_INV_TWO_PI") == 1.0 / tneural._TWO_PI
    assert consts.pop("RM_TWO_PI_HI") == tneural._TWO_PI_HI
    assert consts.pop("RM_TWO_PI_LO") == tneural._TWO_PI_LO
    assert consts == {f"RM_SIN_C{i}": c
                      for i, c in enumerate(tneural._SIN_COEFFS)}


def test_op_counts_w256():
    """The hand count of the main configuration's SDF evaluation: the MLP
    3-256-256-1 (2·nin·nout per layer), 256 scale multiplies, 512 sin_fast
    of 18 ops (10 mul, 7 add, one rounding), the skip term (3 mul, 4 add, 1
    sqrt), the onioned box room and the union's select."""
    program = SdfProgram(_w256(tgraph))
    want = SdfProgram(_w256(tgraph).children[0]).op_counts()
    mlp = 3 * 256 + 256 * 256 + 256
    for k, v in {"add": mlp + 7 * 512 + 4, "mul": mlp + 256 + 10 * 512 + 3,
                 "sqrt": 1, "abs_neg": 512, "select": 1}.items():
        want[k] += v
    assert program.op_counts() == want
    assert program.ops_per_eval == 142622
    assert rk.kernel_ops(program, 10, 24) == 10 * (
        29 * 142622 + 24 * rk.OPS_PER_STEP + rk.OPS_TAIL)


# -- renders ------------------------------------------------------------------


def _planes_stable(hit):
    x, y, z, d = (np.asarray(p) for p in hit[:4])
    return (np.abs(d) < 1e-2) & (np.sqrt(x * x + y * y + z * z) < 10)


def test_fast_renderer_matches_jax_fused_interpret():
    """neural_demo (width 16, exact sine), f64 16×12, 6 steps: the port's
    plain version against the JAX fused Pallas kernel in interpret mode,
    all 8 modes on converged pixels."""
    kw = _cfg(16, 12, marching_steps=6)
    q, t = [[0.0, 0.0, 1.0, 0.0]], [[0.0, 0.2, 2.5]]
    jr = jfast.FastRenderer(jreg.make_scene("neural_demo"),
                            JaxRenderConfig(**kw), dtype=jnp.float64,
                            grid_dtype=np.float64, interpret=True,
                            march_impl="fused")
    tr = tfast.FastRenderer(treg.make_scene("neural_demo"), RenderConfig(**kw),
                            dtype=torch.float64, grid_dtype=np.float64,
                            device="cpu")
    jq, jt = jnp.asarray(q), jnp.asarray(t)
    want = jr.render_all_modes(jr.init_params, jq, jt, degree=2)
    got = tr.render_all_modes(tr.init_params, q, t, degree=2)
    origin, dirs = jr._pose_planes(jq, jt)
    hit, _ = jr._march_planes(jr.init_params, origin, dirs, 6)
    mask = np.asarray(jr._assemble([jnp.asarray(_planes_stable(hit))]))
    assert mask.mean() > 0.3  # 6 steps: the room's far walls converge later
    for name, w in want.items():
        m = np.broadcast_to(mask, w.shape)
        np.testing.assert_allclose(got[name].numpy()[m], np.asarray(w)[m],
                                   rtol=1e-9, atol=1e-11, equal_nan=True,
                                   err_msg=name)


@pytest.mark.parametrize("march_impl", ["fused", "xla"])
def test_fast_renderer_w256_matches_jax_xla(march_impl):
    """The trained w256 model with the weights file, f64 24×16, 16 steps, at
    the demo's pose: the port (kernel's plain version, and its 'xla' march)
    against the JAX FastRenderer's XLA march."""
    kw = _cfg(24, 16, marching_steps=16)
    jr = jfast.FastRenderer(_w256(jgraph), JaxRenderConfig(**kw),
                            dtype=jnp.float64, grid_dtype=np.float64,
                            march_impl="xla")
    tr = tfast.FastRenderer(_w256(tgraph), RenderConfig(**kw),
                            dtype=torch.float64, grid_dtype=np.float64,
                            device="cpu", march_impl=march_impl)
    jp = j_load_pytree(WEIGHTS, jr.init_params)
    tp = load_pytree(WEIGHTS, tr.init_params)
    jq, jt = jnp.asarray(DEMO_Q), jnp.asarray(DEMO_T)
    origin, dirs = jr._pose_planes(jq, jt)
    hit, _ = jr._march_planes(jp, origin, dirs, 16)
    mask = np.asarray(jr._assemble([jnp.asarray(_planes_stable(hit))]))
    assert mask.mean() > 0.5
    for mode in (0, 4, 5):
        want = np.asarray(jr.render(jp, jq, jt, mode=mode, degree=2))
        got = tr.render(tp, DEMO_Q, DEMO_T, mode=mode, degree=2).numpy()
        m = np.broadcast_to(mask, want.shape)
        np.testing.assert_allclose(got[m], want[m], rtol=1e-9, atol=1e-11,
                                   err_msg=f"mode {mode}")


def test_renderer_use_pallas_matches_jax():
    """The modular Renderer with the march kernel's plain version against
    the JAX Renderer on neural_demo, f64 16×12, 16 steps, modes 0 and 4."""
    kw = _cfg(16, 12, marching_steps=16)
    q, t = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2, 2.5]])
    jr = JaxRenderer(jreg.make_scene("neural_demo"), JaxRenderConfig(**kw),
                     dtype=jnp.float64, grid_dtype=np.float64)
    tr = Renderer(treg.make_scene("neural_demo"),
                  RenderConfig(**kw, use_pallas=True), dtype=torch.float64,
                  grid_dtype=np.float64, device="cpu")

    @jax.jit
    def jax_frames(params, q, t):
        _, _, ray_pos, ray_dirs = jr.camera.pose(q, t)
        p, _ = jr._march(params, ray_pos, ray_dirs, 16)
        f = jr.sdf_vec(params, p)
        stable = (jnp.abs(f) < 1e-2) & (
            jnp.linalg.norm(p, axis=-1, keepdims=True) < 10.0)
        return [jr.render(params, q, t, mode=m, degree=2)
                for m in (0, 4)], stable

    want, mask = jax_frames(jr.init_params, jnp.asarray(q), jnp.asarray(t))
    mask = np.asarray(mask)
    assert mask.mean() > 0.5
    for mode, w in zip((0, 4), want):
        got = tr.render(tr.init_params, q, t, mode=mode, degree=2).numpy()
        m = np.broadcast_to(mask, got.shape)
        np.testing.assert_allclose(got[m], np.asarray(w)[m], rtol=1e-9,
                                   atol=1e-11, err_msg=f"mode {mode}")


def frame_and_hits(renderer, params, steps):
    """The mode-0 frame at the demo's pose and where its rays hit the
    object (ended within OBJECT_RADIUS of the origin), from one march.
    chip_smoke.py runs the same function."""
    r = renderer
    with torch.no_grad():
        q, t = r._pose(DEMO_Q, DEMO_T)
        origin, dirs = r._pose_planes(q, t)
        hit, final_dirs = r._march_planes(params, origin, dirs, steps)
        norm = torch.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2)
        hits = r._assemble([(norm < OBJECT_RADIUS).to(r.dtype)]) > 0.5
        return r._assemble(r._shade(0, 1, q, origin, final_dirs, hit)), hits


def agreement(got, want):
    """(share of pixels whose object hit agrees, mean absolute difference of
    the frames) of two :func:`frame_and_hits` results."""
    return (float((got[1] == want[1]).to(torch.float64).mean()),
            float((got[0] - want[0]).abs().mean()))


def test_neural_frame_agrees_with_analytic_target():
    """The trained field against the shape it was distilled to, 64×64, f32,
    24 steps (the demo's step count): the thresholds chip_smoke.py holds the
    card's 512×512 frame to. A wrong weight layout (w1 transposed) fails."""
    from ray_marching_tpu_torch.scene.graph import (
        Affine,
        SmoothUnion,
        Sphere,
        Union,
    )

    cfg = RenderConfig(**_cfg(64, 64, marching_steps=24))
    r = tfast.FastRenderer(_w256(tgraph), cfg, device="cpu")
    target_shape = SmoothUnion(children=(
        Affine(child=Sphere(radius=0.45), orientation=(1.0, 0.0, 0.0, 0.0),
               translation=(0.3, 0.1, 0.0)),
        Affine(child=Sphere(radius=0.35), orientation=(1.0, 0.0, 0.0, 0.0),
               translation=(-0.35, -0.1, 0.1)),
    ), blend_k=8.0)
    target = tfast.FastRenderer(
        Union(children=(_w256(tgraph).children[0], target_shape)), cfg,
        device="cpu")
    params = _w256_params(torch.float32)
    want = frame_and_hits(target, target.init_params, 24)
    agree, mean_diff = agreement(frame_and_hits(r, params, 24), want)
    assert agree >= TARGET_MIN_AGREE and mean_diff <= TARGET_MAX_MEAN_DIFF, \
        (agree, mean_diff)
    bad = {"c0": params["c0"],
           "c1": dict(params["c1"], w1=params["c1"]["w1"].T.contiguous())}
    agree_bad, diff_bad = agreement(frame_and_hits(r, bad, 24), want)
    assert agree_bad < TARGET_MIN_AGREE or diff_bad > TARGET_MAX_MEAN_DIFF


def test_checkpoint_restores_the_w256_weights():
    """The npz written by the JAX package's training tool, restored against
    the port's template: matrix leaves included, dtype and device from the
    template, values equal to the JAX package's restore."""
    tp = _w256_params(torch.float64)
    jp = j_load_pytree(WEIGHTS, jgraph.init_params(_w256(jgraph),
                                                   jnp.float64))
    want = jgraph.param_paths(jp)
    got = tgraph.param_paths(tp)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    assert tuple(tp["c1"]["w1"].shape) == (256, 256)


# -- scene files and the CLI --------------------------------------------------


def test_scene_file_round_trips_with_jax(tmp_path):
    want = jser.load_scene(SCENE_FILE)
    got = tser.load_scene(SCENE_FILE)
    assert tser.node_to_dict(got) == jser.node_to_dict(want)
    assert repr(got) == repr(want)
    path = tser.save_scene(tmp_path / "scene.json", _w256(tgraph))
    assert repr(jser.load_scene(path)) == repr(_w256(jgraph))
    path = jser.save_scene(tmp_path / "jax.json", _w256(jgraph))
    assert tser.load_scene(path) == _w256(tgraph)
    bulb = {"type": "Union", "children": [
        {"type": "Sphere", "radius": 0.5},
        {"type": "Mandelbulb", "power": 8, "iterations": 10, "scale": 1.0}]}
    assert repr(tser.node_from_dict(bulb)) == repr(jser.node_from_dict(bulb))
    with pytest.raises(ValueError, match="unknown scene node type"):
        tser.node_from_dict({"type": "Teapot"})


def test_register_custom_node_refuses_name_clashes():
    from dataclasses import dataclass

    @dataclass(frozen=True)
    class Sphere(tgraph.Node):  # noqa: F811 - shadows a built-in on purpose
        radius: float = 1.0

    with pytest.raises(ValueError, match="collides with a built-in node"):
        tgraph.register_custom_node(Sphere, None, None)

    @dataclass(frozen=True)
    class NeuralSDF(tgraph.Node):
        pass

    with pytest.raises(ValueError, match="collides with"):
        tgraph.register_custom_node(NeuralSDF, None, None)
    with pytest.raises(TypeError, match="must subclass Node"):
        tgraph.register_custom_node(int, None, None)
    assert tgraph.custom_node_types()["NeuralSDF"] is tneural.NeuralSDF


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "modular"])
def test_cli_render_scene_file(tmp_path, fast):
    out = tmp_path / "neural.png"
    cli_main(["render", "--device", "cpu", "--scene-file", str(SCENE_FILE),
              "--width", "24", "--height", "16", "--steps", "8", "-o",
              str(out)] + (["--fast"] if fast else ["--pallas"]))
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == 24
    with pytest.raises(SystemExit, match="scene file not found"):
        cli_main(["render", "--device", "cpu", "--scene-file",
                  str(tmp_path / "missing.json"), "-o", str(out)])


def test_cli_render_w256_with_params(tmp_path):
    """``--params`` with matrix leaves: the trained weights file renders the
    w256 scene written to a scene file."""
    scene = tser.save_scene(tmp_path / "w256.json", _w256(tgraph))
    out = tmp_path / "w256.png"
    cli_main(["render", "--device", "cpu", "--fast", "--scene-file",
              str(scene), "--params", str(WEIGHTS), "--pose",
              "0,0,1,0/0,0.2,2.2", "--width", "16", "--height", "12",
              "--steps", "6", "-o", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(SystemExit, match="params checkpoint not found"):
        cli_main(["render", "--device", "cpu", "--scene-file", str(scene),
                  "--params", str(tmp_path / "none.npz"), "-o", str(out)])


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEURAL_SCENES))
def test_cuda_neural_kernels_match_plain(cuda, name):
    """Forward and march kernels with the MLP inside against their plain
    versions, f64 (1e-9), and the march kernel equal to planes 0-3 of the
    forward kernel bit for bit."""
    from ray_marching_tpu_torch.ops import march_kernel as mk

    node = NEURAL_SCENES[name]()
    program = SdfProgram(node)
    params = tgraph.init_params(node, torch.float64, cuda)
    flat, mats, _ = split_params_padded(params, torch.float64)
    rng = np.random.default_rng(14)
    p = rng.uniform(-1.5, 1.5, (3, 8, 128))
    v = rng.normal(size=(3, 8, 128))
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    rays7 = torch.as_tensor(np.concatenate([p, v, np.ones((1, 8, 128))]),
                            dtype=torch.float64, device=cuda)
    got = rk.fused_march_normals(program, flat, rays7, 12, 0.0, 5e-2,
                                 mats=mats)
    want = rk.reference_march_normals(program, flat, rays7, 12, 0.0, 5e-2,
                                      mats=mats)
    march = mk.march_planes(program, flat, rays7, 12, 0.0, mats=mats)
    torch.cuda.synchronize()
    conv = want[3].abs() < 1e-3
    torch.testing.assert_close(got[:, conv], want[:, conv], rtol=0, atol=1e-9)
    assert torch.equal(march, got[:4])
