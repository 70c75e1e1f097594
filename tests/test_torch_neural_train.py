"""Gradients through ``NeuralSDF`` leaves: the port against the JAX package,
f64 on the CPU, inputs from numpy seeds.

- the MLP's VJP written out (``SdfProgram.evaluate_vjp``, the twin of
  ``ops/csrc/neural.cuh``'s ``rm_mlp_vjp_*``) against ``torch.autograd``
  of the plain SDF: rtol 1e-12 (the same formulas, summed in other orders);
- the backward kernel's plain version against the JAX ``fused_backward``
  (its Pallas kernel in interpret mode, run eagerly): rtol 1e-7, atol 1e-10,
  the convention of tests/test_torch_backward_kernel.py;
- ``FastRenderer`` (``unroll``, ``implicit``, ``render_with_alpha``) and the
  modular ``Renderer(use_pallas=True)`` against ``jax.grad`` of the JAX
  renderers, every leaf (matrices, biases, radius, the room): rtol 1e-7,
  atol 1e-9 relative to a leaf's largest entry, on stable pixels, as
  tests/test_torch_train.py holds the analytic scenes;
- one ``optimize`` step on the neural leaf against optax: rtol 1e-6, as
  tests/test_torch_optimize.py;
- the history, the recompute and the two-level backward equal bit for bit.

The kernel itself is held against its plain version by the ``cuda`` test
below (skipped without a card) and by chip_smoke.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.io.checkpoint import load_pytree as j_load_pytree
from ray_marching_tpu.ops.pallas_backward import fused_backward as j_backward
from ray_marching_tpu.ops.pallas_march import split_params_padded as j_split
from ray_marching_tpu.optim.inverse import InverseConfig as JaxInverseConfig
from ray_marching_tpu.optim.inverse import optimize as j_optimize
from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import neural as jneural
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.cli import main as cli_main
from ray_marching_tpu_torch.io.checkpoint import load_pytree
from ray_marching_tpu_torch.ops import backward_kernel as bk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import neural as tneural
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = REPO / "docs" / "neural_fit_w256" / "weights.npz"
SCENE_FILE = REPO / "docs" / "examples" / "neural_demo.json"
PX = 3.45e-6
EPS = 5e-2
#: View 0 of tools/train_neural_demo.py's poses, and a pose that looks at
#: neural_demo's leaf.
DEMO_Q, DEMO_T = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2,
                                                                 2.2]])
ACTS = ("sine", "sine_fast", "softplus", "tanh")


def _w256(mod):
    """The docs/neural_fit_w256 scene (tools/train_neural_demo.py:113-117),
    in either package."""
    neural = jneural if mod is jgraph else tneural
    return mod.Union(children=(
        mod.Onion(child=mod.Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
        neural.NeuralSDF(hidden=(256, 256), seed=11, scale=0.5, w0=8.0,
                         impl="matmul", activation="sine_fast")))


def _layered_scene():
    """Three hidden layers, componentwise, softplus, behind an Affine, and a
    bf16-operand leaf (tests/test_torch_neural.py)."""
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


#: The neural scenes of tests/test_torch_neural.py's card test.
NEURAL_SCENES = {
    "neural_demo": lambda: treg.make_scene("neural_demo"),
    "w256": lambda: _w256(tgraph),
    "layered": _layered_scene,
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_neural.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(w, h, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, **kw)


def _require_grad(tree):
    if isinstance(tree, dict):
        return {k: _require_grad(v) for k, v in tree.items()}
    return tree.clone().requires_grad_(True)


def _stable_pixels(jr, params, q, t, steps):
    """Pixels whose ray converged (|d| < 1e-2) inside |p| < 10."""
    origin, dirs = jr._pose_planes(q, t)
    hit, _ = jr._march_planes(params, origin, dirs, steps)
    hit = [np.asarray(p) for p in hit]
    stable = (np.abs(hit[3]) < 1e-2) & (
        np.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2) < 10)
    return np.asarray(jr._assemble([jnp.asarray(stable)]))


def _assert_grads_close(got, want, label):
    assert set(got) == set(want), label
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].numpy().reshape(w.shape)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=f"{label} {path}")


def _grads(tree):
    return {k: torch.zeros_like(v) if v.grad is None else v.grad
            for k, v in tgraph.param_paths(tree).items()}


# -- the MLP's VJP, written out -----------------------------------------------


def _vjp_scene(width, act, impl):
    """A neural leaf beside a small sphere that it wins the union against
    almost everywhere, so the MLP's cotangents are not masked off. At width
    256 the componentwise leaf has one hidden layer (its evaluator is a loop
    of 65k plane ops per layer, too slow for two here)."""
    hidden = (width,) if (width == 256 and impl == "componentwise") \
        else (width, width)
    return tgraph.Union(children=(
        tgraph.Sphere(radius=0.05),
        tneural.NeuralSDF(hidden=hidden, activation=act, impl=impl, seed=7,
                          w0=6.0)))


@pytest.mark.parametrize("impl", ["matmul", "componentwise"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("width", [16, 256])
def test_evaluate_vjp_matches_autograd(width, act, impl):
    """The adjoint of the ``mlp`` op (matrix and bias cotangents, the
    point's cotangent) and the skip term's scalar rules, f64, against
    ``torch.autograd.grad`` of ``evaluate``; parameters perturbed from
    their init so that no layer's cotangent is tiny."""
    node = _vjp_scene(width, act, impl)
    program = SdfProgram(node)
    rng = np.random.default_rng(width + len(act))
    flat, mats, _ = split_params_padded(tgraph.init_params(node,
                                                           torch.float64),
                                        torch.float64)
    flat = flat + torch.as_tensor(rng.normal(size=flat.shape) * 0.1)
    mats = [m + torch.as_tensor(rng.normal(size=m.shape) * 0.3 / m.shape[0])
            for m in mats]
    leaves = [flat.requires_grad_(True)] + [m.requires_grad_(True)
                                            for m in mats]
    pts = rng.normal(size=(3, 64)) * 0.6
    p = [torch.as_tensor(c).requires_grad_(True) for c in pts]
    g = torch.as_tensor(rng.normal(size=64))
    d = program.evaluate(flat, *p, mats=mats)
    want = torch.autograd.grad(d, leaves + p, g)
    got_d, gx, gy, gz, gp = program.evaluate_vjp(
        flat.detach(), *[c.detach() for c in p], g,
        mats=[m.detach() for m in mats])
    assert torch.equal(got_d, d.detach())
    for got, ref in zip((gx, gy, gz), want[-3:]):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-14)
    n = len(program.scalar_offsets)
    assert len(gp) == n + len(mats)
    gflat = torch.zeros_like(flat)
    for off, t in zip(program.scalar_offsets, gp[:n]):
        if t is not None:
            gflat[off] = t.sum()
    torch.testing.assert_close(gflat, want[0], rtol=1e-12,
                               atol=1e-14 * float(want[0].abs().max()))
    for got, ref in zip(gp[n:], want[1:1 + len(mats)]):
        torch.testing.assert_close(got, ref, rtol=1e-12,
                                   atol=1e-14 * float(ref.abs().max()))
    # The leaf's biases come from the VJP, its radius from the scalar path.
    leaf = program.mlps[0]
    assert gp[program._compact[leaf.bias[0]]] is not None
    assert program._compact[leaf.radius] in program.acc_scalars


def test_evaluate_vjp_bf16_operands_f32():
    """bf16 operands in f32, the port's one rule in both the written-out
    VJP and autograd: the input's cotangent rounded to bf16 (the cast
    differentiated), the matrices' kept as f32 sums. They agree to one bf16
    rounding (2^-8) where the two sum in other orders and an input
    cotangent lands on either side of a rounding boundary."""
    node = tgraph.Union(children=(
        tgraph.Sphere(radius=0.05),
        tneural.NeuralSDF(hidden=(16, 16), activation="tanh", impl="matmul",
                          seed=5, matmul_dtype="bfloat16")))
    program = SdfProgram(node)
    rng = np.random.default_rng(12)
    flat, mats, _ = split_params_padded(tgraph.init_params(node,
                                                           torch.float32),
                                        torch.float32)
    mats = [m + torch.as_tensor(rng.normal(size=m.shape) * 0.3 / m.shape[0],
                                dtype=torch.float32) for m in mats]
    leaves = [flat.requires_grad_(True)] + [m.requires_grad_(True)
                                            for m in mats]
    p = [torch.as_tensor(c, dtype=torch.float32).requires_grad_(True)
         for c in rng.normal(size=(3, 64)) * 0.6]
    g = torch.as_tensor(rng.normal(size=64), dtype=torch.float32)
    want = torch.autograd.grad(program.evaluate(flat, *p, mats=mats),
                               leaves + p, g)
    _, gx, gy, gz, gp = program.evaluate_vjp(
        flat.detach(), *[c.detach() for c in p], g,
        mats=[m.detach() for m in mats])
    n = len(program.scalar_offsets)
    for got, ref in [*zip((gx, gy, gz), want[-3:]),
                     *zip(gp[n:], want[1:1 + len(mats)])]:
        torch.testing.assert_close(got, ref, rtol=2 ** -8,
                                   atol=2 ** -8 * float(ref.abs().max()))
    # A matrix's cotangent is an f32 sum, never rounded to bf16, in both.
    for got, ref in zip(gp[n:], want[1:1 + len(mats)]):
        for m in (got, ref):
            assert not torch.equal(m, m.to(torch.bfloat16).to(torch.float32))


def test_vjp_op_count_w256():
    """The MLP VJP's count (codegen.py's convention): one forward, in the
    SDF VJP's primal evaluation, then the slopes and δ, W·δ, a ⊗ δ and the
    bias adds."""
    program = SdfProgram(_w256(tgraph))
    h, w = 256, 3 * 256 + 256 * 256 + 256
    forward = 2 * w + h + 2 * h * 18
    slopes = 2 * h * 12 + h
    back = 2 * w - h
    mlp = slopes + back + 2 * w + (2 * h + 1)
    room = SdfProgram(_w256(tgraph).children[0])
    scalar_adjoint = sum(1 for op in program.ops[program.n_primal + 1:]
                         if op[0] in ("add", "sub", "mul", "div", "neg",
                                      "abs", "sqrt", "exp", "log", "max",
                                      "sel_lt", "sel_gt", "sign", "sel_eq"))
    assert program.vjp_ops_per_eval == (program.ops_per_eval + mlp
                                        + scalar_adjoint
                                        + len(program.adj_params))
    # Beyond the MLP and the room: the skip term (7), its sum with the MLP
    # and the union's select.
    assert program.ops_per_eval - forward == room.ops_per_eval + 9
    assert 2.9 * program.ops_per_eval < program.vjp_ops_per_eval
    assert program.vjp_ops_per_eval < 3 * program.ops_per_eval
    assert room.vjp_ops_per_eval < 1000


# -- the backward kernel's plain version vs the JAX kernel ---------------------


def test_plain_backward_matches_jax_kernel():
    """neural_demo (width 16, exact sine), f64 16×12, 6 steps, at the
    FastRenderer's planes: ``reference_backward`` against the JAX
    ``fused_backward`` in interpret mode, the flat cotangent, every matrix
    cotangent and the ray cotangents of stable rays."""
    kw = _cfg(16, 12, marching_steps=6)
    jr = JaxFastRenderer(jreg.make_scene("neural_demo"),
                         JaxRenderConfig(**kw), dtype=jnp.float64,
                         grid_dtype=np.float64, interpret=True,
                         march_impl="fused")
    tr = FastRenderer(treg.make_scene("neural_demo"), RenderConfig(**kw),
                      dtype=torch.float64, grid_dtype=np.float64,
                      device="cpu")
    origin, dirs = jr._pose_planes(jnp.asarray(DEMO_Q), jnp.asarray(DEMO_T))
    rays = np.array(jnp.stack(list(origin) + list(dirs) + [jr._valid]))
    jflat, jmats, rebuild = j_split(jr.init_params, jnp.float64)
    tflat, tmats, _ = split_params_padded(tr.init_params, torch.float64)
    out = rk.reference_march_normals(tr.program, tflat, torch.as_tensor(rays),
                                     6, 0.0, EPS, mats=tmats).numpy()
    stable = ((np.abs(out[3]) < 1e-2) & (np.sqrt((out[:3] ** 2).sum(0)) < 10)
              & (rays[6] > 0.5))
    assert stable.sum() >= 40, stable.sum()
    g = np.random.default_rng(3).normal(size=(8,) + rays.shape[1:]) * stable
    jg_flat, jg_mats, jg_rays = j_backward(
        jr.sdf_c, rebuild, jflat, jmats, jnp.asarray(rays), jnp.asarray(g), 6,
        EPS, True)
    g_flat, g_mats, g_rays = bk.fused_backward(
        tr.program, tflat, torch.as_tensor(rays), torch.as_tensor(g), 6, 0.0,
        EPS, mats=tmats)
    np.testing.assert_allclose(g_flat.numpy(), np.asarray(jg_flat),
                               rtol=1e-7, atol=1e-10, err_msg="params")
    assert len(g_mats) == len(jg_mats) == 3
    for k, (got, want) in enumerate(zip(g_mats, jg_mats)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                                   atol=1e-10, err_msg=f"matrix {k}")
        assert np.abs(np.asarray(want)).max() > 0
    want = np.asarray(jg_rays)
    for i in range(7):
        np.testing.assert_allclose(g_rays.numpy()[i][stable],
                                   want[i][stable], rtol=1e-7, atol=1e-10,
                                   err_msg=f"ray plane {i}")
    assert not g_rays.numpy()[:, rays[6] < 0.5].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_history_recompute_two_level_bitwise(dtype):
    """The plain backward through a neural scene: the forward's history,
    the recompute and the two levels give the same bits, matrices
    included."""
    node = treg.make_scene("neural_demo")
    program = SdfProgram(node)
    flat, mats, _ = split_params_padded(tgraph.init_params(node, dtype),
                                        dtype)
    rng = np.random.default_rng(31)
    pos = rng.uniform(-1.5, 1.5, (3, 2, 128))
    v = rng.normal(size=(3, 2, 128))
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    valid = np.ones((1, 2, 128))
    valid[0, 1, 100:] = 0.0
    rays = torch.as_tensor(np.concatenate([pos, v, valid]), dtype=dtype)
    g = torch.as_tensor(rng.normal(size=(8, 2, 128)), dtype=dtype)
    _, ex = rk.march_forward(program, flat, rays, 16, 0.0, EPS,
                             log_hist=True, mats=mats)
    runs = [bk.fused_backward(program, flat, rays, g, 16, 0.0, EPS,
                              mats=mats, **kw)
            for kw in (dict(hist=ex["hist"], nlive=ex["nlive"]), {},
                       dict(two_level=True))]
    assert bk.LAST_PATH["two_level"]
    for other in runs[1:]:
        assert torch.equal(runs[0][0], other[0])
        assert torch.equal(runs[0][2], other[2])
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], other[1]))
    assert any(bool(m.abs().max() > 0) for m in runs[0][1])


# -- the renderers -------------------------------------------------------------


def _w256_renderers(backward="unroll"):
    kw = _cfg(24, 16, marching_steps=8, backward=backward)
    jr = JaxFastRenderer(_w256(jgraph), JaxRenderConfig(**kw),
                         dtype=jnp.float64, grid_dtype=np.float64,
                         march_impl="xla")
    tr = FastRenderer(_w256(tgraph), RenderConfig(**kw), dtype=torch.float64,
                      grid_dtype=np.float64, device="cpu")
    return (jr, j_load_pytree(WEIGHTS, jr.init_params), tr,
            load_pytree(WEIGHTS, tr.init_params))


@pytest.mark.parametrize("case", ["unroll", "implicit", "alpha"])
def test_fast_renderer_w256_gradients_match_jax(case):
    """The trained w256 model with its weights, f64 24×16, 8 steps, at the
    demo's pose: d mean((render - target)²) (with ``alpha``: plus the
    coverage mask's) with respect to every leaf, the port's FastRenderer
    (the kernels' plain versions) against jax.grad of the JAX FastRenderer's
    XLA march. The target is the frame with the hidden biases moved, and
    only stable pixels are weighted."""
    jr, jp, tr, tp = _w256_renderers("implicit" if case == "implicit"
                                     else "unroll")
    jq, jt = jnp.asarray(DEMO_Q), jnp.asarray(DEMO_T)
    mask = _stable_pixels(jr, jp, jq, jt, 8)
    assert mask.mean() > 0.3  # 8 steps: the room's walls converge later
    moved = jax.tree_util.tree_map(lambda v: v, jp)
    moved["c1"] = dict(jp["c1"], b1=jp["c1"]["b1"] + 0.05)
    target = np.asarray(jr.render(moved, jq, jt, mode=0, degree=1))
    alpha = case == "alpha"

    def j_loss(params):
        if alpha:
            img, a = jr.render_with_alpha(params, jq, jt, mode=0, degree=1)
            return (jnp.mean(((img - target) * mask) ** 2)
                    + jnp.mean((a * mask) ** 2))
        img = jr.render(params, jq, jt, mode=0, degree=1)
        return jnp.mean(((img - target) * mask) ** 2)

    want = jgraph.param_paths(jax.grad(j_loss)(jp))
    params = _require_grad(tp)
    m = torch.as_tensor(mask)
    if alpha:
        img, a = tr.render_with_alpha(params, DEMO_Q, DEMO_T, mode=0,
                                      degree=1)
        loss = (torch.mean(((img - torch.as_tensor(target)) * m) ** 2)
                + torch.mean((a * m) ** 2))
    else:
        img = tr.render(params, DEMO_Q, DEMO_T, mode=0, degree=1)
        loss = torch.mean(((img - torch.as_tensor(target)) * m) ** 2)
    loss.backward()
    got = _grads(params)
    _assert_grads_close(got, want, case)
    for path in ("c1/w0", "c1/w1", "c1/w2", "c1/b0", "c1/b1", "c1/b2",
                 "c1/radius"):
        assert float(got[path].abs().max()) > 0, path


def test_modular_renderer_gradients_match_jax():
    """``Renderer(use_pallas=True)`` on neural_demo (the march kernel's
    plain version, differentiated by the backward's march-only mode's plain
    version), f64 16×12, 16 steps: every leaf against jax.grad of the JAX
    Renderer."""
    kw = _cfg(16, 12, marching_steps=16)
    jr = JaxRenderer(jreg.make_scene("neural_demo"), JaxRenderConfig(**kw),
                     dtype=jnp.float64, grid_dtype=np.float64)
    tr = Renderer(treg.make_scene("neural_demo"),
                  RenderConfig(**kw, use_pallas=True), dtype=torch.float64,
                  grid_dtype=np.float64, device="cpu")
    q, t = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2, 2.5]])

    def stable_mask(params):
        _, _, ray_pos, ray_dirs = jr.camera.pose(jnp.asarray(q),
                                                 jnp.asarray(t))
        p, _ = jr._march(params, ray_pos, ray_dirs, 16)
        f = jr.sdf_vec(params, p)
        return np.asarray((jnp.abs(f) < 1e-2) & (
            jnp.linalg.norm(p, axis=-1, keepdims=True) < 10.0))

    mask = stable_mask(jr.init_params)
    assert mask.mean() > 0.5
    weights = np.random.default_rng(8).normal(size=(1, 12, 16, 3)) * mask

    def j_loss(params):
        img = jr.render(params, jnp.asarray(q), jnp.asarray(t), mode=0,
                        degree=2)
        return jnp.sum(img * weights)

    want = jgraph.param_paths(jax.jit(jax.grad(j_loss))(jr.init_params))
    params = _require_grad(tr.init_params)
    img = tr.render(params, q, t, mode=0, degree=2)
    (img * torch.as_tensor(weights)).sum().backward()
    got = _grads(params)
    _assert_grads_close(got, want, "modular")
    assert float(got["c1/child/w1"].abs().max()) > 0


# -- optimize -----------------------------------------------------------------


def test_optimize_step_on_the_neural_leaf_matches_jax():
    """One Adam step of optimize() on neural_demo's MLP leaves (matrices and
    biases) in both packages, f64 16×12, 8 steps: the same loss and the
    same parameters after it (rtol 1e-6, tests/test_torch_optimize.py)."""
    kw = _cfg(16, 12, marching_steps=8)
    jr = JaxFastRenderer(jreg.make_scene("neural_demo"),
                         JaxRenderConfig(**kw), dtype=jnp.float64,
                         grid_dtype=np.float64, interpret=True,
                         march_impl="xla")
    tr = FastRenderer(treg.make_scene("neural_demo"), RenderConfig(**kw),
                      dtype=torch.float64, grid_dtype=np.float64,
                      device="cpu")
    q, t = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2, 2.5]])
    target = np.asarray(jr.render(jr.init_params, jnp.asarray(q),
                                  jnp.asarray(t), mode=0, degree=2))
    target = target + 0.05 * np.random.default_rng(9).normal(
        size=target.shape)
    common = dict(learning_rate=0.01, steps=1, mode=0, degree=2,
                  trainable=["c1/child/w", "c1/child/b"])
    jout = j_optimize(jr, jnp.asarray(target), jnp.asarray(q),
                      jnp.asarray(t), JaxInverseConfig(**common))
    tout = optimize(tr, target, q, t, InverseConfig(**common))
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-6)
    start = tgraph.param_paths(tr.init_params)
    got = tgraph.param_paths(tout["params"])
    moved = 0
    for path, w in jgraph.param_paths(jout["params"]).items():
        np.testing.assert_allclose(got[path].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-12, err_msg=path)
        moved += int(not torch.equal(got[path], start[path]))
    assert moved == 6


def test_cli_optimize_on_a_neural_scene_file(tmp_path, capsys):
    """``cli optimize --scene-file`` trains the JAX package's neural scene
    file's matrices and writes them to the parameter file."""
    out = tmp_path / "trained.npz"
    cli_main(["optimize", "--scene-file", str(SCENE_FILE), "--device", "cpu",
              "--width", "16", "--height", "12", "--steps", "6",
              "--opt-steps", "2", "--trainable", "c1/child/w",
              "--save-params", str(out)])
    assert "final loss" in capsys.readouterr().out
    node = treg.make_scene("neural_demo")
    start = tgraph.init_params(node, torch.float32)
    trained = load_pytree(out, start)
    for k in ("w0", "w1", "w2"):
        assert not torch.equal(trained["c1"]["child"][k],
                               start["c1"]["child"][k]), k
    assert torch.equal(trained["c1"]["child"]["b0"],
                       start["c1"]["child"]["b0"])


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEURAL_SCENES))
def test_cuda_neural_backward_matches_plain(cuda, name):
    """The backward kernel with the MLP's VJP against its plain version,
    f64 (rtol 1e-9 of each output's largest entry), on converged rays; the
    history, the recompute and the two levels bitwise equal."""
    node = NEURAL_SCENES[name]()
    program = SdfProgram(node)
    params = tgraph.init_params(node, torch.float64, cuda)
    flat, mats, _ = split_params_padded(params, torch.float64)
    rng = np.random.default_rng(15)
    p = rng.uniform(-1.5, 1.5, (3, 8, 128))
    v = rng.normal(size=(3, 8, 128))
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    valid = np.ones((1, 8, 128))
    valid[0, 7, 90:] = 0.0
    rays = torch.as_tensor(np.concatenate([p, v, valid]),
                           dtype=torch.float64, device=cuda)
    out, ex = rk.march_forward(program, flat, rays, 16, 0.0, EPS,
                               log_hist=True, mats=mats)
    conv = (rays[6] > 0.5) & (out[3].abs() < 1e-3)
    g = torch.as_tensor(rng.normal(size=(8, 8, 128)), device=cuda) * conv
    before = bk.LAUNCHES
    runs = [bk.fused_backward(program, flat, rays, g, 16, 0.0, EPS,
                              mats=mats, **kw)
            for kw in (dict(hist=ex["hist"], nlive=ex["nlive"]), {},
                       dict(two_level=True))]
    assert bk.LAUNCHES == before + 3
    want = bk.reference_backward(program, flat, rays, g, 16, 0.0, EPS,
                                 hist=ex["hist"], nlive=ex["nlive"],
                                 mats=mats)
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip([runs[0][0], *runs[0][1], runs[0][2]],
                        [other[0], *other[1], other[2]]):
            assert torch.equal(a, b)
    got = runs[0]
    for a, b in zip([got[0], *got[1], got[2][:, conv]],
                    [want[0], *want[1], want[2][:, conv]]):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())
