"""The port's march kernel wrappers against the JAX ``pallas_march`` (Pallas
kernel in interpret mode), f64 on the CPU, where the port takes the kernel's
plain version: values, gradients, odd ray counts and pad slots. The CUDA
kernel itself is held against the plain version by the ``cuda`` test, which
skips without a card, and by chip_smoke.py.

Tolerances vs JAX: rtol 1e-12 on positions and distance (both march the same
IEEE op sequence; XLA may round an op differently by an ulp), rtol 1e-9 on
gradients (the JAX package differentiates a checkpointed scan, the port runs
its backward kernel's algorithm step by step; the sums over the rays are
taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.ops.pallas_march import pallas_march_with_distance
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.ops import backward_kernel as bk
from ray_marching_tpu_torch.ops import march_kernel as mk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram


def _setup(scene, shape, seed=0):
    _, jsdf, jparams = jgraph.compile_scene(jreg.make_scene(scene),
                                            jnp.float64)
    program = SdfProgram(treg.make_scene(scene))
    tparams = tgraph.init_params(program.node, torch.float64)
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, shape + (3,))
    v = rng.standard_normal(shape + (3,))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (jsdf, jparams), (program, tparams), p0, v


@pytest.mark.parametrize("shape", [(1, 24, 40), (7, 9), (300,)],
                         ids=["960", "odd63", "flat300"])
@pytest.mark.parametrize("tau", [0.0, 1e-6])
@pytest.mark.parametrize("scene", ["test_scene2", "test_scene"])
def test_forward_matches_pallas_march(scene, tau, shape):
    (jsdf, jparams), (program, tparams), p0, v = _setup(scene, shape)
    jpos, jdist = pallas_march_with_distance(
        jsdf, jparams, jnp.asarray(p0), jnp.asarray(v), 12, tau=tau,
        interpret=True)
    pos, dist = mk.kernel_march_with_distance(
        program, tparams, torch.as_tensor(p0), torch.as_tensor(v), 12,
        tau=tau)
    assert pos.shape == shape + (3,) and dist.shape == shape + (1,)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-12,
                               atol=1e-13)
    only = mk.kernel_march(program, tparams, torch.as_tensor(p0),
                           torch.as_tensor(v), 12, tau=tau)
    assert torch.equal(only, pos)


def _camera_like(shape, seed=3):
    """Rays from a plane outside the objects pointing inward: the geometry a
    camera produces, free of the interior knife-edge rays whose gradients
    blow up."""
    rng = np.random.default_rng(seed)
    p0 = np.zeros(shape + (3,))
    p0[..., 0] = rng.uniform(-0.8, 0.8, shape)
    p0[..., 1] = rng.uniform(-0.8, 0.8, shape)
    p0[..., 2] = 2.5
    v = np.zeros(shape + (3,))
    v[..., 2] = -1.0
    return p0, v


@pytest.mark.parametrize("tau", [0.0, 1e-3])
@pytest.mark.parametrize("scene", ["test_scene2", "composite"])
def test_gradients_match_jax_grad(scene, tau):
    """Every leaf and both ray inputs, through positions and distance."""
    (jsdf, jparams), (program, _), _, _ = _setup(scene, (1,))
    shape = (5, 27)  # 135 rays: pad slots exist
    p0, v = _camera_like(shape)
    if scene == "composite":
        p0[..., 2], v[..., 2] = -3.0, 1.0
    rng = np.random.default_rng(4)
    wp, wd = rng.standard_normal(shape + (3,)), rng.standard_normal(shape + (1,))

    def jloss(params, p, d):
        pos, dist = pallas_march_with_distance(jsdf, params, p, d, 16,
                                               tau=tau, interpret=True)
        return jnp.sum(pos * wp) + jnp.sum(dist * wd)

    jg, jgp, jgv = jax.grad(jloss, argnums=(0, 1, 2))(
        jparams, jnp.asarray(p0), jnp.asarray(v))
    params = tgraph.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), torch.float64)
    leaves = tgraph.param_paths(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tp = torch.tensor(p0, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    before = (mk.LAUNCHES, bk.MARCH_LAUNCHES)
    pos, dist = mk.kernel_march_with_distance(program, params, tp, tv, 16,
                                              tau=tau)
    ((pos * torch.as_tensor(wp)).sum()
     + (dist * torch.as_tensor(wd)).sum()).backward()
    assert (mk.LAUNCHES, bk.MARCH_LAUNCHES) == before  # CPU: no launch
    want = jgraph.param_paths(jg)
    assert list(want) == list(leaves)
    assert any(np.abs(np.asarray(x)).max() > 1e-3 for x in want.values())
    for k, leaf in leaves.items():
        got = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-11,
                                   err_msg=f"{scene} tau={tau} {k}")
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv), rtol=1e-9,
                               atol=1e-11)


def test_pad_slots_do_not_poison_parameter_gradients():
    """A primitive at the world origin is a gradient singularity there; pad
    slots must neither sit there nor add to the parameter cotangent. 300
    rays leave 84 pad slots in the last row."""
    jnode = jgraph.Affine(jgraph.Sphere(0.5), (1.0, 0.0, 0.0, 0.0),
                          (0.0, 0.0, 0.0))
    tnode = tgraph.Affine(tgraph.Sphere(0.5), (1.0, 0.0, 0.0, 0.0),
                          (0.0, 0.0, 0.0))
    _, jsdf, jparams = jgraph.compile_scene(jnode, jnp.float64)
    program = SdfProgram(tnode)
    rng = np.random.default_rng(2)
    p0 = rng.uniform(1.0, 2.0, (300, 3))
    v = rng.standard_normal((300, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    rays7 = mk.rays_to_planes(torch.as_tensor(p0), torch.as_tensor(v))
    assert rays7.shape == (7, 3, 128)
    pad = rays7[6] < 0.5
    assert int(pad.sum()) == 84
    for i in range(3):  # the pad slots repeat the last real ray
        assert (rays7[i][pad] == p0[-1, i]).all()
        assert (rays7[3 + i][pad] == v[-1, i]).all()

    jg = jax.grad(lambda p: jnp.sum(pallas_march_with_distance(
        jsdf, p, jnp.asarray(p0), jnp.asarray(v), 8,
        interpret=True)[0] ** 2))(jparams)
    params = tgraph.init_params(tnode, torch.float64)
    leaves = tgraph.param_paths(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    pos = mk.kernel_march(program, params, torch.as_tensor(p0),
                          torch.as_tensor(v), 8)
    (pos ** 2).sum().backward()
    for k, want in jgraph.param_paths(jg).items():
        got = leaves[k].grad
        assert torch.isfinite(got).all(), k
        # atol: summation-order rounding on the sphere's rotation-invariant
        # orientation leaf, whose true gradient is exactly 0.
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-8, err_msg=k)


def _plane_inputs(dtype, rows=4, scene="test_scene2", seed=5):
    program = SdfProgram(treg.make_scene(scene))
    flat, _, _ = split_params_padded(tgraph.init_params(program.node, dtype),
                                  dtype)
    rng = np.random.default_rng(seed)
    n = rows * 128
    pos = rng.uniform(-2.0, 2.0, size=(3, n))
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    valid = np.ones((1, n))
    valid[:, -50:] = 0.0
    rays = torch.as_tensor(np.concatenate([pos, d, valid])
                           .reshape(7, rows, 128), dtype=dtype)
    return program, flat, rays


@pytest.mark.parametrize("tau", [0.0, 1e-3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_planes_equal_the_fused_kernels_first_four(dtype, tau):
    """One march loop, two kernels: the plain versions agree bit for bit, as
    chip_smoke.py checks for the kernels on the card. Pad slots pass their
    position through and get distance 0."""
    program, flat, rays = _plane_inputs(dtype)
    out = mk.march_planes(program, flat, rays, 12, tau)
    full = rk.fused_march_normals(program, flat, rays, 12, tau, 5e-2)
    assert out.shape == (4, 4, 128)
    assert torch.equal(out, full[:4])
    pad = rays[6] < 0.5
    assert torch.equal(out[:3][:, pad], rays[:3][:, pad])
    assert not out[3][pad].any()


@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_march_only_backward_matches_whole_graph_autograd(tau):
    """The plain version of the backward kernel's march-only mode against
    autograd through the plain march (cotangents on valid rays only)."""
    program, flat, rays = _plane_inputs(torch.float64)
    g = torch.as_tensor(np.random.default_rng(6).normal(size=(4, 4, 128)))
    g = g * (rays[6] > 0.5)
    fl = flat.clone().requires_grad_(True)
    r = rays.clone().requires_grad_(True)
    want = torch.autograd.grad(
        (mk.reference_march(program, fl, r, 10, tau) * g).sum(), [fl, r])
    got = bk.march_backward(program, flat, rays, g, 10, tau)
    stable = rk.reference_march_normals(program, flat, rays, 10, tau, 5e-2)
    ok = (stable[3].abs() < 1e-2) & (rays[6] > 0.5)
    torch.testing.assert_close(got[2][:6][:, ok], want[1][:6][:, ok],
                               rtol=1e-9, atol=1e-10)
    assert not got[2][:, rays[6] < 0.5].any() and not got[2][6].any()
    # The parameter cotangent sums every valid ray, diverged ones too.
    g2 = g * ok
    want = torch.autograd.grad(
        (mk.reference_march(program, fl, r, 10, tau) * g2).sum(), [fl])[0]
    got = bk.march_backward(program, flat, rays, g2, 10, tau)[0]
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-10)


def test_march_ops_count():
    program = SdfProgram(treg.make_scene("test_scene2"))
    per_ray = (65 + rk.OPS_PER_STEP) * 32 + 65
    assert per_ray == 2337
    assert mk.march_ops(program, 1000, 32) == 1000 * per_ray
    vjp = program.vjp_ops_per_eval
    assert (bk.backward_ops(program, 1000, 32000, recomputed_steps=32000,
                            march_only=True)
            == 1000 * (vjp + 3 + 32 * (vjp + bk.OPS_BWD_STEP)
                       + 32 * (65 + rk.OPS_PER_STEP)))


@pytest.mark.parametrize("kind", ["rays_shape", "lanes", "dtype_mismatch",
                                  "int_rays", "params_len", "g_planes",
                                  "vector_shapes"])
def test_wrappers_reject_bad_inputs(kind):
    program, flat, rays = _plane_inputs(torch.float64)
    g = torch.zeros((4, 4, 128), dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        if kind == "rays_shape":
            mk.march_planes(program, flat, rays[:6], 8)
        elif kind == "lanes":
            mk.march_planes(program, flat, rays[..., :64], 8)
        elif kind == "dtype_mismatch":
            mk.march_planes(program, flat.float(), rays, 8)
        elif kind == "int_rays":
            mk.march_planes(program, flat, rays.long(), 8)
        elif kind == "params_len":
            mk.march_planes(program, flat[:-1], rays, 8)
        elif kind == "g_planes":
            bk.march_backward(program, flat, rays, g[:3], 8, 0.0)
        else:
            mk.kernel_march(program, tgraph.init_params(program.node,
                                                        torch.float64),
                            torch.zeros(5, 3, dtype=torch.float64),
                            torch.zeros(4, 3, dtype=torch.float64), 8)


def test_wrappers_never_fall_back_off_cpu():
    program, flat, rays = _plane_inputs(torch.float64)
    meta = rays.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mk.march_planes(program, flat.to("meta"), meta, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        bk.march_backward(program, flat.to("meta"), meta,
                          torch.empty((4, 4, 128), dtype=torch.float64,
                                      device="meta"), 8, 0.0)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.0, 1e-3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_march_matches_plain(cuda, dtype, tau):
    """The CUDA march kernel equals its plain version and planes 0-3 of the
    fused kernel bit for bit on the card, and its backward (the march-only
    mode of the backward kernel) the plain backward up to the order of its
    sums (f32: 1e-4 relative to the largest cotangent; f64: 1e-11), on rays
    that converge."""
    program, flat, rays = _plane_inputs(dtype, rows=64)
    flat, rays = flat.to(cuda), rays.to(cuda)
    first = rk.reference_march_normals(program, flat, rays, 12, tau, 5e-2)
    rays[6] = ((first[3].abs() < 1e-3) & (rays[6] > 0.5)).to(dtype)
    before = (mk.LAUNCHES, bk.MARCH_LAUNCHES)
    got = mk.march_planes(program, flat, rays, 12, tau)
    want = mk.reference_march(program, flat, rays, 12, tau)
    full = rk.fused_march_normals(program, flat, rays, 12, tau, 5e-2)
    g = torch.as_tensor(np.random.default_rng(7).normal(size=(4, 64, 128)),
                        dtype=dtype, device=cuda)
    a = bk.march_backward(program, flat, rays, g, 12, tau)
    assert (mk.LAUNCHES, bk.MARCH_LAUNCHES) == (before[0] + 1, before[1] + 1)
    b = bk.reference_backward(program, flat, rays, g, 12, tau, None,
                              march_only=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, full[:4])
    rel = 1e-4 if dtype == torch.float32 else 1e-11
    for x, ref in zip(a[::2], b[::2]):
        assert float((x - ref).abs().max()) <= rel * float(ref.abs().max())
