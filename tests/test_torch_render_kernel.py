"""The port's fused march + normals: its plain PyTorch version against the
JAX ``fused_march_normals`` (Pallas kernel in interpret mode), the wrapper's
checks, the kernel constants and the op count of its bound. The CUDA kernel
itself is held against the plain version by the ``cuda`` tests, which skip
without a card, and by chip_smoke.py.

Tolerance vs JAX: 1e-10 absolute on stable rays (terminal |d| < 1e-2,
|p| < 10), random rays in f64; the Laplacian, 2400× the SDF's rounding, gets
1e-8. Both march the same IEEE op sequence; XLA rounds some ops differently
by an ulp, and unconverged rays amplify that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.ops.pallas_march import split_params_padded as j_split
from ray_marching_tpu.ops.pallas_render import (
    fused_march_normals as j_fused_march_normals,
)
from ray_marching_tpu.render.normals import make_offsets as j_make_offsets
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram

STEPS = 16
EPS = 5e-2


def _rays(seed, rows=16, dtype=np.float64):
    rng = np.random.default_rng(seed)
    n = rows * 128
    pos = rng.uniform(-2.0, 2.0, size=(3, n))
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    valid = np.ones((1, n))
    valid[:, -100:] = 0.0  # pad slots
    return np.concatenate([pos, d, valid]).reshape(7, rows, 128).astype(dtype)


@pytest.fixture(scope="module", params=["test_scene2", "test_scene"])
def scene(request):
    name = request.param
    jparams = jgraph.init_params(jreg.make_scene(name), jnp.float64)
    _, jsdf, _ = jgraph.compile_scene(jreg.make_scene(name), jnp.float64)
    jflat, mats, rebuild = j_split(jparams, jnp.float64)
    program = SdfProgram(treg.make_scene(name))
    tflat, _, _ = split_params_padded(
        tgraph.init_params(program.node, torch.float64), torch.float64)
    return name, (jsdf, rebuild, jflat, mats), program, tflat


@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_plain_matches_jax_kernel(scene, tau):
    name, (jsdf, rebuild, jflat, mats), program, tflat = scene
    rays = _rays(11)
    want = np.asarray(j_fused_march_normals(
        jsdf, rebuild, jflat, mats, jnp.asarray(rays), STEPS, tau, EPS, True))
    got = rk.fused_march_normals(program, tflat, torch.as_tensor(rays),
                                 STEPS, tau, EPS).numpy()
    stable = ((np.abs(want[3]) < 1e-2)
              & (np.sqrt((want[:3] ** 2).sum(0)) < 10) & (rays[6] > 0.5))
    assert stable.sum() >= 64, (name, stable.sum())
    for i in range(8):
        np.testing.assert_allclose(got[i][stable], want[i][stable], rtol=0,
                                   atol=1e-8 if i == 7 else 1e-10,
                                   err_msg=f"{name} tau={tau} plane {i}")
    # Pad slots: unmoved, zero distance / normals / Laplacian.
    pad = rays[6] < 0.5
    np.testing.assert_array_equal(got[:3][:, pad], rays[:3][:, pad])
    assert not got[3:][:, pad].any()


def test_early_exit_freezes_converged_rays(scene):
    """tau > 0 leaves a ray where |d| first fell below tau: marching more
    steps does not move it."""
    _, _, program, tflat = scene
    rays = torch.as_tensor(_rays(12))
    a = rk.fused_march_normals(program, tflat, rays, STEPS, 1e-3, EPS)
    b = rk.fused_march_normals(program, tflat, rays, 2 * STEPS, 1e-3, EPS)
    frozen = (a[3].abs() < 1e-3) & (rays[6] > 0.5)
    assert frozen.any()
    assert torch.equal(a[:3][:, frozen], b[:3][:, frozen])


def test_host_constants_match_jax():
    for npd, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        offsets, inverse = j_make_offsets(EPS, np_dtype=npd)
        consts = rk._host_consts(tdt, 1e-3, EPS)
        assert consts.dtype == npd and consts.shape == (23,)
        np.testing.assert_array_equal(consts[:12], offsets.reshape(-1))
        np.testing.assert_array_equal(consts[12:21], inverse.reshape(-1))
        assert consts[21] == npd(6.0 / EPS**2)
        assert consts[22] == npd(1e-3)


def test_kernel_ops_count():
    program = SdfProgram(treg.make_scene("test_scene2"))
    per_ray = (32 + 5) * 65 + 32 * rk.OPS_PER_STEP + rk.OPS_TAIL
    assert rk.kernel_ops(program, 1000, 32) == 1000 * per_ray
    assert rk.OPS_PER_STEP == 6 and rk.OPS_TAIL == 45


def test_kernel_key_follows_scene():
    a = SdfProgram(treg.make_scene("test_scene2"))
    b = SdfProgram(treg.make_scene("test_scene2"))
    c = SdfProgram(treg.make_scene("test_scene"))
    assert rk.kernel_key(a) == rk.kernel_key(b) != rk.kernel_key(c)


def _bad_args(kind, program, flat, rays):
    if kind == "rays_shape":
        return program, flat, rays[:6]
    if kind == "lanes":
        return program, flat, rays[..., :64]
    if kind == "dtype_mismatch":
        return program, flat.float(), rays
    if kind == "int_rays":
        return program, flat, rays.long()
    if kind == "params_len":
        return program, flat[:-1], rays
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["rays_shape", "lanes", "dtype_mismatch",
                                  "int_rays", "params_len"])
def test_wrapper_rejects_bad_inputs(scene, kind):
    _, _, program, tflat = scene
    args = _bad_args(kind, program, tflat, torch.as_tensor(_rays(13, rows=8)))
    with pytest.raises((ValueError, TypeError)):
        rk.fused_march_normals(*args, STEPS, 0.0, EPS)


def test_wrapper_never_falls_back_off_cpu(scene):
    """A tensor that is neither on the CPU nor on a CUDA device raises; the
    wrapper does not quietly take the plain version."""
    _, _, program, tflat = scene
    rays = torch.empty((7, 8, 128), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rk.fused_march_normals(program, tflat.to("meta"), rays, STEPS, 0.0,
                               EPS)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_cuda_kernel_matches_plain(cuda, scene, dtype, tau):
    """The CUDA kernel equals its plain version on the card (both IEEE op
    for op, no FMA contraction): converged rays to 1e-6 (f32) / 1e-12."""
    _, _, program, tflat = scene
    rays = torch.as_tensor(_rays(14, rows=64), dtype=dtype, device=cuda)
    flat = tflat.to(device=cuda, dtype=dtype)
    before = rk.LAUNCHES
    got = rk.fused_march_normals(program, flat, rays, STEPS, tau, EPS)
    assert rk.LAUNCHES == before + 1
    want = rk.reference_march_normals(program, flat, rays, STEPS, tau, EPS)
    torch.cuda.synchronize()
    conv = (want[3].abs() < 1e-3) & (rays[6] > 0.5)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    for i in range(7):
        torch.testing.assert_close(got[i][conv], want[i][conv], rtol=0,
                                   atol=tol)
