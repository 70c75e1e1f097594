"""The port's XLA-route march (``ops/xla_render.py``) against the JAX
package's ``ops/xla_render.py``, f64 on the CPU, and its place in
``FastRenderer(march_impl='xla')``.

Both sides run the plain plane-wise march: the forward planes are held at
rtol 1e-9, atol 1e-11 on converged rays (the packages differ by an ulp per
op, carried through the march), the gradients of a weighted sum of the
planes at rtol 1e-7, atol 1e-9 relative to the largest entry
(tests/test_torch_train.py's tolerances). Weights sit on converged rays
only: a ray that has not converged carries an astronomically amplified
derivative. The remat (one ``torch.utils.checkpoint`` a step) recomputes the
same operations, so its gradients are held bitwise to the same march
differentiated without checkpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.ops import xla_render as jxla
from ray_marching_tpu.ops.pallas_march import (
    split_params_padded as j_split_params,
)
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops import xla_render as txla
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

PX = 3.45e-6
W, H, STEPS, EPS = 24, 16, 12, 5e-2
Q = np.asarray([[0.0, 0.0, 1.0, 0.0]])
T = np.asarray([[0.0, 0.2, 2.5]])


def _cfg(**kw):
    return RenderConfig(px_width=W, px_height=H, focal_length=PX * H,
                        sensor_width=PX * W, sensor_height=PX * H,
                        marching_steps=STEPS, **kw)


def _setup(scene):
    """The port's renderer, its flat/matrix parameters, rays7 at the bench
    pose, and the JAX side's parameters and SDF."""
    r = FastRenderer(treg.make_scene(scene), _cfg(), dtype=torch.float64,
                     grid_dtype=np.float64, device="cpu")
    origin, dirs = r._pose_planes(*r._pose(Q, T))
    rays7 = torch.stack(list(origin) + list(dirs) + [r._valid], 0)
    flat, mats, _ = split_params_padded(r.init_params, torch.float64)
    jnode = jreg.make_scene(scene)
    _, j_sdf_c, j_params = jgraph.compile_scene(jnode, jnp.float64)
    jflat, jmats, rebuild = j_split_params(j_params, jnp.float64)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    return r, flat, mats, rays7, (j_sdf_c, rebuild, jflat, jmats)


def _port(kind, r, flat, mats, rays7, tau):
    fn = {"plain": txla.xla_march_normals, "cov": txla.xla_march_normals_cov,
          "ift": txla.xla_march_normals_ift,
          "cov_ift": txla.xla_march_normals_cov_ift}[kind]
    return fn(r.program, flat, rays7, STEPS, tau, EPS, mats=mats)


def _jax(kind, jside, rays7, tau):
    sdf_c, rebuild, jflat, jmats = jside
    fn = {"plain": jxla.xla_march_normals, "cov": jxla.xla_march_normals_cov,
          "ift": jxla.xla_march_normals_ift,
          "cov_ift": jxla.xla_march_normals_cov_ift}[kind]
    return lambda f, m, x: fn(sdf_c, rebuild, f, m, x, STEPS, tau, EPS)


def _require_grad(tree):
    if isinstance(tree, dict):
        return {k: _require_grad(v) for k, v in tree.items()}
    return tree.clone().requires_grad_(True)


def _weights(out, rays7, seed):
    """Random plane weights on converged valid rays only."""
    conv = ((out[3].abs() < 1e-2) & (rays7[6] > 0.5)).numpy()
    g = np.random.default_rng(seed).normal(size=tuple(out.shape))
    return g * conv[None], conv


@pytest.mark.parametrize("scene", ["test_scene2", "neural_demo"])
@pytest.mark.parametrize("kind", ["plain", "cov", "ift", "cov_ift"])
@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_entry_point_matches_jax(scene, kind, tau):
    """Forward planes and d sum(planes · g) / d (flat params, matrices,
    rays7) of one entry point against JAX's (unroll: autograd through the
    remat march; ift/cov_ift: the closed-form IFT backward)."""
    r, flat, mats, rays7, jside = _setup(scene)
    out = _port(kind, r, flat, mats, rays7, tau)
    jfn = _jax(kind, jside, rays7, tau)
    jrays = jnp.asarray(rays7.numpy())
    jout = np.asarray(jfn(jside[2], jside[3], jrays))
    assert out.shape == jout.shape == ((9 if "cov" in kind else 8),
                                       rays7.shape[1], 128)
    g, conv = _weights(out, rays7, 7)
    assert conv[rays7[6].numpy() > 0.5].mean() > 0.3
    np.testing.assert_allclose(out.numpy()[:, conv], jout[:, conv],
                               rtol=1e-9, atol=1e-11)

    leaves = [flat.clone().requires_grad_(True)] + [
        m.clone().requires_grad_(True) for m in mats]
    x = rays7.clone().requires_grad_(True)
    got = torch.autograd.grad(
        (_port(kind, r, leaves[0], tuple(leaves[1:]), x, tau)
         * torch.as_tensor(g)).sum(), leaves + [x])
    want = jax.grad(lambda f, m, x: jnp.sum(jfn(f, m, x) * g),
                    argnums=(0, 1, 2))(jside[2], jside[3], jrays)
    want = [want[0], *want[1], want[2]]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-7,
                                   atol=1e-9 * scale, err_msg=f"input {i}")
    assert float(got[0].abs().max()) > 0


@pytest.mark.parametrize("track_min", [False, True])
def test_remat_gradients_equal_the_march_without_checkpoints(track_min):
    """The rematerialized march gives the gradients of the same march
    differentiated without checkpoints, bit for bit, and keeps no step's
    SDF activations (fewer tensors saved for the backward)."""
    r, flat, mats, rays7, _ = _setup("neural_demo")
    g = torch.as_tensor(_weights(
        rk._reference_march(r.program, flat, rays7, STEPS, 0.0, EPS,
                            track_min=track_min, mats=mats)[0], rays7, 3)[0])
    grads, saved = [], []
    for remat in (True, False):
        leaves = [flat.clone().requires_grad_(True)] + [
            m.clone().requires_grad_(True) for m in mats]
        x = rays7.clone().requires_grad_(True)
        count = [0]

        def pack(t):
            count[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = rk._reference_march(r.program, leaves[0], x, STEPS, 0.0,
                                      EPS, track_min=track_min,
                                      mats=tuple(leaves[1:]),
                                      remat=remat)[0]
        grads.append(torch.autograd.grad((out * g).sum(), leaves + [x]))
        saved.append(count[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert saved[0] < saved[1] / 2, saved
    # The route's entry point is the remat march.
    out = (txla.xla_march_normals_cov if track_min
           else txla.xla_march_normals)(r.program, flat, rays7, STEPS, 0.0,
                                        EPS, mats=mats)
    assert torch.equal(out, rk._reference_march(
        r.program, flat, rays7, STEPS, 0.0, EPS, track_min=track_min,
        mats=mats)[0])


@pytest.mark.parametrize("alpha", [False, True])
def test_fast_renderer_xla_implicit_runs_and_matches_fused_ift(alpha):
    """``FastRenderer(march_impl='xla', backward='implicit')`` no longer
    raises, and its gradient is the fused route's IFT gradient: on the CPU
    the fused route marches with the kernel's plain version, the same march,
    so the two are equal bit for bit (on the card they differ as the kernel
    differs from its plain version, within chip_smoke.py's TOL_F32)."""
    grads = []
    for impl in ("xla", "fused"):
        r = FastRenderer(treg.make_scene("test_scene2"),
                         _cfg(backward="implicit"), dtype=torch.float64,
                         grid_dtype=np.float64, device="cpu", march_impl=impl)
        assert r.march_impl == impl
        params = _require_grad(r.init_params)
        leaves = tgraph.param_paths(params)
        if alpha:
            img, a = r.render_with_alpha(params, Q, T)
            loss = (img ** 2).mean() + a.mean()
        else:
            loss = (torch.nan_to_num(r.render(params, Q, T)) ** 2).mean()
        got = torch.autograd.grad(loss, list(leaves.values()))
        grads.append(got)
    assert any(float(g.abs().max()) > 0 for g in grads[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_xla_route_launches_no_kernel(monkeypatch):
    """The XLA route is plain torch: it never reaches the kernel's wrapper,
    forward or backward, with either backward."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("the XLA route reached a kernel wrapper")

    monkeypatch.setattr(rk, "march_forward", no_kernel)
    monkeypatch.setattr(rk, "_FusedMarch", None)
    for backward in ("unroll", "implicit"):
        r = FastRenderer(treg.make_scene("test_scene2"),
                         _cfg(backward=backward), dtype=torch.float64,
                         device="cpu", march_impl="xla")
        params = _require_grad(r.init_params)
        r.render(params, Q, T).sum().backward()
        assert all(v.grad is not None
                   for v in tgraph.param_paths(params).values())
