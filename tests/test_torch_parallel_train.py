"""The port's sharded training paths against the JAX package, f64 on the
CPU, over a gloo group of two child ranks: ``fast_sharding.fast_train_step``
(two Adam steps against ``optax.adam`` on JAX's gradients),
``fast_train_step_silhouette``, a two-camera batch (one row shard per
camera) and ``TiledRenderer(mesh=...)`` (frames and ``loss_and_grad``).

The JAX side is its one-process FastRenderer (Pallas kernels in interpret
mode), which JAX's own tests/test_sharding_fast.py and tests/test_tiled.py
hold equal to its sharded and tiled forms.

Tolerances: frames rtol 1e-9, atol 1e-11 on stable pixels (as
tests/test_torch_fast.py); losses and parameters after Adam steps rtol
1e-6, atol 1e-12 (as tests/test_torch_optimize.py: one Adam step divides by
sqrt(v) + eps, which amplifies the gradients' rounding); gradients rtol
1e-7, atol 1e-9 of the leaf's largest entry (as tests/test_torch_train.py),
with weights on stable pixels only where the loss is a weighted sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.render.shaders import MODES
from ray_marching_tpu_torch.scene import registry as treg
from test_torch_ranks import Ranks, stable_mask

PX = 3.45e-6
W, H = 48, 32
STEPS = 12
Q = np.asarray([[0.1, 0.03, 0.99, 0.03]])
Q = Q / np.linalg.norm(Q)
T = np.asarray([[0.1, 0.2, 2.0]])
Q2 = np.concatenate([Q, [[0.9914449, 0.0, 0.1305262, 0.0]]])
T2 = np.concatenate([T, [[0.3, 0.1, 2.2]]])
LR = 0.02
BETA = 0.05
TILED_MODES = (0, 1, 5)
CAMERA_MODES = (0, 3, 6)


def _cfg_kwargs(**kw):
    return dict(px_width=W, px_height=H, focal_length=PX * H,
                sensor_width=PX * W, sensor_height=PX * H,
                marching_steps=STEPS, **kw)


CHILD = f"""
import functools
from ray_marching_tpu_torch.parallel import fast_sharding as fs
from ray_marching_tpu_torch.parallel.sharding import (
    allreduce_sum, make_mesh, optimizer_step)
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.render.silhouette import composite
from ray_marching_tpu_torch.render.tiled import TiledRenderer
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.graph import map_params, param_paths

mesh = make_mesh((2,), ("rows",), device_type="cpu")
kw = dict(dtype=torch.float64, grid_dtype=np.float64, device="cpu")
f = FastRenderer(registry.make_scene("test_scene2"),
                 RenderConfig(**{_cfg_kwargs()!r}), row_multiple=16, **kw)
q = torch.tensor({Q.tolist()!r}, dtype=torch.float64)
t = torch.tensor({T.tolist()!r}, dtype=torch.float64)
data = np.load(out + "/inputs.npz")
adam = functools.partial(torch.optim.Adam, lr={LR})

# Two steps of the sharded train step.
target = torch.as_tensor(data["target"])
step = fs.fast_train_step(f, mesh, adam, mode=0, degree=2)
p, st = f.init_params, None
for i in range(2):
    p, st, loss = step(p, st, fs.target_planes(f, mesh, target), q, t)
    R[f"loss{{i}}"] = loss.item()
for k, v in param_paths(p).items():
    R[f"p/{{k}}"] = v.numpy()

# One silhouette step, and the same step in one process (image space).
t_alpha = torch.as_tensor(data["target_alpha"])
sil = fs.fast_train_step_silhouette(f, mesh, adam, mode=0, degree=2,
                                    beta={BETA})
ps, _, loss = sil(f.init_params, None, fs.target_planes(f, mesh, target),
                  fs.target_planes(f, mesh, t_alpha), q, t)
R["sil_loss"] = loss.item()


def sil_local(work):
    img, a = f.render_with_alpha(work, q, t, mode=0, degree=2, beta={BETA})
    return (torch.mean((composite(img, a, 0.0) - target) ** 2)
            + torch.mean((a - t_alpha) ** 2))


pl, _, loss = optimizer_step(adam, f.init_params, None, sil_local, ())
R["sil_loss_local"] = loss.item()
for k in param_paths(ps):
    R[f"sil/{{k}}"] = param_paths(ps)[k].numpy()
    R[f"sil_local/{{k}}"] = param_paths(pl)[k].numpy()

# Two cameras, one row shard each.
f2 = FastRenderer(registry.make_scene("test_scene2"),
                  RenderConfig(**{_cfg_kwargs(num_cameras=2)!r}),
                  row_multiple=8, **kw)
q2 = torch.tensor({Q2.tolist()!r}, dtype=torch.float64)
t2 = torch.tensor({T2.tolist()!r}, dtype=torch.float64)
for mode in {CAMERA_MODES!r}:
    R[f"cam{{mode}}"] = fs.fast_shard_render(f2, mesh, mode=mode, degree=2)(
        f2.init_params, q2, t2).numpy()
w2 = torch.as_tensor(data["w2"])
chan = fs.make_channel_fn(f2, mesh, mode=0, degree=2)
wp = f2.image_to_planes(w2)[:, chan.rows]


def grads_of(loss_of):
    p = map_params(f2.init_params, lambda v: v.clone().requires_grad_(True))
    qq, tt = q2.clone().requires_grad_(True), t2.clone().requires_grad_(True)
    leaves = param_paths(p)
    got = torch.autograd.grad(loss_of(p, qq, tt),
                              list(leaves.values()) + [qq, tt])
    return dict(zip(list(leaves) + ["q", "t"], got))


g = grads_of(lambda p, qq, tt: torch.sum(chan(p, qq, tt) * wp))
allreduce_sum(list(g.values()), fs.mesh_groups(mesh))
g1 = grads_of(lambda p, qq, tt: torch.sum(
    f2.render(p, qq, tt, mode=0, degree=2) * w2))
for k in g:
    R[f"cg/{{k}}"], R[f"cg_local/{{k}}"] = g[k].numpy(), g1[k].numpy()

# Strips sharded over the mesh.
tr = TiledRenderer(registry.make_scene("test_scene2"),
                   RenderConfig(**{_cfg_kwargs()!r}), strip_height=12,
                   mesh=mesh, **kw)
for mode in {TILED_MODES!r}:
    R[f"tiled{{mode}}"] = tr.render(tr.init_params, q, t, mode=mode,
                                    degree=2).numpy()
loss, (gt, gq, gtt) = tr.loss_and_grad(tr.init_params, q, t, target, mode=0,
                                       degree=2, with_pose=True)
R["tiled_loss"] = loss.item()
for k, v in dict(param_paths(gt), q=gq, t=gtt).items():
    R[f"tg/{{k}}"] = v.numpy()
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    cfg2 = RenderConfig(**_cfg_kwargs(num_cameras=2))
    tr2 = FastRenderer(treg.make_scene("test_scene2"), cfg2,
                       dtype=torch.float64, grid_dtype=np.float64,
                       device="cpu")
    mask2 = stable_mask(tr2, Q2, T2)
    rng = np.random.default_rng(21)
    target = rng.uniform(0.0, 1.0, (1, H, W, 3))
    inputs = dict(target=target,
                  target_alpha=rng.uniform(0.0, 1.0, (1, H, W, 1)),
                  w2=rng.standard_normal((2, H, W, 3)) * mask2)
    np.savez(tmp / "inputs.npz", **inputs)
    children = Ranks(tmp, CHILD, world=2)

    # The JAX side while the ranks run.
    kw = dict(dtype=jnp.float64, grid_dtype=np.float64, interpret=True)
    jr = JaxFastRenderer(jreg.make_scene("test_scene2"),
                         JaxRenderConfig(**_cfg_kwargs()), **kw)
    q, t = jnp.asarray(Q), jnp.asarray(T)
    want = {k: np.asarray(v) for k, v in jax.jit(
        lambda p: jr.render_all_modes(p, q, t, degree=2))(
            jr.init_params).items()}
    img, alpha = jax.jit(lambda p: jr.render_with_alpha(
        p, q, t, mode=0, degree=2, beta=BETA))(jr.init_params)
    comp = np.asarray(alpha) * np.asarray(img)
    want["sil_loss"] = (np.mean((comp - target) ** 2) + np.mean(
        (np.asarray(alpha) - inputs["target_alpha"]) ** 2))

    def mse(p, q, t):
        return jnp.mean((jr.render(p, q, t, mode=0, degree=2) - target) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(mse, argnums=(0, 1, 2)))
    loss0, (g0, gq, gt) = value_and_grad(jr.init_params, q, t)
    want["tiled_loss"] = float(loss0)
    want["tg"] = dict(jgraph.param_paths(g0), q=gq, t=gt)
    opt = optax.adam(LR)
    params, state = jr.init_params, opt.init(jr.init_params)
    grads, want["losses"] = g0, [float(loss0)]
    for i in range(2):
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        if i == 0:
            loss1, (grads, _, _) = value_and_grad(params, q, t)
            want["losses"].append(float(loss1))
    want["params"] = jgraph.param_paths(params)

    jr2 = JaxFastRenderer(jreg.make_scene("test_scene2"),
                          JaxRenderConfig(**_cfg_kwargs(num_cameras=2)), **kw)
    want["cam"] = {k: np.asarray(v) for k, v in jax.jit(
        lambda p: jr2.render_all_modes(p, jnp.asarray(Q2), jnp.asarray(T2),
                                       degree=2))(jr2.init_params).items()}
    mask = stable_mask(FastRenderer(
        treg.make_scene("test_scene2"), RenderConfig(**_cfg_kwargs()),
        dtype=torch.float64, grid_dtype=np.float64, device="cpu"), Q, T)
    return children.results(), want, mask, mask2


def _close_frame(got, want, mask, label):
    m = np.broadcast_to(mask, want.shape)
    assert m.mean() > 0.5
    np.testing.assert_allclose(got[m], want[m], rtol=1e-9, atol=1e-11,
                               equal_nan=True, err_msg=label)


def _close_grads(got, want, label):
    for path, w in want.items():
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[path].reshape(w.shape), w, rtol=1e-7,
                                   atol=1e-9 * scale,
                                   err_msg=f"{label} {path}")


def test_fast_train_step_matches_optax(run):
    """Two sharded steps: the losses and the parameters of optax.adam on
    JAX's gradients, and the parameters equal bit for bit on both ranks."""
    results, want, _, _ = run
    for r in results:
        np.testing.assert_allclose([r["loss0"], r["loss1"]], want["losses"],
                                   rtol=1e-6)
        for path, w in want["params"].items():
            np.testing.assert_allclose(r[f"p/{path}"], np.asarray(w),
                                       rtol=1e-6, atol=1e-12, err_msg=path)
    for path in want["params"]:
        np.testing.assert_array_equal(results[0][f"p/{path}"],
                                      results[1][f"p/{path}"])


def test_silhouette_step_matches_one_process(run):
    """The sharded silhouette objective equals JAX's on the same render, and
    its step equals the same Adam step on the one-process image-space
    objective."""
    results, want, _, _ = run
    for r in results:
        np.testing.assert_allclose(r["sil_loss"], want["sil_loss"],
                                   rtol=1e-9)
        np.testing.assert_allclose(r["sil_loss"], r["sil_loss_local"],
                                   rtol=1e-9)
        for k in (k[4:] for k in r if k.startswith("sil/")):
            np.testing.assert_allclose(r[f"sil/{k}"], r[f"sil_local/{k}"],
                                       rtol=1e-6, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("mode", CAMERA_MODES)
def test_two_cameras_one_shard_each(run, mode):
    """Each shard takes its camera's pose row (vignette and tangent read
    it): the frames of JAX's two-camera render."""
    results, want, _, mask2 = run
    for r in results:
        _close_frame(r[f"cam{mode}"], want["cam"][MODES[mode]], mask2,
                     MODES[mode])


def test_two_camera_gradients_reach_each_pose_row(run):
    """Parameter and pose gradients summed over the ranks equal the
    one-process gradients: each camera's pose row gets its shard's share."""
    results, _, _, _ = run
    for r in results:
        local = {k[9:]: v for k, v in r.items() if k.startswith("cg_local/")}
        assert {"q", "t"} <= set(local)
        _close_grads({k: r[f"cg/{k}"] for k in local}, local, "two cameras")
        assert np.all(local["q"].any(axis=1))  # both rows carry gradient


@pytest.mark.parametrize("mode", TILED_MODES)
def test_tiled_mesh_frames_match_jax(run, mode):
    """Strips of 12 rows (the last 8), each row-sharded over the two ranks;
    the normalized modes merge bounds reduced across the ranks."""
    results, want, mask, _ = run
    for r in results:
        _close_frame(r[f"tiled{mode}"], want[MODES[mode]], mask, MODES[mode])


def test_tiled_mesh_loss_and_grad_matches_jax(run):
    """The strip-summed loss and its parameter and pose gradients, summed
    across the ranks: JAX's one-pass mean squared error and jax.grad."""
    results, want, _, _ = run
    for r in results:
        np.testing.assert_allclose(r["tiled_loss"], want["tiled_loss"],
                                   rtol=1e-9)
        _close_grads({k: r[f"tg/{k}"] for k in want["tg"]}, want["tg"],
                     "tiled")
