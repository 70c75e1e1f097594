"""The port's sharded modular pipeline (``parallel/sharding.py``:
``shard_render``, ``make_train_step``) against the JAX package's on two
virtual CPU devices, f64, over a gloo group of two child ranks: the rays of
test_scene2 (32×32, 12 steps) sharded by columns on a ("rows", "cols") mesh
of shape (1, 2) and by cameras on a ("dp", "rows") mesh of shape (2, 1).

Tolerances (as tests/test_torch_pipeline.py and tests/test_torch_optimize.py
hold the one-process port): frames rtol 1e-9, atol 1e-11 on stable pixels;
the whole image's MSE rtol 1e-9 and its gradients rtol 1e-7, atol 1e-9 of
the leaf's largest entry; loss and parameters after an Adam step rtol 1e-6,
atol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_marching_tpu.parallel import sharding as jsharding
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.render import march as tmarch
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.scene import registry as treg
from test_torch_ranks import Ranks

PX = 3.45e-6
W = H = 32
STEPS = 12
Q2 = np.asarray([[0.1, 0.03, 0.99, 0.03], [0.9914449, 0.0, 0.1305262, 0.0]])
Q2 = Q2 / np.linalg.norm(Q2, axis=-1, keepdims=True)
T2 = np.asarray([[0.1, 0.2, 2.0], [0.3, 0.1, 2.2]])
LR = 0.02
MODE = 1  # distance: its normalization reduces across the ranks
# mesh name -> (shape, axis names, cameras)
MESHES = {"cols": ((1, 2), ("rows", "cols"), 1),
          "dp": ((2, 1), ("dp", "rows"), 2)}


def _cfg_kwargs(cameras):
    return dict(px_width=W, px_height=H, focal_length=PX * H,
                sensor_width=PX * W, sensor_height=PX * H,
                marching_steps=STEPS, num_cameras=cameras)


CHILD = f"""
import functools
from ray_marching_tpu_torch.parallel import make_mesh, make_train_step
from ray_marching_tpu_torch.parallel import sharding
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.graph import map_params, param_paths

data = np.load(out + "/inputs.npz")
for name, (shape, axes, cams) in {MESHES!r}.items():
    mesh = make_mesh(shape, axes, device_type="cpu")
    r = Renderer(registry.make_scene("test_scene2"),
                 RenderConfig(**dict({_cfg_kwargs(1)!r}, num_cameras=cams)),
                 dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    q = torch.tensor({Q2.tolist()!r}[:cams], dtype=torch.float64)
    t = torch.tensor({T2.tolist()!r}[:cams], dtype=torch.float64)
    target = torch.as_tensor(data[f"target_{{name}}"])
    R[f"{{name}}_frame"] = sharding.shard_render(r, mesh, mode={MODE})(
        r.init_params, q, t).numpy()
    R[f"{{name}}_block"] = [s.start for s in sharding.ray_partition_spec(
        mesh, (cams, {H}, {W}, 3))]
    # The whole image's MSE through the rank's block, its gradients summed.
    render_block = sharding._block_renderer(r, mesh, {MODE}, 1, None)
    p = map_params(r.init_params, lambda v: v.clone().requires_grad_(True))
    img, block = render_block(p, q, t)
    loss = torch.sum((img - target[block]) ** 2) / target.numel()
    grads = torch.autograd.grad(loss, list(param_paths(p).values()))
    sharding.allreduce_sum([loss.detach()] + list(grads),
                           sharding.ray_groups(mesh))
    R[f"{{name}}_loss"] = loss.item()
    for k, g in zip(param_paths(p), grads):
        R[f"{{name}}_g/{{k}}"] = g.numpy()
    step = make_train_step(r, mesh, functools.partial(torch.optim.Adam,
                                                      lr={LR}), mode={MODE})
    p1, _, loss = step(r.init_params, None, target, q, t)
    R[f"{{name}}_step_loss"] = loss.item()
    for k, v in param_paths(p1).items():
        R[f"{{name}}_p/{{k}}"] = v.numpy()
"""


def _stable(cameras, q, t):
    r = Renderer(treg.make_scene("test_scene2"),
                 RenderConfig(**_cfg_kwargs(cameras)), dtype=torch.float64,
                 grid_dtype=np.float64, device="cpu")
    _, _, pos, dirs = r.camera.pose(torch.as_tensor(q), torch.as_tensor(t))
    coords = tmarch.march(r.sdf_vec, r.init_params, pos, dirs, STEPS)
    d = r.sdf_vec(r.init_params, coords)
    return ((d.abs() < 1e-2)
            & (coords.norm(dim=-1, keepdim=True) < 10)).numpy()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_modular")
    rng = np.random.default_rng(31)
    targets = {f"target_{name}": rng.uniform(0.0, 1.0, (cams, H, W, 3))
               for name, (_, _, cams) in MESHES.items()}
    np.savez(tmp / "inputs.npz", **targets)
    children = Ranks(tmp, CHILD, world=2)
    want = {}
    for name, (shape, axes, cams) in MESHES.items():
        jr = JaxRenderer(jreg.make_scene("test_scene2"),
                         JaxRenderConfig(**_cfg_kwargs(cams)),
                         dtype=jnp.float64, grid_dtype=np.float64)
        mesh = jsharding.make_mesh(shape, axes, devices=jax.devices()[:2])
        q, t = jnp.asarray(Q2[:cams]), jnp.asarray(T2[:cams])
        target = jnp.asarray(targets[f"target_{name}"])
        render = jsharding.shard_render(jr, mesh, mode=MODE, degree=1)
        want[f"{name}_frame"] = np.asarray(render(jr.init_params, q, t))
        loss, grads = jax.value_and_grad(
            lambda p: jnp.mean((render(p, q, t) - target) ** 2))(
                jr.init_params)
        want[f"{name}_loss"] = float(loss)
        want[f"{name}_g"] = jgraph.param_paths(grads)
        opt = optax.adam(LR)
        step = jsharding.make_train_step(jr, mesh, opt, mode=MODE, degree=1)
        p1, _, loss = step(jr.init_params, opt.init(jr.init_params), target,
                           q, t)
        want[f"{name}_step_loss"] = float(loss)
        want[f"{name}_p"] = jgraph.param_paths(p1)
        want[f"{name}_mask"] = _stable(cams, Q2[:cams], T2[:cams])
    return children.results(), want


@pytest.mark.parametrize("name", sorted(MESHES))
def test_shard_render_matches_jax(run, name):
    """Each rank renders its block (columns, or a camera) and gathers the
    whole frame: JAX's sharded frame."""
    results, want = run
    m = np.broadcast_to(want[f"{name}_mask"], want[f"{name}_frame"].shape)
    assert m.mean() > 0.3
    for r in results:
        np.testing.assert_allclose(r[f"{name}_frame"][m],
                                   want[f"{name}_frame"][m], rtol=1e-9,
                                   atol=1e-11)
    # The two ranks' blocks: (camera, row, col) starts by mesh coordinate.
    blocks = [tuple(r[f"{name}_block"]) for r in results]
    assert blocks == ([(0, 0, 0), (0, 0, 16)] if name == "cols"
                      else [(0, 0, 0), (1, 0, 0)])


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_loss_and_gradients_match_jax(run, name):
    results, want = run
    for r in results:
        np.testing.assert_allclose(r[f"{name}_loss"], want[f"{name}_loss"],
                                   rtol=1e-9)
        for path, w in want[f"{name}_g"].items():
            w = np.asarray(w)
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(r[f"{name}_g/{path}"].reshape(w.shape),
                                       w, rtol=1e-7, atol=1e-9 * scale,
                                       err_msg=path)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_make_train_step_matches_jax(run, name):
    """One Adam step: JAX's loss and parameters, and the same parameters
    bit for bit on both ranks."""
    results, want = run
    for r in results:
        np.testing.assert_allclose(r[f"{name}_step_loss"],
                                   want[f"{name}_step_loss"], rtol=1e-6)
        for path, w in want[f"{name}_p"].items():
            np.testing.assert_allclose(r[f"{name}_p/{path}"], np.asarray(w),
                                       rtol=1e-6, atol=1e-12, err_msg=path)
    for path in want[f"{name}_p"]:
        np.testing.assert_array_equal(results[0][f"{name}_p/{path}"],
                                      results[1][f"{name}_p/{path}"])
