"""The port's cross-shard reductions against the JAX package's, f64 on the
CPU: ``utils.prmin``/``prmax`` over a gloo process group of two child ranks
against ``ray_marching_tpu.utils.prmin``/``prmax`` under ``shard_map`` on two
virtual CPU devices, and the modular shaders' ``axis_names`` branch
(modes 0, 1, 2 and 5, as tests/test_shader_collectives.py drives the JAX
one) against the JAX renderer's single-device frames and gradients.

Tolerances. ``prmin``/``prmax``: rtol 1e-15 (the same selects, one sum of
two cotangents and one division). Frames: rtol 1e-9, atol 1e-11 on stable
pixels; gradients of a weighted pixel sum (weights on stable pixels only):
rtol 1e-7, atol 1e-9 of the leaf's largest entry, as
tests/test_torch_pipeline.py holds the one-process pipeline to JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ray_marching_tpu import utils as jutils
from ray_marching_tpu.parallel.sharding import make_mesh as j_make_mesh
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.render.shaders import MODES
from ray_marching_tpu_torch.scene import registry as treg
from test_torch_ranks import Ranks

PX = 3.45e-6
W = H = 32
STEPS = 12
Q = np.asarray([[0.1, 0.03, 0.99, 0.03]])
Q = Q / np.linalg.norm(Q)
T = np.asarray([[0.1, 0.2, 2.0]])
SHADER_MODES = (0, 1, 2, 5)

# Per-shard values: the min tied inside shard 0 / across the shards, the
# max likewise, and an untied case.
TIES = {
    "inside": [[3.0, 1.0, 1.0, 9.0], [4.0, 2.0, 6.0, 7.0]],
    "across": [[1.0, 3.0, 7.0, 2.0], [5.0, 1.0, 7.0, 4.0]],
    "none": [[3.0, 1.5, 8.0, 2.0], [5.0, 1.0, 7.0, 4.0]],
}
# Each shard's loss weights its min and its max by its own constants, so
# the cotangents differ across the ranks and must be summed.
C_MIN = [1.5, -0.5]
C_MAX = [0.25, 2.0]


def _cfg_kwargs():
    return dict(px_width=W, px_height=H, focal_length=PX * H,
                sensor_width=PX * W, sensor_height=PX * H,
                marching_steps=STEPS)


CHILD = f"""
from ray_marching_tpu_torch import utils
from ray_marching_tpu_torch.parallel.sharding import (
    allreduce_sum, make_mesh, mesh_groups)
from ray_marching_tpu_torch.render import march as march_mod
from ray_marching_tpu_torch.render import shaders
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.graph import map_params, param_paths

mesh = make_mesh((2,), ("rows",), device_type="cpu")
groups = mesh_groups(mesh)
ties = {TIES!r}
for name, shards in ties.items():
    x = torch.tensor(shards[rank], dtype=torch.float64, requires_grad=True)
    lo, hi = utils.prmin(x, groups), utils.prmax(x, groups)
    (lo * {C_MIN!r}[rank] + hi ** 2 * {C_MAX!r}[rank]).backward()
    R[f"{{name}}_min"], R[f"{{name}}_max"] = lo.item(), hi.item()
    R[f"{{name}}_grad"] = x.grad.numpy()

r = Renderer(registry.make_scene("test_scene2"),
             RenderConfig(**{_cfg_kwargs()!r}), dtype=torch.float64,
             grid_dtype=np.float64, device="cpu")
q = torch.tensor({Q.tolist()!r}, dtype=torch.float64)
t = torch.tensor({T.tolist()!r}, dtype=torch.float64)
rows = slice(rank * {H // 2}, (rank + 1) * {H // 2})
weights = np.load(out + "/weights.npz")
for mode in {SHADER_MODES!r}:
    p = map_params(r.init_params, lambda v: v.clone().requires_grad_(True))
    work = param_paths(p)
    pixel_pos, frames, ray_pos, ray_dirs = r.camera.pose(q, t)
    pixel_pos, ray_pos, ray_dirs = (a[:, rows] for a in
                                    (pixel_pos, ray_pos, ray_dirs))
    coords = march_mod.march(r.sdf_vec, p, ray_pos, ray_dirs, {STEPS})
    dists = r.sdf_vec(p, coords)
    normals, lap = r.normals(r.sdf_vec, p, coords)
    img = shaders.shade(mode, px_coords=pixel_pos, camera_orientation=q,
                        pixel_frames=frames, ray_directions=ray_dirs,
                        surface_coords=coords, surface_normals=normals,
                        surface_laplacian=lap, surface_distances=dists,
                        cyclic_cmap=r.cyclic_cmap, degree=1,
                        axis_names=groups)
    w = torch.as_tensor(weights[f"w{{mode}}"][:, rows])
    torch.sum(torch.nan_to_num(img * w, nan=0.0)).backward()
    R[f"img{{mode}}"] = img.detach().numpy()
    grads = allreduce_sum([work[k].grad for k in sorted(work)], groups)
    for k, g in zip(sorted(work), grads):
        R[f"g{{mode}}/{{k}}"] = g.numpy()
"""


def _stable_mask():
    """Stable pixels of the one-process port frame (rays that converged,
    |d| < 1e-2, within |p| < 10), (1, H, W, 1)."""
    r = Renderer(treg.make_scene("test_scene2"), RenderConfig(**_cfg_kwargs()),
                 dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    _, _, ray_pos, ray_dirs = r.camera.pose(torch.as_tensor(Q),
                                            torch.as_tensor(T))
    from ray_marching_tpu_torch.render import march as tmarch

    coords = tmarch.march(r.sdf_vec, r.init_params, ray_pos, ray_dirs, STEPS)
    d = r.sdf_vec(r.init_params, coords)
    stable = (d.abs() < 1e-2) & (coords.norm(dim=-1, keepdim=True) < 10)
    return stable.numpy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    mask = _stable_mask()
    rng = np.random.default_rng(7)
    weights = {f"w{m}": rng.standard_normal((1, H, W, 1)) * mask
               for m in SHADER_MODES}
    np.savez(tmp / "weights.npz", **weights)
    children = Ranks(tmp, CHILD, world=2)
    # The JAX side while the ranks run.
    jr = JaxRenderer(jreg.make_scene("test_scene2"),
                     JaxRenderConfig(**_cfg_kwargs()), dtype=jnp.float64,
                     grid_dtype=np.float64)
    q, t = jnp.asarray(Q), jnp.asarray(T)
    images = jax.jit(lambda p: jr.render_all_modes(p, q, t, degree=1))(
        jr.init_params)
    want = {}
    for mode in SHADER_MODES:
        def loss(params, mode=mode):
            img = jr.render(params, q, t, mode=mode, degree=1)[..., :1]
            return jnp.sum(jnp.nan_to_num(img * weights[f"w{mode}"],
                                          nan=0.0))

        want[f"img{mode}"] = np.asarray(images[MODES[mode]])
        want[f"g{mode}"] = jgraph.param_paths(
            jax.jit(jax.grad(loss))(jr.init_params))
    return children.results(), want, mask


def _jax_cross_shard(shards):
    """JAX's prmin/prmax of the two shards under shard_map on two virtual
    devices: values and the gradient of the summed per-shard losses."""
    mesh = j_make_mesh((2,), ("x",), devices=jax.devices()[:2])
    c_min, c_max = jnp.asarray(C_MIN), jnp.asarray(C_MAX)

    def local(xs, a, b):
        lo = jutils.prmin(xs, ("x",))
        hi = jutils.prmax(xs, ("x",))
        return (lo * a[0] + hi ** 2 * b[0])[None], lo[None], hi[None]

    # check_vma=False as in JAX's fast_sharding: with the checker on, the
    # cast of the replicated extremum to a per-shard value transposes to a
    # psum of its own, and prmin's backward would sum the cotangents twice.
    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("x"),) * 3,
                       out_specs=(P("x"), P("x"), P("x")), check_vma=False)
    x = jnp.asarray(np.concatenate(shards))
    _, lo, hi = fn(x, c_min, c_max)
    grad = jax.grad(lambda v: jnp.sum(fn(v, c_min, c_max)[0]))(x)
    return float(lo[0]), float(hi[0]), np.asarray(grad).reshape(2, -1)


@pytest.mark.parametrize("case", sorted(TIES))
def test_prmin_prmax_match_jax(ranks, case):
    """The value on both ranks and each rank's cotangent: the summed
    cotangents split over every arg-extremum element of both shards."""
    results, _, _ = ranks
    lo, hi, grad = _jax_cross_shard(TIES[case])
    for rank, got in enumerate(results):
        assert got[f"{case}_min"] == lo and got[f"{case}_max"] == hi
        np.testing.assert_allclose(got[f"{case}_grad"], grad[rank],
                                   rtol=1e-15, atol=0)
    if case == "across":  # the tie split reaches both ranks
        assert all(np.count_nonzero(g[f"{case}_grad"]) == 2 for g in results)


@pytest.mark.parametrize("mode", SHADER_MODES)
def test_shader_axis_names_match_jax(ranks, mode):
    """Row shards shaded with ``axis_names`` assemble into the JAX
    single-device frame, and the gradients summed over the ranks equal
    JAX's."""
    results, want, mask = ranks
    img = np.concatenate([r[f"img{mode}"] for r in results], axis=1)
    img = np.broadcast_to(img, want[f"img{mode}"].shape)
    m = np.broadcast_to(mask, img.shape)
    assert m.mean() > 0.3
    np.testing.assert_allclose(img[m], want[f"img{mode}"][m], rtol=1e-9,
                               atol=1e-11)
    for path, w in want[f"g{mode}"].items():
        w = np.asarray(w)
        for r in results:
            g = r[f"g{mode}/{path}"].reshape(w.shape)
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-9 * scale,
                                       err_msg=f"mode {mode} {path}")
