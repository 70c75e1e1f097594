"""The port's sharded fast path (``parallel/fast_sharding.py``) against the
JAX FastRenderer (Pallas kernels in interpret mode), f64 on the CPU:
test_scene2, 12 steps, 48×32, row shards over a gloo group of child ranks
(two, four for the 2×2 mesh), the kernels' plain versions on each rank.

The JAX side is its one-process renderer, which JAX's own
tests/test_sharding_fast.py holds equal to its sharded one. Each rank also
renders in one process, so the port's sharded results are held against the
port's own one-process ones too, at the same tolerances (not bitwise on the
CPU: torch's vectorised CPU transcendentals treat a tensor's tail
differently, and a shard's tail is elsewhere).

Tolerances, as tests/test_torch_fast.py and tests/test_torch_train.py hold
the one-process port: frames rtol 1e-9, atol 1e-11 on stable pixels (rays
that converged, |d| < 1e-2, within |p| < 10); gradients of a weighted pixel
sum (weights on stable pixels only) rtol 1e-7, atol 1e-9 of the leaf's
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.parallel import fast_sharding as fs
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
GRAD_MODES = (0, 1, 2, 5)
BETA = 0.05


def _cfg_kwargs(**kw):
    return dict(px_width=W, px_height=H, focal_length=PX * H,
                sensor_width=PX * W, sensor_height=PX * H,
                marching_steps=STEPS, **kw)


# Runs on every rank: the sharded results, and the one-process ones.
CHILD = f"""
from ray_marching_tpu_torch.parallel import fast_sharding as fs
from ray_marching_tpu_torch.parallel.sharding import allreduce_sum, make_mesh
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.graph import map_params, param_paths

mesh = make_mesh(tuple(MESH), AXES, device_type="cpu")
f = FastRenderer(registry.make_scene("test_scene2"),
                 RenderConfig(**{_cfg_kwargs()!r}), dtype=torch.float64,
                 grid_dtype=np.float64, device="cpu",
                 row_multiple=8 * mesh.size())
q = torch.tensor({Q.tolist()!r}, dtype=torch.float64)
t = torch.tensor({T.tolist()!r}, dtype=torch.float64)
data = np.load(out + "/../inputs.npz")
for mode in FRAME_MODES:
    R[f"frame{{mode}}"] = fs.fast_shard_render(f, mesh, mode=mode, degree=2)(
        f.init_params, q, t).numpy()
    R[f"local{{mode}}"] = f.render(f.init_params, q, t, mode=mode,
                                   degree=2).numpy()
if WITH_ALPHA:
    img, alpha = fs.fast_shard_render_with_alpha(f, mesh, mode=0, degree=2,
                                                 beta={BETA})(
        f.init_params, q, t)
    R["alpha_img"], R["alpha"] = img.numpy(), alpha.numpy()
    img, alpha = f.render_with_alpha(f.init_params, q, t, mode=0, degree=2,
                                     beta={BETA})
    R["alpha_img_local"], R["alpha_local"] = img.numpy(), alpha.numpy()


def grads_of(loss_of):
    p = map_params(f.init_params, lambda v: v.clone().requires_grad_(True))
    qq, tt = q.clone().requires_grad_(True), t.clone().requires_grad_(True)
    leaves = param_paths(p)
    got = torch.autograd.grad(loss_of(p, qq, tt),
                              list(leaves.values()) + [qq, tt])
    return dict(zip(list(leaves) + ["q", "t"], got))


for mode in GRAD_MODES:
    w = torch.as_tensor(data[f"w{{mode}}"])
    chan = fs.make_channel_fn(f, mesh, mode=mode, degree=2)
    wp = f.image_to_planes(w)[:, chan.rows]
    g = grads_of(lambda p, qq, tt: torch.sum(
        torch.nan_to_num(chan(p, qq, tt) * wp, nan=0.0)))
    allreduce_sum(list(g.values()), fs.mesh_groups(mesh))
    g1 = grads_of(lambda p, qq, tt: torch.sum(torch.nan_to_num(
        f.render(p, qq, tt, mode=mode, degree=2) * w, nan=0.0)))
    for k in g:
        R[f"g{{mode}}/{{k}}"] = g[k].numpy()
        R[f"lg{{mode}}/{{k}}"] = g1[k].numpy()
if REJECTS:
    three = FastRenderer(registry.make_scene("test_scene2"),
                         RenderConfig(**{_cfg_kwargs(num_cameras=3)!r}),
                         dtype=torch.float64, device="cpu")
    try:
        fs.fast_shard_render(three, mesh, mode=0)
    except ValueError as exc:
        R["three_cameras"] = str(exc)
    # 32×32: 8 rows, one 8-row group for two ranks.
    square = FastRenderer(registry.make_scene("test_scene2"),
                          RenderConfig(px_width=32, px_height=32,
                                       marching_steps=4),
                          dtype=torch.float64, device="cpu")
    try:
        fs.make_channel_fn(square, mesh)
    except ValueError as exc:
        R["row_multiple"] = str(exc)
"""


def _child(mesh, axes, frame_modes, grad_modes=(), with_alpha=False,
           rejects=False):
    return (f"MESH, AXES = {tuple(mesh)!r}, {tuple(axes)!r}\n"
            f"FRAME_MODES, GRAD_MODES = {tuple(frame_modes)!r}, "
            f"{tuple(grad_modes)!r}\n"
            f"WITH_ALPHA, REJECTS = {with_alpha!r}, {rejects!r}\n" + CHILD)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_fast")
    tr = FastRenderer(treg.make_scene("test_scene2"),
                      RenderConfig(**_cfg_kwargs()), dtype=torch.float64,
                      grid_dtype=np.float64, device="cpu")
    mask = stable_mask(tr, Q, T)
    rng = np.random.default_rng(11)
    weights = {f"w{m}": rng.standard_normal((1, H, W, 3)) * mask
               for m in GRAD_MODES}
    np.savez(tmp / "inputs.npz", **weights)
    two = Ranks(tmp / "two", _child((2,), ("rows",), range(8), GRAD_MODES,
                                    with_alpha=True, rejects=True), world=2)
    four = Ranks(tmp / "four", _child((2, 2), ("host", "chip"), (1, 2)),
                 world=4)
    # The JAX side while the ranks run.
    jr = JaxFastRenderer(jreg.make_scene("test_scene2"),
                         JaxRenderConfig(**_cfg_kwargs()), dtype=jnp.float64,
                         grid_dtype=np.float64, interpret=True)
    q, t = jnp.asarray(Q), jnp.asarray(T)
    want = {k: np.asarray(v) for k, v in jax.jit(
        lambda p: jr.render_all_modes(p, q, t, degree=2))(
            jr.init_params).items()}
    img, alpha = jax.jit(lambda p: jr.render_with_alpha(
        p, q, t, mode=0, degree=2, beta=BETA))(jr.init_params)
    want["alpha_img"], want["alpha"] = np.asarray(img), np.asarray(alpha)
    for mode in GRAD_MODES:
        w = jnp.asarray(weights[f"w{mode}"])

        def loss(p, q, t, mode=mode, w=w):
            img = jr.render(p, q, t, mode=mode, degree=2)
            return jnp.sum(jnp.nan_to_num(img * w, nan=0.0))

        gp, gq, gt = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            jr.init_params, q, t)
        want[f"g{mode}"] = dict(jgraph.param_paths(gp), q=gq, t=gt)
    return two.results(), four.results(), want, mask


def _assert_frame(got, want, mask, label):
    m = np.broadcast_to(mask, want.shape)
    assert m.mean() > 0.5
    np.testing.assert_allclose(got[m], want[m], rtol=1e-9, atol=1e-11,
                               equal_nan=True, err_msg=label)


def _assert_grads(got, want, label):
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].reshape(w.shape)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=f"{label} {path}")


@pytest.mark.parametrize("mode", range(8))
def test_sharded_frames_match_jax(run, mode):
    """Every rank assembles the whole frame, equal to JAX's and to the
    port's one-process frame."""
    two, _, want, mask = run
    for r in two:
        _assert_frame(r[f"frame{mode}"], want[MODES[mode]], mask, MODES[mode])
        _assert_frame(r[f"frame{mode}"], r[f"local{mode}"], mask,
                      f"{MODES[mode]} vs one process")
    np.testing.assert_array_equal(two[0][f"frame{mode}"],
                                  two[1][f"frame{mode}"])


@pytest.mark.parametrize("mode", [1, 2])
def test_sharded_frames_on_a_2x2_mesh(run, mode):
    """Four ranks on a ("host", "chip") mesh: the reductions run over both
    of its process groups in turn."""
    _, four, want, mask = run
    for r in four:
        _assert_frame(r[f"frame{mode}"], want[MODES[mode]], mask, MODES[mode])
        _assert_frame(r[f"frame{mode}"], r[f"local{mode}"], mask,
                      "vs one process")


def test_sharded_render_with_alpha_matches_jax(run):
    two, _, want, mask = run
    for r in two:
        _assert_frame(r["alpha_img"], want["alpha_img"], mask, "image")
        _assert_frame(r["alpha"], want["alpha"], mask, "alpha")
        _assert_frame(r["alpha"], r["alpha_local"], mask, "alpha local")


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_sharded_gradients_match_jax(run, mode):
    """d sum(channels · w) / d (every leaf, q, t): each rank's share through
    its backward, summed by the all-reduce, against jax.grad of the
    one-process render and the port's one-process gradient (the
    normalized modes route their cotangent through prmin/prmax)."""
    two, _, want, _ = run
    for r in two:
        got = {k: r[f"g{mode}/{k}"] for k in want[f"g{mode}"]}
        local = {k: r[f"lg{mode}/{k}"] for k in want[f"g{mode}"]}
        _assert_grads(got, want[f"g{mode}"], f"mode {mode}")
        _assert_grads(got, local, f"mode {mode} vs one process")
    for k in want[f"g{mode}"]:  # the all-reduce hands every rank one sum
        np.testing.assert_array_equal(two[0][f"g{mode}/{k}"],
                                      two[1][f"g{mode}/{k}"])


def test_bad_rank_counts_are_rejected(run):
    """Three cameras over two ranks, and rows that two ranks cannot split
    into whole 8-row groups, as JAX's ``_check_rows`` rejects them."""
    two, _, _, _ = run
    assert "multiple of the camera count" in str(two[0]["three_cameras"])
    assert "row_multiple=16" in str(two[0]["row_multiple"])


def test_check_rows_reads_only_the_mesh_size():
    """``_check_rows`` needs the mesh's size alone, so it runs in one
    process: 16 rows per camera do not split into three ranks' 8-row
    groups; ``row_multiple=24`` pads them to 24."""
    class Sized:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    f = FastRenderer(treg.make_scene("test_scene2"),
                     RenderConfig(**_cfg_kwargs()), dtype=torch.float64,
                     device="cpu")
    fs._check_rows(f, Sized(1))
    with pytest.raises(ValueError, match="row_multiple=24"):
        fs._check_rows(f, Sized(3))
    g = FastRenderer(treg.make_scene("test_scene2"),
                     RenderConfig(**_cfg_kwargs()), dtype=torch.float64,
                     device="cpu", row_multiple=24)
    assert g.rows_per_cam % 24 == 0
    fs._check_rows(g, Sized(3))
