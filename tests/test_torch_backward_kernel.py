"""The port's backward of the fused march + normals: its plain PyTorch
version against the JAX ``fused_backward`` (Pallas kernel in interpret mode)
and against whole-graph autograd, the history handoff, the two-level
recompute, the march-only mode, the wrapper's checks and the op count of its
bound. The CUDA kernel itself is held against the
plain version by the ``cuda`` tests, which skip without a card, and by
chip_smoke.py.

Tolerance vs JAX (f64, the same rays and cotangents): rtol 1e-7, atol 1e-10
on the ray cotangents of stable rays (terminal |d| < 1e-2, |p| < 10) and on
the parameter cotangent. Both run the same algorithm; the VJP rules round
differently by an ulp per op (division, sqrt), and the parameter cotangent
sums the rays in another order. Only stable rays get a cotangent: a
diverged ray's gradient is astronomically large, and its rounding would
swamp the parameter cotangent of all the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.ops import pallas_backward as j_pb
from ray_marching_tpu.ops.pallas_backward import fused_backward as j_backward
from ray_marching_tpu.ops.pallas_march import _pallas_march_core
from ray_marching_tpu.ops.pallas_march import split_params_padded as j_split
from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.ops import backward_kernel as bk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram

STEPS = 10
EPS = 5e-2
ROWS = 16  # 2048 slots, about a 48×32 frame plus pad


def _rays(seed, rows=ROWS, dtype=np.float64):
    rng = np.random.default_rng(seed)
    n = rows * 128
    pos = rng.uniform(-2.0, 2.0, size=(3, n))
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    valid = np.ones((1, n))
    valid[:, -100:] = 0.0  # pad slots
    return np.concatenate([pos, d, valid]).reshape(7, rows, 128).astype(dtype)


def _cotangents(seed, planes, rows=ROWS, dtype=np.float64, mask=None):
    g = np.random.default_rng(seed).normal(size=(planes, rows, 128))
    return (g if mask is None else g * mask).astype(dtype)


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


def _stable(program, tflat, rays, tau):
    out = rk.reference_march_normals(program, tflat.detach(),
                                     torch.as_tensor(rays), STEPS, tau,
                                     EPS).numpy()
    return ((np.abs(out[3]) < 1e-2) & (np.sqrt((out[:3] ** 2).sum(0)) < 10)
            & (rays[6] > 0.5))


@pytest.mark.parametrize("track_min", [False, True], ids=["plain", "min_f"])
@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_plain_backward_matches_jax_kernel(scene, tau, track_min):
    name, (jsdf, rebuild, jflat, mats), program, tflat = scene
    rays = _rays(21)
    stable = _stable(program, tflat, rays, tau)
    assert stable.sum() >= 64, (name, stable.sum())
    g = _cotangents(22, 9 if track_min else 8, mask=stable)
    jg_flat, _, jg_rays = j_backward(
        jsdf, rebuild, jflat, mats, jnp.asarray(rays), jnp.asarray(g), STEPS,
        EPS, True, track_min=track_min, tau=tau)
    g_flat, _, g_rays = bk.fused_backward(
        program, tflat, torch.as_tensor(rays), torch.as_tensor(g), STEPS, tau,
        EPS, track_min=track_min)
    want = np.asarray(jg_rays)
    for i in range(7):
        np.testing.assert_allclose(
            g_rays.numpy()[i][stable], want[i][stable], rtol=1e-7, atol=1e-10,
            err_msg=f"{name} tau={tau} min_f={track_min} ray plane {i}")
    np.testing.assert_allclose(g_flat.numpy(), np.asarray(jg_flat), rtol=1e-7,
                               atol=1e-10, err_msg=f"{name} params")
    # Pad slots: zero cotangents, exactly.
    assert not g_rays.numpy()[:, rays[6] < 0.5].any()
    assert not g_rays.numpy()[6].any()


@pytest.mark.parametrize("track_min", [False, True], ids=["plain", "min_f"])
@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_plain_backward_matches_whole_graph_autograd(scene, tau, track_min):
    """On generic rays (no ties in min_f) the step-by-step backward equals
    autograd through the unrolled plain march."""
    _, _, program, tflat = scene
    rays = torch.as_tensor(_rays(23)).requires_grad_(True)
    flat = tflat.clone().requires_grad_(True)
    stable = _stable(program, tflat, rays.detach().numpy(), tau)
    g = torch.as_tensor(_cotangents(24, 9 if track_min else 8, mask=stable))
    stable = torch.as_tensor(stable)
    out, _ = rk._reference_march(program, flat, rays, STEPS, tau, EPS,
                                 track_min=track_min)
    want_flat, want_rays = torch.autograd.grad((out * g).sum(), [flat, rays])
    g_flat, _, g_rays = bk.reference_backward(program, flat, rays, g, STEPS,
                                              tau, EPS, track_min=track_min)
    torch.testing.assert_close(g_rays[:6][:, stable], want_rays[:6][:, stable],
                               rtol=1e-9, atol=1e-10)
    torch.testing.assert_close(g_flat, want_flat, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("track_min", [False, True], ids=["plain", "min_f"])
@pytest.mark.parametrize("tau", [0.0, 1e-3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_history_handoff_is_bitwise(scene, dtype, tau, track_min):
    """The forward's history and the backward's own recompute hold the same
    positions, so the two gradients are equal bit for bit (the CPU
    counterpart of what chip_smoke.py checks on the card)."""
    _, _, program, tflat = scene
    fn = rk.fused_march_normals_cov if track_min else rk.fused_march_normals
    g = torch.as_tensor(_cotangents(25, 9 if track_min else 8), dtype=dtype)
    grads = []
    for bwd_hist in (True, False):
        rays = torch.as_tensor(_rays(26), dtype=dtype).requires_grad_(True)
        flat = tflat.to(dtype).requires_grad_(True)
        out = fn(program, flat, rays, STEPS, tau, EPS, bwd_hist=bwd_hist)
        grads.append(torch.autograd.grad((out * g).sum(), [flat, rays]))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_min_f_ties_split_like_a_minimum_chain(scene):
    """A converged ray re-evaluates d == min_f at every later step. Going
    backwards, the backward halves the min_f cotangent at each tied step
    and gives the first attaining step the rest, as autodiff of
    minimum(minimum(...), d_i) does. Rays with direction 0 never move, so
    every step ties exactly: hold the parameter cotangent against autograd
    of that chain."""
    _, _, program, tflat = scene
    still = _rays(27)
    still[3:6] = 0.0
    valid = torch.as_tensor(still[6] > 0.5)
    flat = tflat.clone().requires_grad_(True)
    params = program.rebuild(flat)
    x, y, z = (torch.as_tensor(still[i]) for i in range(3))
    minf = torch.full_like(x, torch.finfo(torch.float64).max)
    for _ in range(STEPS):
        minf = torch.minimum(minf, program.sdf_c(params, x, y, z))
    (want,) = torch.autograd.grad(minf[valid].sum(), flat)
    g = np.zeros((9, ROWS, 128))
    g[8] = 1.0
    got, _, _ = bk.fused_backward(program, tflat, torch.as_tensor(still),
                                  torch.as_tensor(g), STEPS, 0.0, EPS,
                                  track_min=True)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("steps", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_level_is_bitwise_the_history_path(scene, dtype, steps):
    """Checkpoints every 8th position, segments marched again in the sweep:
    the same op sequence per ray and the same sweep order steps-1 .. 0 as
    with the history or the full recompute, so the same bits."""
    _, _, program, tflat = scene
    rays = torch.as_tensor(_rays(33), dtype=dtype)
    flat = tflat.detach().to(dtype)
    g = torch.as_tensor(_cotangents(34, 8), dtype=dtype)
    _, ex = rk.march_forward(program, flat, rays, steps, 0.0, EPS,
                             log_hist=True)
    with_hist = bk.fused_backward(program, flat, rays, g, steps, 0.0, EPS,
                                  hist=ex["hist"], nlive=ex["nlive"])
    assert bk.LAST_PATH == dict(use_hist=True, two_level=False, tau=0.0,
                                track_min=False)
    recomputed = bk.fused_backward(program, flat, rays, g, steps, 0.0, EPS)
    assert bk.LAST_PATH["use_hist"] is False
    # Asked for with a history in hand: the history is ignored.
    two_level = bk.fused_backward(program, flat, rays, g, steps, 0.0, EPS,
                                  hist=ex["hist"], nlive=ex["nlive"],
                                  two_level=True)
    assert bk.LAST_PATH == dict(use_hist=False, two_level=True, tau=0.0,
                                track_min=False)
    # NaN included: on the open test_scene the f32 gradients overflow, in
    # all three paths at the same places.
    for a, b, c in zip(with_hist[::2], recomputed[::2], two_level[::2]):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.isnan(), c.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(a.nan_to_num(), c.nan_to_num())


def test_two_level_replays_segments_from_checkpoints(scene):
    """The plain two-level version really keeps steps/8 checkpoints and
    marches each segment again (it is no alias of the history version): the
    SDF is evaluated steps times for the checkpoints and 7 of every 8 steps
    once more, and the sweep sees the history's positions in reverse."""
    _, _, program, tflat = scene
    rays = torch.as_tensor(_rays(35, rows=1))
    valid = (rays[6] > 0.5).reshape(-1)
    tflat = tflat.detach()
    _, ex = rk.march_forward(program, tflat, rays, 16, 0.0, EPS,
                             log_hist=True)
    calls = []

    def counting_sdf(params, x, y, z):
        calls.append(1)
        return program.sdf_c(params, x, y, z)

    start = [rays[i].reshape(-1)[valid] for i in range(3)]
    dirs = [rays[i].reshape(-1)[valid] for i in (3, 4, 5)]
    end, sweep = bk._two_level_positions(
        counting_sdf, program.rebuild(tflat), start, dirs, 16)
    assert len(calls) == 16
    seen = list(sweep)
    assert len(calls) == 16 + 2 * 7
    assert [s for s, _ in seen] == list(reversed(range(16)))
    for s, pos in seen:
        for c in range(3):
            assert torch.equal(pos[c], ex["hist"][s, c].reshape(-1)[valid])
    for c in range(3):
        assert torch.equal(end[c], ex["hist"][16, c].reshape(-1)[valid])


@pytest.mark.parametrize("steps,tau,track_min", [
    (16, 0.0, False), (32, 0.0, False), (128, 0.0, False), (8, 0.0, False),
    (12, 0.0, False), (20, 0.0, False), (0, 0.0, False), (16, 1e-3, False),
    (16, 0.0, True), (32, 1e-3, True)])
def test_two_level_engages_like_jax(monkeypatch, steps, tau, track_min):
    """The JAX rule with its environment switch on; with the switch off (the
    ``two_level`` argument false) the ordinary path runs whatever the rule
    says."""
    monkeypatch.setenv("RM_TPU_BWD_TWO_LEVEL", "1")
    assert bk.CKPT_INTERVAL == j_pb.CKPT_INTERVAL
    assert (bk.two_level_engages(steps, tau, track_min)
            == j_pb.two_level_engages(steps, tau, track_min))
    if steps:
        program = SdfProgram(treg.make_scene("test_scene2"))
        flat, _, _ = split_params_padded(
            tgraph.init_params(program.node, torch.float64), torch.float64)
        rays = torch.as_tensor(_rays(36, rows=1))
        g = torch.as_tensor(_cotangents(37, 9 if track_min else 8, rows=1))
        for asked in (True, False):
            bk.fused_backward(program, flat, rays, g, steps, tau, EPS,
                              track_min=track_min, two_level=asked)
            assert bk.LAST_PATH["two_level"] is (
                asked and bk.two_level_engages(steps, tau, track_min))


def test_two_level_matches_jax_two_level(monkeypatch):
    """Both packages' two-level backward through their FastRenderer (the JAX
    one with RM_TPU_BWD_TWO_LEVEL=1 and its kernels in interpret mode): f64
    gradients at rtol 1e-9 (the JAX package's own two-level against its
    history path holds the same tolerance, tests/test_fast.py). The forward
    logs no history when the two-level backward engages."""
    px = 3.45e-6
    kw = dict(px_width=48, px_height=32, focal_length=px * 32,
              sensor_width=px * 48, sensor_height=px * 32, marching_steps=16)
    jr = JaxFastRenderer(jreg.make_scene("test_scene2"), JaxRenderConfig(**kw),
                         dtype=jnp.float64, grid_dtype=np.float64,
                         interpret=True)
    tr = FastRenderer(treg.make_scene("test_scene2"), RenderConfig(**kw),
                      dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    q = np.asarray([[0.1, 0.03, 0.99, 0.03]])
    q = q / np.linalg.norm(q)
    t = np.asarray([[0.1, 0.2, 2.0]])
    wgt = np.random.default_rng(5).standard_normal((1, 32, 48, 3))
    monkeypatch.setenv("RM_TPU_BWD_TWO_LEVEL", "1")
    jg = jax.grad(lambda p: jnp.sum(jr.render(
        p, jnp.asarray(q), jnp.asarray(t), mode=0, degree=2) * wgt))(
            jr.init_params)
    assert j_pb.LAST_PATH["two_level"] is True

    def port_grads():
        params = tgraph.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jr.init_params), torch.float64)
        leaves = tgraph.param_paths(params)
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        (tr.render(params, q, t, mode=0, degree=2)
         * torch.as_tensor(wgt)).sum().backward()
        return {k: v.grad for k, v in leaves.items()}

    logged = []
    forward = rk.march_forward
    monkeypatch.setattr(rk, "march_forward", lambda *a, **k: (
        logged.append(k.get("log_hist")), forward(*a, **k))[1])
    monkeypatch.setattr(rk, "BWD_TWO_LEVEL", True)
    two_level = port_grads()
    assert bk.LAST_PATH["two_level"] is True and logged == [False]
    monkeypatch.setattr(rk, "BWD_TWO_LEVEL", False)
    history = port_grads()
    assert bk.LAST_PATH == dict(use_hist=True, two_level=False, tau=0.0,
                                track_min=False)
    assert logged == [False, True]
    want = jgraph.param_paths(jg)
    for k in want:
        assert torch.equal(two_level[k], history[k]), k
        np.testing.assert_allclose(two_level[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-11, err_msg=k)


@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_march_only_backward_matches_jax_march_vjp(scene, tau):
    """The plain version of the march-only mode against the VJP the JAX
    package gives its march kernel (a checkpointed scan)."""
    name, (jsdf, rebuild, jflat, mats), program, tflat = scene
    rays = _rays(38)
    stable = _stable(program, tflat, rays, tau)
    g = _cotangents(39, 4, mask=stable)
    _, vjp = jax.vjp(
        lambda f, r: _pallas_march_core(jsdf, rebuild, f, mats, r, STEPS, tau,
                                        True), jflat, jnp.asarray(rays))
    jg_flat, jg_rays = vjp(jnp.asarray(g))
    g_flat, _, g_rays = bk.march_backward(program, tflat.detach(),
                                       torch.as_tensor(rays),
                                       torch.as_tensor(g), STEPS, tau)
    want = np.asarray(jg_rays)
    for i in range(7):
        np.testing.assert_allclose(
            g_rays.numpy()[i][stable], want[i][stable], rtol=1e-7, atol=1e-10,
            err_msg=f"{name} tau={tau} ray plane {i}")
    np.testing.assert_allclose(g_flat.numpy(), np.asarray(jg_flat), rtol=1e-7,
                               atol=1e-10, err_msg=f"{name} params")
    assert not g_rays.numpy()[:, rays[6] < 0.5].any()


def test_backward_ops_count():
    program = SdfProgram(treg.make_scene("test_scene2"))
    ev, vjp = program.ops_per_eval, program.vjp_ops_per_eval
    assert (ev, vjp) == (65, 226)
    per_ray = 5 * vjp + bk.OPS_BWD_TAIL + 32 * (vjp + bk.OPS_BWD_STEP)
    assert per_ray == 8930
    assert bk.backward_ops(program, 1000, 32 * 1000) == 1000 * per_ray
    assert (bk.backward_ops(program, 1000, 32 * 1000, recomputed_steps=32000)
            == 1000 * (per_ray + 32 * (ev + rk.OPS_PER_STEP)))
    assert bk.OPS_BWD_TAIL == 120 and bk.OPS_BWD_STEP == 14


def _bad_args(kind, flat, rays, g):
    extras = {}
    if kind == "g_planes":
        g = g[:7]
    elif kind == "g_dtype":
        g = g.float()
    elif kind == "hist_without_nlive":
        extras = dict(hist=torch.zeros((STEPS + 1, 3, 8, 128),
                                       dtype=torch.float64))
    elif kind == "hist_shape":
        extras = dict(hist=torch.zeros((STEPS, 3, 8, 128),
                                       dtype=torch.float64),
                      nlive=torch.zeros((8, 128), dtype=torch.int32))
    elif kind == "nlive_dtype":
        extras = dict(hist=torch.zeros((STEPS + 1, 3, 8, 128),
                                       dtype=torch.float64),
                      nlive=torch.zeros((8, 128), dtype=torch.int64))
    elif kind == "params_len":
        flat = flat[:-1]
    else:
        raise AssertionError(kind)
    return flat, rays, g, extras


@pytest.mark.parametrize("kind", ["g_planes", "g_dtype", "hist_without_nlive",
                                  "hist_shape", "nlive_dtype", "params_len"])
def test_backward_wrapper_rejects_bad_inputs(scene, kind):
    _, _, program, tflat = scene
    rays = torch.as_tensor(_rays(28, rows=8))
    g = torch.as_tensor(_cotangents(29, 8, rows=8))
    flat, rays, g, extras = _bad_args(kind, tflat, rays, g)
    with pytest.raises((ValueError, TypeError)):
        bk.fused_backward(program, flat, rays, g, STEPS, 0.0, EPS, **extras)


def test_backward_wrapper_never_falls_back_off_cpu(scene):
    _, _, program, tflat = scene
    rays = torch.empty((7, 8, 128), dtype=torch.float64, device="meta")
    g = torch.empty((8, 8, 128), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bk.fused_backward(program, tflat.to("meta"), rays, g, STEPS, 0.0, EPS)


def test_serving_forward_unchanged_by_training_outputs(scene):
    """The 8 planes are the same bits with and without the training
    outputs, and the training outputs follow their definitions."""
    _, _, program, tflat = scene
    rays = torch.as_tensor(_rays(30))
    serve = rk.fused_march_normals(program, tflat, rays, STEPS, 1e-3, EPS)
    out, extras = rk.march_forward(program, tflat, rays, STEPS, 1e-3, EPS,
                                   track_min=True, log_hist=True,
                                   track_argpos=True)
    assert torch.equal(out[:8], serve)
    valid = rays[6] > 0.5
    hist, nlive, amin = extras["hist"], extras["nlive"], extras["amin"]
    assert hist.shape == (STEPS + 1, 3, ROWS, 128)
    assert torch.equal(hist[0], rays[:3]) and torch.equal(hist[-1], out[:3])
    assert int(nlive[~valid].max()) == 0 and int(nlive.max()) == STEPS
    assert int(nlive[valid].min()) < STEPS  # some rays froze early
    # min_f is the distance at the arg-min step's position.
    params = program.rebuild(tflat)
    d_at = program.sdf_c(params, *extras["argpos"])
    assert torch.equal(d_at[valid], out[8][valid])
    idx = amin.clamp(min=0).long()[None, None]
    at_amin = torch.gather(hist, 0, idx.expand(1, 3, ROWS, 128))[0]
    assert torch.equal(at_amin[:, valid], extras["argpos"][:, valid])
    assert torch.equal(out[8][~valid],
                       torch.full_like(out[8][~valid],
                                       torch.finfo(torch.float64).max))


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("track_min", [False, True], ids=["plain", "min_f"])
@pytest.mark.parametrize("tau", [0.0, 1e-3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_backward_matches_plain(cuda, scene, dtype, tau, track_min):
    """The CUDA backward equals its plain version on the card up to the
    order of its sums (f32: 1e-4 relative to the largest cotangent; f64:
    1e-11), and is bitwise the same with the history on and off. Rays that
    do not converge are marked invalid: their gradients overflow f32 in the
    kernel and the plain version alike."""
    _, _, program, tflat = scene
    rays = torch.as_tensor(_rays(31, rows=64), dtype=dtype, device=cuda)
    flat = tflat.to(device=cuda, dtype=dtype)
    first = rk.reference_march_normals(program, flat, rays, STEPS, tau, EPS)
    rays[6] = ((first[3].abs() < 1e-3) & (rays[6] > 0.5)).to(dtype)
    g = torch.as_tensor(_cotangents(32, 9 if track_min else 8, rows=64),
                        dtype=dtype, device=cuda)
    out, ex = rk.march_forward(program, flat, rays, STEPS, tau, EPS,
                               track_min=track_min, log_hist=True)
    handoff = dict(hist=ex["hist"], nlive=ex["nlive"])
    if track_min:
        handoff.update(minf=out[8].contiguous(), amin=ex["amin"])
    before = bk.LAUNCHES
    a = bk.fused_backward(program, flat, rays, g, STEPS, tau, EPS,
                          track_min=track_min, **handoff)
    b = bk.fused_backward(program, flat, rays, g, STEPS, tau, EPS,
                          track_min=track_min)
    assert bk.LAUNCHES == before + 2
    want = bk.reference_backward(program, flat, rays, g, STEPS, tau, EPS,
                                 track_min=track_min, **handoff)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    conv = rays[6] > 0.5
    assert int(conv.sum()) >= 64
    rel = 1e-4 if dtype == torch.float32 else 1e-11
    for got, ref in ((a[0], want[0]), (a[2][:, conv], want[2][:, conv])):
        assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_two_level_backward_is_bitwise(cuda, scene, dtype):
    """On the card the two-level backward gives the bits of the history and
    the full-recompute paths, and agrees with its plain version (which
    replays segments too) like the ordinary path does."""
    _, _, program, tflat = scene
    steps = 16
    rays = torch.as_tensor(_rays(40, rows=64), dtype=dtype, device=cuda)
    flat = tflat.detach().to(device=cuda, dtype=dtype)
    first = rk.reference_march_normals(program, flat, rays, steps, 0.0, EPS)
    rays[6] = ((first[3].abs() < 1e-3) & (rays[6] > 0.5)).to(dtype)
    g = torch.as_tensor(_cotangents(41, 8, rows=64), dtype=dtype, device=cuda)
    _, ex = rk.march_forward(program, flat, rays, steps, 0.0, EPS,
                             log_hist=True)
    before = bk.LAUNCHES
    a = bk.fused_backward(program, flat, rays, g, steps, 0.0, EPS,
                          hist=ex["hist"], nlive=ex["nlive"])
    b = bk.fused_backward(program, flat, rays, g, steps, 0.0, EPS)
    c = bk.fused_backward(program, flat, rays, g, steps, 0.0, EPS,
                          two_level=True)
    assert bk.LAUNCHES == before + 3 and bk.LAST_PATH["two_level"] is True
    want = bk.reference_backward(program, flat, rays, g, steps, 0.0, EPS,
                                 two_level=True)
    torch.cuda.synchronize()
    for x, y, z in zip(a[::2], b[::2], c[::2]):
        assert torch.equal(x, y) and torch.equal(x, z)
    conv = rays[6] > 0.5
    rel = 1e-4 if dtype == torch.float32 else 1e-11
    for got, ref in ((c[0], want[0]), (c[2][:, conv], want[2][:, conv])):
        assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())
