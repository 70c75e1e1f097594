"""The codegen IR's counted loop (``_Builder.loop``) and the lane-refill
serving forward, on the CPU.

The Mandelbulb's iterations are one rolled loop of the scene IR: its torch
evaluator must give the plain SDF's bits, its adjoint (a checkpointed
reverse loop) must agree with autograd and with the JAX package's gradient,
and its generated CUDA must hold one body and a tape. The serving forward at
tau > 0 refills lanes from a global counter (``render_fwd.cu``,
``render_fwd_refill_kernel``); a Python emulation of its scheduler must give
every slot the plain march's planes bit for bit, whatever order lanes take
slots in. The kernels themselves run on the card only (the ``cuda`` test).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import codegen
from ray_marching_tpu_torch.scene import fractals as tfractals
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram
from ray_marching_tpu_torch.scene.neural import NeuralSDF

PX = 3.45e-6
Q, T = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2, 2.5]])
#: sha256 of the bulb's generated source as the generator wrote it before it
#: rolled loops (the unrolled twin must still give it).
UNROLLED_BULB_SOURCE = (
    "29bf4ad2bce69c7b83c765287b8cd1caa0cfe05a9a181efa06b8a4c74b32c04d")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed, dtype, n=2000):
    """Random points around the set, then the origin, the z axis (rxy = 0),
    the bailout sphere, the far field and NaN coordinates."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.6, 1.6, (3, n))
    p[:, :4] = 0.0
    p[0, 4:40] = p[1, 4:40] = 0.0
    u = rng.normal(size=(3, 200))
    p[:, 40:240] = 2.0 * u / np.linalg.norm(u, axis=0)
    p[:, 240:440] = u * rng.uniform(3.0, 20.0, 200) / np.linalg.norm(u,
                                                                      axis=0)
    p[0, 440], p[1, 441], p[2, 442] = np.nan, np.nan, np.nan
    return [torch.as_tensor(c, dtype=dtype) for c in p]


def _same_bits(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _bulb(scale, dtype):
    scene = treg.make_scene("mandelbulb")
    params = tgraph.init_params(scene, dtype)
    params["c1"]["child"]["scale"] = torch.tensor(scale, dtype=dtype)
    flat, _, specs = split_params_padded(params, dtype)
    return scene, flat, specs


# -- the rolled loop ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", [1.0, 0.85])
def test_rolled_evaluator_equals_plain_sdf_bitwise(dtype, scale):
    """One rolled loop body, run ten times, gives the plain SDF's bits:
    NaN, axis and origin points included."""
    scene, flat, _ = _bulb(scale, dtype)
    program = SdfProgram(scene)
    assert program.loop_trips == (10,)
    pts = _points(2, dtype)
    got = program.evaluate(flat, *pts)
    want = program.sdf_c(program.rebuild(flat), *pts)
    assert _same_bits(got, want)


@pytest.mark.parametrize("power,iterations", [(3, 4), (8, 1), (5, 7)])
def test_rolled_evaluator_other_bulbs(power, iterations):
    node = tfractals.Mandelbulb(power=power, iterations=iterations)
    program = SdfProgram(node)
    assert program.loop_trips == (iterations,)
    pts = _points(3, torch.float64)
    params = {"scale": torch.tensor(1.1, dtype=torch.float64)}
    flat, _, _ = split_params_padded(params, torch.float64)
    assert _same_bits(program.evaluate(flat, *pts),
                      tfractals.mandelbulb_sdf(node)(params, *pts))


def test_zero_iterations_emit_no_loop():
    program = SdfProgram(tfractals.Mandelbulb(iterations=0))
    assert program.loop_trips == ()
    assert "#pragma unroll" not in program.cuda_source()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rolled_vjp_matches_autograd(dtype):
    """The checkpointed adjoint against autograd of the plain SDF: f64 to
    1e-9 of each coordinate's largest cotangent; f32 (the chaotic iteration
    magnifies an ulp of another summation order) on 99.9 % of the points
    within 1e-3 of the point's own largest, the summed scale within 1e-3."""
    scene, flat, specs = _bulb(1.1, dtype)
    program = SdfProgram(scene)
    pts = _points(4, dtype)
    keep = torch.isfinite(pts[0] + pts[1] + pts[2])
    pts = [c[keep] for c in pts]
    g = torch.as_tensor(np.random.default_rng(5).normal(size=pts[0].shape),
                        dtype=dtype)
    d, gx, gy, gz, gp = program.evaluate_vjp(flat, *pts, g)
    xyz = [c.clone().requires_grad_(True) for c in pts]
    leaf = flat.clone().requires_grad_(True)
    want = torch.autograd.grad(program.sdf_c(program.rebuild(leaf), *xyz),
                               xyz + [leaf], g)
    offset = next(s.offset for s in specs if s.path == "c1/child/scale")
    scale = gp[program.scalar_offsets.index(offset)].sum()
    got = torch.stack((gx, gy, gz))
    ref = torch.stack(want[:3])
    if dtype == torch.float64:
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-9,
                                       atol=1e-9 * float(b.abs().max()))
        assert float(scale) == pytest.approx(float(want[3][offset]),
                                             rel=1e-9)
    else:
        rel = (got - ref).abs().amax(0) / ref.abs().amax(0).clamp_min(1e-30)
        assert float((rel < 1e-3).float().mean()) >= 0.999
        assert float(scale) == pytest.approx(float(want[3][offset]),
                                             rel=1e-3)


def test_rolled_vjp_matches_jax_f64():
    """The port's rolled adjoint against jax.vjp of the JAX package's scene
    SDF (unrolled there), f64, eagerly: the distance to 1e-12, the point
    cotangents and the summed scale to 1e-9, on the finite points."""
    scene, flat, specs = _bulb(0.9, torch.float64)
    program = SdfProgram(scene)
    pts = [c[443:1643] for c in _points(6, torch.float64)]
    g = np.random.default_rng(7).normal(size=pts[0].shape)
    d, gx, gy, gz, gp = program.evaluate_vjp(flat, *pts, torch.as_tensor(g))
    jscene = jreg.make_scene("mandelbulb")
    _, jsdf, jparams = jgraph.compile_scene(jscene, jnp.float64)
    jparams["c1"]["child"]["scale"] = jnp.asarray(0.9, jnp.float64)
    with jax.disable_jit():
        jd, vjp = jax.vjp(jsdf, jparams, *(jnp.asarray(c.numpy())
                                           for c in pts))
        jgp, *jxyz = vjp(jnp.asarray(g))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-12)
    for a, b in zip((gx, gy, gz), jxyz):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-9 * np.abs(b).max())
    offset = next(s.offset for s in specs if s.path == "c1/child/scale")
    assert float(gp[program.scalar_offsets.index(offset)].sum()) == \
        pytest.approx(float(jgp["c1"]["child"]["scale"]), rel=1e-9)


def _same_bits_signed(a, b):
    """Equal values with equal signs (zeros included), or NaN in both."""
    return bool((((a == b) & (torch.signbit(a) == torch.signbit(b)))
                 | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rolled_vjp_equals_the_unrolled_twin_bitwise(dtype):
    """The checkpointed reverse loop sums every cotangent in the order of
    the loop written out (running sums of the loop's inputs, trip 0 peeled,
    empty sums started at -0): the distance, the point cotangents and every
    parameter's per-ray cotangent are the unrolled adjoint's bits, signs of
    zeros included, at NaN, axis and origin points and zero cotangents."""
    scene, flat, _ = _bulb(1.0, dtype)
    rolled, twin = SdfProgram(scene), SdfProgram(scene, unroll=True)
    pts = _points(8, dtype)
    g = torch.as_tensor(np.random.default_rng(9).normal(size=pts[0].shape),
                        dtype=dtype)
    g[500:510], g[510:520] = 0.0, -0.0
    a, b = rolled.evaluate_vjp(flat, *pts, g), twin.evaluate_vjp(flat, *pts,
                                                                 g)
    for x, y in zip(a[:4], b[:4]):
        assert _same_bits_signed(x, y)
    assert [k for k, t in enumerate(a[4]) if t is None] == \
        [k for k, t in enumerate(b[4]) if t is None]
    for x, y in zip(a[4], b[4]):
        assert x is None or _same_bits_signed(x, y)


def test_op_counts_are_the_unrolled_work():
    """The counts do not see the rolling: 875 per evaluation and 3,049 per
    VJP (tests/test_torch_mandelbulb.py pins their split), and the twin's
    generated source is the pre-rolling generator's byte for byte. The
    reverse loop's recompute of the body is counted apart: 10 trips of the
    80 ray-dependent ops of an iteration."""
    scene = treg.make_scene("mandelbulb")
    rolled, twin = SdfProgram(scene), SdfProgram(scene, unroll=True)
    assert rolled.op_counts() == twin.op_counts()
    assert (rolled.ops_per_eval, rolled.vjp_ops_per_eval) == (875, 3049)
    assert twin.vjp_ops_per_eval == 3049 and twin.loop_trips == ()
    assert rolled.vjp_recompute_ops == 800 and twin.vjp_recompute_ops == 0
    assert hashlib.sha256(twin.cuda_source().encode()).hexdigest() == \
        UNROLLED_BULB_SOURCE
    assert len(rolled.ops) < len(twin.ops) / 3  # the adjoint twice: rolled, peeled


def test_generated_cuda_holds_one_rolled_body_and_a_tape():
    program = SdfProgram(treg.make_scene("mandelbulb"))
    src = program.cuda_source()
    sdf, vjp = src.split("scene_sdf_vjp(")
    twin = SdfProgram(treg.make_scene("mandelbulb"), unroll=True)
    twin_sdf = twin.cuda_source().split("scene_sdf_vjp(")[0]
    # scene_sdf: one loop of one body (its 5 guarded roots once, not 10x),
    # unrolled by each kernel's rm_sdf_loop_unroll (sdf_prims.cuh).
    assert sdf.count("#pragma unroll (rm_sdf_loop_unroll)") == 1
    assert sdf.count("for (int i0 = 0; i0 < 10; ++i0) {") == 1
    assert twin_sdf.count("rm_sqrt(") == 23
    assert sdf.count("rm_sqrt(") == 5
    # scene_sdf_vjp: the forward loop with a tape of the 5 state values,
    # then the reverse loop over trips 9..1 and trip 0 peeled, each
    # recomputing the body from the tape.
    for k in range(5):
        assert f"  T t0_{k}[10];" in vjp
        assert f"    t0_{k}[i0] = c0_{k};" in vjp
        assert f"t0_{k}[i0];" in vjp and f"t0_{k}[0];" in vjp
    assert vjp.count("for (int i0 = 9; i0 >= 1; --i0) {") == 1
    assert vjp.count("#pragma unroll 1") == 2
    # The primal's 5 roots, then 2 in each recompute of the body.
    assert vjp.count("rm_sqrt(") == 5 + 2 + 2
    assert len(src.splitlines()) * 3 < len(twin.cuda_source().splitlines())


def test_scenes_without_loops_generate_the_same_source():
    """Only a lowering that asks for a loop changes the generated code: a
    scene without one gives its program as before (chip_smoke.py pins the
    hashes on the card too)."""
    for name, digest in (
            ("test_scene2",
             "01995bdb88b485bee773c22c8a51a6079fd70d4f52d88e5ee44821a37bdee8c1"),
            ("test_scene",
             "93b989af7cc5b0632446ee26c0a42e1a204cd9e35660b86950dbda5e1219d52f"),
    ):
        program = SdfProgram(treg.make_scene(name))
        assert program.loops == ()
        assert hashlib.sha256(program.cuda_source().encode()).hexdigest() == \
            digest


def _builder():
    node = NeuralSDF(hidden=(4,))
    offsets = {"b0": 0, "b1": 4, "radius": 5, "s": 6}
    return codegen._Builder(offsets, {"w0": 0, "w1": 12}), node


def test_loop_body_with_an_mlp_raises():
    b, node = _builder()
    with pytest.raises(ValueError, match="may not hold an mlp op"):
        b.loop(2, (0,), lambda o, v: (o.mlp(node, "", v, 1, 2),))


def test_nested_loops_and_escaping_values_raise():
    b, _ = _builder()
    with pytest.raises(ValueError, match="do not nest"):
        b.loop(2, (0,), lambda o, v: o.loop(2, (v,), lambda p, w: (w,)))
    b, _ = _builder()
    seen = []

    def body(o, v):
        seen.append(o.mul(v, v))
        return (seen[-1],)

    b.loop(3, (0,), body)
    with pytest.raises(ValueError, match="read after the loop"):
        b.add(seen[-1], 1)


def test_loop_hoists_constants_and_parameters():
    """A body's constants and parameters are emitted once, ahead of the
    loop, and are not ray-dependent; its arithmetic on the state is."""
    b, _ = _builder()

    def body(o, v):
        return (o.add(o.mul(v, o.const(3.0)), o.param("s")),)

    (out,) = b.loop(4, (0,), body)
    lp = b.loops[0]
    kinds = [op[0] for op in b.ops[:lp.begin]]
    assert kinds.count("const") == 1 and kinds.count("param") == 1
    assert all(b.ops[i][0] not in ("const", "param") for i in lp.body)
    assert all(b.dep[i] for i in lp.body) and b.dep[out]


@dataclass(frozen=True)
class LoopedLeaf(tgraph.Node):
    """A custom leaf whose lowering is a loop: z halved and moved by x²,
    ``turns`` times, less the parameter r."""

    turns: int = 5


def _looped_sdf(node):
    def f(params, x, y, z):
        v = z
        for _ in range(node.turns):
            v = v * 0.5 + x * x
        return v - params["r"]
    return f


def _lower_looped(node, b, prefix, x, y, z):
    def step(o, v):
        return (o.add(o.mul(v, o.const(0.5)), o.mul(x, x)),)

    (v,) = b.loop(node.turns, (z,), step)
    return b.sub(v, b.param(codegen.param_path(prefix, "r")))


def test_custom_lowering_with_a_loop_through_the_door():
    """register_lowering's door: a custom node whose lowering writes its
    SDF with ``builder.loop`` reaches the kernels' programs, and its
    evaluator and adjoint follow the torch SDF it was registered with."""
    tgraph.register_custom_node(
        LoopedLeaf, _looped_sdf,
        lambda node, dtype=torch.float32, device="cpu": {
            "r": torch.tensor(0.3, dtype=dtype, device=device)})
    codegen.register_lowering(LoopedLeaf, _lower_looped)
    program = SdfProgram(LoopedLeaf())
    assert program.loop_trips == (5,)
    flat, _, _ = split_params_padded({"r": torch.tensor(0.3, dtype=torch.float64)},
                                     torch.float64)
    pts = [c[:300] for c in _points(10, torch.float64)]
    assert _same_bits(program.evaluate(flat, *pts),
                      program.sdf_c(program.rebuild(flat), *pts))
    g = torch.ones_like(pts[0])
    _, gx, gy, gz, _ = program.evaluate_vjp(flat, *pts, g)
    xyz = [c.clone().requires_grad_(True) for c in pts]
    want = torch.autograd.grad(program.sdf_c(program.rebuild(flat), *xyz),
                               xyz, g, allow_unused=True)
    torch.testing.assert_close(gx, want[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gz, want[2], rtol=1e-12, atol=1e-12)
    assert torch.equal(gy, torch.zeros_like(gy))


# -- lane refill ----------------------------------------------------------------


def _rays(scene, w, h, dtype):
    r = FastRenderer(treg.make_scene(scene), RenderConfig(
        px_width=w, px_height=h, focal_length=PX * h, sensor_width=PX * w,
        sensor_height=PX * h, marching_steps=8), dtype=dtype,
        grid_dtype=np.float32, device="cpu")
    q, t = r._pose(Q, T)
    rays = torch.stack(list(sum(r._pose_planes(q, t), ())) + [r._valid], 0)
    flat, _, _ = split_params_padded(r.init_params, dtype)
    return r.program, flat, rays


def _refill_emulation(program, flat, rays7, steps, tau, normals_eps, rng,
                      warps=3):
    """render_fwd_refill_kernel's scheduler on tensors: ``warps`` warps of
    32 lanes share one slot counter and run their loop passes in a random
    interleaving; a refill hands the next slots to the lanes that need one
    in a random order (the kernel ranks them by lane). Each pass evaluates
    the SDF once on every lane with a ray, at the point its state names (a
    march step, or tail evaluation j: the centre, then the four offsets),
    then does the kernel's bookkeeping. Returns the 8 planes."""
    sdf, params = program.sdf_c, program.rebuild(flat)
    off, inv, lap_scale, tau_t = rk._plain_consts(rays7.dtype, tau,
                                                  normals_eps)
    planes = rays7.reshape(7, -1)
    n = planes.shape[1]
    out = torch.full((8, n), float("nan"), dtype=rays7.dtype)
    one = lambda v: torch.as_tensor(v, dtype=rays7.dtype).reshape(1)  # noqa: E731
    counter = [0]
    lanes = [[dict(i=-1, done=False) for _ in range(32)] for _ in range(warps)]

    def refill(warp):
        while True:
            need = [ln for ln in warp if ln["i"] < 0 and not ln["done"]]
            if not need:
                return
            base = counter[0]
            counter[0] += len(need)
            for rank, k in enumerate(rng.permutation(len(need))):
                ln, s = need[k], base + rank
                if s >= n:
                    ln["done"] = True
                    continue
                x, y, z = (one(float(planes[c, s])) for c in range(3))
                if float(planes[6, s]) > 0.5:
                    ln.update(i=s, x=x, y=y, z=z, k=0,
                              j=-1 if steps > 0 else 0,
                              v=[one(float(planes[c, s])) for c in (3, 4, 5)])
                else:  # store_pad
                    out[:, s] = torch.cat([x, y, z, torch.zeros(5, dtype=x.dtype)])

    def step(warp):
        refill(warp)
        live = [ln for ln in warp if not ln["done"]]
        if not live:
            return False
        pts = []
        for ln in live:
            j = ln["j"]
            if j > 0:
                pts.append([ln[c] + off[j - 1][a] for a, c in enumerate("xyz")])
            else:
                pts.append([ln["x"], ln["y"], ln["z"]])
        d = sdf(params, *(torch.cat([p[a] for p in pts]) for a in range(3)))
        for ln, dl in zip(live, d):
            dl = dl.reshape(1)
            if ln["j"] < 0:
                if not bool(torch.abs(dl) >= tau_t):
                    ln["j"] = 0
                else:
                    for c, v in zip("xyz", ln["v"]):
                        ln[c] = ln[c] + dl * v
                    ln["k"] += 1
                    if ln["k"] == steps:
                        ln["j"] = 0
            elif ln["j"] < 4:
                ln.setdefault("f", [None] * 5)[ln["j"]] = dl
                ln["j"] += 1
            else:
                dc, f0, f1, f2 = ln["f"][:4]
                f = [f0, f1, f2, dl]
                d1, d2, d3 = f[1] - f[0], f[2] - f[0], f[3] - f[0]
                nx = inv[0][0] * d1 + inv[0][1] * d2 + inv[0][2] * d3
                ny = inv[1][0] * d1 + inv[1][1] * d2 + inv[1][2] * d3
                nz = inv[2][0] * d1 + inv[2][1] * d2 + inv[2][2] * d3
                norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
                mean4 = (f[0] + f[1] + f[2] + f[3]) * 0.25
                out[:, ln["i"]] = torch.cat([
                    ln["x"], ln["y"], ln["z"], dc, nx / norm, ny / norm,
                    nz / norm, (dc - mean4) * lap_scale])
                ln.update(i=-1, f=[None] * 5)
        return True

    busy = list(range(warps))
    while busy:
        w = busy[int(rng.integers(len(busy)))]
        if not step(lanes[w]):
            busy.remove(w)
    return out.reshape((8,) + tuple(rays7.shape[1:]))


@pytest.mark.parametrize("scene,w,h,steps,tau,seed", [
    ("test_scene2", 20, 13, 12, 1e-3, 0),
    ("test_scene2", 20, 13, 12, 1e-3, 1),
    ("test_scene", 17, 9, 10, 5e-2, 2),
    ("mandelbulb", 12, 9, 16, 1e-4, 3),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refill_scheduler_gives_the_plain_planes_bitwise(scene, w, h, steps,
                                                         tau, seed, dtype):
    """Every slot of the emulated lane-refill forward, pads included, holds
    the plain march's 8 planes bit for bit at tau > 0, whatever order the
    warps run and the lanes take slots in."""
    program, flat, rays7 = _rays(scene, w, h, dtype)
    assert int((rays7[6] <= 0.5).sum()) > 0  # the last row's pad slots
    want = rk.reference_march_normals(program, flat, rays7, steps, tau, 5e-2)
    got = _refill_emulation(program, flat, rays7, steps, tau, 5e-2,
                            np.random.default_rng(seed))
    assert _same_bits(got, want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene,tau", [("test_scene2", 1e-3),
                                       ("mandelbulb", 1e-4),
                                       ("test_scene2", 0.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_serving_forward_equals_plain_bitwise(cuda, scene, tau, dtype):
    """On the card the serving forward (lane refill for the bulb at tau > 0,
    one thread per ray otherwise) gives the plain version's planes bit for
    bit, one launch per call."""
    r = FastRenderer(treg.make_scene(scene), RenderConfig(
        px_width=96, px_height=61, focal_length=PX * 61,
        sensor_width=PX * 96, sensor_height=PX * 61, marching_steps=48),
        dtype=dtype, grid_dtype=np.float32, device=cuda)
    q, t = r._pose(Q, T)
    rays = torch.stack(list(sum(r._pose_planes(q, t), ())) + [r._valid], 0)
    flat, _, _ = split_params_padded(r.init_params, dtype, cuda)
    before = rk.LAUNCHES
    got = rk.fused_march_normals(r.program, flat, rays, 48, tau, 5e-2)
    want = rk.reference_march_normals(r.program, flat, rays, 48, tau, 5e-2)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 1
    assert _same_bits(got, want)
