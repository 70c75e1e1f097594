"""The lane-refill march (``march.cu`` ``march_refill_kernel``) and the
freezing evaluation kept as the terminal distance, on the CPU.

The march at tau > 0 of an expensive SDF refills lanes from a global slot
counter; a Python emulation of its scheduler must give every slot the plain
march's 4 planes bit for bit, whatever order the warps run and the lanes
take slots in. Both march kernels keep a frozen ray's freezing evaluation
as its terminal distance, which rests on one fact of the plain march: the
terminal distance of a frozen ray is its freezing evaluation, bit for bit.
The bulb's march at tau > 0 is pinned against the JAX package's Pallas
march (interpret mode, f64, rtol 1e-12 as in
``test_torch_march_kernel.test_forward_matches_pallas_march``). The kernels
themselves run on the card only (``test_torch_march_kernel``'s ``cuda``
test and ``chip_smoke.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.ops.pallas_march import pallas_march_with_distance
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.ops import march_kernel as mk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram

PX = 3.45e-6
Q, T = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2, 2.5]])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _rays(scene, w, h, dtype, steps, tau):
    """The camera's ray planes of ``scene`` at w×h (pad slots in the last
    row), with the first valid slot moved to where the plain march stopped
    on a converged ray, so that it freezes at step 0."""
    r = FastRenderer(treg.make_scene(scene), RenderConfig(
        px_width=w, px_height=h, focal_length=PX * h, sensor_width=PX * w,
        sensor_height=PX * h, marching_steps=8), dtype=dtype,
        grid_dtype=np.float32, device="cpu")
    q, t = r._pose(Q, T)
    rays = torch.stack(list(sum(r._pose_planes(q, t), ())) + [r._valid], 0)
    flat, _, _ = split_params_padded(r.init_params, dtype)
    out = mk.reference_march(r.program, flat, rays, steps, tau)
    hit = ((out[3].abs() < tau) & (rays[6] > 0.5)).reshape(-1).nonzero()
    assert len(hit) > 0, "no ray converged"
    planes = rays.reshape(7, -1)
    planes[:3, 0] = out[:3].reshape(3, -1)[:, int(hit[0])]
    return r.program, flat, rays


def _refill_emulation(program, flat, rays7, steps, tau, rng, warps=3):
    """march_refill_kernel's scheduler on tensors: ``warps`` warps of 32
    lanes share one slot counter and run their loop passes in a random
    interleaving; a refill hands the next slots to the lanes that need one
    in a random order (the kernel ranks them by lane). Each pass evaluates
    the SDF once on every lane with a ray, at its position, then does the
    kernel's bookkeeping: state k < steps is march step k (a ray that
    freezes stores its position and the distance that froze it), k == steps
    the terminal evaluation. Returns the 4 planes and how many rays froze at
    step 0, froze later, and ran every step."""
    sdf, params = program.sdf_c, program.rebuild(flat)
    tau_t = float(np.asarray(tau, rk._np_dtype(rays7.dtype)))
    planes = rays7.reshape(7, -1)
    n = planes.shape[1]
    out = torch.full((4, n), float("nan"), dtype=rays7.dtype)
    one = lambda v: torch.as_tensor(v, dtype=rays7.dtype).reshape(1)  # noqa: E731
    counter = [0]
    seen = {"frozen at 0": 0, "frozen": 0, "all steps": 0}
    lanes = [[dict(i=-1, done=False) for _ in range(32)] for _ in range(warps)]

    def store(ln, d):
        out[:, ln["i"]] = torch.cat([ln["x"], ln["y"], ln["z"], d])
        ln["i"] = -1

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
                              v=[one(float(planes[c, s])) for c in (3, 4, 5)])
                else:
                    out[:, s] = torch.cat([x, y, z, torch.zeros_like(x)])

    def step(warp):
        refill(warp)
        live = [ln for ln in warp if not ln["done"]]
        if not live:
            return False
        d = sdf(params, *(torch.cat([ln[c] for ln in live]) for c in "xyz"))
        for ln, dl in zip(live, d):
            dl = dl.reshape(1)
            if ln["k"] == steps:
                seen["all steps"] += 1
                store(ln, dl)
            elif bool(torch.abs(dl) >= tau_t):
                for c, v in zip("xyz", ln["v"]):
                    ln[c] = ln[c] + dl * v
                ln["k"] += 1
            else:
                seen["frozen at 0" if ln["k"] == 0 else "frozen"] += 1
                store(ln, dl)
        return True

    busy = list(range(warps))
    while busy:
        w = busy[int(rng.integers(len(busy)))]
        if not step(lanes[w]):
            busy.remove(w)
    return out.reshape((4,) + tuple(rays7.shape[1:])), seen


@pytest.mark.parametrize("scene,w,h,steps,tau,seed", [
    ("test_scene2", 20, 13, 12, 1e-3, 0),
    ("test_scene2", 20, 13, 0, 1e-3, 1),
    ("test_scene", 17, 9, 10, 5e-2, 2),
    ("mandelbulb", 12, 9, 16, 1e-4, 3),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refill_march_scheduler_gives_the_plain_planes_bitwise(
        scene, w, h, steps, tau, seed, dtype):
    """Every slot of the emulated lane-refill march, pads included, holds
    the plain march's 4 planes bit for bit at tau > 0: rays that freeze at
    step 0 or later, rays that run every step, and steps = 0."""
    program, flat, rays7 = _rays(scene, w, h, dtype, max(steps, 8), tau)
    assert int((rays7[6] <= 0.5).sum()) > 0  # the last row's pad slots
    want = mk.reference_march(program, flat, rays7, steps, tau)
    got, seen = _refill_emulation(program, flat, rays7, steps, tau,
                                  np.random.default_rng(seed))
    assert _same_bits(got, want)
    n_valid = int((rays7[6] > 0.5).sum())
    assert sum(seen.values()) == n_valid
    if steps == 0:
        assert seen["all steps"] == n_valid
    else:
        assert min(seen.values()) > 0, seen


@pytest.mark.parametrize("scene,steps,tau", [("test_scene2", 24, 1e-3),
                                             ("mandelbulb", 24, 1e-4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frozen_rays_terminal_distance_is_their_freezing_evaluation(
        scene, steps, tau, dtype):
    """The plain march's terminal distance of a ray that froze equals the
    evaluation that froze it, bit for bit: the fact both march kernels rest
    on when they store that evaluation and skip the terminal one."""
    program, flat, rays7 = _rays(scene, 24, 16, dtype, steps, tau)
    sdf, params = program.sdf_c, program.rebuild(flat)
    x, y, z, dx, dy, dz = (rays7[i] for i in range(6))
    valid = rays7[6] > 0.5
    frozen = torch.zeros_like(valid)
    at_freeze = torch.zeros_like(x)
    for _ in range(steps):
        d = sdf(params, x, y, z)
        live = (torch.abs(d) >= tau) & valid & ~frozen
        at_freeze = torch.where(valid & ~frozen & ~live, d, at_freeze)
        frozen |= valid & ~live
        x = torch.where(live, x + d * dx, x)
        y = torch.where(live, y + d * dy, y)
        z = torch.where(live, z + d * dz, z)
    want = mk.reference_march(program, flat, rays7, steps, tau)
    assert int(frozen.sum()) > 0 and int((valid & ~frozen).sum()) > 0
    assert _same_bits(want[:3], torch.stack([x, y, z]))
    assert _same_bits(want[3][frozen], at_freeze[frozen])


def test_refill_dispatch():
    """Which marches take the lane-refill entry on the card: the per-thread
    route at tau > 0 (as the kernel rounds it) for an SDF of at least
    REFILL_MIN_OPS operations."""
    bulb = SdfProgram(treg.make_scene("mandelbulb"))
    analytic = SdfProgram(treg.make_scene("test_scene2"))
    neural = SdfProgram(treg.make_scene("neural_demo"))
    f32, f64 = torch.float32, torch.float64
    assert analytic.ops_per_eval < rk.REFILL_MIN_OPS <= bulb.ops_per_eval
    assert neural.ops_per_eval >= rk.REFILL_MIN_OPS
    assert rk.uses_refill(bulb, f32, 1e-4, "thread")
    assert rk.uses_refill(bulb, f64, 1e-4, "thread")
    assert rk.uses_refill(neural, f64, 1e-3, "thread")
    assert not rk.uses_refill(neural, f32, 1e-3, "tc")
    assert not rk.uses_refill(bulb, f32, 0.0, "thread")
    assert not rk.uses_refill(bulb, f32, 1e-50, "thread")  # 0 in f32
    assert rk.uses_refill(bulb, f64, 1e-50, "thread")
    assert not rk.uses_refill(analytic, f32, 1e-3, "thread")


def test_cpu_march_takes_the_plain_version_and_launches_nothing():
    program, flat, rays7 = _rays("mandelbulb", 12, 9, torch.float64, 16,
                                 1e-4)
    before = (mk.LAUNCHES, mk.REFILL_LAUNCHES)
    got = mk.march_forward(program, flat, rays7, 16, 1e-4)
    assert (mk.LAUNCHES, mk.REFILL_LAUNCHES) == before
    assert _same_bits(got, mk.reference_march(program, flat, rays7, 16,
                                              1e-4))


def test_bulb_march_at_tau_matches_pallas_march():
    """The bulb's march at tau = 1e-4 against the JAX package's Pallas march
    in interpret mode, f64: rays from a plane outside the set towards it, so
    that some freeze and some run every step."""
    scene = "mandelbulb"
    _, jsdf, jparams = jgraph.compile_scene(jreg.make_scene(scene),
                                            jnp.float64)
    program = SdfProgram(treg.make_scene(scene))
    tparams = tgraph.init_params(program.node, torch.float64)
    rng = np.random.default_rng(8)
    shape = (3, 20)
    p0 = np.zeros(shape + (3,))
    p0[..., 0] = rng.uniform(-1.2, 1.2, shape)
    p0[..., 1] = rng.uniform(-1.2, 1.2, shape)
    p0[..., 2] = 2.0
    v = np.zeros(shape + (3,))
    v[..., 2] = -1.0
    steps, tau = 16, 1e-4
    jpos, jdist = pallas_march_with_distance(
        jsdf, jparams, jnp.asarray(p0), jnp.asarray(v), steps, tau=tau,
        interpret=True)
    pos, dist = mk.kernel_march_with_distance(
        program, tparams, torch.as_tensor(p0), torch.as_tensor(v), steps,
        tau=tau)
    frozen = np.abs(dist.numpy()) < tau
    assert 0 < int(frozen.sum()) < frozen.size
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-12,
                               atol=1e-13)
