"""The per-thread kernels' redesign for the H100: where the kernels read the
scene's flat parameters (the constant bank or the caller's pointer, chosen
when a scene's library is built), the launch bounds the build gives the
backward, and the sources' shape that keeps the constant bank safe (every
kernel reads the parameters through ``scene_params``, every launch fills the
bank first, ``csrc/scene_params.cuh``).

The kernels themselves run on the card only (the ``cuda`` tests): the
serving forward and the march bitwise equal to their plain versions, the
backward's three ways of obtaining positions bitwise equal to each other
and within ``TOL_BWD`` of the plain version, and two launches of one
library with different parameters on two streams each giving its own
result.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np
import pytest
import torch

from ray_marching_tpu_torch.ops import backward_kernel as bk
from ray_marching_tpu_torch.ops import march_kernel as mk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram

PX = 3.45e-6
Q, T = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2, 2.5]])
#: The constant bank's size on the H100 (user __constant__ data a module).
CONSTANT_BANK_BYTES = 64 * 1024
#: Tolerance of the f32 backward against its plain version, relative to the
#: largest reference entry (the ray cotangents on converged rays, the
#: parameter cotangent), as chip_smoke.py's TOL_BWD: the kernel applies the
#: adjoint rules by hand and sums in another order.
TOL_BWD_F32 = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(program):
    return dict(f[2:].split("=") for f in rk.scene_flags(program))


def _many_spheres(n):
    """A union of ``n`` spheres: one flat parameter block each."""
    return treg.Union(children=tuple(treg.Sphere(radius=0.1 * (k + 1))
                                     for k in range(n)))


# -- the parameter route and the build's flags --------------------------------


@pytest.mark.parametrize("name", treg.available_scenes())
def test_builtin_scenes_take_their_parameter_route(name):
    """Every built-in scene fits the bank. An SDF without a rolled loop
    takes it (its library is built with its flat vector's length), the
    backward's blocks an SM (the history path's and the marching
    instantiations') and the march loop at tau = 0 without the freeze test;
    the bulb's rolled loop keeps the pointer and the kernels' own defaults
    (four blocks, one loop)."""
    program = SdfProgram(treg.make_scene(name))
    flags = _flags(program)
    assert program.n_flat <= rk.PARAM_BANK_MAX
    if program.loops:
        assert rk.param_route(program) == "pointer"
        assert flags == {}
    else:
        assert rk.param_route(program) == "constant"
        assert flags == {"RM_P_CONST": str(program.n_flat),
                         "RM_BWD_HIST_BLOCKS": str(rk.BWD_HIST_BLOCKS),
                         "RM_BWD_OWN_BLOCKS": str(rk.BWD_OWN_BLOCKS),
                         "RM_MARCH_TAU0_LOOP": "1"}


def test_a_scene_too_large_for_the_bank_keeps_the_pointer():
    """Above PARAM_BANK_MAX flat parameters the library is built without
    RM_P_CONST (the kernels read the caller's pointer); at the limit it
    still takes the bank."""
    big = SdfProgram(_many_spheres(48))
    assert big.n_flat > rk.PARAM_BANK_MAX
    assert rk.param_route(big) == "pointer"
    assert "RM_P_CONST" not in _flags(big)
    small = SdfProgram(_many_spheres(2))
    assert rk.param_route(small) == "constant"


def test_the_route_is_part_of_the_build(monkeypatch):
    """The route changes the flags and so the library's key: a program
    built both ways gets two libraries."""
    program = SdfProgram(treg.make_scene("test_scene2"))
    key = rk.kernel_key(program)
    monkeypatch.setattr(rk, "PARAM_BANK_MAX", program.n_flat - 1)
    assert rk.param_route(program) == "pointer"
    assert rk.kernel_key(program) != key
    monkeypatch.setattr(rk, "PARAM_BANK_MAX", program.n_flat)
    assert rk.kernel_key(program) == key


def test_the_bank_holds_both_types_at_the_limit():
    """Each kernel source holds an f32 and an f64 copy of RM_P_CONST
    values: at PARAM_BANK_MAX they fit the 64 KiB bank with room left."""
    assert rk.PARAM_BANK_MAX * (4 + 8) < CONSTANT_BANK_BYTES
    assert "scene_params.cuh" in rk.KERNEL_SOURCES


# -- the sources --------------------------------------------------------------


def _kernels(source):
    """(name, body) of every __global__ function of a kernel source."""
    out = []
    for m in re.finditer(r"__global__[^{;]*?\b(\w+)\s*\([^{;]*?\)\s*\{",
                         source):
        depth, k = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(source[k], 0)
            k += 1
        out.append((m.group(1), source[m.end():k]))
    return out


def _wrapped(source, index):
    """Whether ``index`` lies inside the argument list of a call of
    rm_launch_with_params."""
    for m in re.finditer(r"rm_launch_with_params\(", source[:index]):
        text = source[m.end():index]
        if text.count("(") - text.count(")") >= 0:
            return True
    return False


def _enclosing_function(source, index):
    heads = list(re.finditer(r"\n(?:static |template[^\n]*\n)*[\w:<>]+ "
                             r"(\w+)\(", source[:index]))
    return heads[-1].group(1)


@pytest.mark.parametrize("unit", rk.KERNEL_UNITS)
def test_every_kernel_reads_the_parameters_through_scene_params(unit):
    """The first statement of every kernel (after its static_asserts)
    takes its parameter pointer through scene_params (the bank's copy on
    the constant route)."""
    source = (rk.CSRC / unit).read_text()
    kernels = _kernels(source)
    assert kernels
    for name, body in kernels:
        first = next(st.strip() for st in body.split(";")
                     if not st.strip().startswith("static_assert"))
        assert re.fullmatch(r"(a\.)?P = scene_params(<[^>]*>)?\((a\.)?P\)",
                            first), name


@pytest.mark.parametrize("unit", rk.KERNEL_UNITS)
def test_every_launch_fills_the_bank_first(unit):
    """Every kernel launch runs inside rm_launch_with_params (the copy into
    the bank before it, the event after it), lexically or in a helper that
    is only called there."""
    source = (rk.CSRC / unit).read_text()
    launches = [m.start() for m in re.finditer(r"<<<", source)]
    assert launches
    for at in launches:
        if _wrapped(source, at):
            continue
        helper = _enclosing_function(source, at)
        calls = [m.start() for m in re.finditer(rf"\b{helper}<", source)]
        assert calls, (unit, helper)
        assert all(_wrapped(source, c) for c in calls), (unit, helper)


def test_the_backward_alone_takes_the_bank():
    """The forward and the march read the caller's pointer on every route
    (on the bank they measured slower, PERF.md); the backward takes the bank
    on the constant route, its two-level instantiation excepted."""
    for unit in rk.KERNEL_UNITS:
        source = (rk.CSRC / unit).read_text()
        assert ("#define RM_P_BANK" in source) == (unit == "render_bwd.cu")
    bwd = (rk.CSRC / "render_bwd.cu").read_text()
    assert "scene_params<T, !TWO_LEVEL>(a.P)" in bwd


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _card_rays(scene, cuda, w=96, h=61, steps=32):
    r = FastRenderer(treg.make_scene(scene), RenderConfig(
        px_width=w, px_height=h, focal_length=PX * h, sensor_width=PX * w,
        sensor_height=PX * h, marching_steps=steps), dtype=torch.float32,
        grid_dtype=np.float32, device=cuda)
    q, t = r._pose(Q, T)
    rays = torch.stack(list(sum(r._pose_planes(q, t), ())) + [r._valid], 0)
    flat, _, _ = split_params_padded(r.init_params, torch.float32, cuda)
    return r.program, flat, rays.contiguous()


def _same_bits(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["test_scene2", "mandelbulb"])
@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_cuda_forward_and_march_equal_plain_bitwise(cuda, scene, tau):
    """The serving forward, the training forward's planes and the march
    give the plain versions' bits (f32), the loop at tau = 0 included."""
    program, flat, rays = _card_rays(scene, cuda)
    want = rk.reference_march_normals(program, flat, rays, 32, tau, 5e-2)
    got = rk.fused_march_normals(program, flat, rays, 32, tau, 5e-2)
    train, _ = rk.march_forward(program, flat, rays, 32, tau, 5e-2,
                                track_min=True, log_hist=True)
    march = mk.march_planes(program, flat, rays, 32, tau)
    plain = mk.reference_march(program, flat, rays, 32, tau)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert _same_bits(train[:8], want)
    assert _same_bits(march, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,steps", [("test_scene2", 32),
                                         ("mandelbulb", 24)])
def test_cuda_backward_three_ways_bitwise(cuda, scene, steps):
    """History, recompute and two levels give the same cotangents bit for
    bit; test_scene2's are within TOL_BWD_F32 of the plain version on the
    converged rays (the bulb's f32 gradient at tau = 0 is not finite
    everywhere, in the plain version either)."""
    program, flat, rays = _card_rays(scene, cuda, steps=steps)
    g = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (8,) + tuple(rays.shape[1:])), dtype=torch.float32).to(cuda)
    _, ex = rk.march_forward(program, flat, rays, steps, 0.0, 5e-2,
                             log_hist=True)
    kw = dict(hist=ex["hist"], nlive=ex["nlive"])
    runs = [bk.fused_backward(program, flat, rays, g, steps, 0.0, 5e-2,
                              **kw),
            bk.fused_backward(program, flat, rays, g, steps, 0.0, 5e-2),
            bk.fused_backward(program, flat, rays, g, steps, 0.0, 5e-2,
                              two_level=True)]
    assert bk.LAST_PATH["two_level"]
    digests = {_digest((f, *m, r)) for f, m, r in runs}
    assert len(digests) == 1
    if scene != "test_scene2":
        return
    want = bk.reference_backward(program, flat, rays, g, steps, 0.0, 5e-2,
                                 **kw)
    ref = rk.reference_march_normals(program, flat, rays, steps, 0.0, 5e-2)
    conv = (rays[6] > 0.5) & (ref[3].abs() < 1e-3)
    got_r, want_r = runs[0][2][:6][:, conv], want[2][:6][:, conv]
    assert float((got_r - want_r).abs().max()) <= (
        TOL_BWD_F32 * float(want_r.abs().max()))
    assert float((runs[0][0] - want[0]).abs().max()) <= (
        TOL_BWD_F32 * float(want[0].abs().max()))


@pytest.mark.cuda
def test_cuda_two_streams_keep_their_parameters(cuda):
    """Launches of one library with two parameter vectors, back to back on
    two streams, each read their own vector from the shared bank: the
    forward, the march and the backward each give the results of serial
    launches, every round."""
    program, flat, rays = _card_rays("test_scene2", cuda)
    flats = (flat, flat * 1.05)
    g = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (8,) + tuple(rays.shape[1:])), dtype=torch.float32).to(cuda)

    def work(f):
        return (rk.fused_march_normals(program, f, rays, 32, 0.0, 5e-2),
                mk.march_planes(program, f, rays, 32, 0.0),
                *bk.fused_backward(program, f, rays, g, 32, 0.0, 5e-2)[::2])

    want = [work(f) for f in flats]
    assert _digest(want[0]) != _digest(want[1])
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    for _ in range(8):
        got = []
        for f, s in zip(flats, streams):
            with torch.cuda.stream(s):
                got.append(work(f))
        torch.cuda.synchronize()
        assert [_digest(w) for w in want] == [_digest(x) for x in got]
