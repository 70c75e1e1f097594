"""The tensor-core MLP evaluation of the serving forward and the march
(``ops/csrc/neural.cuh`` ``rm_mlp_tc``), checked on the CPU.

The kernel cannot run here, so its arithmetic is emulated in plain torch
(:func:`_tc_distance`): layer 0 in the kernel's operation order, the hidden
layer from the prepared fragments (``ops/params.py`` ``tc_fragments``, read
back), summed one k-step at a time in f32 (3xTF32: ``lo·hi + hi·lo + hi·hi``
with ``cvt.rna`` rounding; bf16: one product of rounded operands), then the
bias, the activation and the output dot. Inputs: the trained w256 field of
``docs/neural_fit_w256`` at 4,096 seeded points.

Tolerances: ``chip_smoke.py`` holds the tensor-core kernel to ``TOL_F32``
and, with its control (the fragments' lo zeroed), to ``TOL_F32 / 10``,
which the kernel meets on every converged ray and the control misses: the
distance plane's 1e-5 is the f32 tolerance here (the plain f32 evaluator
is 2e-7 from f64). bf16 operands: ``TOL_BF16``'s distance plane, 1e-3.
"""

import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.scene import neural as jneural
from ray_marching_tpu_torch.io.checkpoint import load_pytree
from ray_marching_tpu_torch.ops import march_kernel as mk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import (
    pack_mats,
    pack_tc,
    split_params_padded,
    tc_fragments,
    tc_weights,
    tf32,
)
from ray_marching_tpu_torch.scene import codegen
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import neural as tneural
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = REPO / "docs" / "neural_fit_w256" / "weights.npz"
CSRC = REPO / "ray_marching_tpu_torch" / "ops" / "csrc"
#: The distance the tensor-core kernel may miss by (module doc).
TOL_F32 = 1e-5
TOL_BF16 = 1e-3
#: sha256 of the generated sources of the scenes without a tensor-core leaf,
#: as the generator wrote them before the tensor-core evaluation existed.
PER_THREAD_SOURCES = {
    "test_scene2":
        "01995bdb88b485bee773c22c8a51a6079fd70d4f52d88e5ee44821a37bdee8c1",
    "test_scene":
        "93b989af7cc5b0632446ee26c0a42e1a204cd9e35660b86950dbda5e1219d52f",
    "mandelbulb":
        "29bf4ad2bce69c7b83c765287b8cd1caa0cfe05a9a181efa06b8a4c74b32c04d",
}


def _w256_node(matmul_dtype="float32"):
    return tneural.NeuralSDF(hidden=(256, 256), seed=11, scale=0.5, w0=8.0,
                             impl="matmul", activation="sine_fast",
                             matmul_dtype=matmul_dtype)


def _w256_scene(matmul_dtype="float32"):
    return tgraph.Union(children=(
        tgraph.Onion(child=tgraph.Box(halfsides=(5.0, 5.0, 5.0)),
                     radius=0.1),
        _w256_node(matmul_dtype)))


@pytest.fixture(scope="module")
def w256():
    """The trained leaf's parameters (f32) and 4,096 seeded points."""
    params = load_pytree(WEIGHTS, tgraph.init_params(_w256_scene(),
                                                     torch.float32))["c1"]
    pts = np.random.default_rng(12).normal(size=(3, 4096)).astype(np.float32)
    return params, pts


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _tc_distance(node, params, pts, mode):
    """The kernel's arithmetic in plain torch: the distance at ``pts``
    (3, N). ``mode``: ``"3xtf32"`` (the f32 kernel), ``"1xtf32"`` (one TF32
    pass), ``"hi_only"`` (the fragments' lo zeroed, as chip_smoke.py's
    control feeds the kernel) or ``"bf16"``."""
    x, y, z = (torch.as_tensor(c)[:, None] for c in pts)
    bf16 = mode == "bf16"
    op = _bf16 if bf16 else (lambda t: t)
    w0m, b0 = params["w0"], params["b0"]
    # Layer 0 as rm_tc_unit0: from 0, inputs in order, bias, scale, act.
    acc = torch.zeros((x.shape[0], w0m.shape[1]), dtype=torch.float32)
    for i, c in enumerate((x, y, z)):
        acc = acc + op(c) * op(w0m[i])
    acc = acc + b0
    act = tneural._activation(node)
    h = act(acc * node.w0)
    w1 = params["w1"]
    nin, nout = w1.shape
    frags = tc_fragments(w1, bf16)
    if bf16:
        a_parts, w_parts, ks = [op(h)], [tc_weights(frags, nin, nout, True)], 16
    else:
        hi, lo = tc_weights(frags, nin, nout)
        h_hi, h_lo = tf32(h), tf32(h - tf32(h))
        a_parts, w_parts, ks = {
            "3xtf32": ([h_lo, h_hi, h_hi], [hi, lo, hi]),
            "hi_only": ([h_lo, h_hi], [hi, hi]),
            "1xtf32": ([h_hi], [hi]),
        }[mode] + (8,)
    acc = torch.zeros((h.shape[0], nout), dtype=torch.float32)
    for k in range(0, nin, ks):
        for a, w in zip(a_parts, w_parts):
            acc = acc + a[:, k:k + ks] @ w[k:k + ks]
    a = act(acc + params["b1"])
    mlp = (op(a) * op(params["w2"][:, 0])).sum(1) + params["b2"][0]
    base = torch.sqrt(x * x + y * y + z * z)[:, 0] - params["radius"]
    return base + mlp


def _plain_distance(node, params, pts):
    return tneural.neural_sdf(node)(params, *(torch.as_tensor(c)
                                              for c in pts))


def _jax_distance(node_kw, params, pts):
    jnode = jneural.NeuralSDF(**node_kw)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    return torch.as_tensor(np.array(jneural.neural_sdf_matmul(jnode)(
        jp, *(jnp.asarray(c) for c in pts))))


# -- (a) the kernel's arithmetic ---------------------------------------------


def test_3xtf32_within_the_f32_tolerance_of_plain_and_jax(w256):
    params, pts = w256
    node = _w256_node()
    got = _tc_distance(node, params, pts, "3xtf32")
    plain = _plain_distance(node, params, pts)
    jax_d = _jax_distance(dict(hidden=(256, 256), seed=11, scale=0.5,
                               w0=8.0, impl="matmul",
                               activation="sine_fast"), params, pts)
    assert got.dtype == torch.float32
    assert float((got - plain).abs().max()) <= TOL_F32
    assert float((got - jax_d).abs().max()) <= TOL_F32


@pytest.mark.parametrize("mode", ["1xtf32", "hi_only"])
def test_fewer_tf32_passes_miss_the_f32_tolerance(w256, mode):
    """One TF32 pass, and the control of chip_smoke.py (the weights' lo
    zeroed), miss it (4.8e-5 and 3.4e-5 against 2.4e-7 for 3xTF32): the
    check can see the precision."""
    params, pts = w256
    node = _w256_node()
    got = _tc_distance(node, params, pts, mode)
    plain = _plain_distance(node, params, pts)
    assert float((got - plain).abs().max()) > TOL_F32


def test_bf16_within_the_bf16_tolerance(w256):
    params, pts = w256
    node = _w256_node("bfloat16")
    got = _tc_distance(node, params, pts, "bf16")
    plain = _plain_distance(node, params, pts)
    assert float((got - plain).abs().max()) <= TOL_BF16


# -- (b) the prepared weights ------------------------------------------------


@pytest.mark.parametrize("shape", [(256, 256), (16, 16), (32, 24), (48, 8)])
def test_tf32_fragments_read_back(w256, shape):
    """hi = tf32(W), lo = tf32(W − hi), hi + lo within 2^-22 of W (lo keeps
    11 of the residual's 13 bits), each at the lane, k-step and n-tile
    neural.cuh reads it from."""
    if shape == (256, 256):
        w = w256[0]["w1"]
    else:
        w = torch.as_tensor(np.random.default_rng(sum(shape)).normal(
            size=shape).astype(np.float32))
    nin, nout = shape
    frags = tc_fragments(w)
    assert frags.dtype == torch.float32 and frags.numel() == 2 * nin * nout
    hi, lo = tc_weights(frags, nin, nout)
    assert torch.equal(hi, tf32(w)) and torch.equal(lo, tf32(w - hi))
    assert bool(((hi + lo) - w).abs().le(2.0**-22 * w.abs()).all())
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    rng = np.random.default_rng(nin)
    for _ in range(64):
        kt, nt = rng.integers(nin // 8), rng.integers(nout // 8)
        g, t = rng.integers(8), rng.integers(4)
        entry = frags[((kt * (nout // 8) + nt) * 32 + 4 * g + t) * 4:][:4]
        k, n = kt * 8 + t, nt * 8 + g
        assert entry.tolist() == [hi[k, n], hi[k + 4, n], lo[k, n],
                                  lo[k + 4, n]]


@pytest.mark.parametrize("shape", [(256, 256), (16, 16), (32, 24)])
def test_bf16_fragments_read_back(shape):
    nin, nout = shape
    w = torch.as_tensor(np.random.default_rng(nout).normal(
        size=shape).astype(np.float32))
    frags = tc_fragments(w, bf16=True)
    assert frags.numel() == nin * nout // 2
    assert torch.equal(tc_weights(frags, nin, nout, True), _bf16(w))
    halves = frags.view(torch.int32)
    rng = np.random.default_rng(nin)
    for _ in range(64):
        kt, nt = rng.integers(nin // 16), rng.integers(nout // 8)
        g, t, r = rng.integers(8), rng.integers(4), rng.integers(2)
        word = int(halves[((kt * (nout // 8) + nt) * 32 + 4 * g + t) * 2
                          + r]) & 0xFFFFFFFF
        for e in range(2):
            bits = torch.tensor([(word >> (16 * e)) & 0xFFFF],
                                dtype=torch.int32).to(torch.int16)
            got = bits.view(torch.bfloat16).float().item()
            assert got == _bf16(w)[kt * 16 + 8 * r + 2 * t + e, nt * 8 + g]


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # the TF32 ulp at 1
    cases = [(1.0 + 2.0**-11, one),                 # a tie: away from zero
             (-(1.0 + 2.0**-11), -one),
             (1.0 + 2.0**-11 - 2.0**-23, 1.0),      # below the tie
             (1.0 + 3 * 2.0**-11, 1.0 + 2 * 2.0**-10)]
    got = tf32(torch.tensor([c for c, _ in cases], dtype=torch.float32))
    assert got.tolist() == [w for _, w in cases]


def test_pack_tc_places_fragments_after_the_packed_matrices():
    program = SdfProgram(_w256_scene())
    params = tgraph.init_params(_w256_scene(), torch.float32)
    _, mats, _ = split_params_padded(params, torch.float32)
    packed = pack_mats(mats)
    buf = pack_tc(packed, mats, program.tc_mats)
    index, bf16, off = program.tc[0]
    assert (index, bf16, off) == (1, False, 0)
    assert buf.shape == (program.tc_size,)
    assert torch.equal(buf[:program.mat_size], packed)
    assert torch.equal(buf[program.mat_size:],
                       tc_fragments(mats[index]))
    assert program.mat_size % 128 == 0


# -- (c) the generated code --------------------------------------------------


@pytest.mark.parametrize("name", ["w256", "neural_demo"])
def test_tc_leaf_generated_and_called_from_the_switch_only(name):
    scene = (_w256_scene() if name == "w256"
             else treg.make_scene("neural_demo"))
    program = SdfProgram(scene)
    assert list(program.tc) == [0]
    src = program.cuda_source()
    assert "#define SCENE_TC 1" in src
    assert src.count("neural_leaf_tc_0(") == 2  # defined once, called once
    sdf = src[src.index("T scene_sdf(const"):src.index("T scene_sdf_vjp(")]
    assert "template <typename T, bool TC = false>" in src
    call = sdf.index("neural_leaf_tc_0(")
    assert sdf.rindex("if constexpr (TC) {", 0, call) > sdf.rfind("}", 0, call)
    assert "neural_leaf_tc_" not in src[src.index("T scene_sdf_vjp("):]
    sizes = program.mlps[0].sizes
    frag = f"M + {program.mat_size}, "
    assert (f"rm_mlp_tc<{sizes[1]}, {sizes[2]}, " in src and frag in src)


def test_kernels_take_the_switch_in_the_serving_and_march_entries_only():
    """``scene_sdf<…, true>`` (through march_sdf and the masked march_ray)
    is instantiated by render_fwd_tc_kernel and march_tc_kernel alone; the
    training forward and the backward kernel never name the switch."""
    fwd = (CSRC / "render_fwd.cu").read_text()
    march = (CSRC / "march.cu").read_text()
    assert "SCENE_TC" not in (CSRC / "render_bwd.cu").read_text()
    for text, kernel in ((fwd, "render_fwd_tc_kernel"),
                         (march, "march_tc_kernel")):
        start = text.index(f"{kernel}(const float*")
        body = text[start:text.index("\n}\n", start)]
        assert "march_ray<float, NoObserver, true>" in body
        rest = text[:start] + text[text.index("\n}\n", start):]
        assert "NoObserver, true>" not in rest
    train = fwd[fwd.index("render_fwd_train_kernel(const T*"):]
    train = train[:train.index("\n}\n")]
    assert "march_ray<T>(" in train and "store_hit<T>(" in train
    assert "march_sdf" not in train and "scene_sdf<" not in train


@pytest.mark.parametrize("name", sorted(PER_THREAD_SOURCES))
def test_scenes_without_a_tc_leaf_generate_the_same_source(name):
    program = SdfProgram(treg.make_scene(name))
    src = program.cuda_source()
    assert not program.tc and "SCENE_TC" not in src
    assert hashlib.sha256(src.encode()).hexdigest() == PER_THREAD_SOURCES[name]


@pytest.mark.parametrize("hidden,impl,takes", [
    ((256, 256), "matmul", True),
    ((16, 16), "auto", True),
    ((32, 8), "matmul", True),
    ((16, 16), "componentwise", False),
    ((8, 8), "matmul", False),            # input width not a k-step
    ((16, 12), "matmul", False),          # output width not an n-tile
    ((16, 264), "matmul", False),         # more accumulators than a lane has
    ((256, 256, 256), "matmul", False),   # three hidden layers
    ((256,), "matmul", False),
])
def test_tc_leaf_predicate(hidden, impl, takes):
    node = tneural.NeuralSDF(hidden=hidden, impl=impl)
    program = SdfProgram(node)
    assert codegen.tc_leaf(program.mlps[0]) is takes
    assert bool(program.tc) is takes


# -- (d) routing by gradient -------------------------------------------------


def test_mlp_route():
    tc = SdfProgram(_w256_scene())
    plain = SdfProgram(treg.make_scene("test_scene2"))
    assert rk.mlp_route(tc, torch.float32) == "tc"
    assert rk.mlp_route(tc, torch.float64) == "thread"
    assert rk.mlp_route(plain, torch.float32) == "thread"


@pytest.fixture
def demo_rays():
    """neural_demo at one row of 128 rays, f32, on the CPU."""
    scene = treg.make_scene("neural_demo")
    program = SdfProgram(scene)
    params = tgraph.init_params(scene, torch.float32)
    flat, mats, _ = split_params_padded(params, torch.float32)
    rng = np.random.default_rng(3)
    p = rng.uniform(-1.0, 1.0, (3, 1, 128))
    v = rng.normal(size=(3, 1, 128))
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    rays7 = torch.as_tensor(np.concatenate([p, v, np.ones((1, 1, 128))]),
                            dtype=torch.float32)
    return program, flat, mats, rays7


def _routes(monkeypatch):
    seen = []
    check = rk._check_route

    def spy(program, rays7, route, tc_mats=None):
        seen.append(route)
        return check(program, rays7, route, tc_mats)

    monkeypatch.setattr(rk, "_check_route", spy)
    return seen


def test_wrappers_route_by_gradient(demo_rays, monkeypatch):
    """march_planes and fused_march_normals: the tensor-core entry without a
    gradient, the per-thread entry under one; the implicit backward's
    forward keeps the serving route; the training outputs the per-thread
    one."""
    program, flat, mats, rays7 = demo_rays
    seen = _routes(monkeypatch)
    mk.march_planes(program, flat, rays7, 2, 0.0, mats)
    rk.fused_march_normals(program, flat, rays7, 2, 0.0, 5e-2, mats=mats)
    rk.fused_march_normals_cov(program, flat, rays7, 2, 0.0, 5e-2,
                               mats=mats)
    assert seen == ["tc", "tc", "thread"]
    seen.clear()
    grad = flat.clone().requires_grad_(True)
    mk.march_planes(program, grad, rays7, 2, 0.0, mats)
    for bwd_hist in (True, False):
        rk.fused_march_normals(program, grad, rays7, 2, 0.0, 5e-2,
                               bwd_hist=bwd_hist, mats=mats)
    rk.fused_march_normals_ift(program, grad, rays7, 2, 0.0, 5e-2,
                               mats=mats)
    assert seen == ["thread", "thread", "thread", "tc"]


def test_route_errors(demo_rays):
    program, flat, mats, rays7 = demo_rays
    with pytest.raises(ValueError, match="training outputs"):
        rk.march_forward(program, flat, rays7, 2, 0.0, 5e-2, log_hist=True,
                         mats=mats, route="tc")
    with pytest.raises(ValueError, match="tensor-core route"):
        rk.march_forward(program, flat.double(), rays7.double(), 2, 0.0,
                         5e-2, mats=tuple(m.double() for m in mats),
                         route="tc")
    analytic = SdfProgram(treg.make_scene("test_scene2"))
    a_flat, _, _ = split_params_padded(
        tgraph.init_params(treg.make_scene("test_scene2"), torch.float32),
        torch.float32)
    with pytest.raises(ValueError, match="tensor-core route"):
        mk.march_forward(analytic, a_flat, rays7, 2, 0.0, route="tc")
    with pytest.raises(ValueError, match="route must be"):
        mk.march_forward(program, flat, rays7, 2, 0.0, mats, route="mma")
    buf = rk.tc_buffer(program, mats)
    assert buf.shape == (program.tc_size,)
    for bad, route in ((buf[1:], "tc"), (buf.double(), "tc"),
                       (buf, "thread")):
        with pytest.raises(ValueError, match="tc_mats must be"):
            rk.march_forward(program, flat, rays7, 2, 0.0, 5e-2, mats=mats,
                             route=route, tc_mats=bad)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _card_rays(cuda, n_rows=32, seed=14, span=1.5):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-span, span, (3, n_rows, 128))
    v = -p / np.linalg.norm(p, axis=0, keepdims=True)
    valid = (rng.uniform(size=(1, n_rows, 128)) > 0.1).astype(np.float64)
    return torch.as_tensor(np.concatenate([p, v, valid]),
                           dtype=torch.float32, device=cuda).contiguous()


def _outside(got, want, tol, conv):
    out = torch.zeros_like(conv)
    for i, t in enumerate(tol):
        out |= ((got[i] - want[i]).abs() > t) & conv
    return float(out.sum()) / max(int(conv.sum()), 1)


TOL_PLANES_F32 = (1e-4, 1e-4, 1e-4, 1e-4, 1e-3, 1e-3, 1e-3, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.0, 1e-3])
def test_cuda_tc_kernels_match_plain_and_each_other(cuda, tau):
    """The tensor-core forward and march on the trained w256 field against
    the plain version (chip_smoke.py's TOL_F32, at most 1e-3 of the
    converged rays outside), the march equal to the forward's planes 0-3
    bit for bit, and a differentiated march equal to the training forward's
    planes bit for bit. At tau = 0 the kernel also within a tenth of
    TOL_F32, and the 1xTF32 control (the fragments' lo zeroed) outside it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = _w256_scene()
    program = SdfProgram(scene)
    params = load_pytree(WEIGHTS, tgraph.init_params(scene, torch.float32,
                                                     cuda))
    flat, mats, _ = split_params_padded(params, torch.float32)
    rays7 = _card_rays(cuda)
    rk.TC_LAUNCHES = mk.TC_LAUNCHES = 0
    got = rk.fused_march_normals(program, flat, rays7, 24, tau, 5e-2,
                                 mats=mats)
    march = mk.march_planes(program, flat, rays7, 24, tau, mats)
    want = rk.reference_march_normals(program, flat, rays7, 24, tau, 5e-2,
                                      mats=mats)
    train, _ = rk.march_forward(program, flat, rays7, 24, tau, 5e-2,
                                log_hist=True, mats=mats)
    grad = flat.clone().requires_grad_(True)
    grad_march = mk.march_planes(program, grad, rays7, 24, tau, mats)
    buf = rk.tc_buffer(program, mats)
    buf[program.mat_size:].view(-1, 4)[:, 2:] = 0
    control, _ = rk.march_forward(program, flat, rays7, 24, tau, 5e-2,
                                  mats=mats, tc_mats=buf)
    torch.cuda.synchronize()
    assert (rk.TC_LAUNCHES, mk.TC_LAUNCHES) == (2, 1)
    conv = (rays7[6] > 0.5) & (want[3].abs() < 1e-3)
    assert int(conv.sum()) > 1000
    assert _outside(got, want, TOL_PLANES_F32, conv) <= 1e-3
    assert torch.equal(march, got[:4])
    assert torch.equal(grad_march.detach(), train[:4])
    tight = tuple(t / 10 for t in TOL_PLANES_F32)
    if tau == 0.0:
        assert _outside(got, want, tight, conv) <= 1e-3
        assert _outside(control, want, tight, conv) > 1e-3


@pytest.mark.cuda
def test_cuda_tc_bf16_and_neural_demo_match_plain(cuda):
    """bf16 operands within chip_smoke.py's TOL_BF16 (1e-2 of the converged
    rays outside at most); neural_demo's 16 -> 16 layer on the tensor cores
    within TOL_F32, its march equal to the forward's planes 0-3."""
    tol_bf16 = (1e-3, 1e-3, 1e-3, 1e-3, 1e-2, 1e-2, 1e-2, 1.0)
    rays7 = _card_rays(cuda, n_rows=16, seed=15)
    for scene, tol, share in (
            (_w256_scene("bfloat16"), tol_bf16, 1e-2),
            (treg.make_scene("neural_demo"), TOL_PLANES_F32, 1e-3)):
        program = SdfProgram(scene)
        params = tgraph.init_params(scene, torch.float32, cuda)
        if scene.children[1].__class__.__name__ == "NeuralSDF":
            params = load_pytree(WEIGHTS, params)
        flat, mats, _ = split_params_padded(params, torch.float32)
        got = rk.fused_march_normals(program, flat, rays7, 24, 0.0, 5e-2,
                                     mats=mats)
        march = mk.march_planes(program, flat, rays7, 24, 0.0, mats)
        want = rk.reference_march_normals(program, flat, rays7, 24, 0.0,
                                          5e-2, mats=mats)
        torch.cuda.synchronize()
        conv = (rays7[6] > 0.5) & (want[3].abs() < 1e-3)
        assert int(conv.sum()) > 100
        assert _outside(got, want, tol, conv) <= share
        assert torch.equal(march, got[:4])
