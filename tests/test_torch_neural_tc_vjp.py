"""The tensor-core VJP of the backward kernel and the tensor-core training
path (``ops/csrc/neural.cuh`` ``rm_mlp_tc_vjp``, ``render_bwd.cu`` with
``TC``, ``render_fwd.cu`` ``render_fwd_train_tc_kernel``), checked on the
CPU.

The kernels cannot run here, so:

- the fragment layouts are read back and driven through an emulated
  ``mma.sync`` (m16n8k8, f64) with the kernel's own index arithmetic: the
  prepared ``Wᵀ`` of ``δ·Wᵀ`` (``ops/params.py`` ``tc_bwd_fragments``) fed
  by δ straight from its C layout, and the sink's ``h1ᵀ·δ2`` from the
  shared-memory staging;
- the VJP's arithmetic is emulated in plain torch (:func:`_tc_vjp`): the
  primal as the serving kernel computes it, δ split as TF32 hi + lo in every
  product with it (3xTF32 in f32; bf16 operands, exact in TF32, times δ's
  two halves), summed one k-step (8) at a time in f32 (in f32 the
  corrections and hi·hi in two sums, ``neural.cuh``'s
  ``rm_mma_3xtf32_split``), and held against ``scene/neural.py`` ``mlp_vjp`` and the JAX package's ``jax.vjp`` of
  ``neural_sdf_matmul`` on the trained w256 field at 64 seeded points.

Tolerances, relative to each output's largest entry (the point cotangent,
every matrix and bias cotangent): f32 against f64 ``TOL_VJP`` = 1e-5, which
the emulation meets (about 1e-6, as the plain f32 VJP) and a 1xTF32 control
misses (about 1e-3); bf16 operands against the plain bf16 rule
``TOL_VJP_BF16`` = 2^-8 (one bf16 rounding of an input cotangent near a
rounding boundary, as ``tests/test_torch_neural_train.py`` allows).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.scene import neural as jneural
from ray_marching_tpu_torch.io.checkpoint import load_pytree
from ray_marching_tpu_torch.ops import backward_kernel as bk
from ray_marching_tpu_torch.ops import march_kernel as mk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import (
    pack_mats,
    pack_tc,
    split_params_padded,
    tc_bwd_fragments,
    tc_bwd_segment,
    tc_bwd_weights,
    tc_fragments,
    tf32,
)
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import neural as tneural
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.codegen import SdfProgram

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = REPO / "docs" / "neural_fit_w256" / "weights.npz"
CSRC = REPO / "ray_marching_tpu_torch" / "ops" / "csrc"
TOL_VJP = 1e-5
TOL_VJP_BF16 = 2.0 ** -8
#: The kernel's shared-memory row strides (neural.cuh RM_TC_LDH, RM_TC_LDD).
LDH, LDD = 136, 40

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
    """The trained leaf's parameters (f32), 64 seeded points near the
    surface and a cotangent per point."""
    params = load_pytree(WEIGHTS, tgraph.init_params(_w256_scene(),
                                                     torch.float32))["c1"]
    rng = np.random.default_rng(21)
    pts = (rng.normal(size=(3, 64)) * 0.4).astype(np.float32)
    g = rng.normal(size=64).astype(np.float32)
    return params, pts, g


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


# -- an emulated mma.sync and the kernel's fragment indexing -------------------

LANE = np.arange(32)
GID, TIG = LANE // 4, LANE % 4


def _mma(a, b):
    """m16n8k8 on per-lane registers (f64): a (32, 4), b (32, 2) -> c (32,
    4), in mma.sync's fragment layout."""
    A = np.zeros((16, 8))
    A[GID, TIG], A[GID + 8, TIG] = a[:, 0], a[:, 1]
    A[GID, TIG + 4], A[GID + 8, TIG + 4] = a[:, 2], a[:, 3]
    B = np.zeros((8, 8))
    B[TIG, GID], B[TIG + 4, GID] = b[:, 0], b[:, 1]
    C = A @ B
    return np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1],
                     C[GID + 8, 2 * TIG], C[GID + 8, 2 * TIG + 1]], 1)


def _kept(mat):
    """A warp's (32 x N) matrix as each lane keeps it (rm_tc_ci): (32, N)."""
    n = mat.shape[1]
    kept = np.zeros((32, n))
    for nt in range(n // 8):
        for mt in range(2):
            for e in range(4):
                kept[:, (nt * 2 + mt) * 4 + e] = mat[
                    mt * 16 + GID + 8 * (e >> 1), nt * 8 + 2 * TIG + (e & 1)]
    return kept


def _delta_wt(delta, frags, nin, nout, bf16):
    """rm_mlp_tc_vjp's W·δ product on the emulated mma: δ (32 rays x nout)
    from its kept C layout, Wᵀ from the prepared fragments; (32, nin)."""
    kept = _kept(delta)
    per = 2 if bf16 else 4
    f = frags.double().numpy().reshape(nout // 8, nin // 8, 32, per)
    out = np.zeros((32, nin))
    for mt in range(2):
        for nt in range(nin // 8):
            c = np.zeros((32, 4))
            for kt in range(nout // 8):
                a = np.stack([kept[:, (kt * 2 + mt) * 4 + (r & 1) * 2
                                   + (r >> 1)] for r in range(4)], 1)
                b = f[kt, nt][:, :2]
                if not bf16:
                    b = b + f[kt, nt][:, 2:]  # hi + lo
                c += _mma(a, b)
            for e in range(4):
                out[mt * 16 + GID + 8 * (e >> 1),
                    nt * 8 + 2 * TIG + (e & 1)] = c[:, e]
    return out


def _sink(h1, d2):
    """rm_mlp_tc_vjp's sink h1ᵀ·δ2 on the emulated mma, its operands read
    from the shared-memory staging as the kernel reads them (rows of the
    block's rays at strides LDH / LDD; chunks of 128 units, 32 columns).
    h1 (R rays x nin), d2 (R x nout), R a multiple of 8; (nin, nout)."""
    rays, nin = h1.shape
    nout = d2.shape[1]
    out = np.zeros((nin, nout))
    for i0 in range(0, nin, 128):
        iw = min(128, nin - i0)
        buf_h = np.zeros((rays, LDH))
        buf_h[:, :iw] = h1[:, i0:i0 + iw]
        for j0 in range(0, nout, 32):
            jw = min(32, nout - j0)
            buf_d = np.zeros((rays, LDD))
            buf_d[:, :jw] = d2[:, j0:j0 + jw]
            hf, df = buf_h.reshape(-1), buf_d.reshape(-1)
            for mt in range(iw // 16):
                for nt in range(jw // 8):
                    c = np.zeros((32, 4))
                    for kt in range(rays // 8):
                        h0 = (kt * 8 + TIG) * LDH
                        h4 = h0 + 4 * LDH
                        u = mt * 16 + GID
                        a = np.stack([hf[h0 + u], hf[h0 + u + 8], hf[h4 + u],
                                      hf[h4 + u + 8]], 1)
                        d0 = (kt * 8 + TIG) * LDD + nt * 8 + GID
                        b = np.stack([df[d0], df[d0 + 4 * LDD]], 1)
                        c += _mma(a, b)
                    for e in range(4):
                        out[i0 + mt * 16 + GID + 8 * (e >> 1),
                            j0 + nt * 8 + 2 * TIG + (e & 1)] = c[:, e]
    return out


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(256, 256), (16, 16), (32, 24)])
def test_wt_fragments_read_back(w256, shape, bf16):
    """Wᵀ's fragments: hi = tf32(W), lo = tf32(W − hi) (bf16: W rounded,
    exact in TF32), each where lane (g, t) reads it for k-step kt and
    n-tile nt: W[nt·8 + g, kt·8 + 2t] and the next column."""
    if shape == (256, 256):
        w = w256[0]["w1"]
    else:
        w = torch.as_tensor(np.random.default_rng(sum(shape)).normal(
            size=shape).astype(np.float32))
    nin, nout = shape
    frags = tc_bwd_fragments(w, bf16)
    per = 2 if bf16 else 4
    assert frags.dtype == torch.float32 and frags.numel() == per * nin * nout // 2
    assert tc_bwd_segment(nin, nout, bf16) >= frags.numel()
    if bf16:
        hi, lo = tc_bwd_weights(frags, nin, nout, True), None
        assert torch.equal(hi, _bf16(w)) and torch.equal(tf32(hi), hi)
    else:
        hi, lo = tc_bwd_weights(frags, nin, nout)
        assert torch.equal(hi, tf32(w)) and torch.equal(lo, tf32(w - hi))
    rng = np.random.default_rng(nin + bf16)
    for _ in range(64):
        kt, nt = rng.integers(nout // 8), rng.integers(nin // 8)
        g, t = rng.integers(8), rng.integers(4)
        entry = frags[((kt * (nin // 8) + nt) * 32 + 4 * g + t) * per:][:per]
        r, c = nt * 8 + g, kt * 8 + 2 * t
        want = [hi[r, c], hi[r, c + 1]] + ([] if bf16 else [lo[r, c],
                                                             lo[r, c + 1]])
        assert entry.tolist() == want


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(256, 256), (16, 16), (32, 24)])
def test_delta_wt_product_from_the_c_layout(shape, bf16):
    """δ enters W·δ as mma's A operand straight from the primal's C layout
    (entries 0 2 1 3): with Wᵀ's k rows prepared in that order the product
    is δ·Wᵀ; with the plain order (tc_fragments of Wᵀ) it is not."""
    nin, nout = shape
    rng = np.random.default_rng(nin * nout + bf16)
    w = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    delta = rng.normal(size=(32, nout))
    frags = tc_bwd_fragments(w, bf16)
    wref = (_bf16(w) if bf16 else w).double().numpy()
    got = _delta_wt(delta, frags, nin, nout, bf16)
    want = delta @ wref.T
    tol = 1e-12 if bf16 else 2.0 ** -21
    assert np.abs(got - want).max() <= tol * np.abs(delta).sum(1).max() * \
        np.abs(wref).max()
    if not bf16:
        plain = tc_fragments(w.T.contiguous())
        wrong = _delta_wt(delta, plain, nin, nout, bf16)
        assert np.abs(wrong - want).max() > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(256, 256), (16, 16), (32, 24)])
def test_sink_product_from_the_staging(shape):
    """The sink's h1ᵀ·δ2, K = the block's 128 rays, from the staged rows:
    the kernel's A (units gid / gid + 8 at rays tig / tig + 4) and B (rays
    tig / tig + 4 at column gid) reads give the product."""
    nin, nout = shape
    rng = np.random.default_rng(nin + 3 * nout)
    h1 = rng.normal(size=(128, nin))
    d2 = rng.normal(size=(128, nout))
    np.testing.assert_allclose(_sink(h1, d2), h1.T @ d2, rtol=1e-12,
                               atol=1e-12)


def test_pack_tc_appends_the_backward_fragments():
    program = SdfProgram(_w256_scene())
    params = tgraph.init_params(_w256_scene(), torch.float32)
    _, mats, _ = split_params_padded(params, torch.float32)
    packed = pack_mats(mats)
    fwd = pack_tc(packed, mats, program.tc_mats)
    bwd = pack_tc(packed, mats, program.tc_mats, backward=True)
    assert fwd.shape == (program.tc_size,)
    assert bwd.shape == (program.tc_bwd_size,)
    assert torch.equal(bwd[:program.tc_size], fwd)
    off = program.mat_size + program.tc_bwd[0]
    assert off == program.tc_size and off % 128 == 0
    assert torch.equal(bwd[off:], tc_bwd_fragments(mats[1]))
    buf = rk.tc_buffer(program, [m.requires_grad_(True) for m in mats],
                       backward=True)
    assert not buf.requires_grad and torch.equal(buf, bwd)


# -- the VJP's arithmetic -------------------------------------------------------


def _ksteps(a_parts, w_parts, k):
    """Σ over the K dimension one k-step at a time (f32), the parts of each
    step in order: Σ_step Σ_part a[:, step] @ w[step]."""
    acc = torch.zeros((a_parts[0].shape[0], w_parts[0].shape[1]),
                      dtype=torch.float32)
    for s in range(0, a_parts[0].shape[1], k):
        for a, w in zip(a_parts, w_parts):
            acc = acc + a[:, s:s + k] @ w[s:s + k]
    return acc


def _fresh_ksteps(a_parts, w_parts, k):
    """As :func:`_ksteps`, each step's parts summed from zero first and then
    added to the running sum: the primal's order (neural.cuh
    ``rm_mma_3xtf32``)."""
    acc = torch.zeros((a_parts[0].shape[0], w_parts[0].shape[1]),
                      dtype=torch.float32)
    for s in range(0, a_parts[0].shape[1], k):
        t = torch.zeros_like(acc)
        for a, w in zip(a_parts, w_parts):
            t = t + a[:, s:s + k] @ w[s:s + k]
        acc = acc + t
    return acc


def _both_ksteps(a_parts, w_parts, k):
    """The VJP's and the sink's order (neural.cuh ``rm_mma_3xtf32_split``):
    the two correction parts of every step into one sum, the third part
    (hi·hi) into another, the two added at the end."""
    cor = torch.zeros((a_parts[0].shape[0], w_parts[0].shape[1]),
                      dtype=torch.float32)
    acc = torch.zeros_like(cor)
    for s in range(0, a_parts[0].shape[1], k):
        for a, w in zip(a_parts[:2], w_parts[:2]):
            cor = cor + a[:, s:s + k] @ w[s:s + k]
        acc = acc + a_parts[2][:, s:s + k] @ w_parts[2][s:s + k]
    return acc + cor


def _split(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def _tc_vjp(node, params, pts, g, mode):
    """The kernel's VJP arithmetic in plain torch for the MLP alone: ``mode``
    ``"3xtf32"`` (f32), ``"1xtf32"`` (the control: one TF32 pass for every
    product, δ and a rounded to TF32) or ``"bf16"`` (bf16 operands).
    Returns ``(gx, gy, gz, grads)`` like ``scene/neural.py`` ``mlp_vjp``,
    the bias cotangents summed over the points."""
    x, y, z = (torch.as_tensor(c)[:, None] for c in pts)
    g = torch.as_tensor(g)[:, None]
    bf16 = mode == "bf16"
    op = _bf16 if bf16 else (lambda t: t)
    act = tneural._activation(node)
    w0m, b0, w1, b1 = params["w0"], params["b0"], params["w1"], params["b1"]
    wo = params["w2"][:, 0]
    pre = torch.zeros((x.shape[0], w0m.shape[1]), dtype=torch.float32)
    for i, c in enumerate((x, y, z)):
        pre = pre + op(c) * op(w0m[i])
    pre = (pre + b0) * node.w0
    h1, s1 = act(pre), tneural._act_slope(node, pre)
    # The primal's hidden layer, as the serving kernel takes it.
    if bf16:
        z2 = _ksteps([op(h1)], [op(w1)], 16)
    else:
        (hh, hl), (wh, wl) = _split(h1), _split(w1)
        z2 = _fresh_ksteps([hl, hh, hh], [wh, wl, wh], 8)
    v2 = z2 + b1
    h2, s2 = act(v2), tneural._act_slope(node, v2)
    d2 = op(op(wo) * g) * s2
    (dh, dl) = _split(d2)
    if bf16:
        gh = _ksteps([dl, dh], [op(w1).T] * 2, 8)
        sink = _ksteps([dl.T, dh.T], [op(h1)] * 2, 8).T
    elif mode == "3xtf32":
        gh = _both_ksteps([dl, dh, dh], [wh.T, wl.T, wh.T], 8)
        sink = _both_ksteps([dh.T, dl.T, dh.T], [hl, hh, hh], 8).T
    else:
        gh = _ksteps([dh], [wh.T], 8)
        sink = _ksteps([dh.T], [tf32(h1)], 8).T
    d1 = (op(gh) * s1) * node.w0
    gin = op(d1 @ op(w0m).T)
    xs = torch.cat([op(x), op(y), op(z)], 1)
    grads = {"w0": xs.T @ d1, "b0": d1.sum(0), "w1": sink,
             "b1": d2.sum(0), "w2": (op(h2) * g).sum(0)[:, None],
             "b2": g.sum(0)}
    return gin[:, 0], gin[:, 1], gin[:, 2], grads


def _plain_vjp(node, params, pts, g, dtype):
    p = {k: v.to(dtype) for k, v in params.items()}
    gx, gy, gz, grads = tneural.mlp_vjp(
        node, p, *(torch.as_tensor(c).to(dtype) for c in pts),
        torch.as_tensor(g).to(dtype))
    grads = {k: v.sum(1) if k.startswith("b") else v
             for k, v in grads.items()}
    return gx, gy, gz, grads


def _jax_vjp(node_kw, params, pts, g):
    """jax.vjp of neural_sdf_matmul without its skip term, f64."""
    jnode = jneural.NeuralSDF(**node_kw)
    jp = {k: jnp.asarray(v.double().numpy()) for k, v in params.items()}

    def mlp(p, x, y, z):
        d = jneural.neural_sdf_matmul(jnode)(p, x, y, z)
        return d - (jnp.sqrt(x * x + y * y + z * z) - p["radius"])

    _, vjp = jax.vjp(mlp, jp, *(jnp.asarray(c, jnp.float64) for c in pts))
    gp, gx, gy, gz = vjp(jnp.asarray(g, jnp.float64))
    grads = {k: torch.as_tensor(np.array(v)) for k, v in gp.items()
             if k != "radius"}
    return (*(torch.as_tensor(np.array(c)) for c in (gx, gy, gz)),
            grads)


def _errors(got, want):
    """Largest difference over the largest reference entry: the point's
    cotangent (3 planes together), then every parameter cotangent."""
    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())

    errs = {"point": rel(torch.stack(got[:3]), torch.stack(want[:3]))}
    for k, w in want[3].items():
        errs[k] = rel(got[3][k].reshape(w.shape), w)
    return errs


W256_KW = dict(hidden=(256, 256), seed=11, scale=0.5, w0=8.0, impl="matmul",
               activation="sine_fast")


def test_tc_vjp_3xtf32_within_tolerance_of_f64_plain_and_jax(w256):
    """The kernel's f32 arithmetic against f64: the port's plain VJP and
    JAX's jax.vjp agree with each other to 1e-12, and the emulation meets
    TOL_VJP against both, as the plain f32 VJP does."""
    params, pts, g = w256
    node = _w256_node()
    got = _tc_vjp(node, params, pts, g, "3xtf32")
    plain64 = _plain_vjp(node, params, pts, g, torch.float64)
    jax64 = _jax_vjp(W256_KW, params, pts, g)
    assert max(_errors(plain64, jax64).values()) <= 1e-12
    assert max(_errors(got, plain64).values()) <= TOL_VJP
    assert max(_errors(got, jax64).values()) <= TOL_VJP
    plain32 = _plain_vjp(node, params, pts, g, torch.float32)
    assert max(_errors(plain32, plain64).values()) <= TOL_VJP


def test_tc_vjp_1xtf32_control_misses_the_tolerance(w256):
    """One TF32 pass per product misses TOL_VJP on the point's cotangent
    and the hidden matrix: the check sees the precision of the split."""
    params, pts, g = w256
    node = _w256_node()
    plain64 = _plain_vjp(node, params, pts, g, torch.float64)
    errs = _errors(_tc_vjp(node, params, pts, g, "1xtf32"), plain64)
    assert errs["point"] > TOL_VJP and errs["w1"] > TOL_VJP


def test_tc_vjp_bf16_follows_the_bf16_rule(w256):
    """bf16 operands: the emulation (W and a rounded, δ split into two TF32
    halves, sums f32, the input cotangents rounded) against the plain bf16
    VJP of scene/neural.py, and the matrix cotangents never rounded."""
    params, pts, g = w256
    node = _w256_node("bfloat16")
    got = _tc_vjp(node, params, pts, g, "bf16")
    plain = _plain_vjp(node, params, pts, g, torch.float32)
    assert max(_errors(got, plain).values()) <= TOL_VJP_BF16
    for k in ("w0", "w1", "w2"):
        m = got[3][k]
        assert not torch.equal(m, _bf16(m))
    for c in got[:3]:
        assert torch.equal(c, _bf16(c))


# -- the generated code ------------------------------------------------------------


@pytest.mark.parametrize("name", ["w256", "w256 bf16", "neural_demo"])
def test_tc_leaf_backward_calls_the_tensor_core_vjp(name):
    """A tc_leaf scene's scene_sdf_vjp takes the switch: its TC branch keeps
    the primal on the tensor cores and calls rm_mlp_tc_vjp with the
    backward fragments after the forward ones; its other branch is the
    per-thread VJP, as before."""
    scene = {"w256": _w256_scene(), "w256 bf16": _w256_scene("bfloat16"),
             "neural_demo": treg.make_scene("neural_demo")}[name]
    program = SdfProgram(scene)
    src = program.cuda_source()
    vjp = src[src.index("T scene_sdf_vjp("):]
    assert "template <typename T, bool TC = false>\n__device__ " \
           "__forceinline__ T scene_sdf_vjp(" in src
    sizes = program.mlps[0].sizes
    assert f"alignas(16) T keep0[TC ? {sizes[2]} : " in vjp
    for call in ("neural_leaf_keep_tc_0(P, M, ", "neural_leaf_vjp_tc_0(P, M, ",
                 "sink.active ? neural_leaf_keep_0<T>(P, M, ",
                 "neural_leaf_vjp_0<T>(P, M, "):
        assert vjp.count(call) == 1, call
        branch = vjp[:vjp.index(call)]
        assert branch.rindex("if constexpr (TC) {") > branch.rfind("}\n  T ")
    bf16 = str(program.tc[0][1]).lower()
    head = f"rm_mlp_tc_vjp<{sizes[1]}, {sizes[2]}, "
    assert src.count(head) == 1
    assert re.search(head + r"RM_ACT_\w+, " + bf16 + r", \w+>\(", src)
    frag = f"M + {program.mat_size + program.tc_bwd[0]}, "
    assert frag in src[src.index(head):]
    assert f"rm_mlp_tc<{sizes[1]}, {sizes[2]}, " in src
    assert ", true>(" in src[src.index("neural_leaf_keep_tc_0("):]


def test_f64_and_other_leaves_keep_the_per_thread_route():
    """f64, a leaf outside tc_leaf's shape and the analytic scenes route
    per thread; a tensor-core leaf beside a per-thread one keeps both
    VJPs."""
    tc = SdfProgram(_w256_scene())
    assert rk.mlp_route(tc, torch.float32) == "tc"
    assert rk.mlp_route(tc, torch.float64) == "thread"
    other = SdfProgram(tneural.NeuralSDF(hidden=(8, 8), impl="matmul"))
    assert not other.tc and rk.mlp_route(other, torch.float32) == "thread"
    both = SdfProgram(tgraph.Union(children=(
        tneural.NeuralSDF(hidden=(16, 16), impl="matmul"),
        tneural.NeuralSDF(hidden=(8, 8), impl="matmul", seed=3))))
    assert list(both.tc) == [0]
    src = both.cuda_source()
    assert "neural_leaf_vjp_tc_0(" in src and "neural_leaf_vjp_tc_1(" not in src
    vjp = src[src.index("T scene_sdf_vjp("):]
    assert "neural_leaf_vjp_1<T>(" in vjp


def test_backward_kernel_op_count_is_unchanged():
    """backward_ops keeps its convention: the tensor-core route changes how
    the VJP runs, not what it needs (415,582 ops per w256 SDF VJP)."""
    program = SdfProgram(_w256_scene())
    assert program.vjp_ops_per_eval == 415_582
    assert bk.backward_ops(program, 1, 24) == (
        5 * 415_582 + bk.OPS_BWD_TAIL + 24 * (415_582 + bk.OPS_BWD_STEP))


# -- the routes ----------------------------------------------------------------------


@pytest.fixture
def demo():
    """neural_demo (16 -> 16 on the tensor cores) at one row of 128 rays,
    f32, on the CPU."""
    scene = treg.make_scene("neural_demo")
    program = SdfProgram(scene)
    params = tgraph.init_params(scene, torch.float32)
    flat, mats, _ = split_params_padded(params, torch.float32)
    rng = np.random.default_rng(5)
    p = rng.uniform(-1.0, 1.0, (3, 1, 128))
    v = -p / np.linalg.norm(p, axis=0, keepdims=True)
    rays7 = torch.as_tensor(np.concatenate([p, v, np.ones((1, 1, 128))]),
                            dtype=torch.float32)
    return program, flat, mats, rays7


def test_backward_routes_follow_their_forward(demo, monkeypatch):
    """_FusedMarch and _March hand their route to fused_backward and
    march_backward (the tensor-core one in f32); the CPU takes the plain
    versions whichever the route, with the same result."""
    program, flat, mats, rays7 = demo
    seen = []
    for mod, name in ((bk, "fused_backward"), (bk, "march_backward")):
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            seen.append((_name, kw.get("route")))
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    grad = flat.clone().requires_grad_(True)
    rk.fused_march_normals(program, grad, rays7, 4, 0.0, 5e-2,
                           mats=mats).sum().backward()
    mk.march_planes(program, grad, rays7, 4, 0.0, mats).sum().backward()
    assert seen == [("fused_backward", "tc"), ("march_backward", "tc")]
    g = torch.as_tensor(np.random.default_rng(6).normal(size=(8, 1, 128)),
                        dtype=torch.float32)
    runs = [bk.fused_backward(program, flat, rays7, g, 4, 0.0, 5e-2,
                              mats=mats, route=route)
            for route in ("tc", "thread")]
    for a, b in zip([runs[0][0], *runs[0][1], runs[0][2]],
                    [runs[1][0], *runs[1][1], runs[1][2]]):
        assert torch.equal(a, b)


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16",
                                          "neural_demo"])
def test_cuda_tc_backward_matches_plain_and_its_three_ways(cuda,
                                                           matmul_dtype):
    """The tensor-core backward on the trained w256 field (32 rows of 128
    rays): history, recompute and two levels bitwise equal, the training
    forward's planes equal to the serving forward's, and within
    chip_smoke.py's TOL_NEURAL_BWD (f32) of the plain version, or its bf16
    ray share and matrix limits. neural_demo (its random 16 -> 16 leaf, f32)
    takes the VJP's smallest shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if matmul_dtype == "neural_demo":
        scene = treg.make_scene("neural_demo")
        params = tgraph.init_params(scene, torch.float32, cuda)
        matmul_dtype = "float32"
    else:
        scene = _w256_scene(matmul_dtype)
        params = load_pytree(WEIGHTS, tgraph.init_params(scene, torch.float32,
                                                         cuda))
    program = SdfProgram(scene)
    flat, mats, _ = split_params_padded(params, torch.float32)
    rng = np.random.default_rng(16)
    p = rng.uniform(-1.5, 1.5, (3, 32, 128))
    v = -p / np.linalg.norm(p, axis=0, keepdims=True)
    valid = (rng.uniform(size=(1, 32, 128)) > 0.1).astype(np.float64)
    rays7 = torch.as_tensor(np.concatenate([p, v, valid]),
                            dtype=torch.float32, device=cuda).contiguous()
    serve, _ = rk.march_forward(program, flat, rays7, 24, 0.0, 5e-2,
                                mats=mats)
    out, ex = rk.march_forward(program, flat, rays7, 24, 0.0, 5e-2,
                               log_hist=True, mats=mats)
    assert torch.equal(out, serve)
    g = torch.as_tensor(rng.normal(size=(8, 32, 128)), dtype=torch.float32,
                        device=cuda)
    bk.TC_LAUNCHES = 0
    runs = [bk.fused_backward(program, flat, rays7, g, 24, 0.0, 5e-2,
                              mats=mats, **kw)
            for kw in (dict(hist=ex["hist"], nlive=ex["nlive"]), {},
                       dict(two_level=True))]
    plain = bk.reference_backward(program, flat, rays7, g, 24, 0.0, 5e-2,
                                  mats=mats, hist=ex["hist"],
                                  nlive=ex["nlive"])
    torch.cuda.synchronize()
    assert bk.TC_LAUNCHES == 3
    first = [runs[0][0], *runs[0][1], runs[0][2]]
    for run in runs[1:]:
        for a, b in zip(first, [run[0], *run[1], run[2]]):
            assert torch.equal(a, b)
    conv = (rays7[6] > 0.5) & (out[3].abs() < 1e-3)
    assert int(conv.sum()) > 100
    got, want = runs[0][2][:, conv], plain[2][:, conv]
    if matmul_dtype == "float32":
        assert (got - want).abs().max() <= 1e-3 * want.abs().max()
        for a, b in zip([runs[0][0], *runs[0][1]], [plain[0], *plain[1]]):
            assert (a - b).abs().max() <= 1e-3 * b.abs().max()
    else:
        # chip_smoke.py's bf16 rule: rays one by one (an input cotangent
        # near a bf16 rounding boundary lands an ulp apart), the matrices
        # against their largest entry.
        per_ray = ((got - want).abs().amax(0)
                   / want.abs().amax(0).clamp_min(1e-30))
        assert float((per_ray <= 1e-4).double().mean()) >= 0.9
        for a, b in zip(runs[0][1], plain[1]):
            assert (a - b).abs().max() <= 1e-2 * b.abs().max()
