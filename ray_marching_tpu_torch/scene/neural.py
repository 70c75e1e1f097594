"""Neural SDF leaves: small coordinate MLPs as scene nodes (counterpart of
``ray_marching_tpu/scene/neural.py``).

The field is ``sphere(|p|, radius) + mlp(p)``: an analytic skip term keeps
the far field eikonal-ish so sphere tracing converges while the MLP shapes
the surface. The node has the JAX package's fields and defaults, and
:func:`init_neural_params` draws the same numbers from the same numpy seed, so
the parameters are equal bit for bit.

Two evaluators with the JAX package's association order:

* ``componentwise``: hidden unit j starts from its bias and adds
  ``h_i · W[i, j]`` in ``i`` order;
* ``matmul``: coordinates stack into a ``(3, N)`` block and every layer is
  ``act(Wᵀ @ H + b)``: the products summed over ``i`` first, then the bias.
  ``matmul_dtype='bfloat16'`` rounds both operands to bf16 and keeps the
  product in f32 (operands cast back to f32 before ``torch.matmul``, which
  would return bf16 otherwise), for f32 only, as in JAX.

bf16 cotangents follow one rule in the port, the backward kernel's: the
cotangent of a layer's *input* is rounded to bf16, as autograd
differentiates the input's cast; the cotangent of a *matrix* (``a ⊗ δ``
summed over the points) and of a bias stay f32 sums, never rounded. The
matrix's cast therefore passes its cotangent back unrounded
(:func:`_bf16_operand`), and :func:`mlp_vjp` writes the same rule out. The
JAX package rounds each TPU tile's per-evaluation matrix sum to bf16
instead (its backward kernel differentiates the cast per tile), so the two
packages' matrix gradients differ by at most a relative 2^-9 of each such
sum.

On the card the MLP runs inside the forward and march kernels and its VJP
inside the backward kernel (``ops/csrc/neural.cuh``, reached through the
``mlp`` and ``mlp_vjp`` ops of :mod:`ray_marching_tpu_torch.scene.codegen`);
these tensor evaluators are the plain SDF of :func:`graph.compile_node` and
therefore the kernels' plain versions, and :func:`mlp_vjp` is the VJP
written out, the plain twin of the kernel's. A plain matrix product outside any kernel may go to
``torch.matmul``, as the JAX package leaves it to XLA.

Activations: ``sine`` (SIREN), ``sine_fast`` (:func:`sin_fast`), ``softplus``
(JAX's ``logaddexp(v, 0)`` formula), ``tanh``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ray_marching_tpu_torch.scene.graph import Node, register_custom_node

_TWO_PI = 2.0 * math.pi
#: The JAX package's odd fit of sin on [-pi, pi] (6 terms, degree 11).
_SIN_COEFFS = (
    0.99999959991984499,
    -0.16666552635387408,
    0.0083324029887569036,
    -0.00019808633342873594,
    2.6997146373165627e-06,
    -2.0362244904890236e-08,
)
# Cody-Waite split of 2π: HI is exact in 8 mantissa bits.
_TWO_PI_HI = 6.28125
_TWO_PI_LO = _TWO_PI - _TWO_PI_HI


def _reduce_poly(x):
    """``(r, r², p)``: ``x`` reduced to [-π, π] and the polynomial at r².
    The constants are Python floats, which torch rounds to ``x``'s dtype as
    JAX rounds its weak-typed ones; ``torch.round`` rounds half to even like
    ``jnp.round``. ``r2 * c5`` is the JAX package's ``c5 * r2``."""
    k = torch.round(x * (1.0 / _TWO_PI))
    r = (x - k * _TWO_PI_HI) - k * _TWO_PI_LO
    r2 = r * r
    p = r2 * _SIN_COEFFS[-1] + _SIN_COEFFS[-2]
    for coeff in _SIN_COEFFS[-3::-1]:
        p = p * r2 + coeff
    return r, r2, p


class _SinFast(torch.autograd.Function):
    """Polynomial sine whose backward is the exact derivative of the
    polynomial, ``p + 2r²·p'(r²)`` (the custom JVP of the JAX package)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        r, _, p = _reduce_poly(x)
        return r * p

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        _, r2, p = _reduce_poly(x)
        n = len(_SIN_COEFFS)
        dp = r2 * ((n - 1) * _SIN_COEFFS[-1]) + (n - 2) * _SIN_COEFFS[-2]
        for k in range(n - 3, 0, -1):
            dp = dp * r2 + k * _SIN_COEFFS[k]
        return (p + 2.0 * r2 * dp) * g


def sin_fast(x):
    """Range-reduced polynomial sine (max abs error 9.65e-8 in f64); the
    function ``activation='sine_fast'`` applies."""
    return _SinFast.apply(x)


#: ``impl='auto'`` takes the matmul evaluator at and above this max hidden
#: width (the JAX package's value).
MATMUL_MIN_WIDTH = 8


@dataclass(frozen=True)
class NeuralSDF(Node):
    """MLP distance field leaf: ``hidden`` widths, ``activation`` ('sine' |
    'sine_fast' | 'softplus' | 'tanh'), SIREN frequency ``w0`` of the first
    layer (sine variants), init ``seed``, skip-sphere radius ``scale``,
    ``impl`` ('auto' | 'matmul' | 'componentwise') and the matmul operand
    precision ``matmul_dtype`` ('float32' | 'bfloat16')."""

    hidden: Tuple[int, ...] = (16, 16)
    activation: str = "sine"
    w0: float = 8.0
    seed: int = 0
    scale: float = 0.5
    impl: str = "auto"
    matmul_dtype: str = "float32"


def init_neural_params(node: NeuralSDF, dtype=torch.float32, device="cpu"):
    """SIREN-style init with the JAX package's numpy draws; the last layer
    starts near zero so the initial field is the sphere skip term."""
    rng = np.random.default_rng(node.seed)
    sizes = (3,) + tuple(node.hidden) + (1,)
    params = {}
    for i, (nin, nout) in enumerate(zip(sizes[:-1], sizes[1:])):
        if node.activation.startswith("sine"):
            bound = (1.0 / nin) if i == 0 else np.sqrt(6.0 / nin) / node.w0
        else:
            bound = np.sqrt(6.0 / (nin + nout))
        w = rng.uniform(-bound, bound, (nin, nout))
        if i == len(sizes) - 2:
            w = w * 0.01
        params[f"w{i}"] = torch.tensor(w, dtype=dtype, device=device)
        params[f"b{i}"] = torch.zeros((nout,), dtype=dtype, device=device)
    params["radius"] = torch.tensor(node.scale, dtype=dtype, device=device)
    return params


def _softplus(v):
    """``jnp.logaddexp(v, 0)``: ``max(v, 0) + log1p(exp(-|v|))``, and
    ``v + 0`` where the difference is NaN."""
    amax = torch.maximum(v, torch.zeros_like(v))
    return torch.where(torch.isnan(v), v + 0.0,
                       amax + torch.log1p(torch.exp(-torch.abs(v))))


def _activation(node: NeuralSDF):
    if node.activation == "sine":
        return torch.sin
    if node.activation == "sine_fast":
        return sin_fast
    if node.activation == "softplus":
        return _softplus
    return torch.tanh


def _scale(node: NeuralSDF, layer: int) -> float:
    return node.w0 if layer == 0 and node.activation.startswith("sine") \
        else 1.0


def _base_term(params, x, y, z):
    return torch.sqrt(x * x + y * y + z * z) - params["radius"]


def _componentwise_layer(params, planes, layer, last, act, scale):
    """One layer of the componentwise evaluator on a list of planes."""
    w, b = params[f"w{layer}"], params[f"b{layer}"]
    nin, nout = w.shape
    out = []
    for j in range(nout):
        acc = b[j]
        for i in range(nin):
            acc = acc + planes[i] * w[i, j]
        out.append(acc if last else act(acc * scale))
    return out


def mlp_componentwise(node: NeuralSDF):
    """The MLP alone, ``f(params, x, y, z) -> h``, componentwise: hidden
    unit j starts from its bias and adds ``h_i · W[i, j]`` in ``i`` order."""
    n_layers = len(node.hidden) + 1
    act = _activation(node)

    def evaluate(params, x, y, z):
        planes = [x, y, z]
        for layer in range(n_layers):
            planes = _componentwise_layer(params, planes, layer,
                                          layer == n_layers - 1, act,
                                          _scale(node, layer))
        return planes[0]

    return evaluate


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


class _Bf16Operand(torch.autograd.Function):
    """A matrix rounded to bf16 on the way forward whose cotangent passes
    back as it is: the port's bf16 rule keeps matrix cotangents in f32."""

    @staticmethod
    def forward(ctx, t):
        return _bf16(t)

    @staticmethod
    def backward(ctx, g):
        return g


def _bf16_operand(t):
    return _Bf16Operand.apply(t)


def _block(x, y, z):
    """``(3, N)`` block of the broadcast coordinates, and their shape."""
    shape = torch.broadcast_shapes(x.shape, y.shape, z.shape)
    dtype = torch.promote_types(x.dtype, torch.promote_types(y.dtype,
                                                             z.dtype))
    return torch.stack([v.to(dtype).expand(shape).reshape(-1)
                        for v in (x, y, z)], 0), shape


def _matmul_layer(node, params, h, layer):
    """``Wᵀ @ H + b`` of one layer (bf16 operands where asked, f32 only;
    the cotangent of ``H`` rounded to bf16 by its cast, ``W``'s not)."""
    lhs, rhs = params[f"w{layer}"].T, h
    if node.matmul_dtype == "bfloat16" and h.dtype == torch.float32:
        lhs, rhs = _bf16_operand(lhs), _bf16(rhs)
    return torch.matmul(lhs, rhs) + params[f"b{layer}"].reshape(-1, 1)


def mlp_matmul(node: NeuralSDF):
    """The MLP alone, ``f(params, x, y, z) -> h``: ``(3, N)`` block, one
    ``torch.matmul`` per layer."""
    n_layers = len(node.hidden) + 1
    act = _activation(node)

    def evaluate(params, x, y, z):
        h, shape = _block(x, y, z)
        for layer in range(n_layers):
            h = _matmul_layer(node, params, h, layer)
            if layer < n_layers - 1:
                h = act(h * _scale(node, layer))
        return h.reshape(shape)

    return evaluate


def resolve_impl(node: NeuralSDF) -> str:
    if node.impl != "auto":
        return node.impl
    width = max(node.hidden) if node.hidden else 0
    return "matmul" if width >= MATMUL_MIN_WIDTH else "componentwise"


def mlp(node: NeuralSDF):
    """The MLP of ``node``'s impl alone, ``f(params, x, y, z) -> h``: the
    leaf's distance is ``(|p| - radius) + h``."""
    impl = resolve_impl(node)
    if impl == "matmul":
        return mlp_matmul(node)
    if impl == "componentwise":
        return mlp_componentwise(node)
    raise ValueError(f"unknown NeuralSDF impl: {node.impl!r}")


def neural_sdf(node: NeuralSDF):
    """The evaluator ``f(params, x, y, z) -> d`` of ``node``'s impl: the
    skip term, then the MLP."""
    field = mlp(node)

    def evaluate(params, x, y, z):
        return _base_term(params, x, y, z) + field(params, x, y, z)

    return evaluate


def _act_slope(node: NeuralSDF, v):
    """The activation's derivative at ``v``, as its autograd backward forms
    it before the multiplication by the incoming cotangent: ``cos`` for
    sine, the polynomial's exact derivative for sine_fast, ``1 - y²`` for
    tanh, and for softplus the two branches of :func:`_softplus` (the
    ``maximum`` with its tie split in half, and ``log1p(exp(-|v|))``)."""
    if node.activation == "sine":
        return torch.cos(v)
    if node.activation == "sine_fast":
        _, r2, p = _reduce_poly(v)
        n = len(_SIN_COEFFS)
        dp = r2 * ((n - 1) * _SIN_COEFFS[-1]) + (n - 2) * _SIN_COEFFS[-2]
        for k in range(n - 3, 0, -1):
            dp = dp * r2 + k * _SIN_COEFFS[k]
        return p + 2.0 * r2 * dp
    if node.activation == "softplus":
        e = torch.exp(-torch.abs(v))
        hinge = torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0))
        return hinge + (-(e / (e + 1.0))) * torch.sign(v)
    y = torch.tanh(v)
    return 1.0 - y * y


def mlp_vjp(node: NeuralSDF, params, x, y, z, g):
    """The MLP's vector-jacobian product written out, the plain twin of
    ``ops/csrc/neural.cuh``'s ``rm_mlp_vjp``: recompute the forward keeping
    every hidden layer's output and activation slope, then walk back with
    ``δ_l = (W_l · δ_{l+1}) ⊙ act'`` (times ``w0`` for the first layer of
    the sine variants). ``g`` is the cotangent of :func:`mlp`'s output.

    bf16 operands (matmul impl, f32), the port's one rule (module doc): the
    cotangent of a layer's input is rounded to bf16, as autograd
    differentiates its cast; a matrix's cotangent is the f32 sum of the
    rounded input times δ, never rounded; both products take the rounded
    operands.

    Returns ``(gx, gy, gz, grads)``: the coordinates' cotangents and, per
    parameter name, ``w<l>``'s cotangent summed over the points and
    ``b<l>``'s per point, ``(nout, N)``."""
    n_layers = len(node.hidden) + 1
    act = _activation(node)
    h, shape = _block(x, y, z)
    componentwise = resolve_impl(node) == "componentwise"
    op = (_bf16 if not componentwise and node.matmul_dtype == "bfloat16"
          and h.dtype == torch.float32 else (lambda t: t))
    acts, slopes = [h], []
    for layer in range(n_layers - 1):
        if componentwise:
            zl = torch.stack(_componentwise_layer(
                params, list(acts[-1]), layer, True, act, 1.0))
        else:
            zl = _matmul_layer(node, params, acts[-1], layer)
        v = zl * _scale(node, layer)
        acts.append(act(v))
        slopes.append(_act_slope(node, v))
    gout = g.expand(shape).reshape(1, -1).to(h.dtype)
    last = n_layers - 1
    grads = {f"w{last}": op(acts[-1]) @ gout.T, f"b{last}": gout}
    ga = op(op(params[f"w{last}"]) @ gout)
    for layer in range(last - 1, -1, -1):
        delta = (ga * slopes[layer]) * _scale(node, layer)
        grads[f"w{layer}"] = op(acts[layer]) @ delta.T
        grads[f"b{layer}"] = delta
        ga = op(op(params[f"w{layer}"]) @ delta)
    gx, gy, gz = (c.reshape(shape) for c in ga)
    return gx, gy, gz, grads


register_custom_node(NeuralSDF, neural_sdf, init_neural_params)
