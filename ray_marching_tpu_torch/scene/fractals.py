"""Fractal SDF nodes: the Mandelbulb distance estimator as a scene leaf
(counterpart of ``ray_marching_tpu/scene/fractals.py``).

The Mandelbulb iterates the triplex power map ``z <- z^n + c`` with the
running derivative ``dr <- n·r^{n-1}·dr + 1`` and estimates the distance as
``0.5·ln(r)·r/dr``; far outside the set it takes ``r - 2^(1/(n-1))``
instead, a bound the estimate overshoots. The node has the JAX package's
fields and defaults, and the same formulation: no trigonometry, the angles'
cosines and sines taken from the coordinates and raised to the n-th angle by
binary exponentiation of the unit complex number ``(cos a, sin a)``; every
division and square root guarded by a select *before* the root, so the
backward stays finite on the axis and at the origin (the guards are
``utils.clamp``-style selects, CLAUDE.md). ``scale`` is the one learnable
leaf (``f(p) = s·mandelbulb(p/s)``); the power is static and unrolled, the
iterations are one counted loop of the arithmetic (``o.loop``), which the
kernels' generated code keeps rolled.

The SDF is written once, :func:`_bulb`, over an arithmetic: torch tensors
for the plain SDF (:func:`mandelbulb_sdf`, registered with
:func:`graph.register_custom_node`), and the SSA builder of
:mod:`ray_marching_tpu_torch.scene.codegen` for the kernels
(:func:`lower_mandelbulb`, registered with :func:`codegen.register_lowering`).
Both take the JAX package's operations in its order, so the generated
evaluator equals the plain SDF bit for bit. The exponentiations leave out
the one squaring after their last bit, which JAX computes and never reads:
no value that is read changes.

Importing this module registers the node (``scene/serialize.py`` does, and
``registry.make_scene("mandelbulb")``).
"""

from __future__ import annotations

import operator
from dataclasses import dataclass

import torch

from ray_marching_tpu_torch.scene import codegen
from ray_marching_tpu_torch.scene.graph import Node, register_custom_node

_EPS2 = 1e-24  # squared-radius guard, applied BEFORE sqrt (backward NaNs)


@dataclass(frozen=True)
class Mandelbulb(Node):
    """Mandelbulb distance-estimator leaf: the integer triplex ``power``
    (8 = the classic bulb) and ``iterations`` (static), the bailout
    ``escape_radius`` and the learnable overall size ``scale`` (compose
    with Affine for pose)."""

    power: int = 8
    iterations: int = 10
    escape_radius: float = 2.0
    scale: float = 1.0


class _Torch:
    """The arithmetic of the plain SDF: tensor operations, constants as
    Python floats (rounded to the tensors' dtype as JAX rounds its
    weak-typed ones)."""

    add, sub, mul, div = operator.add, operator.sub, operator.mul, \
        operator.truediv
    sqrt, log = staticmethod(torch.sqrt), staticmethod(torch.log)

    @staticmethod
    def const(value):
        return float(value)

    @staticmethod
    def sel_lt(a, b, t, f):
        return torch.where(a < b, t, f)

    @staticmethod
    def sel_gt(a, b, t, f):
        return torch.where(a > b, t, f)

    @staticmethod
    def sel_le(a, b, t, f):
        return torch.where(a <= b, t, f)

    @staticmethod
    def loop(n, state, body):
        for _ in range(n):
            state = tuple(body(_Torch, *state))
        return state


def _unit_complex_ipow(o, c, s, n: int):
    """(cos a, sin a) -> (cos n·a, sin n·a), de Moivre by binary
    exponentiation (the JAX package's multiplies, in its order)."""
    rc, rs = o.const(1.0), o.const(0.0)
    while n > 0:
        if n & 1:
            rc, rs = (o.sub(o.mul(rc, c), o.mul(rs, s)),
                      o.add(o.mul(rs, c), o.mul(rc, s)))
        n >>= 1
        if n:
            c, s = (o.sub(o.mul(c, c), o.mul(s, s)),
                    o.mul(o.mul(o.const(2.0), c), s))
    return rc, rs


def _ipow(o, x, n: int):
    """x**n for a static integer n by binary exponentiation."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else o.mul(acc, x)
        n >>= 1
        if n:
            x = o.mul(x, x)
    return acc if acc is not None else o.const(1.0)


def _check_power(node: Mandelbulb) -> int:
    n = int(node.power)
    if n < 2:
        raise ValueError(f"Mandelbulb power must be >= 2, got {n}")
    return n


def _bulb(o, node: Mandelbulb, x, y, z, s):
    """The distance of ``node`` at (x, y, z) for the scale ``s``, in the
    arithmetic ``o``."""
    n = _check_power(node)
    bail2 = float(node.escape_radius) ** 2
    # The set lies inside |c| <= 2^(1/(n-1)): beyond it the orbit diverges.
    set_radius = 2.0 ** (1.0 / (n - 1))
    eps, one, zero = o.const(_EPS2), o.const(1.0), o.const(0.0)
    inv = o.div(one, s)
    cx, cy, cz = o.mul(x, inv), o.mul(y, inv), o.mul(z, inv)
    zx, zy, zz = cx, cy, cz
    dr = one
    r2 = o.add(o.add(o.mul(zx, zx), o.mul(zy, zy)), o.mul(zz, zz))
    r0 = o.sqrt(o.sel_lt(r2, eps, eps, r2))

    def iteration(o, zx, zy, zz, dr, r2):
        rg = o.sqrt(o.sel_lt(r2, eps, eps, r2))
        rxy2 = o.add(o.mul(zx, zx), o.mul(zy, zy))
        rxyg = o.sqrt(o.sel_lt(rxy2, eps, eps, rxy2))
        ct, st = o.div(zz, rg), o.div(rxyg, rg)
        cp = o.sel_lt(rxy2, eps, one, o.div(zx, rxyg))
        sp = o.sel_lt(rxy2, eps, zero, o.div(zy, rxyg))
        ctn, stn = _unit_complex_ipow(o, ct, st, n)
        cpn, spn = _unit_complex_ipow(o, cp, sp, n)
        rn1 = _ipow(o, rg, n - 1)
        rn = o.mul(rn1, rg)
        dr_new = o.add(o.mul(o.mul(o.const(n), rn1), dr), one)
        # live = r2 <= bail2: a NaN r2 keeps the old values, as jnp.where.
        zx = o.sel_le(r2, o.const(bail2),
                      o.add(o.mul(o.mul(rn, stn), cpn), cx), zx)
        zy = o.sel_le(r2, o.const(bail2),
                      o.add(o.mul(o.mul(rn, stn), spn), cy), zy)
        zz = o.sel_le(r2, o.const(bail2), o.add(o.mul(rn, ctn), cz), zz)
        dr = o.sel_le(r2, o.const(bail2), dr_new, dr)
        r2 = o.add(o.add(o.mul(zx, zx), o.mul(zy, zy)), o.mul(zz, zz))
        return zx, zy, zz, dr, r2

    # The iterations as one counted loop: the kernels' code holds one body
    # (codegen's _Builder.loop), the plain SDF runs it as a Python loop.
    zx, zy, zz, dr, r2 = o.loop(int(node.iterations), (zx, zy, zz, dr, r2),
                                iteration)
    rg = o.sqrt(o.sel_lt(r2, eps, eps, r2))
    de = o.div(o.mul(o.mul(o.const(0.5), o.log(rg)), rg), dr)
    # Far field: the estimate overshoots beyond r ~ 4.8 for points that
    # escape at once, r0 - set_radius never does.
    bound = o.sub(r0, o.const(set_radius))
    far = o.sel_lt(de, bound, de, bound)
    de = o.sel_gt(r0, o.const(node.escape_radius), far, de)
    return o.mul(de, s)


def init_mandelbulb_params(node: Mandelbulb, dtype=torch.float32,
                           device="cpu"):
    return {"scale": torch.tensor(node.scale, dtype=dtype, device=device)}


def mandelbulb_sdf(node: Mandelbulb):
    """The plain SDF ``f(params, x, y, z) -> d`` of ``node``."""
    _check_power(node)

    def evaluate(params, x, y, z):
        return _bulb(_Torch, node, x, y, z, params["scale"])

    return evaluate


def lower_mandelbulb(node: Mandelbulb, b, prefix, x, y, z):
    """The kernels' lowering of ``node``: :func:`_bulb` on the SSA builder
    (the reciprocal of the scale depends on the parameter alone)."""
    s = b.param(codegen.param_path(prefix, "scale"))
    return _bulb(b, node, x, y, z, s)


register_custom_node(Mandelbulb, mandelbulb_sdf, init_mandelbulb_params)
codegen.register_lowering(Mandelbulb, lower_mandelbulb)
