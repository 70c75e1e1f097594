"""Plain PyTorch signed-distance fields of the benchmark's scene descriptions.

A scene description is the JSON node tree that the configuration files hold
(``{"type": <node>, ...fields}``, children nested). :func:`build` turns one
into ``(sdf, leaves)``: ``sdf(params, x, y, z)`` maps coordinate tensors to
distances, and ``leaves`` maps each parameter's path (``c1/c0/radius``: the
``c<i>`` of a child of a union, ``child`` of a wrapped node) to its value
from the description.

The formulas follow the published definitions of each shape. Minima and
maxima are selects (``where``), so a gradient goes to the chosen operand
only. The neural leaf is ``(|p| - radius) + MLP(p)``, a SIREN multilayer
perceptron whose first layer's pre-activation is scaled by ``w0``; its
``sine_fast`` activation is a fixed odd polynomial of degree 11 in the
argument reduced to [-pi, pi], and autograd differentiates that polynomial.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch

#: Odd fit of sin on [-pi, pi]: coefficients of r, r^3, ..., r^11.
SIN_FAST_COEFFS = (
    0.99999959991984499,
    -0.16666552635387408,
    0.0083324029887569036,
    -0.00019808633342873594,
    2.6997146373165627e-06,
    -2.0362244904890236e-08,
)
_TWO_PI = 2.0 * math.pi
_TWO_PI_HI = 6.28125
_TWO_PI_LO = _TWO_PI - _TWO_PI_HI


def sin_fast(x):
    """``r·p(r²)`` with ``r`` = x reduced to [-pi, pi] (two-term split of
    2π); the rounding to the nearest period has no gradient."""
    k = torch.round(x * (1.0 / _TWO_PI)).detach()
    r = (x - k * _TWO_PI_HI) - k * _TWO_PI_LO
    r2 = r * r
    p = r2 * SIN_FAST_COEFFS[5] + SIN_FAST_COEFFS[4]
    for c in SIN_FAST_COEFFS[3::-1]:
        p = p * r2 + c
    return r * p


ACTIVATIONS = {"sine": torch.sin, "sine_fast": sin_fast, "tanh": torch.tanh}


def vmin(a, b):
    return torch.where(b < a, b, a)


def vmax(a, b):
    return torch.where(b > a, b, a)


def clamp(x, lo, hi):
    x = torch.where(x < lo, lo, x)
    return torch.where(x > hi, hi, x)


def rotate(q, x, y, z):
    """Rotate (x, y, z) by the unit quaternion ``q`` = (w, i, j, k):
    ``v + w·t + q_v × t`` with ``t = 2 q_v × v``."""
    w, i, j, k = q
    tx, ty, tz = 2 * (j * z - k * y), 2 * (k * x - i * z), 2 * (i * y - j * x)
    return ((j * tz - k * ty) + w * tx + x,
            (k * tx - i * tz) + w * ty + y,
            (i * ty - j * tx) + w * tz + z)


def _sphere(p, x, y, z):
    return torch.sqrt(x * x + y * y + z * z) - p["radius"]


def _box(p, x, y, z):
    h = p["halfsides"]
    qx, qy, qz = torch.abs(x) - h[0], torch.abs(y) - h[1], torch.abs(z) - h[2]
    q_max = vmax(vmax(qx, qy), qz)
    rx, ry, rz = (torch.where(q > 0, q, 0.0) for q in (qx, qy, qz))
    outside = torch.sqrt(rx * rx + ry * ry + rz * rz)
    return outside + torch.where(q_max < 0, q_max, 0.0)


def _torus(p, x, y, z):
    a = torch.sqrt(x * x + z * z) - p["radius1"]
    return torch.sqrt(a * a + y * y) - p["radius2"]


def _line(p, x, y, z):
    s, e = p["start"], p["end"]
    ab = [e[i] - s[i] for i in range(3)]
    ap = [x - s[0], y - s[1], z - s[2]]
    length2 = ab[0] * ab[0] + ab[1] * ab[1] + ab[2] * ab[2]
    t = clamp((ap[0] * ab[0] + ap[1] * ab[1] + ap[2] * ab[2]) / length2,
              0.0, 1.0)
    d = [t * ab[i] - ap[i] for i in range(3)]
    return torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) - p["radius"]


_LEAF_SHAPES = {"Sphere": (_sphere, ("radius",)),
                "Box": (_box, ("halfsides",)),
                "Torus": (_torus, ("radius1", "radius2")),
                "Line": (_line, ("start", "end", "radius"))}


def _neural(node):
    n_layers = len(node["hidden"]) + 1
    act = ACTIVATIONS[node["activation"]]
    w0 = float(node["w0"])

    def mlp(p, x, y, z):
        shape = x.shape
        h = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], 0)
        for layer in range(n_layers):
            h = p[f"w{layer}"].T @ h + p[f"b{layer}"].reshape(-1, 1)
            if layer < n_layers - 1:
                h = act(h * w0) if layer == 0 else act(h)
        return h.reshape(shape)

    def sdf(p, x, y, z):
        return (torch.sqrt(x * x + y * y + z * z) - p["radius"]) \
            + mlp(p, x, y, z)

    sizes = (3,) + tuple(node["hidden"]) + (1,)
    names = []
    for layer, (nin, nout) in enumerate(zip(sizes[:-1], sizes[1:])):
        names += [(f"w{layer}", (nin, nout)), (f"b{layer}", (nout,))]
    names.append(("radius", ()))
    return sdf, names


def build(node, prefix=""):
    """``(sdf, leaves)`` of a scene description (module docstring). A
    neural leaf's matrices have no value in the description: their entries
    in ``leaves`` are shapes, to be filled from a weights file."""
    kind = node["type"]
    if kind in _LEAF_SHAPES:
        fn, names = _LEAF_SHAPES[kind]
        leaves = {prefix + n: node[n] for n in names}

        def sdf(params, x, y, z):
            return fn({n: params[prefix + n] for n in names}, x, y, z)

        return sdf, leaves
    if kind == "NeuralSDF":
        fn, names = _neural(node)
        leaves = {prefix + n: ({"shape": s} if n != "radius"
                               else node["scale"]) for n, s in names}

        def sdf(params, x, y, z):
            return fn({n: params[prefix + n] for n, _ in names}, x, y, z)

        return sdf, leaves
    if kind == "Onion":
        child, leaves = build(node["child"], prefix + "child/")
        leaves[prefix + "radius"] = node["radius"]

        def sdf(params, x, y, z):
            d = child(params, x, y, z)
            return torch.abs(d) - params[prefix + "radius"]

        return sdf, leaves
    if kind == "Affine":
        child, leaves = build(node["child"], prefix + "child/")
        leaves[prefix + "orientation"] = node["orientation"]
        leaves[prefix + "translation"] = node["translation"]

        def sdf(params, x, y, z):
            q = params[prefix + "orientation"]
            t = params[prefix + "translation"]
            conj = (q[0], -q[1], -q[2], -q[3])
            return child(params, *rotate(conj, x - t[0], y - t[1], z - t[2]))

        return sdf, leaves
    if kind in ("Union", "SmoothUnion"):
        built = [build(c, f"{prefix}c{i}/")
                 for i, c in enumerate(node["children"])]
        leaves = {}
        for _, lv in built:
            leaves.update(lv)
        fns = [f for f, _ in built]
        if kind == "Union":
            def sdf(params, x, y, z):
                out = fns[0](params, x, y, z)
                for f in fns[1:]:
                    out = vmin(out, f(params, x, y, z))
                return out

            return sdf, leaves
        leaves[prefix + "blend_k"] = node["blend_k"]

        def sdf(params, x, y, z):
            neg_k = -params[prefix + "blend_k"]
            a = [f(params, x, y, z) * neg_k for f in fns]
            m = a[0]
            for ai in a[1:]:
                m = torch.maximum(m, ai)
            total = sum(torch.exp(ai - m) for ai in a)
            return (torch.log(total) + m) / neg_k

        return sdf, leaves
    raise ValueError(f"scene node type {kind!r} has no plain reference")


def leaf_tensors(leaves, dtype, device, weights=None):
    """The leaves as tensors; a neural matrix takes its value from
    ``weights`` (path -> array), which must hold every one."""
    out = {}
    for path, value in leaves.items():
        if isinstance(value, dict):
            value = weights[path]
        elif weights is not None and path in weights:
            value = weights[path]
        out[path] = torch.as_tensor(value, dtype=torch.float64).to(
            dtype=dtype, device=device)
    return out
