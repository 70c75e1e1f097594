"""Declarative scene graphs and their compiler (counterpart of
``ray_marching_tpu/scene/graph.py``).

The node dataclasses carry the same names and fields as the JAX package's,
so a scene tree reads the same in both. :func:`compile_scene` returns the
vector-form SDF ``sdf_vec(params, p)``, the componentwise tensor SDF
``sdf_c(params, x, y, z)`` and the initial parameter dict (nested dicts of
tensors, the same layout and key names as the JAX pytree).
:func:`params_from_jax` carries a JAX parameter pytree, given as numpy
arrays, across.

Custom leaves enter through :func:`register_custom_node`, the JAX package's
door: ``NeuralSDF`` (scene/neural.py) and ``Mandelbulb`` (scene/fractals.py)
register themselves when their module is imported (``scene/serialize.py``
imports both, the registry imports each where a scene needs it). The kernels
take a custom node once :func:`ray_marching_tpu_torch.scene.codegen.
register_lowering` has given it a lowering.

The union bounding-sphere short-circuit is the JAX package's:
:func:`compile_node` with ``prune=True`` skips a union child whose runtime
bounding sphere (:func:`bounding_sphere_fn`) lies strictly beyond the
running minimum, with the same rules, env switches (``RM_TPU_CSG_PRUNE``,
off by default; ``RM_TPU_PRUNE_MIN_LEAVES``) and values.
``scene/codegen.py`` lowers the same guard into the forward kernels and the
backward's recompute (``SdfProgram(node, prune=True)``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ray_marching_tpu_torch.scene import ops, primitives
from ray_marching_tpu_torch.utils import vmin


class Node:
    """Base class for scene-graph nodes."""


@dataclass(frozen=True)
class Sphere(Node):
    radius: float


@dataclass(frozen=True)
class Box(Node):
    halfsides: Tuple[float, float, float]


@dataclass(frozen=True)
class Plane(Node):
    pass


@dataclass(frozen=True)
class Line(Node):
    start: Tuple[float, float, float]
    end: Tuple[float, float, float]
    radius: float


@dataclass(frozen=True)
class Disk(Node):
    radius: float


@dataclass(frozen=True)
class Torus(Node):
    radius1: float
    radius2: float


@dataclass(frozen=True)
class Affine(Node):
    """Rigid transform of a child SDF: unit quaternion + translation."""

    child: Node
    orientation: Tuple[float, float, float, float]
    translation: Tuple[float, float, float]


@dataclass(frozen=True)
class Union(Node):
    children: Tuple[Node, ...]


@dataclass(frozen=True)
class SmoothUnion(Node):
    children: Tuple[Node, ...]
    blend_k: float


@dataclass(frozen=True)
class Rounding(Node):
    child: Node
    rounding: float


@dataclass(frozen=True)
class Onion(Node):
    child: Node
    radius: float


_PRIMITIVE_FNS = {
    Sphere: primitives.sphere,
    Box: primitives.box,
    Plane: primitives.plane,
    Line: primitives.line,
    Disk: primitives.disk,
    Torus: primitives.torus,
}

#: User-extensible SDF leaves: node type -> (compile_fn, init_fn).
_CUSTOM_NODES: dict = {}

_BUILTIN_NODES = (Sphere, Box, Plane, Line, Disk, Torus, Affine, Union,
                  SmoothUnion, Rounding, Onion)


def register_custom_node(node_type, compile_fn, init_fn) -> None:
    """Register a user-defined SDF leaf type (the JAX package's door).

    ``node_type`` is a frozen-dataclass subclass of :class:`Node` holding the
    static configuration; ``compile_fn(node) -> f(params, x, y, z) -> d``
    builds the componentwise tensor SDF; ``init_fn(node, dtype, device)``
    the initial parameter dict. Scene JSON addresses nodes by bare class
    name, so a name that shadows a built-in or another registered type is
    refused here, as in the JAX package."""
    if not (isinstance(node_type, type) and issubclass(node_type, Node)):
        raise TypeError(f"node_type must subclass Node, got {node_type!r}")
    name = node_type.__name__
    builtin_names = {cls.__name__ for cls in _BUILTIN_NODES}
    clash = next((c for c in _CUSTOM_NODES
                  if c.__name__ == name and c is not node_type), None)
    if name in builtin_names or clash is not None:
        other = "a built-in node" if name in builtin_names else f"{clash!r}"
        raise ValueError(
            f"custom node name {name!r} collides with {other}; scene "
            f"serialization is keyed by class name — rename the class"
        )
    _CUSTOM_NODES[node_type] = (compile_fn, init_fn)


def custom_node_types():
    """Registered custom node types, keyed by class name (serialization)."""
    return {cls.__name__: cls for cls in _CUSTOM_NODES}


def most_derived(table, node):
    """``table``'s entry for a node with isinstance semantics: the
    most-derived registered base wins."""
    for base in type(node).__mro__:
        entry = table.get(base)
        if entry is not None:
            return entry
    return None


def _custom_entry(node):
    """Registry entry (compile_fn, init_fn) of a custom node, or None."""
    return most_derived(_CUSTOM_NODES, node)


def _unknown(node):
    raise TypeError(f"unknown scene node: {node!r}")


def init_params(node: Node, dtype=torch.float32, device="cpu"):
    """Initial parameter dict of a scene tree: primitives contribute their
    fields, combinators nest children under ``c{i}`` keys."""
    def arr(v):
        return torch.tensor(v, dtype=dtype, device=device)

    if isinstance(node, Sphere):
        return {"radius": arr(node.radius)}
    if isinstance(node, Box):
        return {"halfsides": arr(node.halfsides)}
    if isinstance(node, Plane):
        return {}
    if isinstance(node, Line):
        return {"start": arr(node.start), "end": arr(node.end),
                "radius": arr(node.radius)}
    if isinstance(node, Disk):
        return {"radius": arr(node.radius)}
    if isinstance(node, Torus):
        return {"radius1": arr(node.radius1), "radius2": arr(node.radius2)}
    if isinstance(node, Affine):
        return {
            "orientation": arr(node.orientation),
            "translation": arr(node.translation),
            "child": init_params(node.child, dtype, device),
        }
    if isinstance(node, Union):
        return {f"c{i}": init_params(c, dtype, device)
                for i, c in enumerate(node.children)}
    if isinstance(node, SmoothUnion):
        out = {f"c{i}": init_params(c, dtype, device)
               for i, c in enumerate(node.children)}
        out["blend_k"] = arr(node.blend_k)
        return out
    if isinstance(node, Rounding):
        return {"rounding": arr(node.rounding),
                "child": init_params(node.child, dtype, device)}
    if isinstance(node, Onion):
        return {"radius": arr(node.radius),
                "child": init_params(node.child, dtype, device)}
    entry = _custom_entry(node)
    if entry is not None:
        return entry[1](node, dtype, device)
    return _unknown(node)


def subtree_leaf_count(node: Node) -> int:
    """Number of primitive/custom leaves under ``node``: the cost proxy the
    union short-circuit uses to decide whether a child is worth a guarded
    skip (a lone sphere costs less than its own bound check)."""
    child = getattr(node, "child", None)
    if child is not None:
        return subtree_leaf_count(child)
    children = getattr(node, "children", ())
    if children:
        return sum(subtree_leaf_count(c) for c in children)
    return 1


def _sqrt_like(v, like):
    """``sqrt(v)`` as a tensor like ``like``; ``v`` may be a Python float
    (built from an origin-centred ball's centre)."""
    return torch.sqrt(torch.as_tensor(v, dtype=like.dtype, device=like.device))


def bounding_sphere_fn(node: Node) -> Optional[Callable]:
    """Runtime bounding sphere of a subtree: ``fn(params) -> (cx, cy, cz,
    R)`` from the CURRENT parameters (they move while training), such that

        d_subtree(p) >= |p - c| - R   for every p, inside or out.

    The JAX package's rules and expressions: Sphere, Box, Disk and Torus are
    origin-centred with closed-form radii; Line covers its capsule; Union
    takes the ball around the child balls' mean centre; SmoothUnion adds
    ``log(n)/k`` (R = inf for k <= 0); Onion and Rounding inflate by their
    radius; Affine re-centres at its translation and engages only while the
    quaternion is unit or expanding (``m >= 1 - 16 eps``, else R = inf: a
    contracting quaternion gives the field a slope below 1). Plane and every
    custom node (NeuralSDF, Mandelbulb) give None, which disables the skip
    for every union child that contains them. A centre coordinate may be a
    Python float (0.0 for an origin-centred primitive)."""
    if isinstance(node, (Sphere, Disk)):
        return lambda p: (0.0, 0.0, 0.0, torch.abs(p["radius"]))
    if isinstance(node, Box):
        return lambda p: (0.0, 0.0, 0.0,
                          torch.sqrt(torch.sum(p["halfsides"] ** 2)))
    if isinstance(node, Torus):
        return lambda p: (0.0, 0.0, 0.0,
                          torch.abs(p["radius1"]) + torch.abs(p["radius2"]))
    if isinstance(node, Line):

        def line_bound(p):
            c = (p["start"] + p["end"]) * 0.5
            half = torch.sqrt(torch.sum((p["end"] - p["start"]) ** 2)) * 0.5
            return c[0], c[1], c[2], half + torch.abs(p["radius"])

        return line_bound
    if isinstance(node, Affine):
        child = bounding_sphere_fn(node.child)
        if child is None:
            return None

        def affine_bound(p):
            cx, cy, cz, r = child(p["child"])
            q, t = p["orientation"], p["translation"]
            # The inverse query scales lengths by min(1, m): a slope-1
            # bound holds only while m >= 1 (to 16 ulp, which the guard's
            # 32-ulp shrink absorbs).
            u = q[1] ** 2 + q[2] ** 2 + q[3] ** 2
            m = torch.sqrt((1.0 - 2.0 * u) ** 2 + 4.0 * q[0] ** 2 * u)
            c_norm = _sqrt_like(cx * cx + cy * cy + cz * cz, m)
            tol = 16 * torch.finfo(m.dtype).eps
            r_eff = torch.where(m >= 1.0 - tol, c_norm + r,
                                torch.full_like(m, math.inf))
            return t[0], t[1], t[2], r_eff

        return affine_bound
    if isinstance(node, (Union, SmoothUnion)):
        fns = [bounding_sphere_fn(c) for c in node.children]
        if any(f is None for f in fns):
            return None
        n = len(node.children)
        smooth = isinstance(node, SmoothUnion)

        def union_bound(p):
            balls = [f(p[f"c{i}"]) for i, f in enumerate(fns)]
            cx = sum(b[0] for b in balls) / n
            cy = sum(b[1] for b in balls) / n
            cz = sum(b[2] for b in balls) / n
            r = None
            for bx, by, bz, br in balls:
                reach = br + _sqrt_like(
                    (bx - cx) ** 2 + (by - cy) ** 2 + (bz - cz) ** 2, br)
                r = reach if r is None else torch.maximum(r, reach)
            if smooth:
                k = p["blend_k"]
                # log(n) rounded to k's type first, as JAX's weak float
                # (torch's float / tensor would multiply by 1/k instead).
                log_n = torch.tensor(math.log(n), dtype=k.dtype,
                                     device=k.device)
                r = torch.where(k > 0, r + log_n / k,
                                torch.full_like(r, math.inf))
            return cx, cy, cz, r

        return union_bound
    if isinstance(node, Rounding):
        child = bounding_sphere_fn(node.child)
        if child is None:
            return None

        def rounding_bound(p):
            cx, cy, cz, r = child(p["child"])
            return cx, cy, cz, r + p["rounding"]

        return rounding_bound
    if isinstance(node, Onion):
        child = bounding_sphere_fn(node.child)
        if child is None:
            return None

        def onion_bound(p):
            cx, cy, cz, r = child(p["child"])
            return cx, cy, cz, r + torch.abs(p["radius"])

        return onion_bound
    return None  # Plane (unbounded) and custom nodes


#: Union short-circuit (the JAX package's switches, read where a renderer is
#: built): children after the first whose subtree has at least
#: RM_TPU_PRUNE_MIN_LEAVES leaves and a bounding sphere are skipped where
#: every query point is provably farther from them than the running prefix
#: minimum (lb > d, strict); then vmin(d, d_child) = d with no tie, so the
#: values are the unpruned ones, NaN included (lb > NaN is false). Off by
#: default, as in the JAX package, whose off was a TPU measurement: on the
#: H100 a skipped subtree is one branch per thread (PERF.md §6 has the
#: card's times).
def _prune_enabled() -> bool:
    return os.environ.get("RM_TPU_CSG_PRUNE", "0") == "1"


def _prune_min_leaves() -> int:
    return int(os.environ.get("RM_TPU_PRUNE_MIN_LEAVES", "2"))


def pruned_children(node: Node) -> list:
    """For each child of a Union, whether the short-circuit guards it and
    how: its :func:`bounding_sphere_fn`, or None (the first child, which
    seeds the prefix minimum, and any child with fewer than
    ``RM_TPU_PRUNE_MIN_LEAVES`` leaves or no bound)."""
    min_leaves = _prune_min_leaves()
    return [None] + [bounding_sphere_fn(c)
                     if subtree_leaf_count(c) >= min_leaves else None
                     for c in node.children[1:]]


def guard_lower_bound(bound, x, y, z):
    """``lb = |p - c|·(1 - 32 eps) - R`` of a child's bound ``(cx, cy, cz,
    R)`` at the points: the 32-ulp shrink absorbs the rounding of the bound
    arithmetic, so an overestimated lb cannot skip a child that is the
    minimum."""
    cx, cy, cz, radius = bound
    ex, ey, ez = x - cx, y - cy, z - cz
    tol = 32 * torch.finfo(x.dtype).eps
    return torch.sqrt(ex * ex + ey * ey + ez * ez) * (1.0 - tol) - radius


def compile_node(node: Node, prune: bool = False) -> Callable:
    """Compile a node tree into ``f(params, x, y, z) -> d`` (componentwise).

    ``prune=True`` compiles unions with the bounding-sphere short-circuit
    (:func:`pruned_children`), skipping a guarded child for the whole batch
    when every point has lb > d, as the JAX package skips per block. The
    result is FORWARD-ONLY by contract: autograd through a skip would give a
    skipped child no cotangent where the unpruned form gives it a zero one,
    and a zero times an infinite slope is NaN there. Only non-differentiated
    evaluations take it (the kernels' plain versions of a march); every
    gradient goes through the plain compile."""
    if type(node) in _PRIMITIVE_FNS:
        return _PRIMITIVE_FNS[type(node)]
    if isinstance(node, Affine):
        child = compile_node(node.child, prune)

        def affine_fn(params, x, y, z):
            lx, ly, lz = ops.affine_inverse_query(
                params["orientation"], params["translation"], x, y, z
            )
            return child(params["child"], lx, ly, lz)

        return affine_fn
    if isinstance(node, Union):
        children = [compile_node(c, prune) for c in node.children]
        bounds = pruned_children(node) if prune else [None]
        if not any(b is not None for b in bounds):

            def union_fn(params, x, y, z):
                return ops.union([fn(params[f"c{i}"], x, y, z)
                                  for i, fn in enumerate(children)])

            return union_fn

        def union_pruned_fn(params, x, y, z):
            d = children[0](params["c0"], x, y, z)
            for i in range(1, len(children)):
                pi = params[f"c{i}"]
                if bounds[i] is not None and bool(torch.all(
                        guard_lower_bound(bounds[i](pi), x, y, z) > d)):
                    continue  # d_child >= lb > d: vmin(d, d_child) is d
                d = vmin(d, children[i](pi, x, y, z))
            return d

        return union_pruned_fn
    if isinstance(node, SmoothUnion):
        children = [compile_node(c, prune) for c in node.children]

        def smooth_union_fn(params, x, y, z):
            ds = [fn(params[f"c{i}"], x, y, z) for i, fn in enumerate(children)]
            return ops.smooth_union(params["blend_k"], ds)

        return smooth_union_fn
    if isinstance(node, Rounding):
        child = compile_node(node.child, prune)

        def rounding_fn(params, x, y, z):
            return ops.rounding(params["rounding"], child(params["child"], x, y, z))

        return rounding_fn
    if isinstance(node, Onion):
        child = compile_node(node.child, prune)

        def onion_fn(params, x, y, z):
            return ops.onion(params["radius"], child(params["child"], x, y, z))

        return onion_fn
    entry = _custom_entry(node)
    if entry is not None:
        return entry[0](node)
    return _unknown(node)


def as_vector_sdf(sdf_c: Callable) -> Callable:
    """Wrap a componentwise SDF into the ``(..., 3) -> (..., 1)`` convention
    of the marcher, normals and shader stack of the modular pipeline."""

    def sdf_vec(params, p):
        d = sdf_c(params, p[..., 0], p[..., 1], p[..., 2])
        return d[..., None]

    return sdf_vec


def compile_scene(node: Node, dtype=torch.float32, device="cpu"):
    """Compile a scene tree → ``(sdf_vec, sdf_c, params)``, as the JAX
    package's ``compile_scene`` returns them: ``sdf_vec(params, p)`` maps
    ``(..., 3) -> (..., 1)``, ``sdf_c(params, x, y, z)`` is the componentwise
    form, and ``params`` is the initial parameter dict on ``device``."""
    sdf_c = compile_node(node)
    return as_vector_sdf(sdf_c), sdf_c, init_params(node, dtype, device)


def param_paths(params, prefix=""):
    """Flatten a parameter dict into sorted ``path -> leaf`` pairs."""
    out = {}
    for key in sorted(params):
        val = params[key]
        path = f"{prefix}{key}" if not prefix else f"{prefix}/{key}"
        if isinstance(val, dict):
            out.update(param_paths(val, path))
        else:
            out[path] = val
    return out


def map_params(params, fn):
    """The parameter dict with ``fn`` applied to every leaf."""
    if isinstance(params, dict):
        return {k: map_params(v, fn) for k, v in params.items()}
    return fn(params)


def params_from_jax(tree, dtype=torch.float32, device="cpu"):
    """The JAX package's parameter pytree, given as nested dicts of numpy
    arrays (``jax.device_get`` of it, or ``np.asarray`` per leaf), as this
    package's nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)
