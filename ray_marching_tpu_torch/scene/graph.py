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

The union bounding-sphere short-circuit (``compile_node(prune=True)`` in the
JAX package) is not ported: it is off by default there and was measured as
a loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from ray_marching_tpu_torch.scene import ops, primitives


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


def compile_node(node: Node) -> Callable:
    """Compile a node tree into ``f(params, x, y, z) -> d`` (componentwise)."""
    if type(node) in _PRIMITIVE_FNS:
        return _PRIMITIVE_FNS[type(node)]
    if isinstance(node, Affine):
        child = compile_node(node.child)

        def affine_fn(params, x, y, z):
            lx, ly, lz = ops.affine_inverse_query(
                params["orientation"], params["translation"], x, y, z
            )
            return child(params["child"], lx, ly, lz)

        return affine_fn
    if isinstance(node, Union):
        children = [compile_node(c) for c in node.children]

        def union_fn(params, x, y, z):
            return ops.union([fn(params[f"c{i}"], x, y, z)
                              for i, fn in enumerate(children)])

        return union_fn
    if isinstance(node, SmoothUnion):
        children = [compile_node(c) for c in node.children]

        def smooth_union_fn(params, x, y, z):
            ds = [fn(params[f"c{i}"], x, y, z) for i, fn in enumerate(children)]
            return ops.smooth_union(params["blend_k"], ds)

        return smooth_union_fn
    if isinstance(node, Rounding):
        child = compile_node(node.child)

        def rounding_fn(params, x, y, z):
            return ops.rounding(params["rounding"], child(params["child"], x, y, z))

        return rounding_fn
    if isinstance(node, Onion):
        child = compile_node(node.child)

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


def params_from_jax(tree, dtype=torch.float32, device="cpu"):
    """The JAX package's parameter pytree, given as nested dicts of numpy
    arrays (``jax.device_get`` of it, or ``np.asarray`` per leaf), as this
    package's nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)
