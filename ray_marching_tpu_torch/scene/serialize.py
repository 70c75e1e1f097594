"""Scene (de)serialization: node trees ↔ JSON (counterpart of
``ray_marching_tpu/scene/serialize.py``; same format, so a scene file
written by either package loads in the other).

Every node is ``{"type": <class name>, ...fields}``; children are nested
nodes; tuples become lists. Importing this module registers ``NeuralSDF``
(scene/neural.py) and ``Mandelbulb`` (scene/fractals.py), so their scene
files load without the caller importing anything first; third-party custom
nodes load once their defining module is imported.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from ray_marching_tpu_torch.scene import fractals as _fractals  # noqa: F401
from ray_marching_tpu_torch.scene import graph
from ray_marching_tpu_torch.scene import neural as _neural  # noqa: F401

_BUILTIN_TYPES = {cls.__name__: cls for cls in graph._BUILTIN_NODES}


def _node_types() -> dict:
    return {**_BUILTIN_TYPES, **graph.custom_node_types()}


def node_to_dict(node: graph.Node) -> dict:
    out = {"type": type(node).__name__}
    for field in dataclasses.fields(node):
        val = getattr(node, field.name)
        if isinstance(val, graph.Node):
            out[field.name] = node_to_dict(val)
        elif isinstance(val, tuple) and val and isinstance(val[0], graph.Node):
            out[field.name] = [node_to_dict(c) for c in val]
        elif isinstance(val, tuple):
            out[field.name] = list(val)
        else:
            out[field.name] = val
    return out


def node_from_dict(data: dict) -> graph.Node:
    data = dict(data)
    type_name = data.pop("type")
    node_types = _node_types()
    try:
        cls = node_types[type_name]
    except KeyError:
        raise ValueError(
            f"unknown scene node type {type_name!r}; "
            f"known: {sorted(node_types)}"
        ) from None
    kwargs = {}
    fields = {f.name for f in dataclasses.fields(cls)}
    for key, val in data.items():
        if key not in fields:
            raise ValueError(f"{type_name} has no field {key!r}")
        if isinstance(val, dict) and "type" in val:
            kwargs[key] = node_from_dict(val)
        elif (
            isinstance(val, list) and val
            and isinstance(val[0], dict) and "type" in val[0]
        ):
            kwargs[key] = tuple(node_from_dict(c) for c in val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


def save_scene(path, node: graph.Node) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(node_to_dict(node), indent=2) + "\n")
    return path


def load_scene(path) -> graph.Node:
    return node_from_dict(json.loads(Path(path).read_text()))
