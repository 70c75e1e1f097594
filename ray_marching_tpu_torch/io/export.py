"""Render artifacts: a configured renderer saved to one ``.rmx`` file and
rebuilt in a server process (counterpart of ``ray_marching_tpu/io/export.py``
``export_render`` / ``load_render``).

The JAX package lowers the render to serialized StableHLO (``jax.export``).
The port's kernels are CUDA C++ generated per scene and bound through
``ctypes``; no serialized graph can carry them (``torch.export`` traces
PyTorch operators and does not see into a ``ctypes`` call). So the port's
artifact carries what rebuilds the renderer instead, in a zip:

- ``meta.json``: the JAX artifact's keys (``format_version``, ``mode``,
  ``degree``, ``marching_steps``, ``platforms`` = ``["cuda"]``,
  ``num_cameras``, ``px_width``, ``px_height``, ``dtype``), plus
  ``renderer`` (``"fast"`` or ``"modular"``), ``march_impl``,
  ``grid_dtype`` and ``config`` (the ``RenderConfig`` fields);
- ``params.npz``: the scene parameters as ``leaf_0 .. leaf_n`` in the JAX
  package's leaf order (dict keys sorted at every level);
- ``scene.json``: the scene in ``scene/serialize.py``'s format, which both
  packages read.

:func:`load_render` rebuilds the renderer from these (the kernels come from
the nvcc build cache, ``ops/_build/``, or are built at the first render) and
returns ``(render_fn, params, meta)``; the caller needs no scene code.

:func:`export_train_step` saves the sharded training step of the fused path
(:func:`ray_marching_tpu_torch.parallel.fast_sharding.fast_train_step`) the
same way, as a ``.rmxs`` zip: ``meta.json`` with the JAX artifact's keys
(``kind`` = ``"sharded_train_step"``, ``mesh_shape``, ``num_devices``,
``rows``, ``px_width``, ``px_height``, ``marching_steps``, ``dtype``,
``mode``, ``degree``, ``platforms``) plus the renderer's configuration and
the optimizer's name and arguments, ``params.npz`` and ``scene.json``.
:func:`load_train_step` rebuilds the renderer, the mesh and the step in a
process group of the exported size.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import zipfile
from pathlib import Path

import numpy as np
import torch

from ray_marching_tpu_torch.io.checkpoint import _leaf_paths, _rebuild
from ray_marching_tpu_torch.scene.serialize import node_from_dict, node_to_dict

_META_NAME = "meta.json"
_PARAMS_NAME = "params.npz"
_SCENE_NAME = "scene.json"
_FORMAT_VERSION = 1


def _kind(renderer) -> str:
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer

    if isinstance(renderer, FastRenderer):
        return "fast"
    if isinstance(renderer, Renderer):
        return "modular"
    raise TypeError(f"export_render takes a FastRenderer or a Renderer, got "
                    f"{type(renderer).__name__}")


def export_render(renderer, path, *, mode=0, degree: int = 1,
                  marching_steps=None, params=None) -> Path:
    """Save one shader mode of a renderer as a serving artifact.

    The loaded function has the signature of ``renderer.jitted(...)``:
    ``(params, orientation, translation) -> (N, H, W, 3)``. ``params``
    (default the renderer's initial ones; pass an optimized tree to bake it
    in) ride along and stay an input: a server can swap them."""
    kind = _kind(renderer)
    steps = marching_steps or renderer.config.marching_steps
    params = renderer.init_params if params is None else params
    config = dataclasses.asdict(renderer.config)
    meta = {
        "format_version": _FORMAT_VERSION,
        "mode": mode,
        "degree": degree,
        "marching_steps": steps,
        "platforms": ["cuda"],
        "num_cameras": renderer.config.num_cameras,
        "px_width": renderer.config.px_width,
        "px_height": renderer.config.px_height,
        "dtype": str(renderer.dtype).removeprefix("torch."),
        "renderer": kind,
        "march_impl": getattr(renderer, "march_impl", None),
        "grid_dtype": renderer.grid_dtype.name,
        "config": config,
    }
    return _write_zip(path, meta, params, renderer.scene)


def _write_zip(path, meta, params, scene) -> Path:
    buf = io.BytesIO()
    leaves = _leaf_paths(params).values()
    np.savez(buf, **{f"leaf_{i}": v.detach().cpu().numpy()
                     if isinstance(v, torch.Tensor) else np.asarray(v)
                     for i, v in enumerate(leaves)})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_META_NAME, json.dumps(meta, indent=1))
        zf.writestr(_PARAMS_NAME, buf.getvalue())
        zf.writestr(_SCENE_NAME, json.dumps(node_to_dict(scene), indent=1))
    return path


def _read_zip(path):
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(_META_NAME))
        scene = node_from_dict(json.loads(zf.read(_SCENE_NAME)))
        with np.load(io.BytesIO(zf.read(_PARAMS_NAME))) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    return meta, scene, leaves


def _config_of(meta):
    from ray_marching_tpu_torch.render.pipeline import RenderConfig

    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    return RenderConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in meta["config"].items() if k in fields})


def _params_like(renderer, leaves, path):
    """The bundled leaves in the structure of ``renderer.init_params``."""
    names = _leaf_paths(renderer.init_params)
    if len(names) != len(leaves):
        raise ValueError(f"{path}: {len(leaves)} parameter leaves, the scene "
                         f"has {len(names)}")
    return _rebuild(renderer.init_params, {
        name: torch.as_tensor(leaf).to(dtype=ref.dtype, device=ref.device)
        for (name, ref), leaf in zip(names.items(), leaves)})


def load_render(path, device="cuda"):
    """Load a ``.rmx`` artifact: ``(render_fn, params, meta)``.

    ``render_fn(params, orientation, translation)`` renders the exported
    mode with the renderer rebuilt on ``device`` (``"cpu"`` runs the
    kernels' plain versions); ``params`` is the bundled tree, on
    ``device``, in the renderer's structure: pass it through or swap in a
    tree of the same structure (e.g. from ``optimize``)."""
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer

    meta, scene, leaves = _read_zip(path)
    if (meta.get("format_version") != _FORMAT_VERSION
            or meta.get("renderer") not in ("fast", "modular")):
        raise ValueError(f"{path}: not a render artifact of this package "
                         f"(format {meta.get('format_version')}, keys "
                         f"{sorted(meta)})")
    config = _config_of(meta)
    dtype = getattr(torch, meta["dtype"])
    kw = dict(dtype=dtype, grid_dtype=np.dtype(meta["grid_dtype"]),
              device=device)
    if meta["renderer"] == "fast":
        renderer = FastRenderer(scene, config, march_impl=meta["march_impl"],
                                **kw)
    else:
        renderer = Renderer(scene, config, **kw)
    params = _params_like(renderer, leaves, path)
    mode, degree, steps = meta["mode"], meta["degree"], meta["marching_steps"]

    def render_fn(params, orientation, translation):
        return renderer.render(params, orientation, translation, mode=mode,
                               degree=degree, marching_steps=steps)

    render_fn.renderer = renderer
    return render_fn, params, meta


def _optimizer_spec(optimizer):
    """``{"name", "kwargs"}`` of a ``torch.optim`` class or a
    ``functools.partial`` of one with keyword arguments."""
    kwargs = {}
    if isinstance(optimizer, functools.partial):
        if optimizer.args:
            raise ValueError("the optimizer's arguments must be keywords")
        optimizer, kwargs = optimizer.func, dict(optimizer.keywords)
    if getattr(torch.optim, optimizer.__name__, None) is not optimizer:
        raise ValueError(f"{optimizer!r} is not a torch.optim optimizer")
    return {"name": optimizer.__name__,
            "kwargs": {k: list(v) if isinstance(v, tuple) else v
                       for k, v in kwargs.items()}}


def export_train_step(fast, mesh, path, *, optimizer=None, mode: int = 0,
                      degree: int = 1, params=None) -> Path:
    """Save the sharded training step of ``fast`` over ``mesh`` as ``.rmxs``.

    :func:`load_train_step` rebuilds it with ``fast_train_step``'s
    signature, ``(params, opt_state, target_planes, orientation,
    translation) -> (params, opt_state, loss)``. ``optimizer`` is a
    ``torch.optim`` constructor (default ``functools.partial(
    torch.optim.Adam, lr=1e-2)``, the JAX package's ``optax.adam(1e-2)``);
    ``params`` (default the renderer's initial ones) ride along."""
    from ray_marching_tpu_torch.parallel.fast_sharding import _check_rows

    _check_rows(fast, mesh)
    if optimizer is None:
        optimizer = functools.partial(torch.optim.Adam, lr=1e-2)
    params = fast.init_params if params is None else params
    meta = {
        "format_version": _FORMAT_VERSION,
        "kind": "sharded_train_step",
        "mode": mode,
        "degree": degree,
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "num_devices": mesh.size(),
        "platforms": ["cuda"],
        "px_width": fast.config.px_width,
        "px_height": fast.config.px_height,
        "rows": fast.rows,
        "marching_steps": fast.config.marching_steps,
        "dtype": str(fast.dtype).removeprefix("torch."),
        "march_impl": fast.march_impl,
        "grid_dtype": fast.grid_dtype.name,
        "row_multiple": fast.row_multiple,
        "config": dataclasses.asdict(fast.config),
        "optimizer": _optimizer_spec(optimizer),
    }
    return _write_zip(path, meta, params, fast.scene)


def load_train_step(path, device="cuda"):
    """Load a ``.rmxs`` artifact: ``(step_fn, meta)``.

    The process group must have ``meta["num_devices"]`` ranks (every rank
    loads the artifact). ``step_fn`` is ``fast_train_step`` of the rebuilt
    renderer over a mesh of the exported shape; ``step_fn.params`` is the
    bundled tree on ``device`` and ``step_fn.renderer`` the renderer (its
    ``image_to_planes`` and ``fast_sharding.target_planes`` lay out
    targets)."""
    import torch.distributed as dist

    from ray_marching_tpu_torch.parallel import fast_sharding
    from ray_marching_tpu_torch.parallel.sharding import make_mesh
    from ray_marching_tpu_torch.render.fast import FastRenderer

    meta, scene, leaves = _read_zip(path)
    if (meta.get("format_version") != _FORMAT_VERSION
            or meta.get("kind") != "sharded_train_step"):
        raise ValueError(f"{path}: not a sharded train step of this package "
                         f"(format {meta.get('format_version')}, kind "
                         f"{meta.get('kind')!r})")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != meta["num_devices"]:
        raise RuntimeError(
            f"{path} was exported for {meta['num_devices']} ranks; this "
            f"process group has {world}")
    fast = FastRenderer(scene, _config_of(meta),
                        dtype=getattr(torch, meta["dtype"]),
                        grid_dtype=np.dtype(meta["grid_dtype"]),
                        device=device, march_impl=meta["march_impl"],
                        row_multiple=meta["row_multiple"])
    mesh = make_mesh(tuple(meta["mesh_shape"].values()),
                     tuple(meta["mesh_shape"]),
                     device_type=fast.device.type)
    spec = meta["optimizer"]
    optimizer = functools.partial(
        getattr(torch.optim, spec["name"]),
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in spec["kwargs"].items()})
    step_fn = fast_sharding.fast_train_step(
        fast, mesh, optimizer, mode=meta["mode"], degree=meta["degree"])
    step_fn.params = _params_like(fast, leaves, path)
    step_fn.renderer = fast
    step_fn.mesh = mesh
    return step_fn, meta
