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
``export_train_step`` / ``load_train_step`` (the sharded training step)
wait for the port of the parallel modules.
"""

from __future__ import annotations

import dataclasses
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
        zf.writestr(_SCENE_NAME, json.dumps(node_to_dict(renderer.scene),
                                            indent=1))
    return path


def load_render(path, device="cuda"):
    """Load a ``.rmx`` artifact: ``(render_fn, params, meta)``.

    ``render_fn(params, orientation, translation)`` renders the exported
    mode with the renderer rebuilt on ``device`` (``"cpu"`` runs the
    kernels' plain versions); ``params`` is the bundled tree, on
    ``device``, in the renderer's structure: pass it through or swap in a
    tree of the same structure (e.g. from ``optimize``)."""
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer

    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(_META_NAME))
        scene = node_from_dict(json.loads(zf.read(_SCENE_NAME)))
        with np.load(io.BytesIO(zf.read(_PARAMS_NAME))) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    if meta.get("format_version") != _FORMAT_VERSION or "renderer" not in meta:
        raise ValueError(f"{path}: not an artifact of this package (format "
                         f"{meta.get('format_version')}, keys {sorted(meta)})")
    fields = {f.name: f for f in dataclasses.fields(RenderConfig)}
    config = RenderConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in meta["config"].items()
                             if k in fields})
    dtype = getattr(torch, meta["dtype"])
    kw = dict(dtype=dtype, grid_dtype=np.dtype(meta["grid_dtype"]),
              device=device)
    if meta["renderer"] == "fast":
        renderer = FastRenderer(scene, config, march_impl=meta["march_impl"],
                                **kw)
    else:
        renderer = Renderer(scene, config, **kw)
    names = list(_leaf_paths(renderer.init_params))
    if len(names) != len(leaves):
        raise ValueError(f"{path}: {len(leaves)} parameter leaves, the scene "
                         f"has {len(names)}")
    params = _rebuild(renderer.init_params, {
        name: torch.as_tensor(leaf).to(dtype=ref.dtype, device=ref.device)
        for (name, ref), leaf in zip(_leaf_paths(renderer.init_params).items(),
                                     leaves)})
    mode, degree, steps = meta["mode"], meta["degree"], meta["marching_steps"]

    def render_fn(params, orientation, translation):
        return renderer.render(params, orientation, translation, mode=mode,
                               degree=degree, marching_steps=steps)

    render_fn.renderer = renderer
    return render_fn, params, meta
