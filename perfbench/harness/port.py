"""The system under test, reached through the entry points its users call:
``FastRenderer`` built from a scene description (``scene.serialize``),
weights through ``io.checkpoint.load_pytree``, ``optim.inverse.optimize``
and ``viewer.run_viewer``. The only module of the benchmark that imports
the program, and only when a run starts."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from perfbench.harness.spec import ROOT


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg["render"]["dtype"])


def build_renderer(cfg, device):
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import RenderConfig
    from ray_marching_tpu_torch.scene.serialize import node_from_dict

    r = cfg["render"]
    px = r["pixel_size"]
    rc = RenderConfig(
        num_cameras=r.get("num_cameras", 1), px_width=r["width"],
        px_height=r["height"], focal_length=px * r["height"],
        sensor_width=px * r["width"], sensor_height=px * r["height"],
        marching_steps=r["marching_steps"], tau=r["tau"],
        normals_eps=r["normals_eps"])
    return FastRenderer(node_from_dict(cfg["scene"]), rc, dtype=dtype_of(cfg),
                        device=device)


def initial_params(cfg, renderer):
    """The scene's parameters as the program starts from them: its own
    from the description, or the configuration's weights file."""
    if not cfg.get("weights"):
        return renderer.init_params
    from ray_marching_tpu_torch.io.checkpoint import load_pytree

    return load_pytree(ROOT / cfg["weights"], renderer.init_params)


def flat(tree, prefix=""):
    """``{path: tensor}`` of a nested parameter dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def launch_counters() -> dict:
    """The program's own launch counters (module globals of its kernel
    wrappers)."""
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    return {"forward": rk.LAUNCHES, "backward": bk.LAUNCHES}


def backward_path() -> dict:
    """The program's record of its most recent backward launch."""
    from ray_marching_tpu_torch.ops import backward_kernel as bk

    return {k: v for k, v in bk.LAST_PATH.items()
            if isinstance(v, (bool, int, float, str))}


def poses_tensor(poses, dtype, device):
    q = np.stack([p[0] for p in poses])
    t = np.stack([p[1] for p in poses])
    return (torch.as_tensor(q).to(device, dtype),
            torch.as_tensor(t).to(device, dtype))


def weights_file(cfg) -> Path | None:
    return ROOT / cfg["weights"] if cfg.get("weights") else None
