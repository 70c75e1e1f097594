"""Inverse rendering: optimize scene parameters (and camera pose) to match a
target image through pixel-loss gradients (counterpart of
``ray_marching_tpu/optim/inverse.py``, ``torch.optim`` in place of optax).

* **parameter masking**: optimize a chosen subset of parameter paths
  (``c1/c0/radius``, the camera pose), freeze the rest. Frozen leaves get
  zero gradients **and** are restored after every update: adamw's decoupled
  weight decay moves a parameter whatever its gradient;
* **manifold projection**: quaternion leaves are renormalized after every
  update;
* **checkpoint/resume**: params, pose, optimizer state and step counter via
  :mod:`ray_marching_tpu_torch.io.checkpoint`, as one ``.npz`` file or (the
  JAX package's orbax backend) a ``torch.distributed.checkpoint``
  directory;
* **metrics**: JSONL per-step records (loss, grad norm, wall time).

The optimizers take the JAX package's hyperparameters: Adam and AdamW with
``b1 = 0.9, b2 = 0.999, eps = 1e-8`` (added outside the square root in both
libraries) and AdamW's weight decay ``1e-4`` (optax's default, not
``torch.optim``'s).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from ray_marching_tpu_torch.io.checkpoint import (
    load_pytree,
    load_pytree_dcp,
    save_pytree,
    save_pytree_dcp,
)
from ray_marching_tpu_torch.render.silhouette import composite
from ray_marching_tpu_torch.scene.graph import map_params, param_paths

ADAMW_WEIGHT_DECAY = 1e-4


@dataclass
class InverseConfig:
    learning_rate: float = 1e-2
    steps: int = 200
    mode: int = 0
    degree: int = 1
    optimizer: str = "adam"  # adam | sgd | adamw
    # Parameter paths to optimize (substring match); None = every leaf.
    trainable: Optional[Sequence[str]] = None
    optimize_pose: bool = False
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    # npz | dcp (torch.distributed.checkpoint, in place of the JAX
    # package's orbax)
    checkpoint_backend: str = "npz"
    metrics_path: Optional[str] = None
    loss: str = "l2"  # l2 | l1
    # Silhouette-aware loss: with beta > 0 the render is composited with a
    # soft coverage mask (render/silhouette.py) against `background`, so
    # the pixel loss carries gradient across object silhouettes. Pass
    # ``target_alpha`` to optimize() to supervise the mask directly too
    # (weight ``silhouette_weight``).
    silhouette_beta: float = 0.0
    silhouette_weight: float = 1.0
    background: float = 0.0


def _make_optimizer(cfg: InverseConfig, leaves):
    lr = cfg.learning_rate
    if cfg.optimizer == "adam":
        return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=ADAMW_WEIGHT_DECAY)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(leaves, lr=lr)
    raise KeyError(cfg.optimizer)


def _opt_state_tree(optimizer, named):
    """The optimizer's per-leaf state as ``{name: {key: tensor}}``: Adam's
    and AdamW's with zeros where the optimizer has not initialised it yet
    (the checkpoint template), another optimizer's as it holds it."""
    adam = isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW))
    out = {}
    for name, leaf in named.items():
        st = optimizer.state.get(leaf, {})
        if adam:
            out[name] = {
                "step": st.get("step", torch.zeros((), dtype=torch.float32)),
                "exp_avg": st.get("exp_avg", torch.zeros_like(leaf)),
                "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(leaf)),
            }
        elif st:
            out[name] = dict(st)
    return out


def optimize(renderer, target, orientation, translation,
             config: InverseConfig = InverseConfig(),
             init_params=None,
             resume_from: Optional[str] = None,
             callback: Optional[Callable] = None,
             target_alpha=None):
    """Run the inverse-rendering loop.

    Args:
        renderer: a :class:`ray_marching_tpu_torch.render.fast.FastRenderer`.
        target: (N, H, W, 3) target image.
        orientation/translation: camera pose; optimized too when
            ``config.optimize_pose``.
        init_params: starting scene params (defaults to the renderer's).
        resume_from: checkpoint path to resume from.
        callback: ``f(step, loss, state)`` called every step.

    Returns:
        dict with final ``params``, ``orientation``, ``translation``,
        ``losses`` list, and ``steps_run``.
    """
    if config.checkpoint_backend == "orbax":
        raise ValueError(
            "checkpoint_backend='orbax' needs jax; this package's directory "
            "checkpoints are checkpoint_backend='dcp' "
            "(torch.distributed.checkpoint)")
    if config.checkpoint_backend not in ("npz", "dcp"):
        raise ValueError(
            f"checkpoint_backend={config.checkpoint_backend!r}: one of "
            "'npz', 'dcp'")
    dcp = config.checkpoint_backend == "dcp"
    tensor = renderer._tensor

    def fresh(leaf):
        return tensor(leaf).detach().clone().requires_grad_(True)

    params = map_params(
        renderer.init_params if init_params is None else init_params, fresh)
    state = {
        "params": params,
        "orientation": fresh(orientation),
        "translation": fresh(translation),
    }
    named = {f"params/{k}": v for k, v in param_paths(params).items()}
    named["orientation"] = state["orientation"]
    named["translation"] = state["translation"]
    frozen = {
        name for name in named
        if (name in ("orientation", "translation")
            and not config.optimize_pose)
        or (name.startswith("params/") and config.trainable is not None
            and not any(t in name[len("params/"):] for t in config.trainable))
    }
    optimizer = _make_optimizer(config, list(named.values()))
    start_step = 0
    if resume_from:
        template = (map_params(state, torch.Tensor.detach),
                    _opt_state_tree(optimizer, named))
        (loaded, opt_state), extra = (load_pytree_dcp if dcp else
                                      load_pytree)(resume_from, template,
                                                   with_extra=True)
        with torch.no_grad():
            for leaf, value in zip(param_paths(state).values(),
                                   param_paths(loaded).values()):
                leaf.copy_(value)
        for name, st in opt_state.items():
            optimizer.state[named[name]] = st
        start_step = int(extra.get("step", 0))

    target = tensor(target)
    if target_alpha is not None:
        if config.silhouette_beta <= 0:
            # The alpha term only enters the loss on the silhouette branch;
            # dropping supplied mask supervision silently would leave the
            # stalling pixel-only fit the mask was meant to avoid.
            raise ValueError(
                "target_alpha supplied but config.silhouette_beta is 0 — "
                "set silhouette_beta > 0 to enable the coverage loss")
        target_alpha = tensor(target_alpha)

    def loss_fn():
        extra = 0.0
        if config.silhouette_beta > 0:
            image, alpha = renderer.render_with_alpha(
                state["params"], state["orientation"], state["translation"],
                mode=config.mode, degree=config.degree,
                beta=config.silhouette_beta)
            image = composite(image, alpha, config.background)
            if target_alpha is not None:
                extra = config.silhouette_weight * torch.mean(
                    (alpha - target_alpha) ** 2)
        else:
            image = renderer.render(
                state["params"], state["orientation"], state["translation"],
                mode=config.mode, degree=config.degree)
        err = image - target
        if config.loss == "l1":
            return torch.mean(torch.abs(err)) + extra
        return torch.mean(err**2) + extra

    # Frozen leaves never change: their values are put back after every
    # update, which zeroes adamw's decay on them as well.
    held = {name: named[name].detach().clone() for name in frozen}

    def step_fn():
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        for name, leaf in named.items():
            if name in frozen or leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        gnorm = torch.sqrt(sum((leaf.grad**2).sum()
                               for leaf in named.values()))
        optimizer.step()
        with torch.no_grad():
            for name, value in held.items():
                named[name].copy_(value)
            for name, leaf in named.items():
                if name.endswith("orientation"):
                    leaf.div_(torch.linalg.norm(leaf, dim=-1, keepdim=True))
        return loss.detach(), gnorm

    metrics_file = None
    if config.metrics_path:
        Path(config.metrics_path).parent.mkdir(parents=True, exist_ok=True)
        metrics_file = open(config.metrics_path, "a")

    losses = []
    t_start = time.perf_counter()
    try:
        for step in range(start_step, config.steps):
            loss, gnorm = step_fn()
            loss = float(loss)
            losses.append(loss)
            if metrics_file:
                metrics_file.write(json.dumps({
                    "step": step,
                    "loss": loss,
                    "grad_norm": float(gnorm),
                    "wall_s": time.perf_counter() - t_start,
                }) + "\n")
                metrics_file.flush()
            if callback:
                callback(step, loss, state)
            if (config.checkpoint_dir
                    and (step + 1) % config.checkpoint_every == 0):
                name = f"ckpt_{step + 1:06d}" + ("" if dcp else ".npz")
                (save_pytree_dcp if dcp else save_pytree)(
                    Path(config.checkpoint_dir) / name,
                    (map_params(state, torch.Tensor.detach),
                     _opt_state_tree(optimizer, named)),
                    extra={"step": step + 1})
    finally:
        if metrics_file:
            metrics_file.close()

    final = map_params(state, torch.Tensor.detach)
    return {
        "params": final["params"],
        "orientation": final["orientation"],
        "translation": final["translation"],
        "losses": losses,
        "steps_run": len(losses),
    }
