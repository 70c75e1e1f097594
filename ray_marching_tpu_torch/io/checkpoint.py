"""Checkpoints of parameter trees (counterpart of
``ray_marching_tpu/io/checkpoint.py``, the npz backend).

A tree (nested dicts, tuples and lists of tensors) is flattened to named
leaves in one ``.npz`` file; restoring rebuilds it against a template that
supplies the structure, the dtypes and the device. Leaf names follow the JAX
package's (``['c1']['c0']['radius']``, ``[0]`` for a sequence index), so a
scene-parameter file written by either package loads in the other. A resume
checkpoint also holds the optimizer's state, which ``torch.optim`` lays out
in its own way: that part is this package's own. The orbax backend of the
JAX package is not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _leaf_paths(tree, prefix=""):
    """``name -> leaf``, dict keys sorted at every level."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_leaf_paths(tree[key], f"{prefix}[{key!r}]"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, val in enumerate(tree):
            out.update(_leaf_paths(val, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _rebuild(template, leaves, prefix=""):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves, f"{prefix}[{k!r}]")
                for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    return leaves[prefix]


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree, extra: dict | None = None) -> Path:
    """Save a tree's leaves (and optional scalar metadata) to ``path``.

    Returns the path written: ``.npz`` is appended when the suffix is
    missing."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {f"leaf::{k}": _to_numpy(v)
               for k, v in _leaf_paths(tree).items()}
    for k, v in (extra or {}).items():
        payload[f"extra::{k}"] = np.asarray(v)
    np.savez(path, **payload)
    return path


def load_pytree(path, template, with_extra: bool = False):
    """Restore a tree saved by :func:`save_pytree` against ``template``
    (same structure; leaf dtypes and devices follow the template)."""
    with np.load(path) as data:
        stored = {k[len("leaf::"):]: data[k] for k in data.files
                  if k.startswith("leaf::")}
        extra = {k[len("extra::"):]: data[k] for k in data.files
                 if k.startswith("extra::")}
    wanted = _leaf_paths(template)
    missing = [k for k in wanted if k not in stored]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing}")
    bad = [(k, stored[k].shape, tuple(np.shape(_to_numpy(leaf))))
           for k, leaf in wanted.items()
           if stored[k].shape != tuple(np.shape(_to_numpy(leaf)))]
    if bad:
        raise ValueError(
            "checkpoint leaf shapes do not match the template: "
            + ", ".join(f"{k}: stored {s} != template {t}" for k, s, t in bad))
    leaves = {}
    for k, leaf in wanted.items():
        if isinstance(leaf, torch.Tensor):
            leaves[k] = torch.as_tensor(stored[k]).to(dtype=leaf.dtype,
                                                      device=leaf.device)
        else:
            leaves[k] = np.asarray(stored[k], dtype=np.asarray(leaf).dtype)
    tree = _rebuild(template, leaves)
    return (tree, extra) if with_extra else tree
