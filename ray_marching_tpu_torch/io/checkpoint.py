"""Checkpoints of parameter trees (counterpart of
``ray_marching_tpu/io/checkpoint.py``, the npz backend).

A tree (nested dicts, tuples and lists of tensors) is flattened to named
leaves in one ``.npz`` file; restoring rebuilds it against a template that
supplies the structure, the dtypes and the device. Leaf names follow the JAX
package's (``['c1']['c0']['radius']``, ``[0]`` for a sequence index), so a
scene-parameter file written by either package loads in the other. A resume
checkpoint also holds the optimizer's state, which ``torch.optim`` lays out
in its own way: that part is this package's own.

The JAX package's second backend, orbax (atomic, multihost-coordinated
directories), imports jax; its counterpart here is
``torch.distributed.checkpoint`` (DCP): :func:`save_pytree_dcp` /
:func:`load_pytree_dcp`, the same named leaves in a directory, written by
every rank of a process group when one is initialized (by one process
without), and committed atomically by a rename.
"""

from __future__ import annotations

import os
import warnings
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


def _check_shapes(stored_shapes, wanted):
    """Raise as the npz loader does when a leaf is missing or its stored
    shape is not the template's."""
    missing = [k for k in wanted if k not in stored_shapes]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing}")
    bad = [(k, stored_shapes[k], tuple(np.shape(_to_numpy(leaf))))
           for k, leaf in wanted.items()
           if stored_shapes[k] != tuple(np.shape(_to_numpy(leaf)))]
    if bad:
        raise ValueError(
            "checkpoint leaf shapes do not match the template: "
            + ", ".join(f"{k}: stored {s} != template {t}" for k, s, t in bad))


def _as_template(stored, wanted):
    """Stored leaves (numpy) in the template leaves' dtypes and devices."""
    leaves = {}
    for k, leaf in wanted.items():
        if isinstance(leaf, torch.Tensor):
            leaves[k] = torch.as_tensor(stored[k]).to(dtype=leaf.dtype,
                                                      device=leaf.device)
        else:
            leaves[k] = np.asarray(stored[k], dtype=np.asarray(leaf).dtype)
    return leaves


def load_pytree(path, template, with_extra: bool = False):
    """Restore a tree saved by :func:`save_pytree` against ``template``
    (same structure; leaf dtypes and devices follow the template)."""
    with np.load(path) as data:
        stored = {k[len("leaf::"):]: data[k] for k in data.files
                  if k.startswith("leaf::")}
        extra = {k[len("extra::"):]: data[k] for k in data.files
                 if k.startswith("extra::")}
    wanted = _leaf_paths(template)
    _check_shapes({k: v.shape for k, v in stored.items()}, wanted)
    tree = _rebuild(template, _as_template(stored, wanted))
    return (tree, extra) if with_extra else tree


# --- the DCP backend (the counterpart of the JAX package's orbax one) ------


def _dist():
    """torch.distributed when a process group is initialized, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def save_pytree_dcp(directory, tree, extra: dict | None = None) -> Path:
    """Save a tree's leaves (and optional scalar metadata) as a
    ``torch.distributed.checkpoint`` directory.

    ``directory`` must not exist yet (one directory per checkpoint, as
    orbax wants). The checkpoint is written to ``<directory>.tmp`` and
    renamed once complete, so a reader never sees half of one. With a
    process group initialized every rank must call (each writes its part,
    rank 0 the metadata and the rename); without one, one process saves.
    Returns the absolute path."""
    import torch.distributed.checkpoint as dcp

    directory = Path(directory).absolute()
    if directory.exists():
        raise FileExistsError(f"checkpoint directory exists: {directory}")
    tmp = directory.with_name(directory.name + ".tmp")
    state = {f"leaf::{k}": torch.as_tensor(_to_numpy(v)).clone()
             for k, v in _leaf_paths(tree).items()}
    for k, v in (extra or {}).items():
        state[f"extra::{k}"] = torch.as_tensor(np.asarray(v))
    dist = _dist()
    with warnings.catch_warnings():  # "assuming ... a single process"
        warnings.simplefilter("ignore", UserWarning)
        dcp.save(state, checkpoint_id=str(tmp))
    if dist is not None:
        dist.barrier()
    if dist is None or dist.get_rank() == 0:
        os.replace(tmp, directory)
    if dist is not None:
        dist.barrier()
    return directory


def load_pytree_dcp(directory, template, with_extra: bool = False):
    """Restore a tree saved by :func:`save_pytree_dcp` against ``template``
    (same structure; leaf dtypes and devices follow the template, as
    :func:`load_pytree`)."""
    import torch.distributed.checkpoint as dcp

    directory = str(Path(directory).absolute())
    meta = dcp.FileSystemReader(directory).read_metadata()
    state = {key: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for key, m in meta.state_dict_metadata.items()}
    wanted = _leaf_paths(template)
    _check_shapes({k[len("leaf::"):]: tuple(v.shape) for k, v in state.items()
                   if k.startswith("leaf::")}, wanted)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(state, checkpoint_id=directory)
    stored = {k[len("leaf::"):]: v.numpy() for k, v in state.items()
              if k.startswith("leaf::")}
    extra = {k[len("extra::"):]: v.numpy() for k, v in state.items()
             if k.startswith("extra::")}
    tree = _rebuild(template, _as_template(stored, wanted))
    return (tree, extra) if with_extra else tree
