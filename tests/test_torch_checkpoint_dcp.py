"""The port's second checkpoint backend, ``torch.distributed.checkpoint``
(DCP; ``io/checkpoint.py`` ``save_pytree_dcp`` / ``load_pytree_dcp``,
``InverseConfig(checkpoint_backend="dcp")``), on the CPU.

It is the counterpart of the JAX package's orbax backend, which imports
jax: a directory per checkpoint, committed by a rename. The leaves come
back bit for bit; resuming ``optimize`` from a DCP checkpoint gives the
parameters that resuming from the npz checkpoint of the same run gives, bit
for bit, and both equal the uninterrupted run; ``"orbax"`` is refused with
a pointer to ``"dcp"``. The JAX side: the same tree saved by the JAX npz
backend and the DCP backend restores to the same leaves.
"""

import numpy as np
import pytest
import torch

from ray_marching_tpu.io.checkpoint import save_pytree as j_save_pytree
from ray_marching_tpu_torch.io.checkpoint import (
    load_pytree,
    load_pytree_dcp,
    save_pytree_dcp,
)
from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

PX = 3.45e-6
Q0 = np.asarray([[0.0, 0.0, 1.0, 0.0]])
T0 = np.asarray([[0.0, 0.2, 2.5]])


def _tree():
    g = torch.Generator().manual_seed(3)
    return ({"a": torch.randn(3, 4, dtype=torch.float64, generator=g),
             "b": {"c": torch.tensor(2.5, dtype=torch.float32),
                   "d": torch.randn(5, generator=g)}},
            [torch.arange(6, dtype=torch.int32).reshape(2, 3),
             np.float64(0.125)])


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


def test_dcp_round_trip(tmp_path):
    tree = _tree()
    path = save_pytree_dcp(tmp_path / "ck", tree, extra={"step": 7})
    assert path == (tmp_path / "ck").absolute() and path.is_dir()
    assert not (tmp_path / "ck.tmp").exists()  # committed by the rename
    back, extra = load_pytree_dcp(path, tree, with_extra=True)
    _same(back, tree)
    assert int(extra["step"]) == 7
    with pytest.raises(FileExistsError):
        save_pytree_dcp(path, tree)


def test_dcp_refuses_a_wrong_template(tmp_path):
    tree = _tree()
    path = save_pytree_dcp(tmp_path / "ck", tree)
    bad = ({**tree[0], "a": torch.zeros(4, 3, dtype=torch.float64)},
           tree[1])
    with pytest.raises(ValueError, match="shapes do not match"):
        load_pytree_dcp(path, bad)
    with pytest.raises(KeyError, match="missing"):
        load_pytree_dcp(path, (tree[0], tree[1] + [torch.zeros(1)]))


def test_dcp_and_jax_npz_restore_the_same_leaves(tmp_path):
    """A scene-parameter tree through the JAX package's npz backend and
    through DCP: the same leaves, in the template's dtypes."""
    import jax.numpy as jnp

    scene = treg.make_scene("test_scene2")
    template = tgraph.init_params(scene, torch.float64)
    scaled = tgraph.map_params(template, lambda v: v * 1.5)
    j_save_pytree(tmp_path / "j.npz", tgraph.map_params(
        scaled, lambda v: jnp.asarray(v.numpy())))
    a = load_pytree(tmp_path / "j.npz", template)
    b = load_pytree_dcp(save_pytree_dcp(tmp_path / "d", scaled), template)
    _same(a, b)


def test_resume_from_dcp_equals_resume_from_npz(tmp_path):
    cfg = RenderConfig(px_width=24, px_height=16, focal_length=PX * 16,
                       sensor_width=PX * 24, sensor_height=PX * 16,
                       marching_steps=6)
    r = FastRenderer(treg.make_scene("test_scene2"), cfg,
                     dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    true = tgraph.map_params(r.init_params, lambda v: v * 1.1)
    with torch.no_grad():
        target = r.render(true, Q0, T0, mode=0, degree=2)
    base = dict(learning_rate=0.02, mode=0, degree=2,
                trainable=["c1/c0/radius", "c1/c1"], optimizer="adam")
    whole = optimize(r, target, Q0, T0, InverseConfig(steps=4, **base))
    runs = {}
    for backend, name in (("npz", "ckpt_000002.npz"), ("dcp", "ckpt_000002")):
        optimize(r, target, Q0, T0, InverseConfig(
            steps=2, checkpoint_every=2, checkpoint_backend=backend,
            checkpoint_dir=str(tmp_path / backend), **base))
        ckpt = tmp_path / backend / name
        assert ckpt.is_dir() == (backend == "dcp") and ckpt.exists()
        runs[backend] = optimize(r, target, Q0, T0, InverseConfig(
            steps=4, checkpoint_backend=backend, **base),
            resume_from=str(ckpt))
    for backend, rest in runs.items():
        assert rest["steps_run"] == 2
        np.testing.assert_array_equal(rest["losses"], whole["losses"][2:])
        for key in ("orientation", "translation"):
            assert torch.equal(rest[key], whole[key])
    a, b = (tgraph.param_paths(runs[k]["params"]) for k in ("dcp", "npz"))
    for path, v in tgraph.param_paths(whole["params"]).items():
        assert torch.equal(a[path], b[path]) and torch.equal(a[path], v), path


def test_orbax_is_refused_with_a_pointer_to_dcp():
    r = FastRenderer(treg.make_scene("test_scene2"), RenderConfig(
        px_width=8, px_height=8, marching_steps=2), device="cpu")
    for backend, match in (("orbax", "checkpoint_backend='dcp'"),
                           ("pickle", "one of 'npz', 'dcp'")):
        with pytest.raises(ValueError, match=match):
            optimize(r, np.zeros((1, 8, 8, 3)), Q0, T0,
                     InverseConfig(steps=1, checkpoint_backend=backend))
