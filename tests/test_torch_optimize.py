"""The port's ``optim.inverse.optimize`` against the JAX package's, step for
step (f64 on the CPU, JAX's Pallas kernels in interpret mode), resume from a
checkpoint, the checkpoint format both packages share, and ``cli optimize``.

Tolerance of the optimisation steps: rtol 1e-6 on losses and parameters
after three steps. One Adam step divides by sqrt(v) + eps, which amplifies
the rounding of the gradients (held to 1e-7 in test_torch_train.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.io.checkpoint import load_pytree as j_load_pytree
from ray_marching_tpu.io.checkpoint import save_pytree as j_save_pytree
from ray_marching_tpu.optim.inverse import InverseConfig as JaxInverseConfig
from ray_marching_tpu.optim.inverse import optimize as j_optimize
from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch.cli import main as cli_main
from ray_marching_tpu_torch.io.checkpoint import load_pytree, save_pytree
from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

PX = 3.45e-6
Q0 = np.asarray([[0.0, 0.0, 1.0, 0.0]])
T0 = np.asarray([[0.0, 0.2, 2.5]])


def _cfg_kwargs(w, h, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, **kw)


def _renderers(scene, w, h, **kw):
    jr = JaxFastRenderer(jreg.make_scene(scene),
                         JaxRenderConfig(**_cfg_kwargs(w, h, **kw)),
                         dtype=jnp.float64, grid_dtype=np.float64,
                         interpret=True)
    tr = FastRenderer(treg.make_scene(scene),
                      RenderConfig(**_cfg_kwargs(w, h, **kw)),
                      dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    return jr, tr


def _leaves(tree):
    return tgraph.param_paths(tree)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


OPT_CASES = {
    "adam": dict(optimizer="adam", trainable=None, optimize_pose=False),
    "adamw_masked": dict(optimizer="adamw", trainable=["c1/c0/radius"],
                         optimize_pose=False),
    # SGD takes the raw gradient: a small rate keeps three steps gentle.
    "sgd_pose_l1": dict(optimizer="sgd", trainable=["c1/c1"],
                        optimize_pose=True, loss="l1", learning_rate=1e-4),
    "adam_silhouette": dict(optimizer="adam", trainable=["c1/c0/radius"],
                            optimize_pose=False, silhouette_beta=0.05),
}


def _target(jr, silhouette=False):
    """The render of test_scene2 with the sphere 20 % larger, plus seeded
    pixel noise: no pixel error is zero up to rounding, where the l1 loss's
    sign would differ between the packages by chance."""
    true = jgraph.tree_map_with_path(
        lambda path, leaf: leaf * 1.2 if "c1/c0/radius" in path else leaf,
        jr.init_params)
    q, t = jnp.asarray(Q0), jnp.asarray(T0)
    image = np.asarray(jr.render(true, q, t, mode=0, degree=2))
    image = image + 0.05 * np.random.default_rng(45).normal(size=image.shape)
    if silhouette:
        _, alpha = jr.render_with_alpha(true, q, t, mode=0, degree=2,
                                        beta=0.05)
        return image, np.asarray(alpha)
    return image, None


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimize_steps_match_jax(case):
    """Three steps of optimize() in both packages from the same start:
    the same losses and the same parameters (rtol 1e-6: one Adam step
    divides by sqrt(v) + eps, which amplifies the gradients' rounding)."""
    kw = dict(OPT_CASES[case])
    jr, tr = _renderers("test_scene2", 32, 24, marching_steps=8)
    target, target_alpha = _target(jr, "silhouette_beta" in kw)
    common = dict(dict(learning_rate=0.02, steps=3, mode=0, degree=2), **kw)
    jout = j_optimize(jr, jnp.asarray(target), jnp.asarray(Q0),
                      jnp.asarray(T0), JaxInverseConfig(**common),
                      target_alpha=None if target_alpha is None
                      else jnp.asarray(target_alpha))
    tout = optimize(tr, target, Q0, T0, InverseConfig(**common),
                    target_alpha=target_alpha)
    assert tout["steps_run"] == jout["steps_run"] == 3
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-6)
    want = jgraph.param_paths(jout["params"])
    got = _leaves(tout["params"])
    moved = 0
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-12, err_msg=path)
        start = _leaves(tr.init_params)[path].numpy()
        if kw["trainable"] and not any(s in path for s in kw["trainable"]):
            # Frozen leaves do not move, under adamw's decay either.
            np.testing.assert_array_equal(got[path].numpy(), start)
        else:
            moved += int(not np.array_equal(got[path].numpy(), start))
    assert moved >= 1
    for key in ("orientation", "translation"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-6, atol=1e-12)
    if not kw["optimize_pose"]:
        np.testing.assert_array_equal(tout["orientation"].numpy(), Q0)


def test_target_alpha_needs_silhouette_beta():
    _, tr = _renderers("test_scene2", 16, 8, marching_steps=4)
    with pytest.raises(ValueError, match="silhouette_beta"):
        optimize(tr, np.zeros((1, 8, 16, 3)), Q0, T0, InverseConfig(steps=1),
                 target_alpha=np.zeros((1, 8, 16, 1)))
    with pytest.raises(NotImplementedError, match="orbax"):
        optimize(tr, np.zeros((1, 8, 16, 3)), Q0, T0,
                 InverseConfig(steps=1, checkpoint_backend="orbax"))


def test_optimize_resume_continues_the_run(tmp_path):
    """Two steps, a checkpoint, then two more from it equal four steps in
    one go: parameters, optimizer state and step counter all come back."""
    _, tr = _renderers("test_scene2", 32, 24, marching_steps=8)
    jr, _ = _renderers("test_scene2", 32, 24, marching_steps=8)
    target, _ = _target(jr)
    base = dict(learning_rate=0.02, mode=0, degree=2,
                trainable=["c1/c0/radius"], optimizer="adamw")
    whole = optimize(tr, target, Q0, T0, InverseConfig(steps=4, **base))
    metrics = tmp_path / "m" / "metrics.jsonl"
    optimize(tr, target, Q0, T0,
             InverseConfig(steps=2, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / "ck"),
                           metrics_path=str(metrics), **base))
    ckpt = tmp_path / "ck" / "ckpt_000002.npz"
    assert ckpt.exists()
    rest = optimize(tr, target, Q0, T0, InverseConfig(steps=4, **base),
                    resume_from=str(ckpt))
    assert rest["steps_run"] == 2
    np.testing.assert_array_equal(rest["losses"], whole["losses"][2:])
    for path, w in _leaves(whole["params"]).items():
        assert torch.equal(_leaves(rest["params"])[path], w), path
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    assert records[0]["loss"] == whole["losses"][0]
    assert all(r["grad_norm"] > 0 and r["wall_s"] > 0 for r in records)


def test_param_files_cross_between_the_packages(tmp_path):
    """A scene-parameter file written by one package loads in the other."""
    rng = np.random.default_rng(47)
    jparams = jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=np.shape(a)),
        jgraph.init_params(jreg.make_scene("test_scene"), jnp.float64))
    tparams = tgraph.params_from_jax(_np_tree(jparams), torch.float64)
    t_template = tgraph.init_params(treg.make_scene("test_scene"),
                                    torch.float32)
    j_template = jgraph.init_params(jreg.make_scene("test_scene"),
                                    jnp.float32)
    # JAX → port (the suffix is appended like np.savez does).
    path = j_save_pytree(tmp_path / "from_jax", jparams)
    loaded = load_pytree(path, t_template)
    for k, v in _leaves(tparams).items():
        assert _leaves(loaded)[k].dtype == torch.float32
        np.testing.assert_array_equal(_leaves(loaded)[k].numpy(),
                                      v.numpy().astype(np.float32))
    # Port → JAX, with metadata.
    path = save_pytree(tmp_path / "from_torch.npz", tparams,
                       extra={"step": 7})
    back, extra = j_load_pytree(path, j_template, with_extra=True)
    assert int(extra["step"]) == 7
    for k, v in jgraph.param_paths(jparams).items():
        np.testing.assert_array_equal(
            np.asarray(jgraph.param_paths(back)[k]),
            np.asarray(v).astype(np.float32))
    # Wrong scene: named leaves are missing, shapes are checked.
    other = tgraph.init_params(treg.make_scene("test_scene2"), torch.float32)
    with pytest.raises(KeyError, match="missing leaves"):
        load_pytree(path, other)
    bad = {"a": torch.zeros(3)}
    save_pytree(tmp_path / "bad.npz", bad)
    with pytest.raises(ValueError, match="do not match"):
        load_pytree(tmp_path / "bad.npz", {"a": torch.zeros(4)})


def test_cli_optimize_selftest_lowers_loss(tmp_path, capsys):
    out = tmp_path / "fit.npz"
    metrics = tmp_path / "metrics.jsonl"
    args = ["optimize", "--target", "selftest", "--device", "cpu",
            "--dtype", "float64", "--width", "32", "--height", "24",
            "--steps", "8", "--trainable", "c1/c0/radius", "--lr", "0.02"]
    cli_main(args + ["--opt-steps", "12", "--save-params", str(out),
                     "--metrics", str(metrics)])
    losses = [json.loads(line)["loss"]
              for line in metrics.read_text().splitlines()]
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert "final loss" in capsys.readouterr().out
    # The saved parameters warm-start a second run, which starts where the
    # first ended.
    metrics2 = tmp_path / "metrics2.jsonl"
    cli_main(args + ["--opt-steps", "1", "--params", str(out),
                     "--metrics", str(metrics2)])
    first = json.loads(metrics2.read_text().splitlines()[0])["loss"]
    assert first < losses[0]
    with pytest.raises(NotImplementedError, match="PNG"):
        cli_main(args + ["--target", str(tmp_path / "target.png")])
