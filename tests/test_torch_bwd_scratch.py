"""The backward's bounded scratch and the history size rule, on the CPU.

(a) ``render_kernel.hist_enabled`` against the JAX package's
``pallas_render._hist_enabled`` at the same ``RM_TPU_BWD_HIST_MAX``, on
shapes where JAX's tile padding leaves the rows as they are (its tile is
``min(64, rows)`` for an analytic scene), with the cap at the history's
bytes and one byte below. (b) A 24×16 ``FastRenderer`` training step with
the cap below its history: no history is logged, and the gradient is
bitwise the history path's (f64 and f32, the kernels' plain versions) and,
in f64, within tests/test_torch_train.py's tolerance (rtol 1e-7, atol 1e-9
of the largest entry) of the JAX package's gradient. That gradient is its
FastRenderer's XLA route under ``jax.jit``: JAX's history and recompute
paths give the same bits, and its interpreted kernels take 13–20 s for one
gradient here, where this file has 15 s; tests/test_torch_backward_kernel.py
holds the port's recompute against JAX's interpreted kernel. (c) The host's
grid and slot arithmetic of the kernel's persistent launch. (d) ``cli
render --fast --grid-dtype float64`` against the JAX CLI's frame.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu import cli as jcli
from ray_marching_tpu.ops import pallas_render as jpr
from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch import cli as tcli
from ray_marching_tpu_torch.ops import backward_kernel as bk
from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.render.tiled import TiledRenderer
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

PX = 3.45e-6
Q = [[0.0, 0.0, 1.0, 0.0]]
T = [[0.0, 0.2, 2.5]]


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread per test (the suite runs in several workers),
    and none of the JAX package's switches that would change its rule."""
    for name in ("RM_TPU_BWD_HIST", "RM_TPU_BWD_TWO_LEVEL",
                 "RM_TPU_BWD_HIST_MAX", "RM_TPU_NEURAL_TILE"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(w, h, **kw):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h, **kw)


@pytest.mark.parametrize("rows,steps,tau,dtype", [
    (40, 32, 0.0, "float32"), (128, 16, 1e-3, "float32"),
    (64, 24, 0.0, "float64")])
def test_history_decision_matches_jax(rows, steps, tau, dtype, monkeypatch):
    jrays = jnp.zeros((7, rows, 128), getattr(jnp, dtype))
    trays = torch.zeros((7, rows, 128), dtype=getattr(torch, dtype))
    nbytes = (steps + 1) * 3 * rows * 128 * np.dtype(dtype).itemsize
    assert rk.hist_bytes(trays, steps) == nbytes
    # Both packages count the same rows here (JAX pads to min(64, rows)).
    assert rows % min(jpr.DEFAULT_ROWS_PER_TILE, rows) == 0
    assert jpr._hist_enabled(jrays, steps, tau) and rk.hist_enabled(trays,
                                                                   steps)
    for cap, want in ((nbytes, True), (nbytes - 1, False)):
        monkeypatch.setenv("RM_TPU_BWD_HIST_MAX", str(cap))
        assert jpr._hist_enabled(jrays, steps, tau) is want
        assert rk.hist_enabled(trays, steps) is want
        # The cap overrides an explicit request; an explicit "no" holds.
        assert rk.hist_enabled(trays, steps, bwd_hist=True) is want
        assert rk.hist_enabled(trays, steps, bwd_hist=False) is False
    monkeypatch.delenv("RM_TPU_BWD_HIST_MAX")
    # JAX's default cap: 4 GiB.
    assert rk.HIST_MAX_DEFAULT == 2**32
    # Two levels log no history in either package.
    assert not rk.hist_enabled(trays, steps, two_level=True)


def _port_grad(dtype, cap):
    """The 24×16 test_scene2 step's gradient (d sum(render · w) / d every
    leaf) through FastRenderer, with RM_TPU_BWD_HIST_MAX at ``cap`` (None:
    unset), and the path the backward took."""
    r = FastRenderer(treg.make_scene("test_scene2"),
                     RenderConfig(**_cfg(24, 16, marching_steps=12)),
                     dtype=dtype, grid_dtype=np.float64, device="cpu")
    wt = torch.as_tensor(np.random.default_rng(5).normal(size=(1, 16, 24, 3)),
                         dtype=dtype)
    params = _require_grad(r.init_params)
    with pytest.MonkeyPatch.context() as mp:
        if cap is not None:
            mp.setenv("RM_TPU_BWD_HIST_MAX", str(cap))
        (r.render(params, Q, T, mode=0, degree=2) * wt).sum().backward()
    return ({k: v.grad for k, v in tgraph.param_paths(params).items()},
            dict(bk.LAST_PATH))


def _require_grad(tree):
    if isinstance(tree, dict):
        return {k: _require_grad(v) for k, v in tree.items()}
    return tree.clone().requires_grad_(True)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_step_above_the_cap_recomputes_with_the_history_bits(dtype):
    want, path = _port_grad(dtype, None)
    assert path["use_hist"] and not path["two_level"]
    got, path = _port_grad(dtype, 1)
    assert not path["use_hist"] and not path["two_level"]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    assert any(float(v.abs().max()) > 0 for v in got.values())
    if dtype != torch.float64:
        return
    jr = JaxFastRenderer(jreg.make_scene("test_scene2"),
                         JaxRenderConfig(**_cfg(24, 16, marching_steps=12)),
                         dtype=jnp.float64, grid_dtype=np.float64,
                         march_impl="xla")
    wt = np.random.default_rng(5).normal(size=(1, 16, 24, 3))

    def j_loss(params):
        return jnp.sum(jr.render(params, jnp.asarray(Q, jnp.float64),
                                 jnp.asarray(T, jnp.float64), mode=0,
                                 degree=2) * wt)

    jg = jgraph.param_paths(jax.jit(jax.grad(j_loss))(jr.init_params))
    assert set(jg) == set(got)
    for k, w in jg.items():
        w = np.asarray(w)
        g = got[k].numpy().reshape(w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-7,
                                   atol=1e-9 * max(1.0, np.abs(w).max()),
                                   err_msg=k)


def _block_walk(n_blocks, grid):
    """The ray blocks each of ``grid`` launched blocks runs, in its order:
    render_bwd.cu's loop ``blk = blockIdx.x, blockIdx.x + gridDim.x, ...``
    below ``n_blocks``."""
    return [range(b, n_blocks, grid) for b in range(grid)]


@pytest.mark.parametrize("n_blocks", [1, 7, 528, 16384])
@pytest.mark.parametrize("resident", [1, 264, 528, 660, 1 << 20])
def test_persistent_grid_visits_every_ray_block_once(n_blocks, resident):
    grid = bk.scratch_slots(n_blocks, resident)
    assert 1 <= grid <= n_blocks and grid <= resident
    walks = _block_walk(n_blocks, grid)
    assert len(walks) == grid
    seen = sorted(b for walk in walks for b in walk)
    assert seen == list(range(n_blocks))
    # Every block of a walk is its slot's: blk % grid == slot.
    assert all(b % grid == slot for slot, walk in enumerate(walks)
               for b in walk)
    # The trips differ by at most one between blocks.
    trips = [len(w) for w in walks]
    assert max(trips) - min(trips) <= 1
    assert bk.scratch_shape(grid, 32) == (grid, 33, 3, 128)
    assert bk.scratch_shape(grid, 32, two_level=True) == (grid, 4, 3, 128)


def test_1080p_scratch_is_slots_not_frames():
    """At 1080p, 32 steps, f32 (16,200 rows): 660 resident blocks (132 SMs
    at 5 an SM) take 50,688 B a slot, 33.5 MB, against the frame's
    history of 821 MB."""
    rays7 = torch.empty((7, 16200, 128))
    grid = bk.scratch_slots(16200, 132 * 5)
    assert grid == 660
    slot = torch.empty(bk.scratch_shape(1, 32)[1:])
    assert slot.numel() * slot.element_size() == 50688
    assert grid * 50688 == 33454080
    assert rk.hist_bytes(rays7, 32) == 821145600


def test_cli_grid_dtype_matches_jax(tmp_path):
    args = ["render", "--fast", "--width", "48", "--height", "32", "--steps",
            "12", "--mode", "normal", "--grid-dtype", "float64"]
    jcli.main(args + ["--cpu", "-o", str(tmp_path / "jax.png")])
    tcli.main(args + ["--device", "cpu", "-o", str(tmp_path / "port.png")])
    want = jcli._read_png(tmp_path / "jax.png")
    np.testing.assert_array_equal(tcli._read_png(tmp_path / "port.png"),
                                  want)
    # The flag reaches all three renderers.
    parser = argparse.ArgumentParser()
    tcli._add_render_args(parser)
    parser.add_argument("--strip-height", type=int, default=None)
    for fast, strip, cls in ((True, None, FastRenderer),
                             (False, None, Renderer),
                             (False, 4, TiledRenderer)):
        ns = parser.parse_args(
            ["--device", "cpu", "--width", "16", "--height", "8",
             "--grid-dtype", "float64", *(["--fast"] if fast else []),
             *(["--strip-height", str(strip)] if strip else [])])
        r = tcli._build_renderer(ns, fast=fast)
        assert isinstance(r, cls)
        assert np.dtype(r.grid_dtype) == np.float64
