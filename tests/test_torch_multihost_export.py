"""The port's multi-process helpers (``parallel/multihost.py``) and the
sharded train-step artifact (``io/export.py`` ``export_train_step`` /
``load_train_step``) on the CPU, over gloo groups of child ranks, against
the JAX package's artifact format (tests/test_export_multichip.py reads the
same meta keys).
"""

import json
import time
import zipfile

import numpy as np
import pytest
import torch.distributed as dist

from ray_marching_tpu_torch.io.export import load_train_step
from ray_marching_tpu_torch.parallel import multihost
from test_torch_ranks import Ranks

# The meta keys of the JAX package's .rmxs (ray_marching_tpu/io/export.py).
JAX_META_KEYS = {"format_version", "kind", "mode", "degree", "mesh_shape",
                 "num_devices", "platforms", "px_width", "px_height", "rows",
                 "marching_steps", "dtype"}
BARRIER_TIMEOUT_S = 3.0

CHILD = """
import functools
import json
import os
from ray_marching_tpu_torch.io.export import export_train_step, load_train_step
from ray_marching_tpu_torch.parallel import fast_sharding as fs
from ray_marching_tpu_torch.parallel import multihost
from ray_marching_tpu_torch.parallel.sharding import make_mesh
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.graph import param_paths

R["host0"] = multihost.is_host0()
multihost.host0_print(f"HOST0_LINE from rank {rank}")
R["mesh_one_node"] = list(multihost.make_global_mesh(device_type="cpu").shape)
os.environ["LOCAL_WORLD_SIZE"] = "1"
R["mesh_nodes"] = list(multihost.make_global_mesh(device_type="cpu").shape)
t0 = time.perf_counter()
multihost.barrier(30)
R["barrier_s"] = time.perf_counter() - t0

mesh = make_mesh((world,), ("rows",), device_type="cpu")
px = 3.45e-6
f = FastRenderer(registry.make_scene("test_scene2"),
                 RenderConfig(px_width=16, px_height=8, focal_length=8 * px,
                              sensor_width=16 * px, sensor_height=8 * px,
                              marching_steps=4),
                 dtype=torch.float64, grid_dtype=np.float64, device="cpu",
                 row_multiple=8 * world)
opt = functools.partial(torch.optim.Adam, lr=0.02, betas=(0.8, 0.99))
path = f"{out}/step{world}.rmxs"
if rank == 0:
    export_train_step(f, mesh, path, optimizer=opt, mode=0, degree=2)
multihost.barrier(30)
step, meta = load_train_step(path, device="cpu")
R["meta"] = json.dumps(meta)
q = torch.tensor([[0.0, 0.0, 1.0, 0.0]], dtype=torch.float64)
t = torch.tensor([[0.0, 0.2, 2.5]], dtype=torch.float64)
target = fs.target_planes(f, mesh, f.render(f.init_params, q, t, mode=0,
                                             degree=2) * 0.9)
direct = fs.fast_train_step(f, mesh, opt, mode=0, degree=2)
for name, fn, params in (("direct", direct, f.init_params),
                         ("loaded", step, step.params)):
    p, st = params, None
    for i in range(2):
        p, st, loss = fn(p, st, target, q, t)
    R[f"{name}_loss"] = loss.item()
    for k, v in param_paths(p).items():
        R[f"{name}/{k}"] = v.numpy()
"""

CHILD_ABSENT_PEER = f"""
if rank == 0:
    t0 = time.perf_counter()
    try:
        multihost.barrier({BARRIER_TIMEOUT_S})
    except TimeoutError as exc:
        R["error"] = str(exc)
    R["waited_s"] = time.perf_counter() - t0
else:
    time.sleep({BARRIER_TIMEOUT_S} + 5)
"""


def _child(body):
    return ("import time\nfrom ray_marching_tpu_torch.parallel import "
            "multihost\n" + body)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    groups = {world: Ranks(tmp / f"world{world}", _child(CHILD), world)
              for world in (1, 2)}
    absent = Ranks(tmp / "absent", _child(CHILD_ABSENT_PEER), 2)
    by_world = {w: g.results() for w, g in groups.items()}
    return by_world, groups[2].wait(), absent.results(), tmp


def test_initialize_without_configuration(monkeypatch):
    """No arguments and no torchrun environment: one process, no group."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized()
    assert multihost.is_host0()


def test_host0_helpers(run):
    by_world, outs, _, _ = run
    assert [bool(r["host0"]) for r in by_world[2]] == [True, False]
    assert "HOST0_LINE from rank 0" in outs[0][1]
    assert "HOST0_LINE" not in outs[1][1]


def test_global_mesh_puts_nodes_outermost(run):
    """One node of two processes: (1, 2); two nodes of one: (2, 1)."""
    by_world, _, _, _ = run
    for r in by_world[2]:
        assert list(r["mesh_one_node"]) == [1, 2]
        assert list(r["mesh_nodes"]) == [2, 1]


def test_barrier_completes(run):
    by_world, _, _, _ = run
    for r in by_world[2]:
        assert float(r["barrier_s"]) < 30


def test_barrier_raises_when_a_peer_never_arrives(run):
    """Rank 1 never calls the barrier: rank 0 gets a TimeoutError naming its
    rank and the world size, within its limit, instead of hanging."""
    _, _, absent, _ = run
    msg = str(absent[0]["error"])
    assert "rank 0 of 2" in msg
    assert BARRIER_TIMEOUT_S <= float(absent[0]["waited_s"]) \
        < BARRIER_TIMEOUT_S + 4


@pytest.mark.parametrize("world", [1, 2])
def test_exported_step_equals_the_direct_step(run, world):
    """Two steps of the loaded step: the direct step's loss and parameters
    bit for bit, on every rank."""
    by_world, _, _, _ = run
    for r in by_world[world]:
        assert np.isfinite(r["direct_loss"])
        assert r["loaded_loss"] == r["direct_loss"]
        keys = [k[7:] for k in r if k.startswith("direct/")]
        assert keys
        for k in keys:
            assert (r[f"loaded/{k}"] == r[f"direct/{k}"]).all(), k


@pytest.mark.parametrize("world", [1, 2])
def test_train_step_meta(run, world):
    """JAX's meta keys, the mesh, and what rebuilds the step."""
    by_world, _, _, tmp = run
    meta = json.loads(str(by_world[world][0]["meta"]))
    assert JAX_META_KEYS <= set(meta)
    assert meta["kind"] == "sharded_train_step"
    assert meta["mesh_shape"] == {"rows": world}
    assert meta["num_devices"] == world
    assert meta["platforms"] == ["cuda"]
    assert (meta["px_width"], meta["px_height"], meta["marching_steps"]) \
        == (16, 8, 4)
    assert meta["rows"] == 8 * world and meta["dtype"] == "float64"
    assert (meta["mode"], meta["degree"]) == (0, 2)
    assert meta["optimizer"] == {"name": "Adam", "kwargs": {
        "lr": 0.02, "betas": [0.8, 0.99]}}
    with zipfile.ZipFile(tmp / f"world{world}" / f"step{world}.rmxs") as zf:
        assert sorted(zf.namelist()) == ["meta.json", "params.npz",
                                         "scene.json"]


def test_load_refuses_another_world_size(run):
    """The two-rank artifact in this process, which has no group."""
    _, _, _, tmp = run
    with pytest.raises(RuntimeError, match="exported for 2 ranks"):
        load_train_step(tmp / "world2" / "step2.rmxs", device="cpu")
    assert not dist.is_initialized()

