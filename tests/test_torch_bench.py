"""The port's benchmark (``ray_marching_tpu_torch/bench.py``) and ``cli
bench`` against the JAX package's root ``bench.py``, on the CPU.

The root ``bench.py`` is loaded by path, as ``ray_marching_tpu/cli.py``
``cmd_bench`` loads it. Each case sets the same ``BENCH_*`` environment for
both sides.

Tolerances: on the modular route (BENCH_FAST=0, remat) at 16×12 in f64 the
loss agrees to rtol 1e-9 and every parameter's gradient to rtol 1e-7, atol
1e-9, as tests/test_torch_pipeline.py holds the modular ``Renderer``'s
images and gradients to JAX's (both run the same IEEE op sequence; the
pixel sums are taken in another order). Every ray of the closed room
converges at this pose, so no pixel is left out.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu_torch import bench
from ray_marching_tpu_torch import cli
from ray_marching_tpu_torch.scene import graph as tgraph

ROOT = Path(__file__).resolve().parent.parent
ENV = ("BENCH_BACKWARD", "BENCH_FAST", "BENCH_PALLAS")

#: name -> (environment, use_pallas): the five routes of ``cli bench``'s
#: flags (default, --no-fast, --backward unroll, --backward implicit,
#: --pallas).
ROUTES = {
    "default": ({}, False),
    "no_fast": ({"BENCH_FAST": "0"}, False),
    "unroll": ({"BENCH_BACKWARD": "unroll"}, False),
    "implicit": ({"BENCH_BACKWARD": "implicit"}, False),
    "pallas": ({"BENCH_PALLAS": "1"}, True),
}


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bench_env(monkeypatch):
    """Clears the BENCH_* variables for the test and restores them after
    (also those a command under test sets); returns a setter."""
    for k in ENV:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)

    def set_env(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)

    return set_env


@pytest.mark.parametrize("route", ROUTES)
def test_build_step_picks_the_jax_route(jbench, bench_env, route):
    env, use_pallas = ROUTES[route]
    bench_env(env)
    jr, _ = jbench.build_step(16, 12, use_pallas=use_pallas)
    tr, _ = bench.build_step(16, 12, use_pallas=use_pallas, device="cpu")
    assert type(tr).__name__ == type(jr).__name__
    for field in ("remat", "backward", "use_pallas", "marching_steps",
                  "px_width", "px_height", "focal_length", "sensor_width",
                  "sensor_height"):
        assert getattr(tr.config, field) == getattr(jr.config, field), field
    want = {"default": "FastRenderer"}.get(route, "Renderer")
    assert type(tr).__name__ == want


def test_modular_step_matches_jax(jbench, bench_env):
    """Loss and every parameter gradient of the step on the route JAX runs
    without interpreted Pallas (BENCH_FAST=0: the modular ``Renderer``,
    remat), 16×12, f64."""
    bench_env({"BENCH_FAST": "0"})
    jr, jstep = jbench.build_step(16, 12, dtype_name="float64")
    jloss, jgrads = jstep(jr.init_params)
    want = {k: np.asarray(v) for k, v in jgraph.param_paths(jgrads).items()}

    tr, tstep = bench.build_step(16, 12, dtype_name="float64", device="cpu")
    assert tr.config.remat and type(tr).__name__ == "Renderer"
    params = tr.init_params
    for k, v in jgraph.param_paths(jr.init_params).items():
        np.testing.assert_array_equal(
            tgraph.param_paths(params)[k].numpy(), np.asarray(v), err_msg=k)
    loss, grads = tstep(params)
    got = {k: v.numpy() for k, v in tgraph.param_paths(grads).items()}
    assert loss.dtype == torch.float64 and loss.ndim == 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-9)
    assert set(got) == set(want)
    assert any(np.abs(v).max() > 1e-6 for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-9,
                                   err_msg=k)
    # The step's parameters are its inputs, untouched.
    assert not any(v.requires_grad for v in tgraph.param_paths(params)
                   .values())


def test_measure_on_the_cpu(bench_env):
    bench_env({"BENCH_FAST": "0"})
    rays = bench.measure(16, 12, iters=2, device="cpu")
    assert np.isfinite(rays) and rays > 0
    r, _ = bench.build_step(16, 12, device="cpu")
    assert bench.time_forward(r, 2) > 0


@pytest.mark.parametrize("state", [
    dict(value=4.2e8, cpu_rays=2.1e5, stage="done"),
    dict(value=4.2e8, cpu_rays=None, stage="CPU leg started"),
    dict(value=None, cpu_rays=None, stage="step built"),
])
@pytest.mark.parametrize("degraded", [False, True])
def test_emit_prints_bench_py_lines(jbench, monkeypatch, capsys, state,
                                    degraded):
    lines = []
    for mod in (jbench, bench):
        monkeypatch.setattr(mod, "_STATE", {**state, "cpu_proc": None})
        monkeypatch.setattr(mod, "_EMITTED", False)
        monkeypatch.setattr(mod, "DEADLINE", 450.0)
        mod.emit(degraded=degraded)
        mod.emit(degraded=degraded)  # at most one line
        out = capsys.readouterr().out.splitlines()
        assert len(out) == 1
        lines.append(json.loads(out[0]))
    want, got = lines
    assert got == want
    assert got["metric"] == "rays_per_sec_fwd_bwd_1080p"
    assert got["unit"] == "rays/s/chip"
    assert ("degraded" in got) == degraded
    if state["value"] and state["cpu_rays"]:
        assert got["vs_baseline"] == round(4.2e8 / (10 * 2.1e5), 3)
    else:
        assert got["vs_baseline"] is None


def test_cli_bench_sets_the_environment_and_calls_main(bench_env,
                                                       monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", lambda: seen.append(
        {k: os.environ.get(k) for k in ENV}))
    cli.main(["bench"])  # no flag sets nothing
    cli.main(["bench", "--backward", "unroll", "--no-fast", "--pallas"])
    assert seen == [dict.fromkeys(ENV),
                    {"BENCH_BACKWARD": "unroll", "BENCH_FAST": "0",
                     "BENCH_PALLAS": "1"}]


def test_main_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_watchdog_finds_its_descendants():
    """The watchdog's process walk sees a child and its grandchild."""
    import subprocess
    import sys

    proc = subprocess.Popen([sys.executable, "-c",
                             "import subprocess, sys, time; "
                             "p = subprocess.Popen(['sleep', '30']); "
                             "print(p.pid, flush=True); time.sleep(30)"],
                            stdout=subprocess.PIPE, text=True)
    try:
        grandchild = int(proc.stdout.readline())
        found = bench._descendants(os.getpid())
        assert proc.pid in found and grandchild in found
    finally:
        for pid in (grandchild, proc.pid):
            os.kill(pid, 9)
        proc.wait()
