"""Benchmark: forward+backward rays/s of the flagship render on the card
(counterpart of the JAX package's root ``bench.py``).

Backward-mode selection via BENCH_BACKWARD, as in ``bench.py``, and the
renderer each setting builds here:

- ``remat`` (default) with BENCH_FAST=1 (default): ``FastRenderer``, its
  fused forward kernel (``ops/csrc/render_fwd.cu``, with the history) and
  its backward kernel (``ops/csrc/render_bwd.cu``);
- ``remat`` with BENCH_FAST=0 (``cli bench --no-fast``): the modular
  ``Renderer`` with ``RenderConfig.remat`` (plain torch, one checkpoint a
  march step);
- ``unroll`` / ``implicit``: the modular ``Renderer`` with that
  ``RenderConfig.backward`` (plain torch, as the JAX bench runs them
  under XLA);
- BENCH_PALLAS=1 (``--pallas``): the modular ``Renderer`` with
  ``use_pallas=True``, its march through the CUDA march kernel
  (``ops/csrc/march.cu``) and that kernel's backward.

Measures the loss ``mean((image - target)**2)`` and its gradients with
respect to the scene parameters (test_scene2, lambertian, 32 march steps,
float32) at 1080p on the CUDA device, then a CPU leg in a subprocess: the
port's plain path at 480×270 (rays/s is per-ray work, so independent of
the resolution to first order). The CPU leg starts after the card's timing:
the port's steps are host-bound (torch's many small kernels around the
CUDA ones), and a leg on the same cores would slow the number it is the
baseline for.

Prints a forward-only JSON line first (informational), then the headline
line LAST, with ``bench.py``'s keys:
  {"metric": "rays_per_sec_fwd_1080p", ...}
  {"metric": "rays_per_sec_fwd_bwd_1080p", "value": <card rays/s>,
   "unit": "rays/s/chip", "vs_baseline": <card / (10 x cpu)>}

Progress goes to stderr, the card's name and power limit first. A watchdog
thread prints the best-available line, marked ``degraded``, kills the CPU
leg and any nvcc build still running, and exits 0 once BENCH_DEADLINE
seconds (default 450) have passed. The kernels' nvcc build cache
(``ops/_build/``) is always on; a cold build takes about a minute of the
warm-up.

    python -m ray_marching_tpu_torch.cli bench [--backward remat|unroll|implicit]
        [--no-fast] [--pallas]

Without a CUDA device :func:`main` raises: it never reports the CPU's
rays/s as the card's. :func:`build_step` and :func:`measure` take
``device="cpu"`` for the plain versions.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.graph import map_params, param_paths

BENCH_STEPS = 32
WARMUP_ITERS = 2
BENCH_Q = [[0.0, 0.0, 1.0, 0.0]]
BENCH_T = [[0.0, 0.2, 2.5]]
DEADLINE = float(os.environ.get("BENCH_DEADLINE", "450"))

_T0 = time.perf_counter()
# Best-so-far result, readable by the watchdog thread at any moment.
_STATE: dict = {"value": None, "cpu_rays": None, "stage": "start"}
_EMIT_LOCK = threading.Lock()
_EMITTED = False


def progress(msg: str) -> None:
    _STATE["stage"] = msg
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def emit(degraded: bool = False) -> None:
    """Print THE one JSON line (at most once, even under the watchdog)."""
    global _EMITTED
    with _EMIT_LOCK:
        if _EMITTED:
            return
        _EMITTED = True
    value = _STATE["value"]
    cpu = _STATE["cpu_rays"]
    vs = round(value / (10.0 * cpu), 3) if (value and cpu) else None
    out = {
        "metric": "rays_per_sec_fwd_bwd_1080p",
        "value": round(value) if value else None,
        "unit": "rays/s/chip",
        "vs_baseline": vs,
    }
    if degraded:
        out["degraded"] = f"deadline {DEADLINE}s hit at stage: {_STATE['stage']}"
    print(json.dumps(out), flush=True)


def _descendants(pid: int) -> list:
    """Every live descendant of process ``pid``, from the parent ids in
    ``/proc/<pid>/stat`` (empty where there is no ``/proc``)."""
    children = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        children.setdefault(int(fields[1]), []).append(int(stat.parent.name))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def _watchdog() -> None:
    """Emit the best-available result and hard-exit if the deadline passes.

    A thread, so it fires while the main thread waits on nvcc or the card.
    Before exiting it kills this process's children (the CPU leg, nvcc and
    the compilers nvcc started), which would outlive it.
    """
    remaining = DEADLINE - (time.perf_counter() - _T0)
    while remaining > 0:
        time.sleep(min(remaining, 5.0))
        remaining = DEADLINE - (time.perf_counter() - _T0)
    progress(f"DEADLINE ({DEADLINE}s) reached — emitting degraded result")
    emit(degraded=True)
    for pid in _descendants(os.getpid()):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    os._exit(0)


def build_step(width, height, dtype_name="float32", use_pallas=False,
               device="cuda"):
    """``(renderer, step)``: ``step(params) -> (loss, grads)``, the loss and
    its gradients (a tree like ``params``) with respect to the scene
    parameters, through the renderer BENCH_BACKWARD / BENCH_FAST /
    ``use_pallas`` select (the module's docstring)."""
    dtype = getattr(torch, dtype_name)
    px = 3.45e-6
    backward = os.environ.get("BENCH_BACKWARD", "remat")
    cfg = RenderConfig(
        px_width=width,
        px_height=height,
        focal_length=px * height,
        sensor_width=px * width,
        sensor_height=px * height,
        marching_steps=BENCH_STEPS,
        use_pallas=use_pallas,
        remat=backward == "remat",
        backward="implicit" if backward == "implicit" else "unroll",
    )
    fast_ok = os.environ.get("BENCH_FAST", "1") == "1" and backward == "remat"
    cls = FastRenderer if fast_ok and not use_pallas else Renderer
    r = cls(registry.make_scene("test_scene2"), cfg, dtype=dtype,
            device=device)
    q, t = r._tensor(BENCH_Q), r._tensor(BENCH_T)
    target = torch.zeros((1, height, width, 3), dtype=dtype, device=r.device)

    def step(params):
        live = map_params(params,
                          lambda v: v.detach().requires_grad_(True))
        leaves = list(param_paths(live).values())
        image = r.render(live, q, t, mode=0, degree=2)
        loss = torch.mean((image - target) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(v): torch.zeros_like(v) if g is None else g
                   for v, g in zip(leaves, grads)}
        return loss.detach(), map_params(live, lambda v: by_leaf[id(v)])

    return r, step


def time_step(step, params, iters):
    """Seconds per step: ``WARMUP_ITERS`` steps (the nvcc build at first
    use among them), then ``iters`` back to back, ended by fetching the last
    loss to the host (``bench.py``'s ``float(loss)``)."""
    for _ in range(WARMUP_ITERS):
        out = step(params)
    float(out[0])
    t0 = time.perf_counter()
    for _ in range(iters - 1):
        step(params)
    float(step(params)[0])
    return (time.perf_counter() - t0) / iters


def measure(width, height, iters, use_pallas=False, device="cuda"):
    r, step = build_step(width, height, use_pallas=use_pallas, device=device)
    dt = time_step(step, r.init_params, iters)
    return (width * height) / dt


def time_forward(r, iters):
    """Seconds per forward-only frame (mode 0, degree 2, no autograd), timed
    as :func:`time_step` times a step."""
    q, t = r._tensor(BENCH_Q), r._tensor(BENCH_T)

    def frame(params):
        with torch.no_grad():
            return (torch.mean(r.render(params, q, t, mode=0, degree=2)),)

    return time_step(frame, r.init_params, iters)


_CPU_CHILD = """
import json, os
os.environ['BENCH_FAST'] = '0'  # the CPU leg runs the port's plain path
from ray_marching_tpu_torch import bench
print(json.dumps({'cpu_rays_per_sec': bench.measure(480, 270, iters=3,
                                                    device='cpu')}))
"""


def start_cpu_baseline() -> subprocess.Popen:
    """Launch the CPU leg (no CUDA device visible to it); collected by
    :func:`collect_cpu_baseline`."""
    return subprocess.Popen(
        [sys.executable, "-c", _CPU_CHILD],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        cwd=Path(__file__).resolve().parent.parent,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def collect_cpu_baseline(proc: subprocess.Popen, budget: float) -> float:
    out, err = proc.communicate(timeout=max(budget, 30.0))
    if proc.returncode != 0:
        raise RuntimeError(f"CPU leg exited {proc.returncode}: {err[-2000:]}")
    line = out.strip().splitlines()[-1]
    return float(json.loads(line)["cpu_rays_per_sec"])


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"{torch.cuda.get_device_name(0)} (nvidia-smi failed: {exc})"


def main():
    global _T0, DEADLINE
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bench: no CUDA device (torch.cuda.is_available() is False); "
            "the benchmark measures the card and does not report the CPU's "
            "rays/s in its place")
    _T0 = time.perf_counter()
    DEADLINE = float(os.environ.get("BENCH_DEADLINE", "450"))
    threading.Thread(target=_watchdog, daemon=True).start()

    from ray_marching_tpu_torch.ops.render_kernel import BUILD_DIR

    progress(f"card: {_card()}")
    progress(f"nvcc build cache at {BUILD_DIR} (always on)")

    use_pallas = os.environ.get("BENCH_PALLAS", "0") == "1"
    width, height = 1920, 1080
    r, step = build_step(width, height, use_pallas=use_pallas)
    progress(f"step built ({type(r).__name__}, remat={r.config.remat}, "
             f"backward={r.config.backward}, use_pallas={use_pallas}); "
             "building kernels + warming up")

    # Warmup (includes the nvcc build) then a short pilot: a provisional
    # number exists from here on, so a watchdog fire mid-run still yields
    # a result.
    pilot_iters = 10
    dt = time_step(step, r.init_params, pilot_iters)
    _STATE["value"] = (width * height) / dt
    progress(
        f"built + pilot ({pilot_iters} iters): "
        f"{_STATE['value'] / 1e6:.1f}M rays/s provisional"
    )

    iters = 100
    dt = time_step(step, r.init_params, iters)
    _STATE["value"] = (width * height) / dt
    progress(f"{iters} iters timed: {_STATE['value'] / 1e6:.1f}M rays/s")

    # Forward-only leg (informational second metric; printed BEFORE the
    # headline line, which is the last). Skipped when the deadline's
    # remaining budget is short.
    if DEADLINE - (time.perf_counter() - _T0) > 120.0:
        try:
            fdt = time_forward(r, 100)
            fwd_rays = (width * height) / fdt
            progress(f"forward-only: {fwd_rays / 1e6:.1f}M rays/s")
            print(
                json.dumps(
                    {
                        "metric": "rays_per_sec_fwd_1080p",
                        "value": round(fwd_rays),
                        "unit": "rays/s/chip",
                    }
                ),
                flush=True,
            )
        except Exception as exc:  # informational only — never sink the run
            progress(f"forward-only leg failed: {exc}")
    del r, step

    cpu_proc = start_cpu_baseline()
    progress("CPU leg started (subprocess, after the card's timing)")
    try:
        budget = DEADLINE - (time.perf_counter() - _T0) - 15.0
        _STATE["cpu_rays"] = collect_cpu_baseline(cpu_proc, budget)
        progress(f"CPU leg done: {_STATE['cpu_rays']} rays/s")
    except Exception as exc:  # CPU leg must never sink the benchmark
        progress(f"cpu baseline failed: {exc}")
        cpu_proc.kill()
        cpu_proc.wait()
    emit()


if __name__ == "__main__":
    main()
