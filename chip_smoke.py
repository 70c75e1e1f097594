#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``ray_marching_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out DIR]

It builds the CUDA kernel for each scene it uses (nvcc, all builds started
together), holds the kernel against its plain PyTorch version on the card,
drives the main path (``FastRenderer.render``, test_scene2, 1920×1080,
32 steps, mode 0, degree 2) through the kernel, checks the output, times
kernel, plain version and frame with CUDA events, and prints:

- the card's name and power limit, the torch/CUDA/nvcc versions and the
  ``-Xptxas -v`` report of each build;
- one JSON line ``{"kernels": [...]}`` (times, launches, bound);
- as the last line, ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero before that line.
Without a CUDA device it exits non-zero and prints no result. PNGs go to
``--out`` (default ``chiprun_out/chip_smoke``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PX = 3.45e-6
BENCH_Q = [[0.0, 0.0, 1.0, 0.0]]
BENCH_T = [[0.0, 0.2, 2.5]]
STEPS = 32
#: Card peaks for the bound (NVIDIA H100 SXM data sheet): f32 outside the
#: tensor cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: Kernel vs plain version, on rays whose plain terminal |d| < CONVERGED.
#: f32: positions and d within 1e-4, normals 1e-3, Laplacian 1e-2 (it is
#: (d - mean4)·6/eps², 2400× the SDF's rounding), at most 0.1 % of the
#: converged rays outside. f64: 1e-9 on every plane, no ray outside.
CONVERGED = 1e-3
TOL_F32 = (1e-4, 1e-4, 1e-4, 1e-4, 1e-3, 1e-3, 1e-3, 1e-2)
MAX_SHARE_OUT_F32 = 1e-3
TOL_F64 = 1e-9
PLANES = ("x", "y", "z", "d", "nx", "ny", "nz", "lap")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def config(width, height, **kw):
    from ray_marching_tpu_torch.render.pipeline import RenderConfig

    return RenderConfig(px_width=width, px_height=height,
                        focal_length=PX * height, sensor_width=PX * width,
                        sensor_height=PX * height, marching_steps=STEPS, **kw)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return out


def main_rays(renderer, q, t):
    """The (7, rows, 128) ray planes and flat params the main path hands the
    kernel."""
    import torch

    from ray_marching_tpu_torch.ops.params import split_params_padded

    q, t = renderer._pose(q, t)
    origin, dirs = renderer._pose_planes(q, t)
    rays7 = torch.stack(list(origin) + list(dirs) + [renderer._valid], 0)
    flat, _ = split_params_padded(renderer.init_params, renderer.dtype,
                                  renderer.device)
    return flat, rays7


def compare(label, program, flat, rays7, tau, f64):
    """Kernel vs plain version on the same card inputs; returns the max abs
    difference over converged rays."""
    import torch

    from ray_marching_tpu_torch.ops import render_kernel as rk

    got = rk.fused_march_normals(program, flat, rays7, STEPS, tau, 5e-2)
    want = rk.reference_march_normals(program, flat, rays7, STEPS, tau, 5e-2)
    torch.cuda.synchronize()
    conv = (rays7[6] > 0.5) & (want[3].abs() < CONVERGED)
    n_conv = int(conv.sum())
    check(n_conv > 0, f"{label}: no converged rays")
    diffs, outside = [], torch.zeros_like(conv)
    for i, name in enumerate(PLANES):
        diff = (got[i] - want[i]).abs()
        nan_mismatch = torch.isnan(got[i]) != torch.isnan(want[i])
        diff = torch.where(torch.isnan(got[i]) & torch.isnan(want[i]),
                           torch.zeros_like(diff), diff)
        bad = nan_mismatch | (diff > (TOL_F64 if f64 else TOL_F32[i]))
        outside |= bad & conv
        diffs.append(float(torch.where(conv, diff, 0.0).max()))
    share = int(outside.sum()) / n_conv
    exact = float(((got == want) | (torch.isnan(got) & torch.isnan(want)))
                  .all(0)[rays7[6] > 0.5].float().mean())
    print(f"compare {label}: converged rays {n_conv}, share outside "
          f"tolerance {share:.3e}, bitwise-equal share of valid rays "
          f"{exact:.6f}, max abs diff per plane "
          + " ".join(f"{n}={d:.3e}" for n, d in zip(PLANES, diffs)))
    check(share <= (0.0 if f64 else MAX_SHARE_OUT_F32),
          f"{label}: {share:.3e} of converged rays outside tolerance")
    return max(diffs)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_frames(fn, frame_ms, frames=5):
    """torch.profiler over ``frames`` calls: device time of each kernel, and
    the device busy share of ``frame_ms`` (a frame timed without the
    profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / frames
    if busy_ms == 0.0:
        print("profile: no device time recorded (busy share not measured)")
        return None
    print(f"profile ({frames} frames): kernels busy {busy_ms:.4f} ms per "
          f"frame, {busy_ms / frame_ms:.3f} of the {frame_ms:.4f} ms frame")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / frames:9.4f} ms/frame "
              f"{e.count // frames:4d}x/frame  {e.key[:100]}")
    return {e.key: e.self_device_time_total / 1e3 / frames for e in kernels}


def run(out_dir: Path):
    import torch

    from ray_marching_tpu_torch.io.image import write_png
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.shaders import MODES
    from ray_marching_tpu_torch.scene import registry
    from ray_marching_tpu_torch.scene.codegen import SdfProgram

    card = card_line()
    print(f"card: {card}")
    nvcc = subprocess.run([rk._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, nvcc: {nvcc[-1] if nvcc else '?'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. Build every kernel of the run, all nvcc processes together.
    scenes = ("test_scene2", "test_scene")
    programs = {s: SdfProgram(registry.make_scene(s)) for s in scenes}
    t0 = time.perf_counter()
    rk.build_kernels(programs.values())
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(programs)} "
          "scene libraries")
    for s, p in programs.items():
        key = rk.kernel_key(p)
        print(f"ptxas report ({s}, {key}):")
        print(rk.BUILD_LOG.get(key, "(built before this run)").strip())

    # 2. Kernel vs plain version on the card.
    cfg = config(1920, 1080)
    main = FastRenderer(registry.make_scene("test_scene2"), cfg,
                        dtype=torch.float32)
    max_err = None
    for s in scenes:
        r = main if s == "test_scene2" else FastRenderer(
            registry.make_scene(s), cfg, dtype=torch.float32)
        flat, rays7 = main_rays(r, BENCH_Q, BENCH_T)
        for tau in (0.0, 1e-3):
            err = compare(f"f32 1080p {s} tau={tau:g}", r.program, flat,
                          rays7, tau, f64=False)
            if s == "test_scene2" and tau == 0.0:
                max_err = err
        del r, flat, rays7
    for s in scenes:
        r = FastRenderer(registry.make_scene(s), config(256, 192),
                         dtype=torch.float64, grid_dtype=np.float64)
        flat, rays7 = main_rays(r, BENCH_Q, BENCH_T)
        for tau in (0.0, 1e-3):
            compare(f"f64 256x192 {s} tau={tau:g}", r.program, flat, rays7,
                    tau, f64=True)

    # 3. The main path, counted: 3 poses of mode 0, then all 8 modes.
    poses = [
        (BENCH_Q, BENCH_T),
        ([[0.9914449, 0.0, 0.1305262, 0.0]], [[0.3, 0.1, -2.4]]),
        ([[0.0, 0.0, 0.9659258, 0.258819]], [[-0.4, 0.5, 2.2]]),
    ]
    rk.LAUNCHES = 0
    frames = [main.render(main.init_params, q, t, mode=0, degree=2)
              for q, t in poses]
    all_modes = main.render_all_modes(main.init_params, *poses[0], degree=2)
    torch.cuda.synchronize()
    launches = rk.LAUNCHES
    n_frames = len(frames) + 1
    print(f"main path: {n_frames} marches ({len(frames)} mode-0 frames + "
          f"render_all_modes), kernel launches {launches}")
    check(launches == n_frames, f"kernel launched {launches} times for "
                                f"{n_frames} marches")
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(frames):
        check(tuple(img.shape) == (1, cfg.px_height, cfg.px_width, 3),
              f"frame {i}: shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"frame {i}: non-finite")
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
              f"frame {i}: lambertian outside [0, 1]")
        write_png(out_dir / f"test_scene2_mode0_pose{i}.png", img)
    for name, img in all_modes.items():
        nan_share = float(torch.isnan(img).float().mean())
        print(f"mode {name}: NaN share {nan_share:.3e}")
        # Proximity is 0/0 by the reference's formula when every ray of
        # the closed room converges; every other mode is finite there.
        if name != "proximity":
            check(nan_share == 0.0, f"mode {name}: NaN pixels")
        write_png(out_dir / f"test_scene2_{name}.png", img)

    # 4. End to end against the golden reference images (f64, 96×64).
    golden = np.load(Path(__file__).resolve().parent / "tests" / "golden"
                     / "scene2_room.npz")
    gr = FastRenderer(registry.make_scene(str(golden["meta_scene"])),
                      config(int(golden["meta_width"]),
                             int(golden["meta_height"])),
                      dtype=torch.float64, grid_dtype=np.float64)
    images = gr.render_all_modes(gr.init_params,
                                 golden["meta_orientation"][None],
                                 golden["meta_translation"][None],
                                 degree=int(golden["meta_degree"]))
    for m, name in enumerate(MODES):
        got = images[name].cpu().numpy()
        want = golden[f"image_{m}"]
        mask = np.broadcast_to(golden["stable_mask"], want.shape)
        # rtol 1e-6: the card's log/pow/atan2 may differ from the CPU
        # libm that produced the golden by an ulp.
        np.testing.assert_allclose(got[mask], want[mask], rtol=1e-6,
                                   atol=1e-9, equal_nan=True,
                                   err_msg=f"golden scene2_room mode {name}")
    print("golden scene2_room (96x64, f64, 8 modes, on the card): ok")

    # 5. Timing at the main path's shapes.
    flat, rays7 = main_rays(main, BENCH_Q, BENCH_T)
    prog = main.program
    ms = cuda_ms(lambda: rk.fused_march_normals(prog, flat, rays7, STEPS,
                                                0.0, 5e-2), 50)
    plain_ms = cuda_ms(lambda: rk.reference_march_normals(
        prog, flat, rays7, STEPS, 0.0, 5e-2), 3)
    q, t = poses[0]
    frame_ms = cuda_ms(lambda: main.render(main.init_params, q, t, mode=0,
                                           degree=2), 20)
    tau_ms = cuda_ms(lambda: rk.fused_march_normals(prog, flat, rays7, STEPS,
                                                    1e-3, 5e-2), 50)
    n_valid = int((rays7[6] > 0.5).sum())
    ops = rk.kernel_ops(prog, n_valid, STEPS)
    nbytes = 15 * rays7.shape[1] * rays7.shape[2] * rays7.element_size()
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"timing on {card}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"frame (FastRenderer.render) {frame_ms:.4f} ms; bound: "
          f"{ops} ops ({prog.ops_per_eval} per SDF evaluation) -> "
          f"{t_ops:.4f} ms, {nbytes} bytes -> {t_bytes:.4f} ms; kernel at "
          f"tau=1e-3 {tau_ms:.4f} ms")
    prof = profile_frames(lambda: main.render(main.init_params, q, t,
                                              mode=0, degree=2), frame_ms)
    kernel_dev_ms = next((v for k, v in (prof or {}).items()
                          if k.startswith("void render_fwd_kernel<float>")),
                         None)
    kernels = {"kernels": [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "ray_marching_tpu_torch/ops/csrc/render_fwd.cu",
        "replaces": "ray_marching_tpu/ops/pallas_render.py:227",
        "launches": launches,
        "launches_per_frame": launches / n_frames,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "frame_ms": frame_ms,
        "ms_tau_1e-3": tau_ms,
        "profiler_kernel_ms": kernel_dev_ms,
        "card": card,
    }]}
    print(card)
    print(json.dumps(kernels))
    return {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out/chip_smoke",
                        help="directory for the rendered PNGs")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    result = run(Path(args.out))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
