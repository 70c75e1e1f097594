#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``ray_marching_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out DIR]

It builds the CUDA kernels (forward, backward and march, one library per
scene it uses; one nvcc process per source, all started together), holds
each kernel against its plain PyTorch version on the card, drives the main
paths through the kernels and counts their launches (serving:
``FastRenderer.render``, test_scene2, 1920×1080, 32 steps, mode 0, degree 2;
training: ``optim.inverse.optimize`` on the same setup, with and without the
silhouette loss, with the implicit backward and with the two-level backward;
the modular pipeline: ``Renderer`` with ``use_pallas=True`` at the same
setup, a frame, a frame with a reflection bounce, all 8 modes and one
gradient; the neural slices: the trained width-256 NeuralSDF served (its
MLP on the tensor cores in the serving forward and the march, held against
the plain version, the per-thread route and a 1xTF32 control), and
trained by ``optimize`` through the backward kernel with the MLP's VJP; the
Mandelbulb slice: the ``mandelbulb`` scene, a custom node lowered through
``codegen.register_lowering``, served by the README's command at 1440×900
and trained on its scale by ``optimize``),
checks the outputs (golden images and golden gradients in f64),
times kernels, plain versions, frames and training step with CUDA events
and the profiler, and prints:

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
import dataclasses
import hashlib
import json
import re
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
#: Dense tensor-core peaks of the H100 SXM (NVIDIA H100 data sheet).
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
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
#: Training outputs of the forward kernel (min_f, arg-min step and position,
#: history, live-step count) against the plain version: both run the same
#: IEEE op sequence, so they are expected equal bit for bit; at most this
#: share of the valid rays may differ (an ulp in a libm call can move a
#: ray's exit step).
MAX_SHARE_DIFF_TRAIN = 1e-3
#: Backward kernel vs plain version, relative to the largest reference
#: entry: the 6 ray-cotangent planes on converged rays and the parameter
#: cotangent. The kernel applies the adjoint rules by hand and the plain
#: version through autograd, an ulp apart per op, carried over 32 steps; the
#: parameter cotangent is summed block-wise (128 rays, then 16,200 blocks)
#: where the plain version sums 2 M terms in torch's order. The valid plane
#: is the main path's own, so every valid ray adds to the parameter
#: cotangent. Only where the plain version's parameter cotangent is itself
#: non-finite (test_scene in f32: non-converged rays overflow, in the kernel
#: and the plain version alike, and in the JAX package too,
#: tests/test_torch_train.py) are the non-converged rays marked invalid.
TOL_BWD = {"f32": 1e-4, "f64": 1e-10}
#: Golden gradients on the card (f64): tests/test_fast_golden.py's rtol 1e-7
#: and atol 1e-9, the rtol loosened to 1e-6 because the card's
#: log/pow/atan2 may differ from the CPU libm behind the golden by an ulp.
GOLDEN_GRAD_RTOL, GOLDEN_GRAD_ATOL = 1e-6, 1e-9
TRAIN_STEPS, SILHOUETTE_STEPS, IMPLICIT_STEPS, TWO_LEVEL_STEPS = 5, 3, 3, 3
#: The modular frame (plain torch normals and shading around the march
#: kernel) against the plane-native frame (everything in the fused kernel)
#: of the same configuration, f32, lambertian in [0, 1], on converged
#: pixels: the two compute the tetrahedral normals with the same formula but
#: torch reduces the (..., 4, 3) offsets and the norms in another order, and
#: the finite difference divides that rounding by eps = 0.05. At most 0.1 %
#: of the converged pixels may differ by more.
MODULAR_VS_FAST_ATOL = 1e-3
#: Where the history stops fitting comfortably: the backward at this step
#: count is timed with the history and with two levels.
LONG_STEPS = 128
#: The neural slice's main configuration: the trained width-256 NeuralSDF
#: of docs/neural_fit_w256 beside the room, its weights from the file, at
#: the demo's own resolution, step count and pose (view 0 of
#: tools/train_neural_demo.py's poses), f32.
ROOT = Path(__file__).resolve().parent
#: sha256 of the generated SDF sources of the scenes without a tensor-core
#: MLP leaf, as the generator wrote them before the tensor-core evaluation
#: existed: their libraries run the same code as before.
PER_THREAD_SOURCES = {
    "test_scene2":
        "01995bdb88b485bee773c22c8a51a6079fd70d4f52d88e5ee44821a37bdee8c1",
    "test_scene":
        "93b989af7cc5b0632446ee26c0a42e1a204cd9e35660b86950dbda5e1219d52f",
    "distillation target":
        "0466ffd3fbef4bd33176bed621273cc3944d97a9954559c47c81f8ee651adff0",
    "mandelbulb":
        "29bf4ad2bce69c7b83c765287b8cd1caa0cfe05a9a181efa06b8a4c74b32c04d",
}
NEURAL_WEIGHTS = ROOT / "docs" / "neural_fit_w256" / "weights.npz"
NEURAL_SCENE_FILE = ROOT / "docs" / "examples" / "neural_demo.json"
NEURAL_RES, NEURAL_F64_RES, NEURAL_STEPS, NEURAL_FRAMES = 512, 128, 24, 20
NEURAL_Q, NEURAL_T = [[0.0, 0.0, 1.0, 0.0]], [[0.0, 0.2, 2.2]]
#: bf16 operands (matmul_dtype='bfloat16') against the plain bf16 version,
#: f32 128×128. Both round the same operands to bf16, but their f32 sums run
#: in other orders; where that moves a hidden value across a bf16 rounding
#: boundary, the operand jumps by one bf16 ulp (2^-8 relative), which moves
#: d by up to ~1e-4 and the Laplacian (2400× d's error) by ~0.3. Positions
#: and d within 1e-3, normals 1e-2, Laplacian 1.0; at most 1 % of the
#: converged rays outside.
TOL_BF16 = (1e-3, 1e-3, 1e-3, 1e-3, 1e-2, 1e-2, 1e-2, 1.0)
#: The tensor-core forward is held to TOL_F32 and, at tau = 0, to a tenth of
#: it as well, which it meets on every converged ray while its 1xTF32
#: control (the weights' lo zeroed) misses it on 3.9e-2 of them: TOL_F32
#: alone lets the control through (5 of 256,456 rays outside on an NVIDIA
#: H100 80GB HBM3, 700.00 W).
TOL_F32_TC = tuple(t / 10 for t in TOL_F32)
MAX_SHARE_OUT_BF16 = 1e-2
#: The neural frame against the analytic target the field was distilled to
#: (tools/train_neural_demo.py), mode 0 at the demo's pose: thresholds fixed
#: by tests/test_torch_neural.py's CPU run at 64×64 (0.999 of the pixels
#: agree on hitting the object there, mean difference 0.0049; with the
#: hidden matrix transposed 0.900 and 0.102). An object hit: the ray ends
#: within OBJECT_RADIUS of the origin (the room's walls are 4.9 away).
TARGET_MIN_AGREE, TARGET_MAX_MEAN_DIFF, OBJECT_RADIUS = 0.99, 0.02, 1.5
#: The neural training path: optimize() on the seven leaves of the w256
#: NeuralSDF (c1/w0..w2, c1/b0..b2, c1/radius), Adam, at the main neural
#: configuration, against the analytic target's frame.
NEURAL_TRAIN_STEPS, NEURAL_TRAINABLE = 3, ["c1/"]
#: Neural backward kernel vs plain version (same history), relative to the
#: largest reference entry of each output: the ray cotangents on converged
#: rays, the flat parameter cotangent and every matrix cotangent. The kernel
#: sums W·δ and a ⊗ δ in its own order (per block, then over 2048 blocks)
#: where torch.matmul sums 262,144 rays at once, and the MLP's forward
#: rounding (up to 6.4e-6 on normals, PERF.md) enters every step's
#: cotangent. On the card the largest is 5.8e-5 (rays, f32; PERF.md).
TOL_NEURAL_BWD = {"f32": 1e-3, "f64": 1e-9}
#: tau = 1e-3 and min_f routing at 128² f32: an exit step or a min_f tie can
#: flip between kernel and plain version on an ulp of the MLP, which moves
#: that ray's cotangent and its share of every parameter's.
TOL_NEURAL_BWD_LOOSE = 1e-2
#: bf16 operands at 128² f32, against the plain version, which follows the
#: kernel's rounding rule (the cotangent of a product's input rounded to
#: bf16, a matrix's cotangent summed in f32; scene/neural.py). Both round
#: each ray's input
#: cotangents after sums in other orders, so one near a rounding boundary
#: lands one bf16 ulp (2^-8) apart and the sweep carries it on: the largest
#: ray difference says little (1.2e-2 of the largest entry on the card).
#: The limits (share of converged rays within BF16_RAY_RTOL of their own
#: size, flat, matrices) sit between the kernel's readings on the card
#: (0.972, 3.3e-5, 4.8e-4) and a control's without any cotangent rounding,
#: which must fail them (0.759, 0.50, 0.37; PERF.md).
BF16_RAY_RTOL = 1e-4
TOL_NEURAL_BWD_BF16 = (0.9, 1e-3, 1e-2)


#: A profile may read a kernel at most this far below its CUDA-event time
#: (profile_frames).
PROFILE_MAX_UNDER = 0.05
#: The spin that kernel_ms queues its launches behind: about 10 ms at the
#: H100's 1.98 GHz boost clock, longer than the host takes to queue a
#: timing loop's calls.
SPIN_CYCLES = 20_000_000
#: The Mandelbulb slice: the registry's ``mandelbulb`` scene (the room and
#: Affine(Mandelbulb(power=8, iterations=10, scale=1.0)) about 45° about y),
#: f32, the CLI's default pose and 1440×900, served by the README's command
#: (64 steps, tau = 1e-4, mode normal); trained on its scale leaf from 0.85
#: against the frame at 1.0, mode 0, degree 2, Adam at 1e-2 (the JAX
#: package's test_mandelbulb_scale_trains_by_inverse_rendering at full
#: size). f64 checks at 256×160.
BULB_CLI = ["render", "--scene", "mandelbulb", "--fast", "--steps", "64",
            "--tau", "1e-4", "--mode", "normal"]
BULB_W, BULB_H, BULB_STEPS, BULB_TAU, BULB_MODE = 1440, 900, 64, 1e-4, 4
BULB_F64_W, BULB_F64_H = 256, 160
BULB_FRAMES, BULB_TRAIN_STEPS, BULB_SCALE0 = 20, 3, 0.85
#: Training marches 24 steps at tau = 0, the JAX test's own step count, so
#: the two-level backward engages. At 64 the gradient is unusable in f32:
#: the march's derivative grows with every step a ray takes near the
#: fractal's surface, where the estimate's slope along the ray exceeds 1,
#: so at tau = 0 it overflows (in the kernel and the plain version alike,
#: bulb_slice prints both), and at tau = 1e-4 a few grazing rays still
#: dominate it.
BULB_TRAIN_MARCH = 24
#: Kernel vs plain version over the whole frame: at least this share of the
#: valid rays must agree on every plane within TOL_F32 (the grazing rays of
#: a chaotic boundary may diverge between two evaluation orders; CLAUDE.md),
#: and the same kernel with the scale moved by BULB_CONTROL_SCALE must not.
BULB_MIN_AGREE, BULB_CONTROL_SCALE = 0.999, 1.0 + 1e-3
#: The bulb's backward against its plain version, ray by ray and leaf by
#: leaf (bulb_backward_vs_plain). A few grazing rays' cotangents grow with
#: every step they take near the fractal's surface (to ~1e24 at 64 steps in
#: f32), so a limit relative to the largest entry of the frame holds only
#: those rays. Instead, each converged ray's 6 cotangents are held against
#: the ray's own largest: at least BULB_RAY_SHARE of the converged rays
#: within BULB_RAY_RTOL (on the card 0.99990 in f32, 0.99988 in f64 at 64
#: steps and tau = 0, all of them elsewhere). The parameter cotangent is
#: summed again over the tame rays only (a cotangent at most BULB_WILD
#: times the median ray's; the others are marked invalid for that run and
#: counted), and each scalar leaf is held against its own size
#: (BULB_LEAF_RTOL). An f32 leaf sums ~1.26 M terms that cancel to a few
#: per cent of their magnitudes, so its rounding depends on the order: the
#: plain version's own history and two-level sums differ by 5.5e-4 on the
#: bulb's scale at 24 steps (the kernel, bitwise the same in both modes, is
#: 5.6e-4 from the first and 5.6e-6 from the second); f64 reads at most
#: 1.2e-10.
#: Two controls against the same plain version must fail the limits: the
#: kernel at scale·BULB_CONTROL_SCALE, and the kernel given each input
#: cotangent times 1 + u·BULB_CONTROL_G, u uniform in [-1, 1] (a kernel
#: wrong by up to 1e-3 on every ray: 0.04–0.06 of the rays within in f32,
#: leaves 4.7e-3 and more apart).
BULB_RAY_RTOL = {"f32": 1e-4, "f64": 1e-10}
BULB_RAY_SHARE = 0.999
BULB_LEAF_RTOL = {"f32": 2e-3, "f64": 1e-9}
BULB_WILD = 1e3
BULB_CONTROL_G = 1e-3


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
    flat, _, _ = split_params_padded(renderer.init_params, renderer.dtype,
                                  renderer.device)
    return flat, rays7


def modular_rays(renderer, q, t):
    """The (7, rows, 128) ray planes and flat params that ``Renderer._march``
    hands the march kernel: the camera's posed rays in ``kernel_march``'s own
    layout, padded to whole rows only."""
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops.params import split_params_padded

    _, _, ray_pos, ray_dirs = renderer.camera.pose(renderer._tensor(q),
                                                   renderer._tensor(t))
    flat, _, _ = split_params_padded(renderer.init_params, renderer.dtype,
                                  renderer.device)
    return flat, mk.rays_to_planes(ray_pos, ray_dirs).contiguous()


def compare(label, program, flat, rays7, tau, f64, steps=STEPS, mats=(),
            tol=TOL_F32, max_share=MAX_SHARE_OUT_F32, route=None,
            tc_mats=None, must_fail=False):
    """Kernel vs plain version on the same card inputs; returns the max abs
    difference over converged rays. ``tol`` and ``max_share`` are the f32
    tolerances per plane and the share of converged rays allowed outside
    them (f64: TOL_F64 on every plane, no ray outside). The kernel is
    ``fused_march_normals``'s, or with ``route`` / ``tc_mats`` the one
    ``render_kernel.march_forward`` launches with them. ``must_fail``: a
    control, which must leave more than ``max_share`` outside."""
    import torch

    from ray_marching_tpu_torch.ops import render_kernel as rk

    if route is None and tc_mats is None:
        got = rk.fused_march_normals(program, flat, rays7, steps, tau, 5e-2,
                                     mats=mats)
    else:
        got = rk.march_forward(program, flat, rays7, steps, tau, 5e-2,
                               mats=mats, route=route, tc_mats=tc_mats)[0]
    want = rk.reference_march_normals(program, flat, rays7, steps, tau, 5e-2,
                                      mats=mats)
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
        bad = nan_mismatch | (diff > (TOL_F64 if f64 else tol[i]))
        outside |= bad & conv
        diffs.append(float(torch.where(conv, diff, 0.0).max()))
    share = int(outside.sum()) / n_conv
    exact = float(((got == want) | (torch.isnan(got) & torch.isnan(want)))
                  .all(0)[rays7[6] > 0.5].float().mean())
    print(f"compare {label}: converged rays {n_conv}, share outside "
          f"tolerance {share:.3e}, bitwise-equal share of valid rays "
          f"{exact:.6f}, max abs diff per plane "
          + " ".join(f"{n}={d:.3e}" for n, d in zip(PLANES, diffs)))
    limit = 0.0 if f64 else max_share
    if must_fail:
        check(share > limit, f"{label}: the control is within tolerance")
    else:
        check(share <= limit,
              f"{label}: {share:.3e} of converged rays outside tolerance")
    return max(diffs)


def same_bits(a, b):
    import torch

    if a.dtype.is_floating_point:
        return (a == b) | (torch.isnan(a) & torch.isnan(b))
    return a == b


def compare_training_outputs(label, program, flat, rays7, tau, steps=STEPS):
    """The forward kernel's training configuration on the card: its 8
    planes bitwise equal to the serving configuration's, its extra outputs
    against the plain version. Returns the plain version's 9 planes."""
    import torch

    from ray_marching_tpu_torch.ops import render_kernel as rk

    serve, _ = rk.march_forward(program, flat, rays7, steps, tau, 5e-2)
    out, ex = rk.march_forward(program, flat, rays7, steps, tau, 5e-2,
                               track_min=True, log_hist=True,
                               track_argpos=True)
    ref, rex = rk._reference_march(program, flat, rays7, steps, tau, 5e-2,
                                   track_min=True, log_hist=True,
                                   track_argpos=True)
    torch.cuda.synchronize()
    check(bool(same_bits(out[:8], serve).all()),
          f"{label}: training configuration changes the 8 serving planes")
    valid = rays7[6] > 0.5
    n_valid = int(valid.sum())
    # History entries a ray did not run stay unwritten in the kernel.
    steps_idx = torch.arange(steps + 1, device=rays7.device)[:, None, None]
    ran = (steps_idx <= ex["nlive"][None]) | (steps_idx == steps)
    diffs = {
        "min_f": ~same_bits(out[8], ref[8]),
        "amin": ~same_bits(ex["amin"], rex["amin"]),
        "argpos": ~same_bits(ex["argpos"], rex["argpos"]).all(0),
        "nlive": ~same_bits(ex["nlive"], rex["nlive"]),
        "hist": (~same_bits(ex["hist"], rex["hist"]).all(1) & ran).any(0),
    }
    shares = {k: int((v & valid).sum()) / n_valid for k, v in diffs.items()}
    mean_live = float(ex["nlive"][valid].float().mean())
    print(f"training outputs {label}: 8 planes bitwise equal to serving; "
          f"share of valid rays that differ from plain: "
          + " ".join(f"{k}={v:.3e}" for k, v in shares.items())
          + f"; mean live steps {mean_live:.3f}")
    for k, v in shares.items():
        check(v <= MAX_SHARE_DIFF_TRAIN, f"{label}: {k} differs on {v:.3e} "
                                         "of the valid rays")
    pad = ~valid
    check(bool((out[8][pad] == torch.finfo(out.dtype).max).all())
          and not bool(ex["nlive"][pad].any()), f"{label}: pad slots")
    return ref


def compare_backward(label, program, flat, rays7, tau, f64, ref, seed,
                     steps=STEPS):
    """Backward kernel vs plain version (same history), and history on vs
    off bitwise, with and without the min_f plane, at the valid plane the
    main path gives the kernel. The ray cotangents are compared on the rays
    that converged by ``ref`` (the plain forward's planes), the parameter
    cotangent whole. Where the plain version's own parameter cotangent is
    non-finite, the comparison is made again with the non-converged rays
    marked invalid. Returns the largest absolute difference of the ray
    cotangents and of the parameter cotangent for the run without min_f."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    conv = (rays7[6] > 0.5) & (ref[3].abs() < CONVERGED)
    check(int(conv.sum()) > 0, f"{label}: no converged rays")
    rng = np.random.default_rng(seed)
    g9 = torch.as_tensor(rng.standard_normal((9,) + tuple(rays7.shape[1:])),
                         dtype=rays7.dtype).to(rays7.device)
    tol = TOL_BWD["f64" if f64 else "f32"]
    for masked in (False, True):
        if masked:
            rays7 = rays7.clone()
            rays7[6] = conv.to(rays7.dtype)
        out, ex = rk.march_forward(program, flat, rays7, steps, tau, 5e-2,
                                   track_min=True, log_hist=True)
        runs = {}
        for track_min in (False, True):
            g = g9 if track_min else g9[:8].contiguous()
            handoff = dict(hist=ex["hist"], nlive=ex["nlive"])
            if track_min:
                handoff.update(minf=out[8].contiguous(), amin=ex["amin"])
            # (flat, rays) cotangents: an analytic scene has no matrices.
            runs[track_min] = tuple(r[::2] for r in (
                bk.fused_backward(program, flat, rays7, g, steps, tau, 5e-2,
                                  track_min=track_min, **handoff),
                bk.fused_backward(program, flat, rays7, g, steps, tau, 5e-2,
                                  track_min=track_min),
                bk.reference_backward(program, flat, rays7, g, steps, tau,
                                      5e-2, track_min=track_min, **handoff)))
        torch.cuda.synchronize()
        if masked or all(bool(torch.isfinite(plain[0]).all())
                         for _, _, plain in runs.values()):
            break
        print(f"backward {label}: with every valid ray the plain version's "
              "parameter cotangent is non-finite (kernel's finite: "
              f"{bool(torch.isfinite(runs[False][0][0]).all())}); comparing "
              "with the non-converged rays marked invalid")
    which = "converged rays only" if masked else "every valid ray"
    errs = None
    for track_min, (with_hist, recomputed, plain) in runs.items():
        bitwise = all(bool(same_bits(a, b).all())
                      for a, b in zip(with_hist, recomputed))
        check(bitwise, f"{label} min_f={track_min}: history on and off give "
                       "different bits")
        e_flat = float((with_hist[0] - plain[0]).abs().max())
        s_flat = float(plain[0].abs().max())
        e_rays = float((with_hist[1] - plain[1])[:, conv].abs().max())
        s_rays = float(plain[1][:, conv].abs().max())
        print(f"backward {label} min_f={track_min} ({which}): history "
              f"on/off bitwise equal; vs plain: ray cotangents max abs diff "
              f"{e_rays:.3e} of {s_rays:.3e}, parameter cotangent "
              f"{e_flat:.3e} of {s_flat:.3e} (tolerance {tol:g} relative)")
        check(torch.isfinite(with_hist[0]).all()
              and torch.isfinite(with_hist[1][:, conv]).all(),
              f"{label} min_f={track_min}: non-finite cotangents")
        check(e_rays <= tol * s_rays and e_flat <= tol * s_flat,
              f"{label} min_f={track_min}: kernel and plain disagree")
        check(not bool(with_hist[1][:, rays7[6] < 0.5].any()),
              f"{label}: pad slots got a cotangent")
        if not track_min:
            errs = (e_rays, e_flat)
    return errs, masked


def compare_march(label, program, flat, rays7, tau, f64, backward,
                  steps=STEPS, mats=()):
    """March kernel vs plain version (tolerances of planes 0-3 of the fused
    kernel, expected bitwise) and vs planes 0-3 of the fused kernel (bitwise,
    required: one march loop, two kernels). With ``backward`` also its
    backward, the backward kernel's march-only mode, vs the plain version.
    Returns the largest absolute difference on converged rays, and the
    backward's (ray cotangents, parameter cotangent) or None."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    got = mk.march_planes(program, flat, rays7, steps, tau, mats)
    want = mk.reference_march(program, flat, rays7, steps, tau, mats)
    full = rk.fused_march_normals(program, flat, rays7, steps, tau, 5e-2,
                                  mats=mats)
    torch.cuda.synchronize()
    valid = rays7[6] > 0.5
    conv = valid & (want[3].abs() < CONVERGED)
    n_conv = int(conv.sum())
    check(n_conv > 0, f"march {label}: no converged rays")
    check(bool(same_bits(got, full[:4]).all()),
          f"march {label}: differs from planes 0-3 of the fused kernel")
    diffs, outside = [], torch.zeros_like(conv)
    for i in range(4):
        diff = torch.where(torch.isnan(got[i]) & torch.isnan(want[i]),
                           torch.zeros_like(got[i]), (got[i] - want[i]).abs())
        bad = ((torch.isnan(got[i]) != torch.isnan(want[i]))
               | (diff > (TOL_F64 if f64 else TOL_F32[i])))
        outside |= bad & conv
        diffs.append(float(torch.where(conv, diff, 0.0).max()))
    share = int(outside.sum()) / n_conv
    exact = float(same_bits(got, want).all(0)[valid].float().mean())
    print(f"march {label}: equal to planes 0-3 of the fused kernel bit for "
          f"bit; vs plain: converged rays {n_conv}, share outside tolerance "
          f"{share:.3e}, bitwise-equal share of valid rays {exact:.6f}, max "
          "abs diff per plane "
          + " ".join(f"{n}={d:.3e}" for n, d in zip(PLANES, diffs)))
    check(share <= (0.0 if f64 else MAX_SHARE_OUT_F32),
          f"march {label}: {share:.3e} of converged rays outside tolerance")
    check(not bool(got[3][~valid].any())
          and bool(same_bits(got[:3], rays7[:3])[:, ~valid].all()),
          f"march {label}: pad slots")
    if not backward:
        return max(diffs), None
    rng = np.random.default_rng(900 + int(tau * 1e6) + f64)
    g = torch.as_tensor(rng.standard_normal((4,) + tuple(rays7.shape[1:])),
                        dtype=rays7.dtype).to(rays7.device)
    a = bk.march_backward(program, flat, rays7, g, steps, tau)[::2]
    b = bk.reference_backward(program, flat, rays7, g, steps, tau, None,
                              march_only=True)[::2]
    torch.cuda.synchronize()
    tol = TOL_BWD["f64" if f64 else "f32"]
    e_flat, s_flat = float((a[0] - b[0]).abs().max()), float(b[0].abs().max())
    e_rays = float((a[1] - b[1])[:, conv].abs().max())
    s_rays = float(b[1][:, conv].abs().max())
    print(f"march backward {label} (march-only mode, every valid ray): vs "
          f"plain: ray cotangents max abs diff {e_rays:.3e} of {s_rays:.3e}, "
          f"parameter cotangent {e_flat:.3e} of {s_flat:.3e} (tolerance "
          f"{tol:g} relative)")
    check(bool(torch.isfinite(a[0]).all()),
          f"march backward {label}: non-finite parameter cotangent")
    check(e_rays <= tol * s_rays and e_flat <= tol * s_flat,
          f"march backward {label}: kernel and plain disagree")
    check(not bool(a[1][:, ~valid].any()),
          f"march backward {label}: pad slots got a cotangent")
    return max(diffs), (e_rays, e_flat)


def compare_two_level(label, program, flat, rays7, f64, seed, steps=STEPS):
    """The two-level backward on the card: bitwise equal to the history and
    the full-recompute paths, within TOL_BWD of its plain version (which
    replays segments from checkpoints too); LAST_PATH says which path ran,
    and a configuration where two levels must not engage (tau > 0, or a step
    count that is no multiple of the interval) runs the ordinary path.
    Returns the largest absolute differences (ray cotangents, parameters)."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.standard_normal((8,) + tuple(rays7.shape[1:])),
                        dtype=rays7.dtype).to(rays7.device)
    out, ex = rk.march_forward(program, flat, rays7, steps, 0.0, 5e-2,
                               log_hist=True)
    conv = (rays7[6] > 0.5) & (out[3].abs() < CONVERGED)
    with_hist = bk.fused_backward(program, flat, rays7, g, steps, 0.0, 5e-2,
                                  hist=ex["hist"], nlive=ex["nlive"])[::2]
    check(bk.LAST_PATH["use_hist"] and not bk.LAST_PATH["two_level"],
          f"two-level {label}: the history path did not run")
    recomputed = bk.fused_backward(program, flat, rays7, g, steps, 0.0,
                                   5e-2)[::2]
    two_level = bk.fused_backward(program, flat, rays7, g, steps, 0.0, 5e-2,
                                  two_level=True)[::2]
    check(bk.LAST_PATH["two_level"] and not bk.LAST_PATH["use_hist"],
          f"two-level {label}: LAST_PATH says {bk.LAST_PATH}")
    plain = bk.reference_backward(program, flat, rays7, g, steps, 0.0, 5e-2,
                                  two_level=True)[::2]
    for kw in (dict(tau=1e-3, steps=steps), dict(tau=0.0, steps=12)):
        bk.fused_backward(program, flat, rays7, g, kw["steps"], kw["tau"],
                          5e-2, two_level=True)
        check(not bk.LAST_PATH["two_level"],
              f"two-level {label}: engaged at {kw}")
    torch.cuda.synchronize()
    for name, other in (("history", with_hist), ("recompute", recomputed)):
        check(all(bool(same_bits(a, b).all())
                  for a, b in zip(two_level, other)),
              f"two-level {label}: bits differ from the {name} path")
    tol = TOL_BWD["f64" if f64 else "f32"]
    e_flat = float((two_level[0] - plain[0]).abs().max())
    s_flat = float(plain[0].abs().max())
    e_rays = float((two_level[1] - plain[1])[:, conv].abs().max())
    s_rays = float(plain[1][:, conv].abs().max())
    print(f"two-level backward {label}: bitwise equal to the history and the "
          f"recompute paths; vs plain two-level: ray cotangents max abs diff "
          f"{e_rays:.3e} of {s_rays:.3e}, parameter cotangent {e_flat:.3e} "
          f"of {s_flat:.3e} (tolerance {tol:g} relative); not engaged at "
          "tau=1e-3 and at 12 steps")
    check(e_rays <= tol * s_rays and e_flat <= tol * s_flat,
          f"two-level {label}: kernel and plain disagree")
    return e_rays, e_flat


def live_steps(program, flat, rays7, steps, tau, mats=()):
    """(steps the valid rays moved, summed; rays that froze before the last
    step) of a march at ``tau``, from the forward kernel's live-step
    count: the work a march with an early exit needs."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    _, ex = rk.march_forward(program, flat, rays7, steps, tau, 5e-2,
                             log_hist=True, mats=mats)
    nlive = ex["nlive"][rays7[6] > 0.5].long()
    return int(nlive.sum()), int((nlive < steps).sum())


def forward_ops_live(program, n_valid, live_sum, n_frozen):
    """Operations of the forward kernel with an early exit: a ray evaluates
    the SDF once per live step, once more when it freezes before the last
    step, and 5 times in the tail."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    return ((live_sum + n_frozen + 5 * n_valid) * program.ops_per_eval
            + live_sum * rk.OPS_PER_STEP + n_valid * rk.OPS_TAIL)


def cuda_ms(fn, reps):
    """Time per call by CUDA events over ``reps`` calls as the host issues
    them: what a caller sees, the host's gaps included."""
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


def kernel_ms(fn, reps):
    """Device time per launch of a kernel wrapper: CUDA events around
    ``reps`` back-to-back calls queued behind a spin kernel, so that the
    host's work per call (the wrapper's checks, allocations and launch)
    cannot leave the card idle between launches, as it can in
    :func:`cuda_ms` when the host runs slower than a sub-ms kernel. If the
    spin ended before the last call was queued, the run is repeated with a
    spin four times as long."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = SPIN_CYCLES
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        drained = start.query()
        torch.cuda.synchronize()
        if not drained:
            break
        cycles *= 4
    else:
        print(f"kernel_ms: {reps} calls took longer to queue than a spin of "
              f"{cycles // 4} cycles; the time may hold host gaps")
    return start.elapsed_time(stop) / reps


def profile_frames(fn, frame_ms, frames=5, expect=None):
    """torch.profiler over ``frames`` calls, one call per profiler cycle:
    device time of each kernel per call, and the device busy share of
    ``frame_ms`` (a call timed without the profiler).

    One call per cycle because a cycle over several calls once lost a whole
    launch of a 127 ms kernel (the neural frame read 85.58 ms busy per frame
    against 126.81 ms by CUDA events: two records of three); each cycle here
    ends in a synchronise, and every record is counted. ``expect`` maps a
    kernel-name prefix to (its CUDA-event ms per launch at the same inputs,
    launches per call): the profile fails if it holds fewer records of that
    kernel than the wrapper launched, or reads it more than
    PROFILE_MAX_UNDER below its CUDA-event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    totals = {}  # kernel -> [records, device µs]
    for _ in range(frames):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # Device-side entries only; "Optimizer.step#..." is an annotation
        # that spans the optimizer's kernels, not a kernel.
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and not e.key.startswith("Optimizer.")):
                t = totals.setdefault(e.key, [0, 0.0])
                t[0] += e.count
                t[1] += e.self_device_time_total
    busy_ms = sum(t[1] for t in totals.values()) / 1e3 / frames
    check(busy_ms > 0.0, "profile: no device time recorded")
    print(f"profile ({frames} calls, one per cycle): kernels busy "
          f"{busy_ms:.4f} ms per call, {busy_ms / frame_ms:.3f} of the "
          f"{frame_ms:.4f} ms call")
    for key, (n, us) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {us / 1e3 / frames:9.4f} ms/call {n // frames:4d}x/call  "
              f"{key[:100]}")
    for prefix, (event_ms, per_call) in (expect or {}).items():
        n, us = next((t for k, t in totals.items() if k.startswith(prefix)),
                     (0, 0.0))
        prof_ms = us / 1e3 / max(n, 1)
        print(f"  profile vs CUDA events, {prefix}: {n} records of "
              f"{per_call * frames} launches, {prof_ms:.4f} ms against "
              f"{event_ms:.4f} ms per launch")
        check(n == per_call * frames, f"profile: {n} records of {prefix} for "
                                      f"{per_call * frames} launches")
        check(prof_ms >= (1.0 - PROFILE_MAX_UNDER) * event_ms,
              f"profile: {prefix} reads {prof_ms:.4f} ms, more than "
              f"{PROFILE_MAX_UNDER:.0%} below its {event_ms:.4f} ms by CUDA "
              "events")
    return {k: us / 1e3 / frames for k, (_, us) in totals.items()}


def leaf_params(tree):
    return {k: leaf_params(v) if isinstance(v, dict)
            else v.clone().requires_grad_(True) for k, v in tree.items()}


def golden_gradients(root: Path):
    """f64 gradients through the kernels against the reference-produced
    composite_512 fixture: modes 0, 2, 3, 6, 7 by value; mode 5, where the
    reference is all-NaN, finite through the march given the shader's
    cotangents (tests/test_torch_train_golden.py says why those of the
    arg-max ties are left out)."""
    import torch

    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.scene import registry
    from ray_marching_tpu_torch.scene.graph import param_paths

    g = np.load(root / "tests" / "golden" / "composite_512.npz")
    w, h = int(g["meta_width"]), int(g["meta_height"])
    from ray_marching_tpu_torch.render.pipeline import RenderConfig

    cfg = RenderConfig(px_width=w, px_height=h, focal_length=PX * h,
                       sensor_width=PX * w, sensor_height=PX * h,
                       marching_steps=int(g["meta_steps"]),
                       normals_eps=float(g["meta_normals_eps"]))
    r = FastRenderer(registry.make_scene(str(g["meta_scene"])), cfg,
                     dtype=torch.float64, grid_dtype=np.float64)
    weights = torch.as_tensor(g["loss_weights"], device=r.device)
    degree = int(g["meta_degree"])

    def leaves():
        return (leaf_params(r.init_params),
                r._tensor(g["meta_orientation"][None]).requires_grad_(True),
                r._tensor(g["meta_translation"][None]).requires_grad_(True))

    def collect(params, q, t):
        flat = dict(param_paths(params), camera_orientation=q,
                    camera_translation=t)
        return {k: torch.zeros_like(v) if v.grad is None else v.grad
                for k, v in flat.items()}

    for mode in (0, 2, 3, 6, 7):
        params, q, t = leaves()
        image = r.render(params, q, t, mode=mode, degree=degree)
        (image * weights).sum().backward()
        for path, got in collect(params, q, t).items():
            want = g[f"grad_{mode}/{path}"]
            np.testing.assert_allclose(
                got.cpu().numpy().reshape(want.shape), want,
                rtol=GOLDEN_GRAD_RTOL, atol=GOLDEN_GRAD_ATOL, equal_nan=True,
                err_msg=f"golden composite_512 mode={mode} param={path}")
    params, q, t = leaves()
    orientation, translation = r._pose(q, t)
    origin, dirs = r._pose_planes(orientation, translation)
    hit, final_dirs = r._march_planes(params, origin, dirs,
                                      cfg.marching_steps)
    image = r._assemble(r._shade(5, degree, orientation, origin, final_dirs,
                                 hit))
    cots = torch.autograd.grad((image * weights).sum(), hit,
                               allow_unused=True)
    cots = [torch.zeros_like(p) if c is None else c for p, c in zip(hit, cots)]
    lap = hit[7].detach()
    top = lap.abs() == lap[r._valid_b].abs().max()
    for i, c in enumerate(cots):
        bad = ~torch.isfinite(c)
        check(not bool(bad.any()) or (i == 7 and bool(top[bad].all())),
              f"mode 5: non-finite shader cotangent off the arg-max ties "
              f"(plane {i})")
    torch.autograd.backward(hit, [torch.nan_to_num(c, nan=0.0, posinf=0.0,
                                                   neginf=0.0) for c in cots])
    for path, got in collect(params, q, t).items():
        check(bool(torch.isfinite(got).all()),
              f"mode 5: non-finite gradient of {path}")
    print("golden composite_512 gradients (512x512, f64, 48 steps, on the "
          "card): modes 0 2 3 6 7 ok, mode 5 finite through the march")


def perturbed(params, path, factor):
    """``params`` with the leaf at ``path`` (a/b/c) multiplied by
    ``factor``."""
    key, _, rest = path.partition("/")
    out = dict(params)
    out[key] = (perturbed(params[key], rest, factor) if rest
                else params[key] * factor)
    return out


def drive_training(main, steps, silhouette=False, bwd_per_step=1,
                   two_level=False):
    """optimize() at 1080p through the kernels, counted: the CLI's selftest
    (the target is the render with c1/c0/radius 20 % larger).
    ``bwd_per_step`` is 0 for a renderer with the implicit backward, which
    launches no backward kernel. ``two_level`` asks for the two-level
    backward (the forward then logs no history). Returns (losses, forward
    launches, backward launches, seconds per step after the first by the
    host clock; every step ends in a synchronising read of the loss)."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize

    true = perturbed(main.init_params, "c1/c0/radius", 1.2)
    with torch.no_grad():
        if silhouette:
            target, target_alpha = main.render_with_alpha(
                true, BENCH_Q, BENCH_T, mode=0, degree=2, beta=5e-2)
        else:
            target = main.render(true, BENCH_Q, BENCH_T, mode=0, degree=2)
            target_alpha = None
    cfg = InverseConfig(learning_rate=1e-2, steps=steps, mode=0, degree=2,
                        trainable=["c1/c0/radius"],
                        silhouette_beta=5e-2 if silhouette else 0.0)
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    bk.LAUNCHES = 0
    bk.LAST_PATH.clear()
    stamps = [time.perf_counter()]
    rk.BWD_TWO_LEVEL = two_level
    try:
        out = optimize(main, target, BENCH_Q, BENCH_T, cfg,
                       target_alpha=target_alpha,
                       callback=lambda *_: stamps.append(time.perf_counter()))
    finally:
        rk.BWD_TWO_LEVEL = False
    torch.cuda.synchronize()
    fwd, bwd = rk.LAUNCHES, bk.LAUNCHES
    first = stamps[1] - stamps[0]
    dt = (stamps[-1] - stamps[1]) / (steps - 1)
    label = "render_with_alpha" if silhouette else "render"
    if main.config.backward != "unroll":
        label += f", backward={main.config.backward}"
    if two_level:
        label += ", two-level backward"
        check(bk.LAST_PATH.get("two_level") is True
              and bk.LAST_PATH.get("use_hist") is False,
              f"{label}: LAST_PATH says {bk.LAST_PATH}")
    elif bwd_per_step:
        check(bk.LAST_PATH.get("two_level") is False, f"{label}: two-level "
                                                      "ran unasked")
    radius = float(out["params"]["c1"]["c0"]["radius"])
    print(f"training path ({label}, {steps} Adam steps, 1080p): losses "
          + " ".join(f"{v:.6e}" for v in out["losses"])
          + f"; radius {float(main.init_params['c1']['c0']['radius']):.4f} "
          f"-> {radius:.4f} (target "
          f"{float(true['c1']['c0']['radius']):.4f}); forward launches "
          f"{fwd}, backward launches {bwd}; {dt * 1e3:.3f} ms per step "
          f"after the first, which took {first * 1e3:.1f} ms (host clock)")
    check(out["steps_run"] == steps, "optimize stopped early")
    check(all(np.isfinite(out["losses"])), "non-finite loss")
    check(out["losses"][-1] < out["losses"][0],
          f"{label}: loss did not go down")
    check(fwd == steps and bwd == steps * bwd_per_step,
          f"{label}: {fwd} forward and {bwd} backward launches in {steps} "
          "steps")
    return out["losses"], fwd, bwd, dt


def drive_modular(fast, out_dir: Path):
    """The modular pipeline at full width through the march kernel, counted:
    ``Renderer(test_scene2, use_pallas=True)``, 1920×1080, 32 steps, f32,
    mode 0, degree 2, bench pose: one frame (1 launch), one frame with a
    reflection bounce (2), all 8 modes (1), and one gradient of a pixel MSE
    (1 march launch, 1 launch of its backward). The frame is held against
    ``fast``'s frame of the same configuration on converged pixels, and the
    gradient of ``c1/c0/radius`` against the one through ``fast``. Returns
    (renderer, renderer with one bounce, march launches, marches driven,
    march-backward launches)."""
    import torch

    from ray_marching_tpu_torch.io.image import write_png
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.render.pipeline import Renderer
    from ray_marching_tpu_torch.scene import registry

    scene = registry.make_scene("test_scene2")
    cfg = config(1920, 1080, use_pallas=True)
    r = Renderer(scene, cfg, dtype=torch.float32)
    bouncer = Renderer(scene, config(1920, 1080, use_pallas=True,
                                     reflection_bounces=1),
                       dtype=torch.float32)
    true = perturbed(fast.init_params, "c1/c0/radius", 1.2)
    with torch.no_grad():
        want = fast.render(fast.init_params, BENCH_Q, BENCH_T, mode=0,
                           degree=2)
        target = fast.render(true, BENCH_Q, BENCH_T, mode=0, degree=2)
        q, t = fast._pose(BENCH_Q, BENCH_T)
        origin, dirs = fast._pose_planes(q, t)
        hit, _ = fast._march_planes(fast.init_params, origin, dirs, STEPS)
        conv = fast._assemble(
            [(hit[3].abs() < CONVERGED).to(torch.float32)]) > 0.5
    fast_params = leaf_params(fast.init_params)
    torch.mean((fast.render(fast_params, BENCH_Q, BENCH_T, mode=0, degree=2)
                - target) ** 2).backward()
    want_grad = float(fast_params["c1"]["c0"]["radius"].grad)

    torch.cuda.synchronize()
    mk.LAUNCHES = 0
    bk.MARCH_LAUNCHES = 0
    with torch.no_grad():
        frame = r.render(r.init_params, BENCH_Q, BENCH_T, mode=0, degree=2)
        n_frame = mk.LAUNCHES
        bounced = bouncer.render(bouncer.init_params, BENCH_Q, BENCH_T,
                                 mode=0, degree=2)
        n_bounce = mk.LAUNCHES - n_frame
        all_modes = r.render_all_modes(r.init_params, BENCH_Q, BENCH_T,
                                       degree=2)
        n_modes = mk.LAUNCHES - n_frame - n_bounce
    params = leaf_params(r.init_params)
    loss = torch.mean((r.render(params, BENCH_Q, BENCH_T, mode=0, degree=2)
                       - target) ** 2)
    loss.backward()
    torch.cuda.synchronize()
    launches, bwd_launches = mk.LAUNCHES, bk.MARCH_LAUNCHES
    # Marches asked for: one per render call and one more per bounce.
    n_marches = (3 * (1 + cfg.reflection_bounces)
                 + 1 + bouncer.config.reflection_bounces)
    got_grad = float(params["c1"]["c0"]["radius"].grad)
    del loss

    print(f"modular main path (Renderer, use_pallas=True, 1080p): march "
          f"launches: frame {n_frame}, frame with one bounce {n_bounce}, "
          f"render_all_modes {n_modes}, gradient step "
          f"{launches - n_frame - n_bounce - n_modes}; march-backward "
          f"launches {bwd_launches}")
    check((n_frame, n_bounce, n_modes, launches, bwd_launches)
          == (1, 2, 1, 5, 1), "modular path: unexpected launch counts")
    out_dir.mkdir(parents=True, exist_ok=True)
    shape = (1, cfg.px_height, cfg.px_width, 3)
    for name, img in (("modular_mode0", frame), ("modular_bounce", bounced)):
        check(tuple(img.shape) == shape, f"{name}: shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite")
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
              f"{name}: lambertian outside [0, 1]")
        write_png(out_dir / f"test_scene2_{name}.png", img)
    check(len(all_modes) == 8, "render_all_modes: not 8 images")
    for name, img in all_modes.items():
        check(tuple(img.shape) == shape, f"modular {name}: shape")
        if name != "proximity":  # 0/0 when every ray converges, as above
            check(not bool(torch.isnan(img).any()), f"modular {name}: NaN")
    mask = conv.expand(shape)
    diff = (frame - want).abs()[mask]
    share = float((diff > MODULAR_VS_FAST_ATOL).float().mean())
    print(f"modular frame vs FastRenderer frame: converged pixels "
          f"{int(conv.sum())}, max abs diff {float(diff.max()):.3e}, share "
          f"above {MODULAR_VS_FAST_ATOL:g}: {share:.3e}")
    check(share <= MAX_SHARE_OUT_F32, "modular and fast frames disagree")
    # The two renderers reach the same gradient by different sums (autograd
    # through torch normals and shading there, the fused backward kernel
    # here) in f32 over 2 M pixels: 1 % of the value.
    print(f"modular gradient of c1/c0/radius: {got_grad:.6e}, through "
          f"FastRenderer {want_grad:.6e}")
    check(np.isfinite(got_grad) and got_grad != 0.0
          and abs(got_grad - want_grad) <= 1e-2 * abs(want_grad),
          "modular and fast gradients disagree")
    for path, leaf in leaf_items(params):
        check(leaf.grad is not None and bool(torch.isfinite(leaf.grad).all()),
              f"modular gradient of {path}: missing or non-finite")
    return r, bouncer, launches, n_marches, bwd_launches


def leaf_items(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaf_items(v, path)
        else:
            yield path, v


def golden_bounce(root: Path):
    """f64 on the card through the march kernel against the reference-made
    scene2_bounce_512 fixture (one reflection bounce): its images on the
    stable pixels, and its mode-0 gradients through the march's backward.
    Tolerances: tests/test_golden_parity.py's, the rtol loosened to 1e-6 for
    the card's libm as for the other goldens."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
    from ray_marching_tpu_torch.scene import registry
    from ray_marching_tpu_torch.scene.graph import param_paths

    g = np.load(root / "tests" / "golden" / "scene2_bounce_512.npz")
    w, h = int(g["meta_width"]), int(g["meta_height"])
    bounces = int(g["meta_reflection_bounces"])
    cfg = RenderConfig(px_width=w, px_height=h, focal_length=PX * h,
                       sensor_width=PX * w, sensor_height=PX * h,
                       marching_steps=int(g["meta_steps"]),
                       normals_eps=float(g["meta_normals_eps"]),
                       reflection_bounces=bounces, use_pallas=True)
    r = Renderer(registry.make_scene(str(g["meta_scene"])), cfg,
                 dtype=torch.float64, grid_dtype=np.float64)
    degree = int(g["meta_degree"])
    q, t = g["meta_orientation"][None], g["meta_translation"][None]
    before = mk.LAUNCHES
    with torch.no_grad():
        images = r.render_all_modes(r.init_params, q, t, degree=degree)
    check(mk.LAUNCHES == before + 1 + bounces, "golden bounce: launches")
    from ray_marching_tpu_torch.render.shaders import MODES

    for m in g["meta_image_modes"].tolist():
        got = images[MODES[m]].cpu().numpy()
        want = g[f"image_{m}"]
        mask = np.broadcast_to(g["stable_mask"], want.shape)
        np.testing.assert_allclose(
            got[mask], want[mask], rtol=GOLDEN_GRAD_RTOL, atol=1e-9,
            equal_nan=True, err_msg=f"golden scene2_bounce_512 mode {m}")
    params = leaf_params(r.init_params)
    tq = r._tensor(q).requires_grad_(True)
    tt = r._tensor(t).requires_grad_(True)
    before = bk.MARCH_LAUNCHES
    image = r.render(params, tq, tt, mode=0, degree=degree)
    (image * torch.as_tensor(g["loss_weights"], device=r.device)).sum() \
        .backward()
    check(bk.MARCH_LAUNCHES == before + 1 + bounces,
          "golden bounce: backward launches")
    flat = dict(param_paths(params), camera_orientation=tq,
                camera_translation=tt)
    for path, leaf in flat.items():
        want = g[f"grad_0/{path}"]
        got = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        np.testing.assert_allclose(
            got.cpu().numpy().reshape(want.shape), want,
            rtol=GOLDEN_GRAD_RTOL, atol=GOLDEN_GRAD_ATOL, equal_nan=True,
            err_msg=f"golden scene2_bounce_512 grad_0 {path}")
    print(f"golden scene2_bounce_512 ({w}x{h}, f64, {bounces} bounce, "
          "use_pallas=True, on the card): images of modes "
          f"{g['meta_image_modes'].tolist()} ok, mode-0 gradients through "
          "the march kernel's backward ok")

def neural_scene(matmul_dtype="float32"):
    """``Union(room, NeuralSDF(hidden=(256, 256), ...))`` of
    tools/train_neural_demo.py:113-117 (--hidden 256 --impl matmul
    --activation sine_fast)."""
    from ray_marching_tpu_torch.scene.graph import Box, Onion, Union
    from ray_marching_tpu_torch.scene.neural import NeuralSDF

    return Union(children=(
        Onion(child=Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
        NeuralSDF(hidden=(256, 256), seed=11, scale=0.5, w0=8.0,
                  impl="matmul", activation="sine_fast",
                  matmul_dtype=matmul_dtype)))


def target_scene():
    """The analytic shape the w256 field was distilled to, in the room
    (tools/train_neural_demo.py:56-70)."""
    from ray_marching_tpu_torch.scene.graph import (
        Affine,
        SmoothUnion,
        Sphere,
        Union,
    )

    return Union(children=(neural_scene().children[0], SmoothUnion(
        children=(
            Affine(child=Sphere(radius=0.45),
                   orientation=(1.0, 0.0, 0.0, 0.0),
                   translation=(0.3, 0.1, 0.0)),
            Affine(child=Sphere(radius=0.35),
                   orientation=(1.0, 0.0, 0.0, 0.0),
                   translation=(-0.35, -0.1, 0.1)),
        ), blend_k=8.0)))


def neural_renderer(res, dtype, scene=None, **kw):
    """``FastRenderer`` on the main neural configuration at ``res``² and its
    weights from the file (``io.checkpoint.load_pytree`` against the
    renderer's own template)."""
    import torch

    from ray_marching_tpu_torch.io.checkpoint import load_pytree
    from ray_marching_tpu_torch.render.fast import FastRenderer

    cfg = dataclasses.replace(config(res, res), marching_steps=NEURAL_STEPS)
    r = FastRenderer(scene or neural_scene(), cfg, dtype=dtype,
                     grid_dtype=np.float64 if dtype == torch.float64
                     else np.float32, **kw)
    return r, load_pytree(NEURAL_WEIGHTS, r.init_params)


def neural_rays(renderer, params):
    """The flat parameters, matrices and (7, rows, 128) planes
    ``FastRenderer`` hands the kernel at the demo's pose."""
    import torch

    from ray_marching_tpu_torch.ops.params import split_params_padded

    q, t = renderer._pose(NEURAL_Q, NEURAL_T)
    origin, dirs = renderer._pose_planes(q, t)
    rays7 = torch.stack(list(origin) + list(dirs) + [renderer._valid], 0)
    flat, mats, _ = split_params_padded(params, renderer.dtype,
                                        renderer.device)
    return flat, mats, rays7


class PlainMarchCalls:
    """Counts the calls of the kernels' plain marches while it is active."""

    def __enter__(self):
        from ray_marching_tpu_torch.ops import march_kernel as mk
        from ray_marching_tpu_torch.ops import render_kernel as rk
        from ray_marching_tpu_torch.render import fast

        self.n = 0
        self._saved = [(rk, "_reference_march"), (fast, "_reference_march"),
                       (mk, "reference_march")]
        self._saved = [(m, a, getattr(m, a)) for m, a in self._saved]
        for mod, attr, fn in self._saved:
            setattr(mod, attr, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        return counted

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def ptxas_entry(log, kernel, args="IfE"):
    """(registers, stack frame bytes, spill store bytes, static shared
    memory bytes) of the f32 instantiation of ``kernel`` (its mangled
    template arguments ``args``; ``PKf`` for a kernel that is no template)
    in a build's ``-Xptxas -v`` report (None each when the library was built
    before this run)."""
    if not log:
        return None, None, None, None
    for chunk in log.split("Compiling entry function '")[1:]:
        if re.match(r"_Z\d+" + kernel + args, chunk):
            regs = re.search(r"Used (\d+) registers", chunk)
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores", chunk)
            smem = re.search(r"(\d+) bytes smem", chunk)
            return (int(regs.group(1)), int(frame.group(1)),
                    int(frame.group(2)), int(smem.group(1)) if smem else 0)
    raise SmokeFailure(f"no ptxas report for {kernel}")


def tc_bound_ms(program, ops, n_evals):
    """The least time of ``ops`` operations over ``n_evals`` SDF
    evaluations when the tensor-core layers of ``program`` run on the tensor
    cores: their multiplies and adds (2·N1·N2 per evaluation) at the TF32
    rate taken three times (3xTF32) or the bf16 rate, the rest at the f32
    SIMT rate."""
    tc_s, tc_ops = 0.0, 0
    for k in program.tc:
        sizes = program.mlps[k].sizes
        n = n_evals * 2 * sizes[1] * sizes[2]
        bf16 = program.mlps[k].node.matmul_dtype == "bfloat16"
        tc_s += n / (PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS / 3)
        tc_ops += n
    return (tc_s + (ops - tc_ops) / PEAK_F32_FLOPS) * 1e3


def frame_and_hits(renderer, params):
    """The mode-0 frame at the demo's pose and where its rays hit the
    object (ended within OBJECT_RADIUS of the origin), from one march
    (tests/test_torch_neural.py::frame_and_hits)."""
    import torch

    r = renderer
    with torch.no_grad():
        q, t = r._pose(NEURAL_Q, NEURAL_T)
        origin, dirs = r._pose_planes(q, t)
        hit, final_dirs = r._march_planes(params, origin, dirs, NEURAL_STEPS)
        norm = torch.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2)
        hits = r._assemble([(norm < OBJECT_RADIUS).to(r.dtype)]) > 0.5
        return r._assemble(r._shade(0, 1, q, origin, final_dirs, hit)), hits


def neural_slice(card, out_dir: Path):
    """The neural slice on the card: kernels vs plain versions (f32 at the
    main configuration's planes, tau 0 and 1e-3, the MLP on the tensor
    cores; the per-thread route; f64 128×128; bf16 operands 128×128), the
    march kernel vs the forward's planes 0-3 bitwise for both routes and
    under a gradient against the training forward, the 1xTF32 control, the
    main path (FastRenderer.render, 20 frames, counted; every launch on the
    tensor cores, no plain march), the weights check against the analytic
    target, the modular path (Renderer, use_pallas=True, one frame,
    counted), the CLI on the JAX package's neural scene file, timings and
    both bounds. Returns the two entries of the kernels line."""
    import torch

    from ray_marching_tpu_torch.cli import main as cli_main
    from ray_marching_tpu_torch.io.image import write_png
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.ops.params import split_params_padded
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer
    from ray_marching_tpu_torch.scene import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"neural slice: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    main, params = neural_renderer(NEURAL_RES, torch.float32)
    prog = main.program
    flat, mats, rays7 = neural_rays(main, params)
    check(rk.mlp_route(prog, torch.float32) == "tc",
          "the w256 scene does not take the tensor-core route")
    errs = {}
    for tau in (0.0, 1e-3):
        label = f"neural f32 {NEURAL_RES}x{NEURAL_RES} w256 tau={tau:g}"
        errs[tau] = compare(label + " (tensor cores)", prog, flat, rays7,
                            tau, False, NEURAL_STEPS, mats)
        m_err, _ = compare_march(label + " (tensor cores)", prog, flat,
                                 rays7, tau, False, backward=False,
                                 steps=NEURAL_STEPS, mats=mats)
        errs[("march", tau)] = m_err
    compare(
        f"neural f32 {NEURAL_RES}x{NEURAL_RES} w256 tau=0 (tensor cores, "
        "a tenth of TOL_F32)", prog, flat, rays7, 0.0, False, NEURAL_STEPS,
        mats, tol=TOL_F32_TC)
    errs["thread"] = compare(
        f"neural f32 {NEURAL_RES}x{NEURAL_RES} w256 tau=0 (per-thread MLP)",
        prog, flat, rays7, 0.0, False, NEURAL_STEPS, mats, route="thread")
    # The 1xTF32 control: the same kernel, the weights' lo zeroed in the
    # prepared buffer. It must miss a tenth of TOL_F32.
    control = rk.tc_buffer(prog, mats)
    control[prog.mat_size:].view(-1, 4)[:, 2:] = 0
    label = (f"neural f32 {NEURAL_RES}x{NEURAL_RES} w256 tau=0, 1xTF32 "
             "control")
    compare(label + " (a tenth of TOL_F32: must fail)", prog, flat, rays7,
            0.0, False, NEURAL_STEPS, mats, tol=TOL_F32_TC, tc_mats=control,
            must_fail=True)
    errs["control"] = compare(label + " (TOL_F32 itself)", prog, flat, rays7,
                              0.0, False, NEURAL_STEPS, mats,
                              tc_mats=control)
    del control
    # The routes' pairs, bit for bit: the per-thread serving forward and
    # march; the march under a gradient (the per-thread entry) and the
    # training forward.
    thread, _ = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2,
                                 mats=mats, route="thread")
    thread_march = mk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0,
                                    mats, route="thread")
    train, _ = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2,
                                log_hist=True, mats=mats)
    mk.LAUNCHES = mk.TC_LAUNCHES = 0
    grad_march = mk.march_planes(prog, flat.clone().requires_grad_(True),
                                 rays7, NEURAL_STEPS, 0.0, mats)
    torch.cuda.synchronize()
    check((mk.LAUNCHES, mk.TC_LAUNCHES) == (1, 0),
          "the march under a gradient did not take the per-thread entry")
    check(bool(same_bits(thread_march, thread[:4]).all()),
          "per-thread march differs from the per-thread forward's planes")
    check(bool(same_bits(grad_march.detach(), train[:4]).all()),
          "the gradient route's march differs from the training forward")
    check(bool(same_bits(train[:8], thread).all()),
          "the training forward differs from the per-thread serving one")
    print("neural routes: per-thread march == per-thread forward planes 0-3, "
          "the gradient route's march (per-thread entry) == the training "
          "forward's planes 0-3, training forward == per-thread serving "
          "planes 0-7, all bit for bit")
    del thread, thread_march, train, grad_march
    r64, p64 = neural_renderer(NEURAL_F64_RES, torch.float64)
    f_flat, f_mats, f_rays = neural_rays(r64, p64)
    label = f"neural f64 {NEURAL_F64_RES}x{NEURAL_F64_RES} w256"
    compare(label, r64.program, f_flat, f_rays, 0.0, True, NEURAL_STEPS,
            f_mats)
    compare_march(label, r64.program, f_flat, f_rays, 0.0, True,
                  backward=False, steps=NEURAL_STEPS, mats=f_mats)
    rbf, pbf = neural_renderer(NEURAL_F64_RES, torch.float32,
                               scene=neural_scene("bfloat16"))
    bf_flat, bf_mats, bf_rays = neural_rays(rbf, pbf)
    compare(f"neural bf16 operands {NEURAL_F64_RES}x{NEURAL_F64_RES} w256 "
            f"(tolerance {TOL_BF16}, share {MAX_SHARE_OUT_BF16})",
            rbf.program, bf_flat, bf_rays, 0.0, False, NEURAL_STEPS, bf_mats,
            tol=TOL_BF16, max_share=MAX_SHARE_OUT_BF16)
    del r64, p64, f_flat, f_mats, f_rays, rbf, pbf, bf_flat, bf_mats, bf_rays

    # The main path, counted: FastRenderer.render with march_impl='auto'.
    check(main.march_impl == "fused", f"auto chose {main.march_impl}")
    main.render(params, NEURAL_Q, NEURAL_T, mode=0, degree=1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    rk.LAUNCHES = rk.TC_LAUNCHES = 0
    with PlainMarchCalls() as plain:
        start.record()
        for _ in range(NEURAL_FRAMES):
            frame = main.render(params, NEURAL_Q, NEURAL_T, mode=0, degree=1)
        stop.record()
        torch.cuda.synchronize()
    launches, tc_launches = rk.LAUNCHES, rk.TC_LAUNCHES
    frame_ms = start.elapsed_time(stop) / NEURAL_FRAMES
    print(f"neural main path (FastRenderer.render, march_impl='auto', w256, "
          f"{NEURAL_RES}x{NEURAL_RES}, {NEURAL_STEPS} steps): {NEURAL_FRAMES} "
          f"frames, forward-kernel launches {launches} (tensor-core entry "
          f"{tc_launches}), plain-march calls {plain.n}; {frame_ms:.4f} ms "
          "per frame (CUDA events)")
    check(launches == tc_launches == NEURAL_FRAMES and plain.n == 0,
          "neural main path: launches, route or plain marches")
    valid_px = main._assemble([main._valid]) > 0.5
    check(tuple(frame.shape) == (1, NEURAL_RES, NEURAL_RES, 3)
          and bool(torch.isfinite(frame[valid_px.expand_as(frame)]).all()),
          "neural frame: shape or non-finite pixels")
    out_dir.mkdir(parents=True, exist_ok=True)
    write_png(out_dir / "neural_w256_mode0.png", frame)
    target = FastRenderer(target_scene(), main.config, dtype=torch.float32,
                          grid_dtype=np.float32)
    got, want = frame_and_hits(main, params), frame_and_hits(
        target, target.init_params)
    agree = float((got[1] == want[1]).to(torch.float64).mean())
    mean_diff = float((got[0] - want[0]).abs().mean())
    print(f"neural frame vs the analytic target it was distilled to: "
          f"{agree:.6f} of the pixels agree on hitting the object (at least "
          f"{TARGET_MIN_AGREE}), mean abs difference {mean_diff:.6f} (at most "
          f"{TARGET_MAX_MEAN_DIFF})")
    check(agree >= TARGET_MIN_AGREE and mean_diff <= TARGET_MAX_MEAN_DIFF,
          "the neural frame does not match the target: weights carried "
          "wrongly?")
    del target

    # The modular path, counted: one frame through the march kernel.
    modular = Renderer(neural_scene(),
                       dataclasses.replace(main.config, use_pallas=True),
                       dtype=torch.float32)
    with torch.no_grad():
        modular.render(params, NEURAL_Q, NEURAL_T, mode=0, degree=1)
        torch.cuda.synchronize()
        mk.LAUNCHES = mk.TC_LAUNCHES = 0
        with PlainMarchCalls() as plain:
            mod_frame = modular.render(params, NEURAL_Q, NEURAL_T, mode=0,
                                       degree=1)
            torch.cuda.synchronize()
        march_launches, march_tc_launches = mk.LAUNCHES, mk.TC_LAUNCHES
        hit, _ = main._march_planes(params, *main._pose_planes(
            *main._pose(NEURAL_Q, NEURAL_T)), NEURAL_STEPS)
        conv = main._assemble([(hit[3].abs() < CONVERGED).to(torch.float32)]
                              ) > 0.5
    diff = (mod_frame - frame).abs()[conv.expand_as(frame)]
    share = float((diff > MODULAR_VS_FAST_ATOL).float().mean())
    print(f"neural modular path (Renderer, use_pallas=True): march launches "
          f"{march_launches} (tensor-core entry {march_tc_launches}), "
          f"plain-march calls {plain.n}; vs the "
          f"FastRenderer frame on {int(conv.sum())} converged pixels: max abs "
          f"diff {float(diff.max()):.3e}, share above "
          f"{MODULAR_VS_FAST_ATOL:g} {share:.3e}")
    check(march_launches == march_tc_launches == 1 and plain.n == 0,
          "neural modular path: launches, route or plain marches")
    check(share <= MAX_SHARE_OUT_F32, "neural modular and fast frames differ")
    write_png(out_dir / "neural_w256_modular_mode0.png", mod_frame)

    # The JAX package's CLI entry for neural scenes, in process.
    rk.LAUNCHES = rk.TC_LAUNCHES = 0
    cli_main(["render", "--scene-file", str(NEURAL_SCENE_FILE), "--fast",
              "-o", str(out_dir / "neural_demo_cli.png")])
    torch.cuda.synchronize()
    check(rk.LAUNCHES == rk.TC_LAUNCHES == 1,
          f"cli render: {rk.LAUNCHES} launches, {rk.TC_LAUNCHES} on the "
          "tensor cores")
    cli_launches = rk.LAUNCHES

    # Timing: the kernels at the main configuration, their plain versions,
    # the modular frame; both marches for both neural scenes.
    ms = kernel_ms(lambda: rk.fused_march_normals(prog, flat, rays7,
                                                NEURAL_STEPS, 0.0, 5e-2,
                                                mats=mats), 5)
    thread_ms = kernel_ms(lambda: rk.march_forward(
        prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2, mats=mats,
        route="thread"), 3)
    plain_ms = cuda_ms(lambda: rk.reference_march_normals(
        prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2, mats=mats), 2)
    rbf, pbf = neural_renderer(NEURAL_RES, torch.float32,
                               scene=neural_scene("bfloat16"))
    bf_flat, bf_mats, bf_rays = neural_rays(rbf, pbf)
    bf16_ms = {route: kernel_ms(lambda: rk.march_forward(
        rbf.program, bf_flat, bf_rays, NEURAL_STEPS, 0.0, 5e-2, mats=bf_mats,
        route=route), 3) for route in ("tc", "thread")}
    del rbf, pbf, bf_flat, bf_mats, bf_rays
    m_flat, m_mats, _ = split_params_padded(params, torch.float32,
                                            modular.device)
    _, _, ray_pos, ray_dirs = modular.camera.pose(
        modular._tensor(NEURAL_Q), modular._tensor(NEURAL_T))
    m_rays7 = mk.rays_to_planes(ray_pos, ray_dirs).contiguous()
    march_ms = kernel_ms(lambda: mk.march_planes(prog, m_flat, m_rays7,
                                               NEURAL_STEPS, 0.0, m_mats), 5)
    march_thread_ms = kernel_ms(lambda: mk.march_forward(
        prog, m_flat, m_rays7, NEURAL_STEPS, 0.0, m_mats, route="thread"), 3)
    march_plain_ms = cuda_ms(lambda: mk.reference_march(
        prog, m_flat, m_rays7, NEURAL_STEPS, 0.0, m_mats), 2)

    def modular_frame():
        with torch.no_grad():
            return modular.render(params, NEURAL_Q, NEURAL_T, mode=0,
                                  degree=1)

    modular_ms = cuda_ms(modular_frame, 3)
    prof = profile_frames(lambda: main.render(params, NEURAL_Q, NEURAL_T,
                                              mode=0, degree=1), frame_ms,
                          frames=3,
                          expect={"render_fwd_tc_kernel": (ms, 1)})
    kernel_dev_ms = next((v for k, v in prof.items()
                          if k.startswith("render_fwd_tc_kernel")), None)
    # The tensor-core buffer each serving launch prepares (tc_buffer): its
    # time per call as issued, and its device time.
    prep_ms = cuda_ms(lambda: rk.tc_buffer(prog, mats), 20)
    prep_dev_ms = sum(profile_frames(lambda: rk.tc_buffer(prog, mats),
                                     prep_ms, frames=3).values())
    print(f"tensor-core buffer (tc_buffer, once per serving launch): "
          f"{prep_ms:.4f} ms per call by CUDA events as issued, "
          f"{prep_dev_ms:.4f} ms of device time; the serving frame "
          f"{frame_ms:.4f} ms, its kernel {ms:.4f} ms")
    dispatch = {}
    demo = registry.make_scene("neural_demo")
    for name, scene, p in (("neural_demo", demo, None),
                           ("w256", neural_scene(), params)):
        for impl in ("fused", "xla"):
            r = FastRenderer(scene, main.config, dtype=torch.float32,
                             march_impl=impl)
            p_ = r.init_params if p is None else p
            dispatch[f"{name}_{impl}_frame_ms"] = cuda_ms(
                lambda: r.render(p_, NEURAL_Q, NEURAL_T, mode=0, degree=1),
                3)
    print(f"neural timing on {card} ({NEURAL_RES}x{NEURAL_RES}, "
          f"{NEURAL_STEPS} steps, f32): forward kernel {ms:.4f} ms on the "
          f"tensor cores, {thread_ms:.4f} ms per thread, plain "
          f"{plain_ms:.3f} ms; "
          f"bf16 operands {bf16_ms['tc']:.4f} ms on the tensor cores, "
          f"{bf16_ms['thread']:.4f} ms per thread; march kernel "
          f"{march_ms:.4f} ms on the tensor cores, {march_thread_ms:.4f} ms "
          f"per thread, plain "
          f"{march_plain_ms:.3f} ms; frame {frame_ms:.4f} ms (FastRenderer), "
          f"{modular_ms:.4f} ms (Renderer, use_pallas=True); march_impl "
          "fused vs xla, frame ms: "
          + ", ".join(f"{k[:-9]} {v:.4f}" for k, v in dispatch.items()))

    # Bounds: operations from the op counts (the MLP dominates), bytes from
    # the planes and the matrices, each read or written once.
    n_valid = int((rays7[6] > 0.5).sum())
    plane_bytes = rays7.shape[1] * rays7.shape[2] * rays7.element_size()
    mat_bytes = sum(m.numel() for m in mats) * rays7.element_size()
    ops = rk.kernel_ops(prog, n_valid, NEURAL_STEPS)
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = (15 * plane_bytes + mat_bytes) / PEAK_BYTES * 1e3
    m_valid = int((m_rays7[6] > 0.5).sum())
    m_plane_bytes = (m_rays7.shape[1] * m_rays7.shape[2]
                     * m_rays7.element_size())
    m_ops = mk.march_ops(prog, m_valid, NEURAL_STEPS)
    tm_ops = m_ops / PEAK_F32_FLOPS * 1e3
    tm_bytes = (11 * m_plane_bytes + mat_bytes) / PEAK_BYTES * 1e3
    # The tensor-core bounds: the hidden layer's multiplies and adds at the
    # 3xTF32 rate, the rest of each evaluation at the f32 SIMT rate.
    t_tc = tc_bound_ms(prog, ops, n_valid * (NEURAL_STEPS + 5))
    tm_tc = tc_bound_ms(prog, m_ops, m_valid * (NEURAL_STEPS + 1))
    log = rk.BUILD_LOG.get(rk.kernel_key(prog), "")
    regs = {name: ptxas_entry(log, kernel, args) for name, kernel, args in (
        ("forward, tensor cores", "render_fwd_tc_kernel", "PKf"),
        ("march, tensor cores", "march_tc_kernel", "PKf"),
        ("forward, per thread", "render_fwd_kernel", "IfE"),
        ("march, per thread", "march_kernel", "IfE"))}
    print(f"neural bounds: forward {ops} ops ({prog.ops_per_eval} per SDF "
          f"evaluation) -> {t_ops:.4f} ms at the f32 SIMT rate, "
          f"{t_tc:.4f} ms with the hidden layer on the tensor cores "
          f"(3xTF32), bytes -> {t_bytes:.4f} ms; march {m_ops} ops -> "
          f"{tm_ops:.4f} ms SIMT, {tm_tc:.4f} ms tensor cores, bytes -> "
          f"{tm_bytes:.4f} ms; ptxas (f32; registers, stack, spill stores, "
          "shared memory): "
          + "; ".join(f"{k} {v[0]}, {v[1]} B, {v[2]} B, {v[3]} B"
                      for k, v in regs.items()))
    fwd_regs, march_regs = (regs["forward, tensor cores"],
                            regs["march, tensor cores"])
    common = {"route": "cuda", "library_ms": None, "card": card}
    return [{
        "name": "render_fwd_neural",
        "source": "ray_marching_tpu_torch/ops/csrc/render_fwd.cu + "
                  "ray_marching_tpu_torch/ops/csrc/neural.cuh",
        "replaces": "ray_marching_tpu/ops/pallas_render.py:227 + "
                    "ray_marching_tpu/scene/neural.py:232",
        "launches": launches,
        "launches_cli": cli_launches,
        "launches_tc": tc_launches,
        "mlp": "tensor cores, mma.sync 3xTF32",
        "max_abs_err": errs[0.0],
        "max_abs_err_tau_1e-3": errs[1e-3],
        "max_abs_err_per_thread": errs["thread"],
        "max_abs_err_control_1xtf32": errs["control"],
        "ms": ms,
        "ms_per_thread": thread_ms,
        "ms_bf16": bf16_ms["tc"],
        "ms_bf16_per_thread": bf16_ms["thread"],
        "plain_ms": plain_ms,
        "bound_ms": max(t_tc, t_bytes),
        "bound_by": "operations" if t_tc >= t_bytes else "bytes",
        "bound_ms_simt": max(t_ops, t_bytes),
        "frame_ms": frame_ms,
        "profiler_kernel_ms": kernel_dev_ms,
        "tc_buffer_ms": prep_ms,
        "tc_buffer_device_ms": prep_dev_ms,
        "registers": fwd_regs[0],
        "stack_bytes": fwd_regs[1],
        "spill_store_bytes": fwd_regs[2],
        "smem_bytes": fwd_regs[3],
        "registers_per_thread_route": regs["forward, per thread"][0],
        **dispatch,
        **common,
    }, {
        "name": "march_neural",
        "source": "ray_marching_tpu_torch/ops/csrc/march.cu + "
                  "ray_marching_tpu_torch/ops/csrc/neural.cuh",
        "replaces": "ray_marching_tpu/ops/pallas_march.py:173 + "
                    "ray_marching_tpu/scene/neural.py:232",
        "launches": march_launches,
        "launches_tc": march_tc_launches,
        "mlp": "tensor cores, mma.sync 3xTF32",
        "max_abs_err": errs[("march", 0.0)],
        "max_abs_err_tau_1e-3": errs[("march", 1e-3)],
        "ms": march_ms,
        "ms_per_thread": march_thread_ms,
        "plain_ms": march_plain_ms,
        "bound_ms": max(tm_tc, tm_bytes),
        "bound_by": "operations" if tm_tc >= tm_bytes else "bytes",
        "bound_ms_simt": max(tm_ops, tm_bytes),
        "frame_ms": modular_ms,
        "registers": march_regs[0],
        "stack_bytes": march_regs[1],
        "spill_store_bytes": march_regs[2],
        "smem_bytes": march_regs[3],
        "registers_per_thread_route": regs["march, per thread"][0],
        **common,
    }]


class PlainBackwardCalls:
    """Counts the calls of the backward kernel's plain version while it is
    active."""

    def __enter__(self):
        from ray_marching_tpu_torch.ops import backward_kernel as bk

        self.n, self._fn = 0, bk.reference_backward

        def counted(*args, **kwargs):
            self.n += 1
            return self._fn(*args, **kwargs)

        bk.reference_backward = counted
        return self

    def __exit__(self, *exc):
        from ray_marching_tpu_torch.ops import backward_kernel as bk

        bk.reference_backward = self._fn


def rel_err(got, want):
    """Largest absolute difference over the largest reference entry."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale > 0 else 1.0)


def trainable_leaves(tree, trainable):
    """The leaves of ``tree`` that ``optimize`` trains for ``trainable``
    (a leaf is trained when one entry is a substring of its path)."""
    return {p: v for p, v in leaf_items(tree)
            if any(t in p for t in trainable)}


def counted_optimize(label, renderer, target, q, t, cfg, init_params,
                     two_level=False):
    """optimize() through the kernels, counted: one forward and one backward
    launch per step, no plain march or backward, the backward path asked
    for (the history, or two levels without one), finite losses and a
    finite gradient of every trainable leaf at every step. Returns (result,
    the trainable leaves' gradients at each step, each step's ms by the host
    clock; every step ends in a synchronise)."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.optim.inverse import optimize

    grads, stamps = [], []

    def seen(step, loss, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        grads.append({p: None if v.grad is None else v.grad.clone()
                      for p, v in trainable_leaves(state["params"],
                                                   cfg.trainable).items()})

    torch.cuda.synchronize()
    rk.LAUNCHES = bk.LAUNCHES = 0
    bk.LAST_PATH.clear()
    rk.BWD_TWO_LEVEL = two_level
    stamps.append(time.perf_counter())
    try:
        with PlainMarchCalls() as pm, PlainBackwardCalls() as pb:
            out = optimize(renderer, target, q, t, cfg,
                           init_params=init_params, callback=seen)
            torch.cuda.synchronize()
    finally:
        rk.BWD_TWO_LEVEL = False
    fwd, bwd, n_plain, path = rk.LAUNCHES, bk.LAUNCHES, pm.n + pb.n, dict(
        bk.LAST_PATH)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]

    def shown(v):  # a scalar leaf's value, else its largest entry
        return "None" if v is None else (
            f"{float(v):.9e}" if v.numel() == 1
            else f"max|.| {float(v.abs().max()):.3e}")

    print(f"{label} (optimize, {cfg.steps} Adam steps on {cfg.trainable}"
          f"{', two-level backward' if two_level else ''}): losses "
          + " ".join(f"{v:.6e}" for v in out["losses"])
          + "; gradients per step " + " | ".join(
              " ".join(f"{p}={shown(v)}" for p, v in step.items())
              for step in grads)
          + f"; forward launches {fwd}, backward launches {bwd}, plain "
          f"calls {n_plain}, path {path}; step ms (host clock) "
          + " ".join(f"{v:.1f}" for v in step_ms))
    check(out["steps_run"] == cfg.steps and all(np.isfinite(out["losses"])),
          f"{label}: steps or losses")
    check((fwd, bwd, n_plain) == (cfg.steps, cfg.steps, 0),
          f"{label}: launches or plain calls")
    check(path.get("two_level") is two_level
          and path.get("use_hist") is not two_level, f"{label}: path {path}")
    check(len(grads) == cfg.steps and all(
        v is not None and bool(torch.isfinite(v).all())
        for step in grads for v in step.values()),
        f"{label}: missing or non-finite gradients")
    return out, grads, step_ms


def drive_optimize(label, renderer, target, q, t, cfg, init_params):
    """counted_optimize with the history, then its first step again with two
    levels: the same loss and the same gradients bit for bit. Returns
    (result, gradients per step, step ms, backward launches of the history
    run, of the two-level step)."""
    import torch

    out, grads, step_ms = counted_optimize(label, renderer, target, q, t,
                                           cfg, init_params)
    out_2l, grads_2l, _ = counted_optimize(
        label, renderer, target, q, t, dataclasses.replace(cfg, steps=1),
        init_params, two_level=True)
    check(out_2l["losses"][0] == out["losses"][0]
          and all(torch.equal(v, grads[0][p])
                  for p, v in grads_2l[0].items()),
          f"{label}: the two-level step differs from the history's first")
    print(f"{label}: the two-level step's loss and gradients equal the "
          "history run's first bit for bit")
    return out, grads, step_ms, cfg.steps, 1


def counted_gradient(renderer, params, q, t, target, degree, alpha=False):
    """One counted gradient of every leaf of a mode-0 MSE (``alpha``:
    through render_with_alpha, plus the mean square alpha). Returns
    ((forward, backward, march, march-backward launches, plain marches,
    plain backwards, all finite), the leaves with their gradients)."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    leaves = leaf_params(params)
    torch.cuda.synchronize()
    rk.LAUNCHES = bk.LAUNCHES = bk.MARCH_LAUNCHES = mk.LAUNCHES = 0
    with PlainMarchCalls() as pm, PlainBackwardCalls() as pb:
        if alpha:
            img, a = renderer.render_with_alpha(leaves, q, t, mode=0,
                                                degree=degree)
            loss = torch.mean((img - target) ** 2) + torch.mean(a ** 2)
        else:
            loss = torch.mean((renderer.render(leaves, q, t, mode=0,
                                               degree=degree) - target) ** 2)
        loss.backward()
        torch.cuda.synchronize()
    finite = all(v.grad is not None and bool(torch.isfinite(v.grad).all())
                 for _, v in leaf_items(leaves))
    return (rk.LAUNCHES, bk.LAUNCHES, mk.LAUNCHES, bk.MARCH_LAUNCHES, pm.n,
            pb.n, finite), leaves


def cli_optimize(args, backward_launches):
    """The CLI's optimize, counted: ``backward_launches`` backward kernel
    launches."""
    import torch

    from ray_marching_tpu_torch.cli import main as cli_main
    from ray_marching_tpu_torch.ops import backward_kernel as bk

    bk.LAUNCHES = 0
    cli_main(["optimize", *args])
    torch.cuda.synchronize()
    check(bk.LAUNCHES == backward_launches,
          f"cli optimize {args}: {bk.LAUNCHES} backward launches")


def backward_timings(prog, flat, rays7, steps, m_rays7, reps, mats=()):
    """The training kernels at tau = 0 by CUDA events: the backward in its
    three modes in turns (history, two-level, recompute, then backwards),
    its plain versions, the march-only mode at the march kernel's planes
    ``m_rays7`` and its plain version, and the forward with history.
    Returns {name: ms} and the turns."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    rng = np.random.default_rng(37)
    g8 = torch.as_tensor(rng.standard_normal((8,) + tuple(rays7.shape[1:])),
                         dtype=rays7.dtype).to(rays7.device)
    g4 = torch.as_tensor(rng.standard_normal((4,) + tuple(m_rays7.shape[1:])),
                         dtype=m_rays7.dtype).to(m_rays7.device)
    _, ex = rk.march_forward(prog, flat, rays7, steps, 0.0, 5e-2,
                             log_hist=True, mats=mats)
    mode_kw = {"history": dict(hist=ex["hist"], nlive=ex["nlive"]),
               "recompute": {}, "two-level": dict(two_level=True)}

    def bwd(mode):
        return bk.fused_backward(prog, flat, rays7, g8, steps, 0.0, 5e-2,
                                 mats=mats, **mode_kw[mode])

    turns = [(m, kernel_ms(lambda m=m: bwd(m), reps))
             for m in ("history", "two-level", "recompute", "recompute",
                       "two-level", "history")]
    ms = {m: sum(v for n, v in turns if n == m) / 2 for m in mode_kw}
    ms["plain"] = cuda_ms(lambda: bk.reference_backward(
        prog, flat, rays7, g8, steps, 0.0, 5e-2, mats=mats,
        **mode_kw["history"]), 1)
    ms["plain two-level"] = cuda_ms(lambda: bk.reference_backward(
        prog, flat, rays7, g8, steps, 0.0, 5e-2, mats=mats, two_level=True),
        1)
    ms["march-only"] = kernel_ms(lambda: bk.march_backward(
        prog, flat, m_rays7, g4, steps, 0.0, mats), reps)
    ms["plain march-only"] = cuda_ms(lambda: bk.reference_backward(
        prog, flat, m_rays7, g4, steps, 0.0, None, march_only=True,
        mats=mats), 1)
    ms["forward with history"] = kernel_ms(lambda: rk.march_forward(
        prog, flat, rays7, steps, 0.0, 5e-2, log_hist=True, mats=mats), reps)
    return ms, turns


def train_step_profile(renderer, params, trainable, q, t, target, degree,
                       lr, reps, frames, times):
    """One training step (render, mode-0 MSE, backward, Adam on the
    ``trainable`` leaves) by CUDA events over ``reps`` steps, then profiled
    (profile_frames, held against ``times`` of backward_timings). Returns
    (step ms, the profile's ms per kernel)."""
    import torch

    leaves = leaf_params(params)
    opt = torch.optim.Adam(list(trainable_leaves(leaves, trainable).values()),
                           lr=lr)

    def train_step():
        opt.zero_grad(set_to_none=True)
        torch.mean((renderer.render(leaves, q, t, mode=0, degree=degree)
                    - target) ** 2).backward()
        opt.step()

    step_ms = cuda_ms(train_step, reps)
    prof = profile_frames(train_step, step_ms, frames=frames, expect={
        "void render_bwd_kernel<float": (times["history"], 1),
        "void render_fwd_train_kernel<float>": (
            times["forward with history"], 1)})
    return step_ms, prof


def backward_work(prog, rays7, steps, m_rays7, mats=()):
    """Operations and bytes of each backward mode at tau = 0, every ray
    sweeping every step: bytes of the planes, the history, the matrices and
    the partial rows, each read or written once. With the history: 4 ray
    planes (direction and valid), 8 cotangent planes, 6 output planes, the
    live-step plane; the recompute reads all 7 ray planes and its scratch
    is neither input nor output; the march-only mode reads 7 ray planes and
    4 cotangent planes at the march kernel's planes ``m_rays7``. Returns
    {mode: (ops, bytes)} and the partial rows' bytes per launch."""
    from ray_marching_tpu_torch.ops import backward_kernel as bk

    size = rays7.element_size()
    mat_bytes = sum(m.numel() for m in mats) * size

    def planes(r):
        n = r.shape[1] * r.shape[2]
        return n * size, -(-n // 128) * bk.partial_cols(prog) * size

    plane, partial = planes(rays7)
    m_plane, m_partial = planes(m_rays7)
    n_valid = int((rays7[6] > 0.5).sum())
    m_valid = int((m_rays7[6] > 0.5).sum())
    swept, k = n_valid * steps, bk.CKPT_INTERVAL
    work = {
        "history": (bk.backward_ops(prog, n_valid, swept),
                    19 * plane + (steps + 1) * 3 * plane + partial
                    + mat_bytes),
        "recompute": (bk.backward_ops(prog, n_valid, swept,
                                      recomputed_steps=swept),
                      21 * plane + partial + mat_bytes),
        # Two levels march every step once for the checkpoints and k - 1
        # of every k once more in the replay; the checkpoints are scratch.
        "two-level": (bk.backward_ops(
            prog, n_valid, swept,
            recomputed_steps=swept + swept * (k - 1) // k),
            21 * plane + partial + mat_bytes),
        "march-only": (bk.backward_ops(prog, m_valid, m_valid * steps,
                                       recomputed_steps=m_valid * steps,
                                       march_only=True),
                       17 * m_plane + m_partial + mat_bytes),
    }
    return work, partial


def bounds_of(work):
    """{name: (bound ms, what bounds it)} of {name: (ops, bytes)}."""
    out = {}
    for name, (ops, nbytes) in work.items():
        to, tb = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(to, tb), "operations" if to >= tb else "bytes")
    return out


def kernel_row(name, source, replaces, launches, ms, plain_ms, bound, card,
               **extra):
    """One entry of the kernels line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None, "card": card, **extra}


def neural_backward_vs_plain(label, prog, flat, mats, rays7, tau, tol,
                             track_min=False, modes=("history",), seed=0,
                             mat_tol=None):
    """The neural backward kernel against its plain version (same history),
    with ``modes`` among history, recompute and two-level bitwise equal to
    each other; ``mat_tol`` (default ``tol``) for the matrices. Returns the
    largest relative errors (rays, flat, matrices) and the largest absolute
    error of the ray cotangents."""
    mat_tol = tol if mat_tol is None else mat_tol
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    out, ex = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, tau, 5e-2,
                               track_min=track_min, log_hist=True, mats=mats)
    conv = (rays7[6] > 0.5) & (out[3].abs() < CONVERGED)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (9 if track_min else 8,) + tuple(rays7.shape[1:])),
        dtype=rays7.dtype).to(rays7.device)
    handoff = dict(hist=ex["hist"], nlive=ex["nlive"])
    if track_min:
        handoff.update(minf=out[8].contiguous(), amin=ex["amin"])
    kw = {"history": handoff, "recompute": {},
          "two-level": dict(two_level=True)}
    runs = {m: bk.fused_backward(prog, flat, rays7, g, NEURAL_STEPS, tau,
                                 5e-2, track_min=track_min, mats=mats,
                                 **kw[m]) for m in modes}
    plain = bk.reference_backward(prog, flat, rays7, g, NEURAL_STEPS, tau,
                                  5e-2, track_min=track_min, mats=mats,
                                  **handoff)
    torch.cuda.synchronize()
    first = runs[modes[0]]
    for m in modes[1:]:
        check(all(bool(same_bits(a, b).all()) for a, b in zip(
            [first[0], *first[1], first[2]],
            [runs[m][0], *runs[m][1], runs[m][2]])),
              f"{label}: {modes[0]} and {m} give different bits")
    e_rays = rel_err(first[2][:, conv], plain[2][:, conv])
    e_flat = rel_err(first[0], plain[0])
    e_mats = [rel_err(a, b) for a, b in zip(first[1], plain[1])]
    finite = (bool(torch.isfinite(first[0]).all())
              and all(bool(torch.isfinite(m).all()) for m in first[1])
              and bool(torch.isfinite(first[2][:, conv]).all()))
    print(f"neural backward {label}: {' == '.join(modes)} bitwise; vs plain "
          f"(relative to the largest entry; tolerance {tol:g}, matrices "
          f"{mat_tol:g}): ray "
          f"cotangents {e_rays:.3e} on {int(conv.sum())} converged rays, "
          f"flat {e_flat:.3e}, matrices "
          + " ".join(f"{e:.3e}" for e in e_mats)
          + f"; finite {finite}")
    check(finite, f"{label}: non-finite cotangents")
    check(max(e_rays, e_flat) <= tol and max(e_mats) <= mat_tol,
          f"{label}: kernel and plain disagree")
    check(not bool(first[2][:, rays7[6] < 0.5].any()),
          f"{label}: pad slots got a cotangent")
    abs_rays = float((first[2] - plain[2])[:, conv].abs().max())
    return e_rays, e_flat, max(e_mats), abs_rays


class UnroundedInputCotangents:
    """The control of the bf16 check: while active, the plain version's cast
    of a layer's input passes its cotangent back unrounded as well (the
    package rounds it, scene/neural.py), so no cotangent is rounded."""

    def __enter__(self):
        import torch

        from ray_marching_tpu_torch.scene import neural

        def straight(t):  # r - t is exact, so t + (r - t) is r
            return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()

        self._fn, neural._bf16 = neural._bf16, straight
        return self

    def __exit__(self, *exc):
        from ray_marching_tpu_torch.scene import neural

        neural._bf16 = self._fn


def neural_bf16_backward(prog, flat, mats, rays7, seed):
    """bf16 operands: the kernel (history, recompute and two-level bitwise
    equal) against the package's plain version, which follows the same bf16
    rule (TOL_NEURAL_BWD_BF16), and against a control without any cotangent
    rounding, which must fail the same limits. Returns {reference: (share
    of converged rays within BF16_RAY_RTOL, flat, matrices)}."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    label = f"f32 {NEURAL_F64_RES}x{NEURAL_F64_RES} w256 bf16 operands"
    out, ex = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2,
                               log_hist=True, mats=mats)
    conv = (rays7[6] > 0.5) & (out[3].abs() < CONVERGED)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (8,) + tuple(rays7.shape[1:])), dtype=rays7.dtype).to(rays7.device)
    handoff = dict(hist=ex["hist"], nlive=ex["nlive"])
    runs = [bk.fused_backward(prog, flat, rays7, g, NEURAL_STEPS, 0.0, 5e-2,
                              mats=mats, **kw)
            for kw in (handoff, {}, dict(two_level=True))]
    got = runs[0]
    check(all(bool(same_bits(a, b).all()) for r in runs[1:] for a, b in zip(
        [got[0], *got[1], got[2]], [r[0], *r[1], r[2]])),
          f"{label}: history, recompute and two-level give different bits")
    check(bool(torch.isfinite(got[0]).all())
          and all(bool(torch.isfinite(m).all()) for m in got[1])
          and bool(torch.isfinite(got[2][:, conv]).all()),
          f"{label}: non-finite cotangents")
    readings = {}
    for name in ("sound", "control"):
        if name == "sound":
            ref = bk.reference_backward(prog, flat, rays7, g, NEURAL_STEPS,
                                        0.0, 5e-2, mats=mats, **handoff)
        else:
            with UnroundedInputCotangents():
                ref = bk.reference_backward(prog, flat, rays7, g,
                                            NEURAL_STEPS, 0.0, 5e-2,
                                            mats=mats, **handoff)
        torch.cuda.synchronize()
        a, b = got[2][:, conv], ref[2][:, conv]
        per_ray = ((a - b).abs().amax(0)
                   / b.abs().amax(0).clamp_min(torch.finfo(b.dtype).tiny))
        q = torch.quantile(per_ray.double(), torch.tensor(
            [0.5, 0.9, 0.99], dtype=torch.float64, device=per_ray.device))
        readings[name] = (float((per_ray <= BF16_RAY_RTOL).double().mean()),
                          rel_err(got[0], ref[0]),
                          max(rel_err(x, y) for x, y in zip(got[1], ref[1])),
                          rel_err(a, b))
        share, e_flat, e_mats, e_rays = readings[name]
        print(f"neural backward {label} vs plain ({name}: cotangents of the "
              f"matrices f32, of the inputs "
              f"{'rounded' if name == 'sound' else 'f32'}): share of "
              f"{int(conv.sum())} converged rays within {BF16_RAY_RTOL:g} "
              f"{share:.4f} (per-ray relative difference quantiles 0.5 / 0.9 "
              f"/ 0.99: " + " / ".join(f"{float(v):.3e}" for v in q)
              + f"; largest over the largest entry {e_rays:.3e}), flat "
              f"{e_flat:.3e}, matrices {e_mats:.3e}")
        del ref
    min_share, flat_tol, mat_tol = TOL_NEURAL_BWD_BF16

    def within(r):
        return r[0] >= min_share and r[1] <= flat_tol and r[2] <= mat_tol

    print(f"neural backward {label}: limits share >= {min_share:g}, flat <= "
          f"{flat_tol:g}, matrices <= {mat_tol:g}; sound within "
          f"{within(readings['sound'])}, control within "
          f"{within(readings['control'])}")
    check(within(readings["sound"]), f"{label}: kernel and plain disagree")
    check(not within(readings["control"]),
          f"{label}: the limits do not tell the control from the kernel")
    check(not bool(got[2][:, rays7[6] < 0.5].any()),
          f"{label}: pad slots got a cotangent")
    return readings


def neural_training(card, out_dir: Path):
    """The neural training slice on the card: the backward kernel with the
    MLP's VJP against its plain version (512² f32 with the history; 128² f64
    with the three ways bitwise equal; tau = 1e-3, min_f, bf16 operands and
    the march-only mode), then the main path (3 counted
    optimize() steps on the w256 leaf: one forward and one backward launch
    each, no plain march or backward), render_with_alpha, the implicit
    backward (no backward launch), one Renderer(use_pallas=True) gradient,
    the CLI, timings, profile and bounds. Returns its rows of the kernels
    line."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.optim.inverse import InverseConfig
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer

    main, params = neural_renderer(NEURAL_RES, torch.float32)
    prog = main.program
    flat, mats, rays7 = neural_rays(main, params)
    errs = neural_backward_vs_plain(
        f"f32 {NEURAL_RES}x{NEURAL_RES} w256", prog, flat, mats, rays7, 0.0,
        TOL_NEURAL_BWD["f32"], modes=("history", "recompute", "two-level"),
        seed=31)
    small = NEURAL_F64_RES
    r64, p64 = neural_renderer(small, torch.float64)
    f_flat, f_mats, f_rays = neural_rays(r64, p64)
    neural_backward_vs_plain(
        f"f64 {small}x{small} w256", prog, f_flat, f_mats, f_rays, 0.0,
        TOL_NEURAL_BWD["f64"], modes=("history", "recompute", "two-level"),
        seed=32)
    r32, p32 = neural_renderer(small, torch.float32)
    s_flat, s_mats, s_rays = neural_rays(r32, p32)
    neural_backward_vs_plain(
        f"f32 {small}x{small} w256", prog, s_flat, s_mats, s_rays, 0.0,
        TOL_NEURAL_BWD["f32"], modes=("history", "recompute", "two-level"),
        seed=33)
    loose = {}
    loose["tau"] = neural_backward_vs_plain(
        f"f32 {small}x{small} w256 tau=1e-3", prog, s_flat, s_mats, s_rays,
        1e-3, TOL_NEURAL_BWD_LOOSE, modes=("history", "recompute"), seed=34)
    loose["min_f"] = neural_backward_vs_plain(
        f"f32 {small}x{small} w256 min_f", prog, s_flat, s_mats, s_rays, 0.0,
        TOL_NEURAL_BWD_LOOSE, track_min=True, modes=("history", "recompute"),
        seed=35)
    # The march-only mode, at the planes the modular Renderer gives it.
    modular = Renderer(neural_scene(),
                       dataclasses.replace(main.config, use_pallas=True),
                       dtype=torch.float32)
    _, _, ray_pos, ray_dirs = modular.camera.pose(modular._tensor(NEURAL_Q),
                                                  modular._tensor(NEURAL_T))
    m_rays7 = mk.rays_to_planes(ray_pos, ray_dirs).contiguous()
    g4 = torch.as_tensor(np.random.default_rng(36).standard_normal(
        (4,) + tuple(m_rays7.shape[1:])), dtype=torch.float32).to(
            m_rays7.device)
    m_ref = mk.reference_march(prog, flat, m_rays7, NEURAL_STEPS, 0.0,
                               mats)
    m_conv = (m_rays7[6] > 0.5) & (m_ref[3].abs() < CONVERGED)
    got = bk.march_backward(prog, flat, m_rays7, g4, NEURAL_STEPS, 0.0,
                            mats)
    want = bk.reference_backward(prog, flat, m_rays7, g4, NEURAL_STEPS,
                                 0.0, None, march_only=True, mats=mats)
    torch.cuda.synchronize()
    mb_errs = (rel_err(got[2][:, m_conv], want[2][:, m_conv]),
               rel_err(got[0], want[0]),
               max(rel_err(a, b) for a, b in zip(got[1], want[1])),
               float((got[2] - want[2])[:, m_conv].abs().max()))
    print(f"neural march backward (march-only mode, f32 {NEURAL_RES}x"
          f"{NEURAL_RES}) vs plain: rays {mb_errs[0]:.3e}, flat "
          f"{mb_errs[1]:.3e}, matrices {mb_errs[2]:.3e} (tolerance "
          f"{TOL_NEURAL_BWD['f32']:g})")
    check(max(mb_errs[:3]) <= TOL_NEURAL_BWD["f32"]
          and all(bool(torch.isfinite(m).all()) for m in got[1]),
          "neural march backward: kernel and plain disagree")
    del got, want, m_ref, g4
    rbf, pbf = neural_renderer(small, torch.float32,
                               scene=neural_scene("bfloat16"))
    bf_flat, bf_mats, bf_rays = neural_rays(rbf, pbf)
    loose["bf16"] = neural_bf16_backward(rbf.program, bf_flat, bf_mats,
                                         bf_rays, seed=38)
    del r64, p64, r32, p32, rbf, pbf, f_flat, f_mats, f_rays, s_flat, s_mats
    del s_rays, bf_flat, bf_mats, bf_rays

    # The main path, counted: optimize() on the seven c1 leaves, then its
    # first step again with two levels.
    target_r = FastRenderer(target_scene(), main.config, dtype=torch.float32,
                            grid_dtype=np.float32)
    with torch.no_grad():
        target = target_r.render(target_r.init_params, NEURAL_Q, NEURAL_T,
                                 mode=0, degree=1)
    del target_r
    # The field is trained already: Adam moves every weight by about the
    # rate, and 1e-3 is 5 % of a hidden weight (the loss then rises).
    cfg = InverseConfig(learning_rate=1e-5, steps=NEURAL_TRAIN_STEPS, mode=0,
                        degree=1, trainable=NEURAL_TRAINABLE)
    out, _, step_ms, train_launches, two_level_launches = drive_optimize(
        f"neural training main path (w256, {NEURAL_RES}x{NEURAL_RES}, "
        f"{NEURAL_STEPS} steps)", main, target, NEURAL_Q, NEURAL_T, cfg,
        params)
    moved = {p: float((v - trainable_leaves(params, NEURAL_TRAINABLE)[p])
                      .abs().max())
             for p, v in trainable_leaves(out["params"],
                                          NEURAL_TRAINABLE).items()}
    print("neural training: largest change per leaf "
          + " ".join(f"{k}={v:.3e}" for k, v in moved.items()))
    check(len(moved) == 7 and all(v > 0 for v in moved.values()),
          "neural training: a c1 leaf did not move")

    alpha_counts, _ = counted_gradient(main, params, NEURAL_Q, NEURAL_T,
                                       target, 1, alpha=True)
    implicit = FastRenderer(neural_scene(), dataclasses.replace(
        main.config, backward="implicit"), dtype=torch.float32)
    ift_counts, _ = counted_gradient(implicit, params, NEURAL_Q, NEURAL_T,
                                     target, 1)
    mod_counts, _ = counted_gradient(modular, params, NEURAL_Q, NEURAL_T,
                                     target, 1)
    print(f"neural gradients (launches: forward, backward, march, march "
          f"backward; plain marches, plain backwards; all finite): "
          f"render_with_alpha {alpha_counts}, backward='implicit' "
          f"{ift_counts}, Renderer(use_pallas=True) {mod_counts}")
    check(alpha_counts == (1, 1, 0, 0, 0, 0, True),
          "neural render_with_alpha gradient")
    check(ift_counts == (1, 0, 0, 0, 0, 0, True), "neural implicit gradient")
    check(mod_counts == (0, 0, 1, 1, 0, 0, True), "neural modular gradient")
    del implicit

    # The CLI's optimize on the JAX package's neural scene file.
    cli_optimize(["--scene-file", str(NEURAL_SCENE_FILE), "--width", "128",
                  "--height", "96", "--steps", "16", "--opt-steps", "2",
                  "--trainable", "c1"], 2)

    # Timing at the main configuration, a training step and its profile.
    times, turns = backward_timings(prog, flat, rays7, NEURAL_STEPS, m_rays7,
                                    2, mats=mats)
    step_ev_ms, prof = train_step_profile(
        main, params, NEURAL_TRAINABLE, NEURAL_Q, NEURAL_T, target, 1, 1e-3,
        2, 2, times)
    bwd_dev_ms = next((v for k, v in prof.items()
                       if k.startswith("void render_bwd_kernel<float")), None)
    busy_ms = sum(prof.values())
    print(f"neural training timing on {card} ({NEURAL_RES}x{NEURAL_RES}, "
          f"{NEURAL_STEPS} steps, f32): "
          + ", ".join(f"{m} {v:.3f} ms" for m, v in times.items())
          + " (turns " + ", ".join(f"{n} {v:.3f}" for n, v in turns)
          + f"); training step {step_ev_ms:.3f} ms (CUDA events), device "
          f"busy {busy_ms} ms, backward kernel {bwd_dev_ms} ms (profiler)")

    # Bounds: operations from the op counts (the MLP's VJP dominates),
    # bytes from the planes, the history, the matrices and the partial rows.
    work, partial_bytes = backward_work(prog, rays7, NEURAL_STEPS, m_rays7,
                                        mats)
    bounds = bounds_of(work)
    log = rk.BUILD_LOG.get(rk.kernel_key(prog), "")
    # The f32 history instantiation (no min_f, not two-level, not
    # march-only).
    regs = ptxas_entry(log, "render_bwd_kernel", "IfLb0ELb0ELb0EE")
    print(f"neural backward bounds ({prog.vjp_ops_per_eval} ops per SDF VJP, "
          f"{prog.ops_per_eval} per evaluation; partial rows "
          f"{partial_bytes} bytes per launch): "
          + "; ".join(f"{m} {o} ops, {nb} bytes -> {bounds[m][0]:.4f} ms "
                      f"({bounds[m][1]})" for m, (o, nb) in work.items())
          + f"; ptxas (f32, history): {regs[0]} registers, "
          f"{regs[1]} bytes stack, {regs[2]} bytes spilled")

    source = ("ray_marching_tpu_torch/ops/csrc/render_bwd.cu + "
              "ray_marching_tpu_torch/ops/csrc/neural.cuh")
    rows = [kernel_row(
        name, source, replaces + " + ray_marching_tpu/scene/neural.py:232",
        launches, times[mode], times[f"plain {mode}"
                                     if mode != "history" else "plain"],
        bounds[mode], card, max_abs_err=err[3], max_rel_err_rays=err[0],
        max_rel_err_flat=err[1], max_rel_err_mats=err[2])
        for name, mode, replaces, launches, err in (
            ("render_bwd_neural", "history",
             "ray_marching_tpu/ops/pallas_backward.py:119", train_launches,
             errs),
            ("render_bwd_two_level_neural", "two-level",
             "ray_marching_tpu/ops/pallas_backward.py:377",
             two_level_launches, errs),
            ("march_bwd_neural", "march-only",
             "ray_marching_tpu/ops/pallas_march.py:358", mod_counts[3],
             mb_errs))]
    rows[0].update(ms_recompute=times["recompute"],
                   bound_ms_recompute=bounds["recompute"][0],
                   launches_render_with_alpha=alpha_counts[1],
                   launches_implicit=ift_counts[1],
                   optimize_step_ms=step_ms, step_ms=step_ev_ms,
                   step_busy_ms=busy_ms, profiler_kernel_ms=bwd_dev_ms,
                   forward_with_history_ms=times["forward with history"],
                   partial_bytes=partial_bytes,
                   max_rel_err_tau_1e_3=max(loose["tau"][:3]),
                   max_rel_err_min_f=max(loose["min_f"][:3]),
                   bf16_share_rays_within=loose["bf16"]["sound"][0],
                   bf16_share_rays_within_control=loose["bf16"]["control"][0],
                   max_rel_err_bf16_mats=loose["bf16"]["sound"][2],
                   registers=regs[0], stack_bytes=regs[1],
                   spill_store_bytes=regs[2])
    return rows


def bulb_renderer(cls, width, height, dtype, steps=BULB_STEPS, tau=BULB_TAU,
                  **kw):
    """``cls`` (FastRenderer or Renderer) on the mandelbulb scene."""
    import torch

    from ray_marching_tpu_torch.scene import registry

    cfg = dataclasses.replace(config(width, height, **kw),
                              marching_steps=steps, tau=tau)
    return cls(registry.make_scene("mandelbulb"), cfg, dtype=dtype,
               grid_dtype=np.float64 if dtype == torch.float64
               else np.float32)


def with_scale(params, scale):
    """``params`` with the bulb's scale leaf (c1/child/scale) set."""
    import torch

    child = dict(params["c1"]["child"])
    child["scale"] = torch.full_like(child["scale"], scale)
    return dict(params, c1=dict(params["c1"], child=child))


def bulb_agreement(label, prog, flat, rays7, tau, control_flat):
    """Kernel vs plain version over every valid ray of the frame: the share
    whose 8 planes agree within TOL_F32 (at least BULB_MIN_AGREE), and the
    same share for the kernel at the control's parameters, which must fall
    below it. Returns (share, rays that disagree, control share)."""
    import torch

    from ray_marching_tpu_torch.ops import render_kernel as rk

    want = rk.reference_march_normals(prog, flat, rays7, BULB_STEPS, tau,
                                      5e-2)
    valid = rays7[6] > 0.5
    tol = torch.as_tensor(TOL_F32, dtype=want.dtype,
                          device=want.device)[:, None, None]

    def share(params):
        got = rk.fused_march_normals(prog, params, rays7, BULB_STEPS, tau,
                                     5e-2)
        ok = (((got - want).abs() <= tol)
              | (torch.isnan(got) & torch.isnan(want))).all(0)[valid]
        return float(ok.double().mean()), int((~ok).sum())

    agree, n_bad = share(flat)
    control, _ = share(control_flat)
    torch.cuda.synchronize()
    print(f"bulb agreement {label}: {agree:.6f} of {int(valid.sum())} valid "
          f"rays agree with the plain version on every plane ({n_bad} do "
          f"not; at least {BULB_MIN_AGREE}); the control (scale "
          f"{BULB_CONTROL_SCALE:g}) {control:.6f}")
    check(agree >= BULB_MIN_AGREE, f"bulb {label}: kernel and plain disagree")
    check(control < BULB_MIN_AGREE,
          f"bulb {label}: the limit does not tell the control apart")
    return agree, n_bad, control


def bulb_backward_vs_plain(label, prog, flat, rays7, tau, steps, f64, mode,
                           control_flat, seed):
    """One backward mode on the bulb against its plain version, ray by ray
    and leaf by leaf (BULB_RAY_RTOL, BULB_RAY_SHARE, BULB_LEAF_RTOL, with
    BULB_WILD), and two controls, which must fail the same limits: the
    kernel at ``control_flat`` (the scale moved by BULB_CONTROL_SCALE), and
    the kernel given every cotangent moved by up to BULB_CONTROL_G of
    itself. ``mode`` is ``history`` (the forward's history handed over),
    ``two-level`` or ``march-only`` (``rays7`` then the march kernel's
    planes). Returns the readings: share of converged rays within the limit,
    the largest per-ray and per-leaf relative differences, the largest
    absolute difference of the ray cotangents, the rays left out of the
    leaf sums, and each control's share and leaf difference."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    prec = "f64" if f64 else "f32"
    march_only = mode == "march-only"
    rng = np.random.default_rng(seed)
    shape = (4 if march_only else 8,) + tuple(rays7.shape[1:])
    g = torch.as_tensor(rng.standard_normal(shape),
                        dtype=rays7.dtype).to(rays7.device)
    g_moved = g * torch.as_tensor(
        1.0 + BULB_CONTROL_G * rng.uniform(-1.0, 1.0, shape),
        dtype=rays7.dtype).to(rays7.device)

    def kernel(params, rays, cot):
        if march_only:
            return bk.march_backward(prog, params, rays, cot, steps, tau)
        if mode == "two-level":
            got = bk.fused_backward(prog, params, rays, cot, steps, tau, 5e-2,
                                    two_level=True)
            check(bk.LAST_PATH["two_level"], f"{label}: two levels did not "
                                             "engage")
            return got
        _, ex = rk.march_forward(prog, params, rays, steps, tau, 5e-2,
                                 log_hist=True)
        return bk.fused_backward(prog, params, rays, cot, steps, tau, 5e-2,
                                 hist=ex["hist"], nlive=ex["nlive"])

    def plain(rays):
        return bk.reference_backward(
            prog, flat, rays, g, steps, tau, None if march_only else 5e-2,
            two_level=mode == "two-level", march_only=march_only)

    d = rk.fused_march_normals(prog, flat, rays7, steps, tau, 5e-2)[3]
    valid = rays7[6] > 0.5
    conv = valid & (d.abs() < CONVERGED)
    want = plain(rays7)
    size = want[2][:6].abs().amax(0)
    tiny = torch.finfo(rays7.dtype).tiny
    check(bool(torch.isfinite(want[2][:, conv]).all()),
          f"{label}: non-finite plain ray cotangents")
    median = float(size[conv].median())
    tame = valid & (size <= BULB_WILD * median)
    tame_rays = rays7.clone()
    tame_rays[6] = tame.to(rays7.dtype)
    want_tame = plain(tame_rays)[0][prog.scalar_offsets]

    def readings(params, cot):
        got = kernel(params, rays7, cot)
        diff = (got[2][:6] - want[2][:6]).abs().amax(0)
        per_ray = (diff / size.clamp_min(tiny))[conv]
        leaves = kernel(params, tame_rays, cot)[0][prog.scalar_offsets]
        per_leaf = ((leaves - want_tame).abs()
                    / want_tame.abs().clamp_min(tiny))
        finite = (bool(torch.isfinite(got[2][:, conv]).all())
                  and bool(torch.isfinite(leaves).all()))
        return (float((per_ray <= BULB_RAY_RTOL[prec]).double().mean()),
                float(per_ray.max()), float(per_leaf.max()),
                float(diff[conv].max()), finite,
                torch.quantile(per_ray.double(), torch.tensor(
                    [0.5, 0.99, 0.999], dtype=torch.float64,
                    device=per_ray.device)).tolist(), per_leaf.tolist())

    runs = {"kernel": readings(flat, g),
            "control scale": readings(control_flat, g),
            "control cotangents": readings(flat, g_moved)}
    torch.cuda.synchronize()

    def within(r):
        return r[0] >= BULB_RAY_SHARE and r[2] <= BULB_LEAF_RTOL[prec]

    n_wild = int((valid & ~tame).sum())
    for name, r in runs.items():
        print(f"bulb backward {label} {mode} vs plain, {name}: share of "
              f"{int(conv.sum())} converged rays within "
              f"{BULB_RAY_RTOL[prec]:g} of their own largest cotangent "
              f"{r[0]:.6f} (quantiles 0.5 / 0.99 / 0.999 "
              + " / ".join(f"{v:.3e}" for v in r[5])
              + f", largest {r[1]:.3e}; largest absolute {r[3]:.3e}); "
              f"largest leaf difference over its own size {r[2]:.3e} on the "
              f"rays within {BULB_WILD:g}x the median ray's {median:.3e} "
              f"({n_wild} of {int(valid.sum())} left out; each leaf "
              + " ".join(f"{v:.1e}" for v in r[6])
              + f"); finite {r[4]}; within the limits {within(r)}")
    sound = runs["kernel"]
    check(sound[4] and within(sound), f"{label} {mode}: kernel and plain "
                                      "disagree")
    for name in ("control scale", "control cotangents"):
        check(not within(runs[name]),
              f"{label} {mode}: the limits do not tell the {name} apart")
    return {"ray_share_within": sound[0], "max_rel_err_rays": sound[1],
            "max_rel_err_leaves": sound[2], "max_abs_err": sound[3],
            "rays_left_out_of_leaves": n_wild,
            "ray_share_within_control_scale": runs["control scale"][0],
            "max_rel_err_leaves_control_scale": runs["control scale"][2],
            "ray_share_within_control_cotangents":
                runs["control cotangents"][0],
            "max_rel_err_leaves_control_cotangents":
                runs["control cotangents"][2]}


def bulb_ptxas(log):
    """(entry, registers, stack frame bytes, spill store bytes) of every
    kernel in a build's ``-Xptxas -v`` report."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", chunk)
        out.append((chunk.split("'")[0], int(regs.group(1)),
                    int(frame.group(1)), int(frame.group(2))))
    return out


def bulb_slice(card, out_dir: Path):
    """The Mandelbulb slice on the card: the bulb's library (registers,
    stack), every kernel against its plain version (forward at tau = 1e-4
    and 0 with the agreement limit and its control, the training outputs,
    the backward with history and recompute, the march and its backward,
    the two-level backward; each backward mode ray by ray and leaf by leaf
    with its controls; f32 at 1440×900, f64 at 256×160), then the main
    paths, counted: the README's serving command, 20 FastRenderer frames and
    20 Renderer(use_pallas=True) frames, 3 optimize() steps on the scale
    leaf, one two-level step, one modular gradient and the CLI's optimize;
    timings, profiles and bounds. Returns its rows of the kernels line."""
    import torch

    from ray_marching_tpu_torch.cli import main as cli_main
    from ray_marching_tpu_torch.io.image import write_png
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.ops.params import split_params_padded
    from ray_marching_tpu_torch.optim.inverse import InverseConfig
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer

    main = bulb_renderer(FastRenderer, BULB_W, BULB_H, torch.float32)
    prog = main.program
    key = rk.kernel_key(prog)
    entries = bulb_ptxas(rk.BUILD_LOG.get(key, ""))
    print(f"bulb library {key}: {prog.ops_per_eval} ops per SDF evaluation, "
          f"{prog.vjp_ops_per_eval} per SDF VJP; ptxas (registers, stack "
          "bytes, spill store bytes): "
          + "; ".join(f"{e[:40]} {r} {f} {sp}" for e, r, f, sp in entries))
    errs = {}

    # 1. Kernels vs plain versions, f32 at the main paths' planes: the
    # fused kernels at FastRenderer's, the march kernel and its backward at
    # the modular Renderer's.
    flat, rays7 = main_rays(main, BENCH_Q, BENCH_T)
    modular = bulb_renderer(Renderer, BULB_W, BULB_H, torch.float32,
                            use_pallas=True)
    m_flat, m_rays7 = modular_rays(modular, BENCH_Q, BENCH_T)
    control_flat, _, _ = split_params_padded(
        with_scale(main.init_params, BULB_CONTROL_SCALE), torch.float32,
        main.device)
    label = f"f32 {BULB_W}x{BULB_H} mandelbulb"
    for tau in (BULB_TAU, 0.0):
        errs[("fwd", tau)] = compare(f"{label} tau={tau:g}", prog, flat,
                                     rays7, tau, False, steps=BULB_STEPS)
    errs["agree"] = bulb_agreement(f"{label} tau={BULB_TAU:g}", prog, flat,
                                   rays7, BULB_TAU, control_flat)
    ref = compare_training_outputs(f"{label} tau={BULB_TAU:g}", prog, flat,
                                   rays7, BULB_TAU, steps=BULB_STEPS)
    _, masked = compare_backward(f"{label} tau={BULB_TAU:g}", prog, flat,
                                 rays7, BULB_TAU, False, ref, 61,
                                 steps=BULB_STEPS)
    check(not masked, f"{label}: plain backward non-finite on the main path")
    del ref
    errs["march"], _ = compare_march(
        f"{label} tau={BULB_TAU:g}", prog, m_flat, m_rays7, BULB_TAU, False,
        backward=True, steps=BULB_STEPS)
    compare_two_level(f"{label} tau=0 {BULB_TRAIN_MARCH} steps", prog, flat,
                      rays7, False, 62, steps=BULB_TRAIN_MARCH)

    def by_ray(lab, f_flat, f_rays, m_flat_, m_rays, ctrl, f64, runs):
        """bulb_backward_vs_plain for each (steps, tau, modes) of ``runs``;
        the march-only mode at the march kernel's planes."""
        for steps, tau, modes in runs:
            for i, mode in enumerate(modes):
                march = mode == "march-only"
                errs[(mode, steps, tau, f64)] = bulb_backward_vs_plain(
                    f"{lab} {steps} steps tau={tau:g}", prog,
                    m_flat_ if march else f_flat, m_rays if march else f_rays,
                    tau, steps, f64, mode, ctrl, 70 + i)

    # Each backward mode ray by ray and leaf by leaf: at the serving
    # configuration and at the training one.
    by_ray(label, flat, rays7, m_flat, m_rays7, control_flat, False,
           ((BULB_STEPS, BULB_TAU, ("history", "march-only")),
            (BULB_TRAIN_MARCH, 0.0, ("history", "two-level", "march-only"))))
    # tau = 0 at 64 steps: the f32 parameter cotangent overflows in the
    # kernel and the plain version alike (BULB_TRAIN_MARCH says why).
    out0, ex0 = rk.march_forward(prog, flat, rays7, BULB_STEPS, 0.0, 5e-2,
                                 log_hist=True)
    g0 = torch.as_tensor(np.random.default_rng(63).standard_normal(
        (8,) + tuple(rays7.shape[1:])), dtype=torch.float32).to(rays7.device)
    finite = [bool(torch.isfinite(r[0][prog.scalar_offsets]).all()) for r in (
        bk.fused_backward(prog, flat, rays7, g0, BULB_STEPS, 0.0, 5e-2,
                          hist=ex0["hist"], nlive=ex0["nlive"]),
        bk.reference_backward(prog, flat, rays7, g0, BULB_STEPS, 0.0, 5e-2,
                              hist=ex0["hist"], nlive=ex0["nlive"]))]
    print(f"bulb backward {label} tau=0 {BULB_STEPS} steps: parameter "
          f"cotangent finite: kernel {finite[0]}, plain version {finite[1]} "
          "(the derivative of the march grows with the steps a converged ray "
          "takes at the fractal's surface)")
    del out0, ex0, g0

    # f64 at 256×160, tight limits.
    r64 = bulb_renderer(FastRenderer, BULB_F64_W, BULB_F64_H, torch.float64)
    f_flat, f_rays = main_rays(r64, BENCH_Q, BENCH_T)
    m64 = bulb_renderer(Renderer, BULB_F64_W, BULB_F64_H, torch.float64,
                        use_pallas=True)
    mf_flat, mf_rays = modular_rays(m64, BENCH_Q, BENCH_T)
    f_control, _, _ = split_params_padded(
        with_scale(r64.init_params, BULB_CONTROL_SCALE), torch.float64,
        r64.device)
    label64 = f"f64 {BULB_F64_W}x{BULB_F64_H} mandelbulb"
    for tau in (BULB_TAU, 0.0):
        lab = f"{label64} tau={tau:g}"
        compare(lab, prog, f_flat, f_rays, tau, True, steps=BULB_STEPS)
        ref = compare_training_outputs(lab, prog, f_flat, f_rays, tau,
                                       steps=BULB_STEPS)
        _, masked = compare_backward(lab, prog, f_flat, f_rays, tau, True,
                                     ref, 64, steps=BULB_STEPS)
        check(not masked, f"{lab}: plain backward non-finite")
        compare_march(lab, prog, mf_flat, mf_rays, tau, True, backward=True,
                      steps=BULB_STEPS)
    compare_two_level(f"{label64} tau=0", prog, f_flat, f_rays, True, 65,
                      steps=BULB_STEPS)
    by_ray(label64, f_flat, f_rays, mf_flat, mf_rays, f_control, True,
           ((BULB_STEPS, BULB_TAU, ("history", "march-only")),
            (BULB_STEPS, 0.0, ("history", "two-level", "march-only"))))
    f64_runs = [v for k, v in errs.items() if len(k) == 4 and k[3]]
    del r64, m64, f_flat, f_rays, mf_flat, mf_rays, f_control, ref

    # 2. Serving, counted: the README's command, then 20 frames of the
    # same configuration through FastRenderer and through the modular
    # Renderer(use_pallas=True), timed with CUDA events.
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    rk.LAUNCHES = mk.LAUNCHES = 0
    with PlainMarchCalls() as plain:
        cli_main(BULB_CLI + ["-o", str(out_dir / "mandelbulb_cli.png")])
        torch.cuda.synchronize()
    cli_launches = rk.LAUNCHES
    check(cli_launches == 1 and plain.n == 0,
          f"bulb cli render: {cli_launches} launches, {plain.n} plain")
    params = main.init_params

    def frames(renderer, counter):
        renderer.render(params, BENCH_Q, BENCH_T, mode=BULB_MODE, degree=2)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        counter.LAUNCHES = 0
        with torch.no_grad(), PlainMarchCalls() as plain:
            start.record()
            for _ in range(BULB_FRAMES):
                img = renderer.render(params, BENCH_Q, BENCH_T,
                                      mode=BULB_MODE, degree=2)
            stop.record()
            torch.cuda.synchronize()
        return (img, counter.LAUNCHES, plain.n,
                start.elapsed_time(stop) / BULB_FRAMES)

    frame, launches, n_plain, frame_ms = frames(main, rk)
    mod_frame, mod_launches, m_plain, mod_ms = frames(modular, mk)
    print(f"bulb serving ({BULB_W}x{BULB_H}, {BULB_STEPS} steps, tau "
          f"{BULB_TAU:g}, mode normal): cli render 1 launch; FastRenderer "
          f"{BULB_FRAMES} frames, forward launches {launches}, plain marches "
          f"{n_plain}, {frame_ms:.4f} ms per frame; Renderer(use_pallas="
          f"True) {BULB_FRAMES} frames, march launches {mod_launches}, plain "
          f"marches {m_plain}, {mod_ms:.4f} ms per frame (CUDA events)")
    check((launches, n_plain, mod_launches, m_plain)
          == (BULB_FRAMES, 0, BULB_FRAMES, 0), "bulb serving: launches")
    shape = (1, BULB_H, BULB_W, 3)
    for name, img in (("mandelbulb_normal", frame),
                      ("mandelbulb_modular_normal", mod_frame)):
        check(tuple(img.shape) == shape and bool(torch.isfinite(img).all()),
              f"{name}: shape or non-finite pixels")
        write_png(out_dir / f"{name}.png", img)
    with torch.no_grad():
        hit, _ = main._march_planes(params, *main._pose_planes(
            *main._pose(BENCH_Q, BENCH_T)), BULB_STEPS)
        conv = main._assemble([(hit[3].abs() < CONVERGED).to(torch.float32)]
                              ) > 0.5
    diff = (mod_frame - frame).abs()[conv.expand_as(frame)]
    share = float((diff > MODULAR_VS_FAST_ATOL).float().mean())
    print(f"bulb modular frame vs FastRenderer frame: {int(conv.sum())} "
          f"converged pixels, max abs diff {float(diff.max()):.3e}, share "
          f"above {MODULAR_VS_FAST_ATOL:g} {share:.3e}")
    check(share <= MAX_SHARE_OUT_F32, "bulb modular and fast frames differ")
    del hit, conv, diff, frame, mod_frame

    # 3. Training, counted: optimize() on the scale leaf at the training
    # configuration (BULB_TRAIN_MARCH march steps, tau = 0), its first step
    # again with two levels, one gradient through the modular
    # Renderer(use_pallas=True) and the CLI's optimize.
    trainer = bulb_renderer(FastRenderer, BULB_W, BULB_H, torch.float32,
                            steps=BULB_TRAIN_MARCH, tau=0.0)
    with torch.no_grad():
        target = trainer.render(params, BENCH_Q, BENCH_T, mode=0, degree=2)
    start_params = with_scale(params, BULB_SCALE0)
    cfg = InverseConfig(learning_rate=1e-2, steps=BULB_TRAIN_STEPS, mode=0,
                        degree=2, trainable=["c1/child/scale"])
    out, grads, step_ms, train_launches, two_level_launches = drive_optimize(
        f"bulb training ({BULB_W}x{BULB_H}, {BULB_TRAIN_MARCH} steps, tau 0, "
        f"scale from {BULB_SCALE0})", trainer, target, BENCH_Q, BENCH_T, cfg,
        start_params)
    scales = [float(g["c1/child/scale"]) for g in grads]
    print(f"bulb training: scale -> "
          f"{float(out['params']['c1']['child']['scale']):.6f}")
    check(all(v != 0.0 for v in scales), "bulb training: zero scale gradient")
    mod_train = bulb_renderer(Renderer, BULB_W, BULB_H, torch.float32,
                              steps=BULB_TRAIN_MARCH, tau=0.0,
                              use_pallas=True)
    mod_counts, leaves = counted_gradient(mod_train, start_params, BENCH_Q,
                                          BENCH_T, target, 2)
    mod_grad = float(leaves["c1"]["child"]["scale"].grad)
    print(f"bulb modular gradient (launches: forward, backward, march, march "
          f"backward; plain marches, plain backwards; all finite) "
          f"{mod_counts}; scale gradient {mod_grad:.6e}")
    check(mod_counts == (0, 0, 1, 1, 0, 0, True) and mod_grad != 0.0,
          "bulb modular gradient")
    del leaves, mod_train
    cli_optimize(["--scene", "mandelbulb", "--target", "selftest",
                  "--trainable", "c1/child/scale", "--steps",
                  str(BULB_TRAIN_MARCH), "--opt-steps", "2"], 2)

    # 4. Timing at the main paths' own inputs: serving at the scene's
    # parameters, training at the start of the fit. At tau = 0 every ray
    # sweeps every step: the kernels' work does not depend on where Adam
    # has moved the scale.
    s2 = BULB_TRAIN_MARCH
    t_flat, _, _ = split_params_padded(start_params, torch.float32,
                                       main.device)
    ms = kernel_ms(lambda: rk.fused_march_normals(prog, flat, rays7,
                                                BULB_STEPS, BULB_TAU, 5e-2),
                 20)
    ms_tau0 = kernel_ms(lambda: rk.fused_march_normals(
        prog, flat, rays7, BULB_STEPS, 0.0, 5e-2), 10)
    plain_ms = cuda_ms(lambda: rk.reference_march_normals(
        prog, flat, rays7, BULB_STEPS, BULB_TAU, 5e-2), 1)
    march_ms = kernel_ms(lambda: mk.march_planes(prog, m_flat, m_rays7,
                                               BULB_STEPS, BULB_TAU), 20)
    march_plain_ms = cuda_ms(lambda: mk.reference_march(
        prog, m_flat, m_rays7, BULB_STEPS, BULB_TAU), 1)
    times, turns = backward_timings(prog, t_flat, rays7, s2, m_rays7, 3)
    # The backward with history at the serving configuration, for the
    # record.
    g8 = torch.as_tensor(np.random.default_rng(66).standard_normal(
        (8,) + tuple(rays7.shape[1:])), dtype=torch.float32).to(rays7.device)
    _, ex_h = rk.march_forward(prog, flat, rays7, BULB_STEPS, BULB_TAU,
                               5e-2, log_hist=True)
    bwd_serving_ms = kernel_ms(lambda: bk.fused_backward(
        prog, flat, rays7, g8, BULB_STEPS, BULB_TAU, 5e-2, hist=ex_h["hist"],
        nlive=ex_h["nlive"]), 3)
    del ex_h, g8
    step_ev_ms, step_prof = train_step_profile(
        trainer, start_params, cfg.trainable, BENCH_Q, BENCH_T, target, 2,
        1e-2, 5, 3, times)
    frame_prof = profile_frames(
        lambda: main.render(params, BENCH_Q, BENCH_T, mode=BULB_MODE,
                            degree=2), frame_ms, frames=3,
        expect={"void render_fwd_kernel<float>": (ms, 1)})
    print(f"bulb timing on {card} ({BULB_W}x{BULB_H}, f32): serving "
          f"({BULB_STEPS} steps, tau {BULB_TAU:g}): forward kernel "
          f"{ms:.4f} ms ({ms_tau0:.4f} at tau 0), plain {plain_ms:.3f} ms; "
          f"march kernel {march_ms:.4f} ms, plain {march_plain_ms:.3f} ms; "
          f"training ({s2} steps, tau 0, scale {BULB_SCALE0}): "
          + ", ".join(f"{m} {v:.4f} ms" for m, v in times.items())
          + " (turns " + ", ".join(f"{n} {v:.4f}" for n, v in turns)
          + f"); backward with history at the serving configuration "
          f"{bwd_serving_ms:.4f} ms; training step {step_ev_ms:.4f} ms (CUDA "
          f"events), device busy {sum(step_prof.values()):.4f} ms "
          f"(profiler); serving frame {frame_ms:.4f} ms, busy "
          f"{sum(frame_prof.values()):.4f} ms")

    # 5. Bounds from this run's inputs: operations from the op counts and
    # the steps the rays really took, bytes from the planes, the history
    # and the partial rows, each read or written once.
    n_valid = int((rays7[6] > 0.5).sum())
    live_sum, n_frozen = live_steps(prog, flat, rays7, BULB_STEPS, BULB_TAU)
    m_valid = int((m_rays7[6] > 0.5).sum())
    m_live, m_frozen = live_steps(prog, m_flat, m_rays7, BULB_STEPS,
                                  BULB_TAU)
    plane = rays7.shape[1] * rays7.shape[2] * rays7.element_size()
    m_plane = m_rays7.shape[1] * m_rays7.shape[2] * m_rays7.element_size()
    work, _ = backward_work(prog, rays7, s2, m_rays7)
    work.update({
        "forward": (forward_ops_live(prog, n_valid, live_sum, n_frozen),
                    15 * plane),
        # A march evaluates once per live step, once where it froze and
        # once at its end.
        "march": ((m_live + m_frozen + m_valid) * prog.ops_per_eval
                  + m_live * rk.OPS_PER_STEP, 11 * m_plane),
    })
    bounds = bounds_of(work)
    print(f"bulb bounds (serving: live steps per valid ray "
          f"{live_sum / n_valid:.3f}, march {m_live / m_valid:.3f}): "
          + "; ".join(f"{n} {work[n][0]} ops, {work[n][1]} bytes -> "
                      f"{b:.4f} ms ({by})" for n, (b, by) in bounds.items()))

    regs = {e: (r, f, sp) for e, r, f, sp in entries}

    def ptx(kernel, args):
        r, f, sp = next((v for e, v in regs.items()
                         if re.match(r"_Z\d+" + kernel + args, e)),
                        (None, None, None))
        return {"registers": r, "stack_bytes": f, "spill_store_bytes": sp}

    rows = [kernel_row(
        name, f"ray_marching_tpu_torch/ops/csrc/{source}",
        f"ray_marching_tpu/ops/{replaces}", n, t, p_ms, bounds[work_key],
        card, scene="mandelbulb", **ptx(*ptx_key), **err)
        for name, source, replaces, n, t, p_ms, work_key, ptx_key, err in (
            ("render_fwd_bulb", "render_fwd.cu", "pallas_render.py:227",
             launches + cli_launches, ms, plain_ms, "forward",
             ("render_fwd_kernel", "IfE"),
             {"max_abs_err": errs[("fwd", BULB_TAU)]}),
            ("march_bulb", "march.cu", "pallas_march.py:173", mod_launches,
             march_ms, march_plain_ms, "march", ("march_kernel", "IfE"),
             {"max_abs_err": errs["march"]}),
            ("render_bwd_bulb", "render_bwd.cu", "pallas_backward.py:119",
             train_launches, times["history"], times["plain"], "history",
             ("render_bwd_kernel", "IfLb0ELb0ELb0EE"),
             errs[("history", s2, 0.0, False)]),
            ("render_bwd_two_level_bulb", "render_bwd.cu",
             "pallas_backward.py:377", two_level_launches,
             times["two-level"], times["plain two-level"], "two-level",
             ("render_bwd_kernel", "IfLb0ELb1ELb0EE"),
             errs[("two-level", s2, 0.0, False)]),
            ("march_bwd_bulb", "render_bwd.cu", "pallas_march.py:358",
             mod_counts[3], times["march-only"], times["plain march-only"],
             "march-only", ("render_bwd_kernel", "IfLb0ELb0ELb1EE"),
             errs[("march-only", s2, 0.0, False)]))]
    rows[0].update(ms_tau_0=ms_tau0, frame_ms=frame_ms,
                   agree_share=errs["agree"][0],
                   disagreeing_rays=errs["agree"][1],
                   agree_share_control=errs["agree"][2],
                   profiler_kernel_ms=next(
                       (v for k_, v in frame_prof.items()
                        if k_.startswith("void render_fwd_kernel<float>")),
                       None))
    rows[1].update(frame_ms=mod_ms)
    serving = {mode: errs[(mode, BULB_STEPS, BULB_TAU, False)]
               for mode in ("history", "march-only")}
    for row in rows[2:]:
        row.update(steps=s2, f64_min_ray_share_within=min(
            r["ray_share_within"] for r in f64_runs),
            f64_max_rel_err_leaves=max(
                r["max_rel_err_leaves"] for r in f64_runs))
    rows[2].update(ms_recompute=times["recompute"],
                   bound_ms_recompute=bounds["recompute"][0],
                   ms_serving_configuration=bwd_serving_ms,
                   forward_with_history_ms=times["forward with history"],
                   step_ms=step_ev_ms, step_busy_ms=sum(step_prof.values()),
                   optimize_step_ms=step_ms, losses=out["losses"],
                   scale_gradients=scales,
                   profiler_kernel_ms=next(
                       (v for k_, v in step_prof.items()
                        if k_.startswith("void render_bwd_kernel<float")),
                       None),
                   **{f"serving_{k}": v
                      for k, v in serving["history"].items()})
    rows[4].update(**{f"serving_{k}": v
                      for k, v in serving["march-only"].items()})
    return rows


def run(out_dir: Path):
    import torch

    t_start = time.perf_counter()

    from ray_marching_tpu_torch.io.image import write_png
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer
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

    # 1. Build every kernel of the run, all nvcc processes together: the
    # analytic scenes, the neural slices' scenes, the analytic target of
    # the weights check and the Mandelbulb.
    scenes = ("test_scene2", "test_scene")
    programs = {s: SdfProgram(registry.make_scene(s)) for s in scenes}
    programs.update({
        "neural w256": SdfProgram(neural_scene()),
        "neural w256 bf16": SdfProgram(neural_scene("bfloat16")),
        "neural_demo": SdfProgram(registry.make_scene("neural_demo")),
        "distillation target": SdfProgram(target_scene()),
        "mandelbulb": SdfProgram(registry.make_scene("mandelbulb")),
    })
    t0 = time.perf_counter()
    rk.build_kernels(programs.values())
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(programs)} "
          "scene libraries")
    for s, p in programs.items():
        key = rk.kernel_key(p)
        print(f"ptxas report ({s}, {key}, units "
              f"{', '.join(rk.KERNEL_UNITS)}):")
        print(rk.BUILD_LOG.get(key, "(built before this run)").strip())
    for s, digest in PER_THREAD_SOURCES.items():
        check(not programs[s].tc and hashlib.sha256(
            programs[s].cuda_source().encode()).hexdigest() == digest,
              f"{s}: the generated source is not the per-thread one")
    print("generated sources without a tensor-core MLP leaf ("
          + ", ".join(PER_THREAD_SOURCES) + "): byte-identical to the "
          "per-thread generator's (sha256); with one: "
          + ", ".join(s for s, p in programs.items() if p.tc))

    # 2. Kernels vs plain versions on the card: the forward's serving
    # configuration, its training outputs, the backward (history on and
    # off bitwise equal, with and without min_f), the march kernel (also
    # against planes 0-3 of the fused kernel) with its backward, and the
    # two-level backward (bitwise equal to the other two paths). The fused
    # kernels see FastRenderer's planes, the march kernel and its backward
    # the planes the modular Renderer gives them.
    cfg = config(1920, 1080)
    main = FastRenderer(registry.make_scene("test_scene2"), cfg,
                        dtype=torch.float32)
    max_err = bwd_err = march_err = march_bwd_err = two_level_err = None
    seed = 100
    for s in scenes:
        r = main if s == "test_scene2" else FastRenderer(
            registry.make_scene(s), cfg, dtype=torch.float32)
        flat, rays7 = main_rays(r, BENCH_Q, BENCH_T)
        m_flat, m_rays7 = modular_rays(
            Renderer(registry.make_scene(s), config(1920, 1080,
                                                    use_pallas=True),
                     dtype=torch.float32), BENCH_Q, BENCH_T)
        for tau in (0.0, 1e-3):
            label = f"f32 1080p {s} tau={tau:g}"
            err = compare(label, r.program, flat, rays7, tau, f64=False)
            ref = compare_training_outputs(label, r.program, flat, rays7, tau)
            seed += 1
            errs, masked = compare_backward(label, r.program, flat, rays7,
                                            tau, False, ref, seed)
            # The main path's scene is held at the main path's own inputs.
            check(not (masked and s == "test_scene2"),
                  f"{label}: plain backward non-finite on the main path")
            # The march's backward is held at the main path's scene: on the
            # open test_scene its f32 parameter cotangent overflows like the
            # fused backward's (compare_backward above says so when it does).
            m_err, mb_err = compare_march(label, r.program, m_flat, m_rays7,
                                          tau, False,
                                          backward=s == "test_scene2")
            if s == "test_scene2" and tau == 0.0:
                max_err, bwd_err = err, errs
                march_err, march_bwd_err = m_err, mb_err
                two_level_err = compare_two_level(label, r.program, flat,
                                                  rays7, False, seed + 50)
            del ref
        del r, flat, rays7, m_flat, m_rays7
    for s in scenes:
        r = FastRenderer(registry.make_scene(s), config(256, 192),
                         dtype=torch.float64, grid_dtype=np.float64)
        flat, rays7 = main_rays(r, BENCH_Q, BENCH_T)
        m_flat, m_rays7 = modular_rays(
            Renderer(registry.make_scene(s), config(256, 192,
                                                    use_pallas=True),
                     dtype=torch.float64, grid_dtype=np.float64),
            BENCH_Q, BENCH_T)
        for tau in (0.0, 1e-3):
            label = f"f64 256x192 {s} tau={tau:g}"
            compare(label, r.program, flat, rays7, tau, f64=True)
            ref = compare_training_outputs(label, r.program, flat, rays7, tau)
            seed += 1
            compare_backward(label, r.program, flat, rays7, tau, True, ref,
                             seed)
            compare_march(label, r.program, m_flat, m_rays7, tau, True,
                          backward=True)
            if s == "test_scene2" and tau == 0.0:
                compare_two_level(label, r.program, flat, rays7, True,
                                  seed + 50)

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

    # 3b. The training paths, counted: optimize() through render and through
    # render_with_alpha, one forward and one backward launch per step.
    hist_losses, fwd_train, bwd_train, step_s = drive_training(main,
                                                               TRAIN_STEPS)
    _, fwd_sil, bwd_sil, sil_step_s = drive_training(main, SILHOUETTE_STEPS,
                                                     silhouette=True)
    # The implicit backward: the same forward kernel, then plain torch at
    # the endpoint, so no backward launch.
    implicit = FastRenderer(registry.make_scene("test_scene2"),
                            config(1920, 1080, backward="implicit"),
                            dtype=torch.float32)
    _, fwd_ift, _, ift_step_s = drive_training(implicit, IMPLICIT_STEPS,
                                               bwd_per_step=0)
    del implicit
    # The two-level backward: one forward launch without a history and one
    # backward launch per step; its gradients are bitwise the history
    # path's, so the losses repeat the first ones of the first run (the same
    # set-up with the history).
    hist_losses = hist_losses[:TWO_LEVEL_STEPS]
    losses_2l, fwd_2l, bwd_2l, step_2l_s = drive_training(
        main, TWO_LEVEL_STEPS, two_level=True)
    check(np.allclose(losses_2l, hist_losses, rtol=1e-6, atol=0.0),
          f"two-level losses {losses_2l} differ from the history run's "
          f"{hist_losses}")

    # 3c. The modular pipeline at full width through the march kernel.
    (modular, bouncer, march_launches, n_marches,
     march_bwd_launches) = drive_modular(main, out_dir)

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
    golden_gradients(Path(__file__).resolve().parent)
    golden_bounce(Path(__file__).resolve().parent)

    # 5. Timing at the main path's shapes.
    flat, rays7 = main_rays(main, BENCH_Q, BENCH_T)
    prog = main.program
    ms = kernel_ms(lambda: rk.fused_march_normals(prog, flat, rays7, STEPS,
                                                0.0, 5e-2), 50)
    plain_ms = cuda_ms(lambda: rk.reference_march_normals(
        prog, flat, rays7, STEPS, 0.0, 5e-2), 3)
    q, t = poses[0]
    frame_ms = cuda_ms(lambda: main.render(main.init_params, q, t, mode=0,
                                           degree=2), 20)
    tau_ms = kernel_ms(lambda: rk.fused_march_normals(prog, flat, rays7, STEPS,
                                                    1e-3, 5e-2), 50)
    n_valid = int((rays7[6] > 0.5).sum())
    plane_bytes = rays7.shape[1] * rays7.shape[2] * rays7.element_size()
    ops = rk.kernel_ops(prog, n_valid, STEPS)
    nbytes = 15 * plane_bytes
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    live_sum, n_frozen = live_steps(prog, flat, rays7, STEPS, 1e-3)
    tau_ops = forward_ops_live(prog, n_valid, live_sum, n_frozen)
    print(f"timing on {card}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"frame (FastRenderer.render) {frame_ms:.4f} ms; bound: "
          f"{ops} ops ({prog.ops_per_eval} per SDF evaluation) -> "
          f"{t_ops:.4f} ms, {nbytes} bytes -> {t_bytes:.4f} ms; kernel at "
          f"tau=1e-3 {tau_ms:.4f} ms, mean live steps "
          f"{live_sum / n_valid:.3f}, {tau_ops} ops -> "
          f"{tau_ops / PEAK_F32_FLOPS * 1e3:.4f} ms")
    prof = profile_frames(lambda: main.render(main.init_params, q, t,
                                              mode=0, degree=2), frame_ms,
                          expect={"void render_fwd_kernel<float>": (ms, 1)})
    kernel_dev_ms = next((v for k, v in prof.items()
                          if k.startswith("void render_fwd_kernel<float>")),
                         None)

    # 5b. The training kernels: forward with history, backward with the
    # history and with its own recompute (in turns), the plain backward.
    def fwd_hist():
        return rk.march_forward(prog, flat, rays7, STEPS, 0.0, 5e-2,
                                log_hist=True)

    out_h, ex_h = fwd_hist()
    g8 = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (8,) + tuple(rays7.shape[1:])), dtype=rays7.dtype).to(rays7.device)

    def bwd(hist):
        kw = dict(hist=ex_h["hist"], nlive=ex_h["nlive"]) if hist else {}
        return bk.fused_backward(prog, flat, rays7, g8, STEPS, 0.0, 5e-2,
                                 **kw)

    fwd_hist_ms = kernel_ms(fwd_hist, 20)
    turns = [(h, kernel_ms(lambda: bwd(h), 10))
             for h in (True, False, False, True)]
    bwd_hist_ms = sum(v for h, v in turns if h) / 2
    bwd_rec_ms = sum(v for h, v in turns if not h) / 2
    plain_bwd_ms = cuda_ms(lambda: bk.reference_backward(
        prog, flat, rays7, g8, STEPS, 0.0, 5e-2, hist=ex_h["hist"],
        nlive=ex_h["nlive"]), 1)
    swept = n_valid * STEPS
    n_blocks = -(-rays7.shape[1] * rays7.shape[2] // 128)
    partial_bytes = (n_blocks * len(prog.scalar_offsets)
                     * rays7.element_size())
    hist_bytes = (STEPS + 1) * 3 * plane_bytes
    # Bytes the function must move. With the history: 4 ray planes (the
    # direction and valid; every position comes from the history), 8
    # cotangent planes, 6 output planes, the live-step plane, the history
    # and the partial rows. With the recompute: all 7 ray planes, no
    # live-step plane, and the scratch history is neither input nor output.
    bwd_ops = bk.backward_ops(prog, n_valid, swept)
    bwd_bytes = 19 * plane_bytes + hist_bytes + partial_bytes
    rec_ops = bk.backward_ops(prog, n_valid, swept, recomputed_steps=swept)
    rec_bytes = 21 * plane_bytes + partial_bytes
    tb_ops, tb_bytes = (bwd_ops / PEAK_F32_FLOPS * 1e3,
                        bwd_bytes / PEAK_BYTES * 1e3)
    tr_ops, tr_bytes = (rec_ops / PEAK_F32_FLOPS * 1e3,
                        rec_bytes / PEAK_BYTES * 1e3)
    default_hist = rk.BWD_HIST
    print(f"training kernels on {card}: forward with history "
          f"{fwd_hist_ms:.4f} ms (serving {ms:.4f} ms; history "
          f"{hist_bytes} bytes); backward with history {bwd_hist_ms:.4f} ms "
          f"(turns {[round(v, 4) for h, v in turns if h]}), with recompute "
          f"{bwd_rec_ms:.4f} ms (turns "
          f"{[round(v, 4) for h, v in turns if not h]}); default: "
          f"{'history' if default_hist else 'recompute'}; plain backward "
          f"{plain_bwd_ms:.3f} ms; bound with history: {bwd_ops} ops "
          f"({prog.vjp_ops_per_eval} per SDF VJP) -> {tb_ops:.4f} ms, "
          f"{bwd_bytes} bytes -> {tb_bytes:.4f} ms; bound with recompute: "
          f"{rec_ops} ops -> {tr_ops:.4f} ms, {rec_bytes} bytes -> "
          f"{tr_bytes:.4f} ms")
    # 5d. The kernels of this slice: the march kernel and its backward at
    # the planes the modular Renderer gives them, the two-level backward at
    # FastRenderer's in turns with the other two paths, and their plain
    # versions.
    m_flat, m_rays7 = modular_rays(modular, BENCH_Q, BENCH_T)
    m_prog = modular.program
    march_ms = kernel_ms(lambda: mk.march_planes(m_prog, m_flat, m_rays7, STEPS,
                                               0.0), 50)
    march_tau_ms = kernel_ms(lambda: mk.march_planes(m_prog, m_flat, m_rays7,
                                                   STEPS, 1e-3), 50)
    march_plain_ms = cuda_ms(lambda: mk.reference_march(m_prog, m_flat,
                                                        m_rays7, STEPS, 0.0),
                             3)
    g4 = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (4,) + tuple(m_rays7.shape[1:])), dtype=m_rays7.dtype).to(
            m_rays7.device)
    march_bwd_ms = kernel_ms(lambda: bk.march_backward(m_prog, m_flat, m_rays7,
                                                     g4, STEPS, 0.0), 10)
    march_bwd_plain_ms = cuda_ms(lambda: bk.reference_backward(
        m_prog, m_flat, m_rays7, g4, STEPS, 0.0, None, march_only=True), 1)
    m_valid = int((m_rays7[6] > 0.5).sum())
    m_plane_bytes = (m_rays7.shape[1] * m_rays7.shape[2]
                     * m_rays7.element_size())
    m_partial_bytes = (-(-m_rays7.shape[1] * m_rays7.shape[2] // 128)
                       * len(m_prog.scalar_offsets) * m_rays7.element_size())
    print(f"march kernel's planes on the modular path: "
          f"{tuple(m_rays7.shape)}, {m_valid} valid rays")

    def bwd_two_level():
        return bk.fused_backward(prog, flat, rays7, g8, STEPS, 0.0, 5e-2,
                                 two_level=True)

    turns_2l = [(name, kernel_ms(fn, 10)) for name, fn in (
        ("history", lambda: bwd(True)), ("two-level", bwd_two_level),
        ("recompute", lambda: bwd(False)), ("recompute", lambda: bwd(False)),
        ("two-level", bwd_two_level), ("history", lambda: bwd(True)))]
    two_level_ms = sum(v for n, v in turns_2l if n == "two-level") / 2
    two_level_plain_ms = cuda_ms(lambda: bk.reference_backward(
        prog, flat, rays7, g8, STEPS, 0.0, 5e-2, two_level=True), 1)
    k = bk.CKPT_INTERVAL
    march_ops = mk.march_ops(m_prog, m_valid, STEPS)
    march_bytes = 11 * m_plane_bytes
    tm_ops, tm_bytes = (march_ops / PEAK_F32_FLOPS * 1e3,
                        march_bytes / PEAK_BYTES * 1e3)
    # Two levels march every step once for the checkpoints and k - 1 of
    # every k once more in the replay; the checkpoints are scratch.
    tl_ops = bk.backward_ops(prog, n_valid, swept,
                             recomputed_steps=swept + swept * (k - 1) // k)
    tl_bytes = rec_bytes
    t2_ops, t2_bytes = (tl_ops / PEAK_F32_FLOPS * 1e3,
                        tl_bytes / PEAK_BYTES * 1e3)
    # The march's backward: 7 ray planes, 4 cotangent planes, 6 out.
    mb_ops = bk.backward_ops(m_prog, m_valid, m_valid * STEPS,
                             recomputed_steps=m_valid * STEPS,
                             march_only=True)
    mb_bytes = 17 * m_plane_bytes + m_partial_bytes
    tmb_ops, tmb_bytes = (mb_ops / PEAK_F32_FLOPS * 1e3,
                          mb_bytes / PEAK_BYTES * 1e3)
    print(f"march kernel on {card}: {march_ms:.4f} ms (tau=1e-3: "
          f"{march_tau_ms:.4f} ms), plain {march_plain_ms:.3f} ms; bound: "
          f"{march_ops} ops -> {tm_ops:.4f} ms, {march_bytes} bytes -> "
          f"{tm_bytes:.4f} ms; its backward (march-only mode) "
          f"{march_bwd_ms:.4f} ms, plain {march_bwd_plain_ms:.3f} ms; bound: "
          f"{mb_ops} ops -> {tmb_ops:.4f} ms, {mb_bytes} bytes -> "
          f"{tmb_bytes:.4f} ms")
    print(f"two-level backward on {card}: {two_level_ms:.4f} ms; turns "
          + ", ".join(f"{n} {v:.4f}" for n, v in turns_2l)
          + f" ms; plain {two_level_plain_ms:.3f} ms; bound: {tl_ops} ops -> "
          f"{t2_ops:.4f} ms, {tl_bytes} bytes -> {t2_bytes:.4f} ms; scratch "
          f"{STEPS // k * 3 * plane_bytes} bytes against a history of "
          f"{hist_bytes}")
    del out_h, ex_h

    # 5e. Where the history stops being small: 128 steps.
    long_hist_bytes = (LONG_STEPS + 1) * 3 * plane_bytes
    long_ckpt_bytes = LONG_STEPS // k * 3 * plane_bytes
    _, ex_long = rk.march_forward(prog, flat, rays7, LONG_STEPS, 0.0, 5e-2,
                                  log_hist=True)
    long_hist_ms = kernel_ms(lambda: bk.fused_backward(
        prog, flat, rays7, g8, LONG_STEPS, 0.0, 5e-2, hist=ex_long["hist"],
        nlive=ex_long["nlive"]), 3)
    del ex_long
    long_rec_ms = kernel_ms(lambda: bk.fused_backward(
        prog, flat, rays7, g8, LONG_STEPS, 0.0, 5e-2), 3)
    long_2l_ms = kernel_ms(lambda: bk.fused_backward(
        prog, flat, rays7, g8, LONG_STEPS, 0.0, 5e-2, two_level=True), 3)
    check(bk.LAST_PATH["two_level"], "two levels did not engage at 128 steps")
    print(f"backward at 1080p x {LONG_STEPS} steps on {card}: history "
          f"{long_hist_bytes} bytes, two-level scratch {long_ckpt_bytes} "
          f"bytes; with the history {long_hist_ms:.4f} ms, with the full "
          f"recompute {long_rec_ms:.4f} ms, with two levels "
          f"{long_2l_ms:.4f} ms")
    del g8, g4, m_flat, m_rays7

    # 5f. The modular frame and where its device time goes.
    def modular_frame():
        with torch.no_grad():
            return modular.render(modular.init_params, q, t, mode=0, degree=2)

    def bounce_frame():
        with torch.no_grad():
            return bouncer.render(bouncer.init_params, q, t, mode=0, degree=2)

    modular_ms = cuda_ms(modular_frame, 20)
    bounce_ms = cuda_ms(bounce_frame, 20)
    del bouncer
    print(f"modular frame (Renderer.render, use_pallas=True, 1080p) on "
          f"{card}: {modular_ms:.4f} ms; with one reflection bounce "
          f"{bounce_ms:.4f} ms")
    mod_prof = profile_frames(modular_frame, modular_ms, expect={
        "void march_kernel<float>": (march_ms, 1)})
    march_dev_ms = next((v for k_, v in mod_prof.items()
                         if k_.startswith("void march_kernel<float>")), None)
    if march_dev_ms is not None:
        busy = sum(mod_prof.values())
        print(f"modular frame: march kernel {march_dev_ms:.4f} ms of "
              f"{busy:.4f} ms busy; the plain torch ops around it (posing, "
              f"6 SDF evaluations, normals, shading) "
              f"{busy - march_dev_ms:.4f} ms in "
              f"{len(mod_prof) - 1} kinds of kernel")

    # 5c. The whole training step (render + backward + Adam), history on
    # and off, and where its device time goes.
    step_ms = {}
    r = main
    for hist in (True, False):
        rk.BWD_HIST = hist
        params = leaf_params(r.init_params)
        leaves = [params["c1"]["c0"]["radius"]]
        opt = torch.optim.Adam(leaves, lr=1e-2)
        with torch.no_grad():
            target = r.render(perturbed(r.init_params, "c1/c0/radius", 1.2),
                              q, t, mode=0, degree=2)

        def train_step():
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((r.render(params, q, t, mode=0, degree=2)
                               - target) ** 2)
            loss.backward()
            opt.step()

        step_ms[hist] = cuda_ms(train_step, 10)
        print(f"training step (render + backward + Adam, 1080p, "
              f"{'history' if hist else 'recompute'}): "
              f"{step_ms[hist]:.4f} ms")
        if hist == default_hist:
            expect = {"void render_bwd_kernel<float": (
                bwd_hist_ms if hist else bwd_rec_ms, 1)}
            if hist:
                expect["void render_fwd_train_kernel<float>"] = (fwd_hist_ms,
                                                                 1)
            step_prof = profile_frames(train_step, step_ms[hist],
                                       expect=expect)
    rk.BWD_HIST = default_hist
    bwd_dev_ms = next((v for k, v in step_prof.items()
                       if k.startswith("void render_bwd_kernel<float")), None)
    fwd_train_dev_ms = next(
        (v for k, v in step_prof.items()
         if k.startswith("void render_fwd_train_kernel<float>")), None)

    bwd_ms = bwd_hist_ms if default_hist else bwd_rec_ms
    bwd_bound = (max(tb_ops, tb_bytes) if default_hist
                 else max(tr_ops, tr_bytes))
    bwd_bound_by = ("operations" if (tb_ops >= tb_bytes if default_hist
                                     else tr_ops >= tr_bytes) else "bytes")
    kernels = {"kernels": [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "ray_marching_tpu_torch/ops/csrc/render_fwd.cu",
        "replaces": "ray_marching_tpu/ops/pallas_render.py:227",
        "launches": launches + fwd_train + fwd_sil + fwd_ift,
        "launches_serving": launches,
        "launches_per_frame": launches / n_frames,
        "launches_training": fwd_train + fwd_sil + fwd_ift,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "frame_ms": frame_ms,
        "ms_tau_1e-3": tau_ms,
        "bound_ms_tau_1e-3": tau_ops / PEAK_F32_FLOPS * 1e3,
        "ms_with_history": fwd_hist_ms,
        "profiler_kernel_ms": kernel_dev_ms,
        "profiler_train_kernel_ms": fwd_train_dev_ms,
        "card": card,
    }, {
        "name": "render_bwd",
        "route": "cuda",
        "source": "ray_marching_tpu_torch/ops/csrc/render_bwd.cu",
        "replaces": "ray_marching_tpu/ops/pallas_backward.py:119",
        "launches": bwd_train + bwd_sil,
        "launches_per_step": (bwd_train + bwd_sil)
        / (TRAIN_STEPS + SILHOUETTE_STEPS),
        "max_abs_err": bwd_err[0],
        "max_abs_err_params": bwd_err[1],
        "ms": bwd_ms,
        "plain_ms": plain_bwd_ms,
        "bound_ms": bwd_bound,
        "bound_by": bwd_bound_by,
        "library_ms": None,
        "ms_with_history": bwd_hist_ms,
        "ms_with_recompute": bwd_rec_ms,
        "default": "history" if default_hist else "recompute",
        "step_ms_history": step_ms[True],
        "step_ms_recompute": step_ms[False],
        "optimize_step_ms": step_s * 1e3,
        "optimize_silhouette_step_ms": sil_step_s * 1e3,
        "optimize_implicit_step_ms": ift_step_s * 1e3,
        "profiler_kernel_ms": bwd_dev_ms,
        "card": card,
    }, {
        "name": "march",
        "route": "cuda",
        "source": "ray_marching_tpu_torch/ops/csrc/march.cu",
        "replaces": "ray_marching_tpu/ops/pallas_march.py:173",
        "launches": march_launches,
        "launches_per_march": march_launches / n_marches,
        "max_abs_err": march_err,
        "ms": march_ms,
        "plain_ms": march_plain_ms,
        "bound_ms": max(tm_ops, tm_bytes),
        "bound_by": "operations" if tm_ops >= tm_bytes else "bytes",
        "library_ms": None,
        "ms_tau_1e-3": march_tau_ms,
        "frame_ms": modular_ms,
        "frame_ms_one_bounce": bounce_ms,
        "profiler_kernel_ms": march_dev_ms,
        "card": card,
    }, {
        "name": "render_bwd_two_level",
        "route": "cuda",
        "source": "ray_marching_tpu_torch/ops/csrc/render_bwd.cu",
        "replaces": "ray_marching_tpu/ops/pallas_backward.py:377",
        "launches": bwd_2l,
        "launches_per_step": bwd_2l / TWO_LEVEL_STEPS,
        "max_abs_err": two_level_err[0],
        "max_abs_err_params": two_level_err[1],
        "ms": two_level_ms,
        "plain_ms": two_level_plain_ms,
        "bound_ms": max(t2_ops, t2_bytes),
        "bound_by": "operations" if t2_ops >= t2_bytes else "bytes",
        "library_ms": None,
        "optimize_step_ms": step_2l_s * 1e3,
        "forward_launches_without_history": fwd_2l,
        "ms_128_steps": long_2l_ms,
        "ms_128_steps_history": long_hist_ms,
        "ms_128_steps_recompute": long_rec_ms,
        "scratch_bytes_128_steps": long_ckpt_bytes,
        "history_bytes_128_steps": long_hist_bytes,
        "card": card,
    }, {
        "name": "march_bwd",
        "route": "cuda",
        "source": "ray_marching_tpu_torch/ops/csrc/render_bwd.cu",
        "replaces": "ray_marching_tpu/ops/pallas_march.py:358",
        "launches": march_bwd_launches,
        "max_abs_err": march_bwd_err[0],
        "max_abs_err_params": march_bwd_err[1],
        "ms": march_bwd_ms,
        "plain_ms": march_bwd_plain_ms,
        "bound_ms": max(tmb_ops, tmb_bytes),
        "bound_by": "operations" if tmb_ops >= tmb_bytes else "bytes",
        "library_ms": None,
        "card": card,
    }]}
    # 6. The neural slice: NeuralSDF scenes through both kernels.
    kernels["kernels"] += neural_slice(card, out_dir)
    # 7. Neural training: the MLP's VJP in the backward kernel.
    kernels["kernels"] += neural_training(card, out_dir)
    # 8. The Mandelbulb: a custom node lowered into all three kernels.
    kernels["kernels"] += bulb_slice(card, out_dir)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          "builds included")
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
