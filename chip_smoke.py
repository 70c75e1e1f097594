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
and by the modular pipeline through the lane-refill march, and trained on
its scale by ``optimize``; the lighting modes, the Fourier colourmap, the
tiled renderer and the XLA route's backwards through the same kernels:
``occlusion`` and ``shaded`` frames and gradients at 1080p on both
renderers, tiled 8K frames and a tiled 4K gradient against one pass, and
the XLA route's training step against the kernel pair; I/O and the host
side: the 1080p and w256 artifacts served over HTTP, the browser and
orbit viewers, ``cli optimize --target <png>`` and ``cli profile``; the
parallel modules: one rank on NCCL and two ranks on the card over gloo;
the union short-circuit: the main path built under ``RM_TPU_CSG_PRUNE=1``
against the same without it, kernels, gradients, frames and ``optimize``
bit for bit, and a tensor-core scene with a guarded union; the backward's
bounded scratch: every backward path bit for bit on three scenes, and the
peak memory of 1080p and 4K training steps under the history size rule),
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
import contextlib
import dataclasses
import faulthandler
import functools
import hashlib
import json
import re
import shutil
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
#: optimize steps of the prune phase on each backward path (history,
#: recompute, two levels).
TRAIN_STEPS_PRUNE = 3
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
#: The scratch phase: the most a 1080p, 32-step, f32 recompute's scratch
#: slots may take (bytes; the frame's history is 821 MB), and the 4K
#: training steps at each step count, whose 64-step history (6.49 GB in
#: f32) is above the default RM_TPU_BWD_HIST_MAX.
SCRATCH_MAX_1080P = 64 * 2**20
SCRATCH_4K_STEPS = (32, 64)
#: The neural slice's main configuration: the trained width-256 NeuralSDF
#: of docs/neural_fit_w256 beside the room, its weights from the file, at
#: the demo's own resolution, step count and pose (view 0 of
#: tools/train_neural_demo.py's poses), f32.
ROOT = Path(__file__).resolve().parent
#: sha256 of the generated SDF sources of the scenes without a tensor-core
#: MLP leaf, as the generator wrote them before the tensor-core evaluation
#: existed (the bulb's: since its loop was rolled): their libraries run the
#: same code as before.
PER_THREAD_SOURCES = {
    "test_scene2":
        "01995bdb88b485bee773c22c8a51a6079fd70d4f52d88e5ee44821a37bdee8c1",
    "test_scene":
        "93b989af7cc5b0632446ee26c0a42e1a204cd9e35660b86950dbda5e1219d52f",
    "distillation target":
        "0466ffd3fbef4bd33176bed621273cc3944d97a9954559c47c81f8ee651adff0",
    # The bulb's iterations as one rolled loop (scene/fractals.py).
    "mandelbulb":
        "ff94cfc7e5ac20f0c23b3420e8613eeed0e251f98c2dab6a17527a9978c21228",
}
#: sha256 of the Mandelbulb's f32 serving-forward planes (64 steps, tau =
#: 1e-4 and 0) and march planes at 1440×900 (bulb_planes_digest), as the
#: port computed them on an NVIDIA H100 80GB HBM3 before the rolled SDF and
#: the lane-refill forward existed (commit af163ff;
#: tools/torch_simt_variants.py digest): the new kernels must give the same
#: bits.
BULB_PLANES_DIGEST = (
    "eec4e103f469de8e30b8c2405025c4b92770a86faeb38f65709edb72ffa24173")
#: sha256 of the bulb's f32 backward cotangents (bulb_backward_digest) as
#: the same commit computed them: the rolled, checkpointed VJP sums in the
#: unrolled one's order, so the backward keeps its bits too.
BULB_BACKWARD_DIGEST = (
    "b98e864b7f37c3fceaea02825cb4516bbf90079fea5ba02c81585544d76ce6c7")
#: sha256 of the f64 neural training forward's history and the backward's
#: cotangents at 128² (neural_f64_digest), as the port computed them on an
#: NVIDIA H100 80GB HBM3 before the tensor-core backward existed (commit
#: 994f98a; tools/torch_tc_variants.py digest): f64 keeps the per-thread
#: route, so its bits must not move.
NEURAL_F64_DIGEST = (
    "70ef492de97fdbb332f647b8149610a3d498fc7cc98f977cd2fad2981171e8ca")
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
#: The f32 training forward's history against the plain march's, on the
#: converged rays, at every step both ran: each step moves the position by
#: the SDF's value, whose rounding TOL_F32 bounds by its d limit, and a step
#: of a ray that is not yet near the surface does not contract the error
#: carried in (a converged ray's final position does), so the limit is the d
#: plane's carried over every step.
HIST_TOL_F32 = NEURAL_STEPS * TOL_F32[3]
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
#: Cycles profile_frames may discard, over all its calls, because the
#: profiler delivered fewer records of an expected kernel than the call
#: launched.
PROFILE_MAX_DROPPED = 3
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
#: The lighting, tiling and XLA-route phase (lighting_tiled_xla). Lighting
#: frames: the main path's configuration (test_scene2 1080p, 32 steps, f32)
#: through FastRenderer and Renderer(use_pallas=True), LIGHT_FRAMES each;
#: the bulb's shaded frame at its serving size. Every lighting image is held
#: against the same renderer on the plain march (FastRenderer
#: march_impl='xla', Renderer without use_pallas) on converged pixels: the
#: intensity takes the kernel's f32 normals (TOL_F32's 1e-3) through the
#: diffuse term and its positions (1e-4) through the probes and the shadow
#: ray, so LIGHT_ATOL, at most MAX_SHARE_OUT_F32 of the pixels outside.
LIGHT_FRAMES = 20
LIGHT_ATOL = 1e-3
#: The shaded gradient, FastRenderer against Renderer(use_pallas=True):
#: TOL_BWD["f32"] (grads_agreement). The two take their normals by
#: different operation orders, their second derivatives through the
#: backward kernel and through autograd, and sum 2 M pixels in different
#: orders: the backward kernel against its plain version's tolerance.
SHADED_GRAD_RTOL = 1e-4
#: Tiled frames at 8K in STRIP-row strips (9 strips) and the tiled gradient
#: at 4K (5 strips), against one pass through FastRenderer. Frames: TOL_F32
#: on converged pixels (the strips' ray planes are the one-pass grid's, so
#: bit-for-bit equality is expected and reported). The 4K gradient: the
#: loss within TILED_LOSS_RTOL, each leaf within TOL_BWD["f32"] of its
#: largest entry: every ray's cotangents are the one pass's, and the kernel
#: sums them in the same 128-ray blocks (a 512-row strip is whole blocks);
#: only the sum over the blocks is grouped by strip, an f32 reassociation.
TILED_8K, TILED_4K, STRIP = (7680, 4320), (3840, 2160), 512
TILED_MODES = (0, 1, "shaded")
TILED_LOSS_RTOL = 1e-5
#: The XLA route's training step (render, pixel MSE, backward, Adam) against
#: the kernel pair: the w256 field at 512² (24 steps) and the analytic main
#: path at 1080p. Its frame is held to the kernel's within LIGHT_ATOL (mode
#: 0 is a clamped dot with the normals) and its gradient of the frame's mean
#: square (JAX's parity loss) on converged pixels within XLA_GRAD_RTOL
#: (grads_agreement).
#: Analytic: TOL_BWD["f32"] (the backward kernel's adjoints against
#: autograd, f32 sums in other orders). w256: TOL_NEURAL_BWD_LOOSE (the
#: tensor-core MLP, 3xTF32, against plain f32 matmuls, forward and
#: backward). Beyond converged pixels the routes are held against the
#: plain march in f64 instead (W256_TRAIN_GRAD_RTOL).
XLA_STEPS = 3
XLA_GRAD_RTOL = {"analytic": 1e-4, "w256": 1e-2}
#: Where the w256 f32 gradients depart from the plain march in f64
#: (w256_witness), each leaf against its largest f64 entry. The kernel pair
#: in f64 against the plain march in f64, on every pixel and the training
#: loss, within TOL_NEURAL_BWD["f64"]: the same math (6.2e-11 and 9.7e-12
#: on the card). The training loss's f32 gradient, over every pixel
#: whether its ray converged or not: per thread within
#: W256_TRAIN_GRAD_RTOL["thread"] (4.2e-3 on the card, plain f32 4.0e-3);
#: on the tensor cores within the same ["tc"]. The tensor-core primal once
#: chained every pass of every k-step through the mma's own accumulation,
#: which truncates, and stood at 5.7e-2 under a limit of 0.1; it now sums
#: each k-step from zero and adds it in SIMT f32 (neural.cuh RM_ACC_FRESH:
#: 8.9e-3; tools/torch_tc_variants.py accuracy, PERF.md §6).
W256_TRAIN_GRAD_RTOL = {"thread": 1e-2, "tc": 1e-2}


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
    diffs, outside = plane_errors(got, want, conv,
                                  (TOL_F64,) * len(PLANES) if f64 else tol)
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


def plane_errors(got, want, conv, tol):
    """Per plane i, the largest |got[i] - want[i]| on the rays ``conv``
    marks, and the mask of those rays with a plane outside ``tol[i]`` or NaN
    in only one of the two."""
    import torch

    diffs, outside = [], torch.zeros_like(conv)
    for i, t in enumerate(tol):
        diff = (got[i] - want[i]).abs()
        nan_mismatch = torch.isnan(got[i]) != torch.isnan(want[i])
        diff = torch.where(torch.isnan(got[i]) & torch.isnan(want[i]),
                           torch.zeros_like(diff), diff)
        outside |= (nan_mismatch | (diff > t)) & conv
        diffs.append(float(torch.where(conv, diff, 0.0).max()))
    return diffs, outside


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


def march_entries(label, program, flat, rays7, steps, tau, mats=(),
                  plain_bits=True):
    """The march's two per-thread entries on the same inputs, the refill
    threshold forced each way: lane refill (march_refill_kernel, which the
    default dispatch must take here) and one thread per ray (march_kernel,
    whose frozen rays keep their freezing evaluation). Both must equal
    planes 0-3 of the fused kernel and each other bit for bit, and with
    ``plain_bits`` the plain version too (not for an MLP, whose plain
    version sums in another order: compare_march holds it to a
    tolerance)."""
    import torch

    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    check(rk.uses_refill(program, rays7.dtype, tau, "thread"),
          f"march entries {label}: the dispatch does not refill")
    saved, outs, counts = rk.REFILL_MIN_OPS, [], []
    try:
        for threshold in (0, 1 << 30):
            rk.REFILL_MIN_OPS = threshold
            before = mk.REFILL_LAUNCHES
            outs.append(mk.march_forward(program, flat, rays7, steps, tau,
                                         mats, route="thread"))
            counts.append(mk.REFILL_LAUNCHES - before)
    finally:
        rk.REFILL_MIN_OPS = saved
    full = rk.fused_march_normals(program, flat, rays7, steps, tau, 5e-2,
                                  mats=mats)
    want = (mk.reference_march(program, flat, rays7, steps, tau, mats)
            if plain_bits else outs[1])
    torch.cuda.synchronize()
    same = [bool(same_bits(outs[0], other).all())
            for other in (outs[1], full[:4], want)]
    print(f"march entries {label}: refill launches {counts}; lane refill "
          f"== one thread per ray {same[0]}, == fused planes 0-3 {same[1]}"
          + (f", == plain {same[2]}" if plain_bits else "")
          + " (bit for bit)")
    check(counts == [1, 0] and all(same),
          f"march entries {label}: the two entries differ")


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
    ends in a synchronise. A cycle can still come back without a record
    (once two of three records of the 2.2 ms bulb training forward): a cycle
    that holds fewer records of an ``expect`` kernel than its call launched
    is reported and discarded, and the call profiled again, at most
    PROFILE_MAX_DROPPED times in all. ``expect`` maps a kernel-name prefix
    to (its CUDA-event ms per launch at the same inputs, launches per
    call): the profile fails if the kept cycles hold fewer records of that
    kernel than the wrapper launched, or read it more than
    PROFILE_MAX_UNDER below its CUDA-event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    expect = expect or {}
    fn()
    torch.cuda.synchronize()
    totals = {}  # kernel -> [records, device µs]
    kept = dropped = 0
    while kept < frames:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # Device-side entries only; "Optimizer.step#..." is an annotation
        # that spans the optimizer's kernels, not a kernel.
        cycle = {e.key: (e.count, e.self_device_time_total)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0
                 and not e.key.startswith("Optimizer.")}
        short = {prefix: n for prefix, (_, per_call) in expect.items()
                 if (n := sum(c for k, (c, _) in cycle.items()
                              if k.startswith(prefix))) < per_call}
        if short:
            dropped += 1
            print(f"profile: cycle discarded, records short of the call's "
                  f"launches: {short} ({dropped} of at most "
                  f"{PROFILE_MAX_DROPPED})")
            check(dropped <= PROFILE_MAX_DROPPED,
                  f"profile: {dropped} cycles short of records")
            continue
        kept += 1
        for key, (n, us) in cycle.items():
            t = totals.setdefault(key, [0, 0.0])
            t[0] += n
            t[1] += us
    busy_ms = sum(t[1] for t in totals.values()) / 1e3 / frames
    check(busy_ms > 0.0, "profile: no device time recorded")
    print(f"profile ({frames} calls, one per cycle, {dropped} cycles "
          f"discarded): kernels busy {busy_ms:.4f} ms per call, "
          f"{busy_ms / frame_ms:.3f} of the {frame_ms:.4f} ms call")
    for key, (n, us) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {us / 1e3 / frames:9.4f} ms/call {n // frames:4d}x/call  "
              f"{key[:100]}")
    for prefix, (event_ms, per_call) in expect.items():
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

        self.n = 0
        # The XLA route (ops/xla_render.py) calls rk._reference_march too.
        self._saved = [(rk, "_reference_march"), (mk, "reference_march")]
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


def tc_bound_ms(program, ops, n_evals, n_vjps=0):
    """The least time of ``ops`` operations over ``n_evals`` SDF
    evaluations and ``n_vjps`` SDF VJPs when the tensor-core layers of
    ``program`` run on the tensor cores: their multiplies and adds (2·N1·N2
    per evaluation; three such products per VJP: its primal, W·δ and
    a ⊗ δ) at the TF32 rate taken three times (3xTF32) or, for bf16
    operands, the bf16 rate (the primal) and the TF32 rate taken twice (the
    products with δ, which stays f32), the rest at the f32 SIMT rate."""
    tc_s, tc_ops = 0.0, 0
    for k in program.tc:
        sizes = program.mlps[k].sizes
        per = 2 * sizes[1] * sizes[2]
        bf16 = program.mlps[k].node.matmul_dtype == "bfloat16"
        primal = (n_evals + n_vjps) * per
        back = 2 * n_vjps * per
        tc_s += primal / (PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS / 3)
        tc_s += back / (PEAK_TF32_FLOPS / (2 if bf16 else 3))
        tc_ops += primal + back
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
    # march and training forward; the tensor-core serving forward, training
    # forward and march under a gradient.
    thread, _ = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2,
                                 mats=mats, route="thread")
    thread_march = mk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0,
                                    mats, route="thread")
    thread_train, _ = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0,
                                       5e-2, log_hist=True, mats=mats,
                                       route="thread")
    serve, _ = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2,
                                mats=mats)
    rk.LAUNCHES = rk.TC_LAUNCHES = 0
    train, _ = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2,
                                log_hist=True, mats=mats)
    mk.LAUNCHES = mk.TC_LAUNCHES = 0
    grad_march = mk.march_planes(prog, flat.clone().requires_grad_(True),
                                 rays7, NEURAL_STEPS, 0.0, mats)
    torch.cuda.synchronize()
    check((rk.LAUNCHES, rk.TC_LAUNCHES, mk.LAUNCHES, mk.TC_LAUNCHES)
          == (1, 1, 1, 1), "the training forward or the march under a "
          "gradient did not take the tensor-core entry")
    check(bool(same_bits(thread_march, thread[:4]).all()),
          "per-thread march differs from the per-thread forward's planes")
    check(bool(same_bits(thread_train[:8], thread).all()),
          "the per-thread training forward differs from its serving one")
    check(bool(same_bits(train[:8], serve).all()),
          "the tensor-core training forward differs from the serving one")
    check(bool(same_bits(grad_march.detach(), train[:4]).all()),
          "the gradient route's march differs from the training forward")
    print("neural routes: per-thread march == per-thread forward planes 0-3, "
          "per-thread training forward == per-thread serving planes 0-7; "
          "tensor-core training forward == tensor-core serving planes 0-7, "
          "the march under a gradient (tensor-core entry) == its planes 0-3; "
          "all bit for bit")
    del thread, thread_march, thread_train, serve, train, grad_march
    r64, p64 = neural_renderer(NEURAL_F64_RES, torch.float64)
    f_flat, f_mats, f_rays = neural_rays(r64, p64)
    label = f"neural f64 {NEURAL_F64_RES}x{NEURAL_F64_RES} w256"
    compare(label, r64.program, f_flat, f_rays, 0.0, True, NEURAL_STEPS,
            f_mats)
    compare_march(label, r64.program, f_flat, f_rays, 0.0, True,
                  backward=False, steps=NEURAL_STEPS, mats=f_mats)
    # At tau > 0 the per-thread MLP's march refills lanes.
    compare_march(f"{label} tau=1e-3", r64.program, f_flat, f_rays, 1e-3,
                  True, backward=False, steps=NEURAL_STEPS, mats=f_mats)
    march_entries(f"{label} tau=1e-3", r64.program, f_flat, f_rays,
                  NEURAL_STEPS, 1e-3, f_mats, plain_bits=False)
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
        ("march, per thread", "march_kernel", "IfLb0EE"))}
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
                     two_level=False, tc=False):
    """optimize() through the kernels, counted: one forward and one backward
    launch per step (``tc``: all of them on the tensor-core entries, else
    none), no plain march or backward, the backward path asked for (the
    history, or two levels without one), finite losses and a finite
    gradient of every trainable leaf at every step. Returns (result, the
    trainable leaves' gradients at each step, each step's ms by the host
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
    rk.LAUNCHES = bk.LAUNCHES = rk.TC_LAUNCHES = bk.TC_LAUNCHES = 0
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
    tc_fwd, tc_bwd = rk.TC_LAUNCHES, bk.TC_LAUNCHES
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
          + f"; forward launches {fwd} ({tc_fwd} tensor-core), backward "
          f"launches {bwd} ({tc_bwd} tensor-core), plain calls {n_plain}, "
          f"path {path}; step ms (host clock) "
          + " ".join(f"{v:.1f}" for v in step_ms))
    check(out["steps_run"] == cfg.steps and all(np.isfinite(out["losses"])),
          f"{label}: steps or losses")
    check((fwd, bwd, n_plain) == (cfg.steps, cfg.steps, 0),
          f"{label}: launches or plain calls")
    check((tc_fwd, tc_bwd) == ((cfg.steps, cfg.steps) if tc else (0, 0)),
          f"{label}: tensor-core launches")
    check(path.get("two_level") is two_level
          and path.get("use_hist") is not two_level, f"{label}: path {path}")
    check(len(grads) == cfg.steps and all(
        v is not None and bool(torch.isfinite(v).all())
        for step in grads for v in step.values()),
        f"{label}: missing or non-finite gradients")
    return out, grads, step_ms


def drive_optimize(label, renderer, target, q, t, cfg, init_params,
                   tc=False):
    """counted_optimize with the history, then its first step again with two
    levels: the same loss and the same gradients bit for bit. Returns
    (result, gradients per step, step ms, backward launches of the history
    run, of the two-level step)."""
    import torch

    out, grads, step_ms = counted_optimize(label, renderer, target, q, t,
                                           cfg, init_params, tc=tc)
    out_2l, grads_2l, _ = counted_optimize(
        label, renderer, target, q, t, dataclasses.replace(cfg, steps=1),
        init_params, two_level=True, tc=tc)
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
    rk.TC_LAUNCHES = bk.TC_LAUNCHES = bk.MARCH_TC_LAUNCHES = 0
    mk.TC_LAUNCHES = 0
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


def cli_optimize(args, backward_launches, tc_launches=0):
    """The CLI's optimize, counted: ``backward_launches`` backward kernel
    launches, ``tc_launches`` of them on the tensor-core instantiation."""
    import torch

    from ray_marching_tpu_torch.cli import main as cli_main
    from ray_marching_tpu_torch.ops import backward_kernel as bk

    bk.LAUNCHES = bk.TC_LAUNCHES = 0
    cli_main(["optimize", *args])
    torch.cuda.synchronize()
    check((bk.LAUNCHES, bk.TC_LAUNCHES) == (backward_launches, tc_launches),
          f"cli optimize {args}: {bk.LAUNCHES} backward launches, "
          f"{bk.TC_LAUNCHES} on the tensor cores")


def backward_timings(prog, flat, rays7, steps, m_rays7, reps, mats=(),
                     route=None, plain=True):
    """The training kernels at tau = 0 by CUDA events, on the MLP ``route``
    (the default one when None): the backward in its three modes in turns
    (history, two-level, recompute, then backwards), its plain versions
    (with ``plain``), the march-only mode at the march kernel's planes
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
                             log_hist=True, mats=mats, route=route)
    mode_kw = {"history": dict(hist=ex["hist"], nlive=ex["nlive"]),
               "recompute": {}, "two-level": dict(two_level=True)}

    def bwd(mode):
        return bk.fused_backward(prog, flat, rays7, g8, steps, 0.0, 5e-2,
                                 mats=mats, route=route, **mode_kw[mode])

    turns = [(m, kernel_ms(lambda m=m: bwd(m), reps))
             for m in ("history", "two-level", "recompute", "recompute",
                       "two-level", "history")]
    ms = {m: sum(v for n, v in turns if n == m) / 2 for m in mode_kw}
    ms["march-only"] = kernel_ms(lambda: bk.march_backward(
        prog, flat, m_rays7, g4, steps, 0.0, mats, route=route), reps)
    ms["forward with history"] = kernel_ms(lambda: rk.march_forward(
        prog, flat, rays7, steps, 0.0, 5e-2, log_hist=True, mats=mats,
        route=route), reps)
    if not plain:
        return ms, turns
    ms["plain"] = cuda_ms(lambda: bk.reference_backward(
        prog, flat, rays7, g8, steps, 0.0, 5e-2, mats=mats,
        **mode_kw["history"]), 1)
    ms["plain two-level"] = cuda_ms(lambda: bk.reference_backward(
        prog, flat, rays7, g8, steps, 0.0, 5e-2, mats=mats, two_level=True),
        1)
    ms["plain march-only"] = cuda_ms(lambda: bk.reference_backward(
        prog, flat, m_rays7, g4, steps, 0.0, None, march_only=True,
        mats=mats), 1)
    return ms, turns


def train_step_profile(renderer, params, trainable, q, t, target, degree,
                       lr, reps, frames, times,
                       fwd_kernel="void render_fwd_train_kernel<float>"):
    """One training step (render, mode-0 MSE, backward, Adam on the
    ``trainable`` leaves) by CUDA events over ``reps`` steps, then profiled
    (profile_frames, held against ``times`` of backward_timings; the
    training forward's kernel name begins ``fwd_kernel``). Returns (step
    ms, the profile's ms per kernel)."""
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
        fwd_kernel: (times["forward with history"], 1)})
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
    route = rk.mlp_route(prog, flat.dtype)
    bk.TC_LAUNCHES = 0
    runs = {m: bk.fused_backward(prog, flat, rays7, g, NEURAL_STEPS, tau,
                                 5e-2, track_min=track_min, mats=mats,
                                 **kw[m]) for m in modes}
    check(bk.TC_LAUNCHES == (len(modes) if route == "tc" else 0),
          f"{label}: {bk.TC_LAUNCHES} tensor-core launches on route {route}")
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
    print(f"neural backward {label} ({route} route): "
          f"{' == '.join(modes)} bitwise; vs plain "
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


def backward_recompute_history(prog, flat, mats, rays7, steps, tau):
    """The positions the tensor-core backward marches when it is given no
    history: the scratch of one launch of ``rm_render_bwd_tc_f32`` in its
    recompute mode with one block per ray block (so one slot each), laid
    out as the forward's history (steps + 1, 3, rows, 128), NaN where the
    kernel wrote nothing. A comparison launch, outside the wrappers'
    counts."""
    import ctypes

    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    lib = rk._load(prog)
    packed = rk.tc_buffer(prog, mats, backward=True)
    plane = tuple(rays7.shape[1:])
    n = rays7.shape[1] * rays7.shape[2]
    n_blocks = -(-n // lib.rm_render_bwd_block())
    dev = rays7.device
    slots = torch.full((n_blocks, steps + 1, 3, rays7.shape[2]),
                       float("nan"), device=dev)
    g = torch.zeros((8,) + plane, device=dev)
    out = torch.empty((7,) + plane, device=dev)
    partials = torch.empty((n_blocks, bk.partial_cols(prog)), device=dev)
    consts = rk._host_consts(torch.float32, tau, 5e-2)
    err = lib.rm_render_bwd_tc_f32(
        flat.data_ptr(), packed.data_ptr(), rays7.data_ptr(), g.data_ptr(),
        0, slots.data_ptr(), 1, None, 0, None, None, None, out.data_ptr(),
        partials.data_ptr(), n_blocks, n_blocks, bk.partial_cols(prog), n,
        steps, consts.ctypes.data_as(ctypes.c_void_p),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err == 0, f"recompute launch failed: cudaError {err}")
    # Slot b holds ray block b (rows of 128 rays): (block, step, xyz, lane)
    # -> (step, xyz, row, lane).
    return slots.permute(1, 2, 0, 3).contiguous()


def neural_training_forward(prog, flat, mats, rays7):
    """The tensor-core training forward at the main neural configuration:
    its 8 planes bitwise equal to the tensor-core serving forward's, its
    history bitwise equal to the backward's recompute (tau 0 and 1e-3, on
    every entry the forward wrote); at tau 0 against the plain version on
    the converged rays: its 8 planes and its min_f plane (at the d plane's
    limit) within TOL_F32 and a tenth of it, as the serving forward is held,
    and its history at the steps both ran within HIST_TOL_F32 (the
    per-thread route's reading printed beside it). Returns the largest
    difference of the 8 planes there."""
    import torch

    from ray_marching_tpu_torch.ops import render_kernel as rk

    for tau in (0.0, 1e-3):
        serve, _ = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, tau,
                                    5e-2, mats=mats)
        out, ex = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, tau,
                                   5e-2, track_min=True, log_hist=True,
                                   mats=mats)
        rec = backward_recompute_history(prog, flat, mats, rays7,
                                         NEURAL_STEPS, tau)
        torch.cuda.synchronize()
        steps_idx = torch.arange(NEURAL_STEPS + 1,
                                 device=rays7.device)[:, None, None]
        ran = ((steps_idx < ex["nlive"][None])
               | (steps_idx == NEURAL_STEPS))[:, None]
        ran = ran & ((rays7[6] > 0.5) | (steps_idx == NEURAL_STEPS)[:, None])
        same_hist = bool((same_bits(ex["hist"], rec) | ~ran).all())
        same_planes = bool(same_bits(out[:8], serve).all())
        print(f"neural training forward (tensor cores, tau={tau:g}): 8 "
              f"planes == serving {same_planes}, history == the backward's "
              f"recompute on {int(ran.sum())} written entries {same_hist}; "
              f"mean live steps "
              f"{float(ex['nlive'][rays7[6] > 0.5].float().mean()):.3f}")
        check(same_planes and same_hist,
              f"neural training forward at tau={tau:g}: planes or history")
        del serve, out, ex, rec
    want, wex = rk._reference_march(prog, flat, rays7, NEURAL_STEPS, 0.0,
                                    5e-2, track_min=True, log_hist=True,
                                    mats=mats)
    conv = (rays7[6] > 0.5) & (want[3].abs() < CONVERGED)
    n_conv = int(conv.sum())
    check(n_conv > 0, "neural training forward: no converged rays")
    steps_idx = torch.arange(NEURAL_STEPS + 1,
                             device=rays7.device)[:, None, None]

    def hist_diff(ex):
        """Per ray, the largest |history - plain history| over the steps
        both ran and the terminal slot (inf where NaN)."""
        both = ((steps_idx < torch.minimum(ex["nlive"], wex["nlive"])[None])
                | (steps_idx == NEURAL_STEPS))[:, None]
        diff = torch.where(both, (ex["hist"] - wex["hist"]).abs(),
                           0.0).amax((0, 1))
        return torch.where(torch.isnan(diff), float("inf"), diff)

    out, ex = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2,
                               track_min=True, log_hist=True, mats=mats)
    tc_hist = hist_diff(ex)
    del ex
    _, thread_ex = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0,
                                    5e-2, track_min=True, log_hist=True,
                                    mats=mats, route="thread")
    thread_hist = hist_diff(thread_ex)
    del thread_ex
    torch.cuda.synchronize()
    for name, tol in (("TOL_F32", TOL_F32), ("a tenth of TOL_F32",
                                             TOL_F32_TC)):
        diffs, outside = plane_errors(out, want, conv, tol + (tol[3],))
        share = int(outside.sum()) / n_conv
        print(f"compare neural training forward f32 {NEURAL_RES}x"
              f"{NEURAL_RES} w256 tau=0 (tensor cores, {name}): converged "
              f"rays {n_conv}, share outside tolerance {share:.3e}; max abs "
              "diff per plane " + " ".join(f"{n}={d:.3e}" for n, d in zip(
                  PLANES + ("min_f",), diffs)))
        check(share <= MAX_SHARE_OUT_F32,
              f"neural training forward: {share:.3e} of converged rays "
              f"outside {name}")
    hist_share = int(((tc_hist > HIST_TOL_F32) & conv).sum()) / n_conv
    print(f"compare neural training forward history f32 {NEURAL_RES}x"
          f"{NEURAL_RES} w256 tau=0 (tolerance {HIST_TOL_F32:g}): share of "
          f"converged rays outside {hist_share:.3e}; largest difference "
          f"{float(tc_hist[conv].max()):.3e} on the tensor cores, "
          f"{float(thread_hist[conv].max()):.3e} per thread (share above "
          f"the final positions' {TOL_F32[0]:g}: "
          f"{int(((tc_hist > TOL_F32[0]) & conv).sum()) / n_conv:.3e} and "
          f"{int(((thread_hist > TOL_F32[0]) & conv).sum()) / n_conv:.3e})")
    check(hist_share <= MAX_SHARE_OUT_F32,
          f"neural training forward: history outside {HIST_TOL_F32:g} on "
          f"{hist_share:.3e} of the converged rays")
    return max(diffs[:8])


def neural_f64_digest(prog, flat, mats, rays7):
    """sha256 of the f64 training forward's history (tau 0) and the bytes
    of the backward's cotangents from it, for a cotangent drawn from seed
    32 (NEURAL_F64_DIGEST)."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    _, ex = rk.march_forward(prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2,
                             log_hist=True, mats=mats)
    g = torch.as_tensor(np.random.default_rng(32).standard_normal(
        (8,) + tuple(rays7.shape[1:]))).to(rays7.device)
    run = bk.fused_backward(prog, flat, rays7, g, NEURAL_STEPS, 0.0, 5e-2,
                            hist=ex["hist"], nlive=ex["nlive"], mats=mats)
    digest = hashlib.sha256()
    for t in (ex["hist"], run[0], *run[1], run[2]):
        digest.update(t.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


def neural_training(card, out_dir: Path):
    """The neural training slice on the card, on the tensor cores: the
    backward kernel with the MLP's VJP against its plain version (512² f32
    with the history, recompute and two levels bitwise equal; 128² f32, and
    neural_demo's 16 -> 16 leaf; tau = 1e-3, min_f, bf16 operands and the
    march-only mode; 128² f64 on the per-thread route), the training forward (bitwise the serving
    forward's planes, its history bitwise the backward's recompute), then
    the main path (3 counted optimize() steps on the w256 leaf: one forward
    and one backward launch each, all on the tensor-core entries, no plain
    march or backward), render_with_alpha, the implicit backward (no
    backward launch), one Renderer(use_pallas=True) gradient, the CLI,
    timings on both routes, profile and bounds. Returns its rows of the
    kernels line."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.optim.inverse import InverseConfig
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer
    from ray_marching_tpu_torch.scene import registry

    main, params = neural_renderer(NEURAL_RES, torch.float32)
    prog = main.program
    flat, mats, rays7 = neural_rays(main, params)
    check(rk.mlp_route(prog, torch.float32) == "tc",
          "the w256 scene does not train on the tensor cores")
    errs = neural_backward_vs_plain(
        f"f32 {NEURAL_RES}x{NEURAL_RES} w256", prog, flat, mats, rays7, 0.0,
        TOL_NEURAL_BWD["f32"], modes=("history", "recompute", "two-level"),
        seed=31)
    fwd_err = neural_training_forward(prog, flat, mats, rays7)
    small = NEURAL_F64_RES
    r64, p64 = neural_renderer(small, torch.float64)
    f_flat, f_mats, f_rays = neural_rays(r64, p64)
    check(rk.mlp_route(prog, torch.float64) == "thread",
          "f64 does not keep the per-thread MLP")
    neural_backward_vs_plain(
        f"f64 {small}x{small} w256", prog, f_flat, f_mats, f_rays, 0.0,
        TOL_NEURAL_BWD["f64"], modes=("history", "recompute", "two-level"),
        seed=32)
    digest = neural_f64_digest(prog, f_flat, f_mats, f_rays)
    print(f"neural f64 {small}x{small} (per-thread route): sha256 of the "
          f"training forward's history and the backward's cotangents "
          f"{digest}, pinned {NEURAL_F64_DIGEST}")
    check(digest == NEURAL_F64_DIGEST,
          "neural f64: the per-thread route's bits moved")
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
    # neural_demo's 16 -> 16 leaf: the tensor-core VJP at its smallest
    # shape (one m-tile of the sink, 16 columns a pass).
    demo = FastRenderer(registry.make_scene("neural_demo"),
                        dataclasses.replace(config(small, small),
                                            marching_steps=NEURAL_STEPS),
                        dtype=torch.float32)
    d_flat, d_mats, d_rays = neural_rays(demo, demo.init_params)
    neural_backward_vs_plain(
        f"f32 {small}x{small} neural_demo", demo.program, d_flat, d_mats,
        d_rays, 0.0, TOL_NEURAL_BWD["f32"],
        modes=("history", "recompute", "two-level"), seed=39)
    del demo, d_flat, d_mats, d_rays
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
    bk.MARCH_TC_LAUNCHES = 0
    got = bk.march_backward(prog, flat, m_rays7, g4, NEURAL_STEPS, 0.0,
                            mats)
    want = bk.reference_backward(prog, flat, m_rays7, g4, NEURAL_STEPS,
                                 0.0, None, march_only=True, mats=mats)
    torch.cuda.synchronize()
    mb_errs = (rel_err(got[2][:, m_conv], want[2][:, m_conv]),
               rel_err(got[0], want[0]),
               max(rel_err(a, b) for a, b in zip(got[1], want[1])),
               float((got[2] - want[2])[:, m_conv].abs().max()))
    print(f"neural march backward (march-only mode, tensor cores "
          f"{bk.MARCH_TC_LAUNCHES}, f32 {NEURAL_RES}x{NEURAL_RES}) vs plain: "
          f"rays {mb_errs[0]:.3e}, flat {mb_errs[1]:.3e}, matrices "
          f"{mb_errs[2]:.3e} (tolerance {TOL_NEURAL_BWD['f32']:g})")
    check(max(mb_errs[:3]) <= TOL_NEURAL_BWD["f32"]
          and bk.MARCH_TC_LAUNCHES == 1
          and all(bool(torch.isfinite(m).all()) for m in got[1]),
          "neural march backward: kernel and plain disagree")
    del got, want, m_ref, g4
    rbf, pbf = neural_renderer(small, torch.float32,
                               scene=neural_scene("bfloat16"))
    bf_flat, bf_mats, bf_rays = neural_rays(rbf, pbf)
    bk.TC_LAUNCHES = 0
    loose["bf16"] = neural_bf16_backward(rbf.program, bf_flat, bf_mats,
                                         bf_rays, seed=38)
    check(bk.TC_LAUNCHES == 3, "bf16: the backward left the tensor cores")
    del r64, p64, r32, p32, rbf, pbf, f_flat, f_mats, f_rays, s_flat, s_mats
    del s_rays, bf_flat, bf_mats, bf_rays

    # The main path, counted: optimize() on the seven c1 leaves, then its
    # first step again with two levels; every launch on the tensor cores.
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
        params, tc=True)
    moved = {p: float((v - trainable_leaves(params, NEURAL_TRAINABLE)[p])
                      .abs().max())
             for p, v in trainable_leaves(out["params"],
                                          NEURAL_TRAINABLE).items()}
    print("neural training: largest change per leaf "
          + " ".join(f"{k}={v:.3e}" for k, v in moved.items()))
    check(len(moved) == 7 and all(v > 0 for v in moved.values()),
          "neural training: a c1 leaf did not move")

    def tc_counts():
        return (rk.TC_LAUNCHES, bk.TC_LAUNCHES, mk.TC_LAUNCHES,
                bk.MARCH_TC_LAUNCHES)

    alpha_counts, _ = counted_gradient(main, params, NEURAL_Q, NEURAL_T,
                                       target, 1, alpha=True)
    alpha_tc = tc_counts()
    implicit = FastRenderer(neural_scene(), dataclasses.replace(
        main.config, backward="implicit"), dtype=torch.float32)
    ift_counts, _ = counted_gradient(implicit, params, NEURAL_Q, NEURAL_T,
                                     target, 1)
    ift_tc = tc_counts()
    mod_counts, _ = counted_gradient(modular, params, NEURAL_Q, NEURAL_T,
                                     target, 1)
    mod_tc = tc_counts()
    print(f"neural gradients (launches: forward, backward, march, march "
          f"backward; plain marches, plain backwards; all finite / the "
          f"tensor-core launches of the same four): render_with_alpha "
          f"{alpha_counts} / {alpha_tc}, backward='implicit' {ift_counts} / "
          f"{ift_tc}, Renderer(use_pallas=True) {mod_counts} / {mod_tc}")
    check(alpha_counts == (1, 1, 0, 0, 0, 0, True)
          and alpha_tc == (1, 1, 0, 0), "neural render_with_alpha gradient")
    check(ift_counts == (1, 0, 0, 0, 0, 0, True) and ift_tc == (1, 0, 0, 0),
          "neural implicit gradient")
    check(mod_counts == (0, 0, 1, 1, 0, 0, True) and mod_tc == (0, 0, 1, 1),
          "neural modular gradient")
    del implicit

    # The CLI's optimize on the JAX package's neural scene file
    # (neural_demo's 16 -> 16 leaf: the tensor cores).
    cli_optimize(["--scene-file", str(NEURAL_SCENE_FILE), "--width", "128",
                  "--height", "96", "--steps", "16", "--opt-steps", "2",
                  "--trainable", "c1"], 2, 2)

    # Timing at the main configuration on both routes, a training step and
    # its profile.
    times, turns = backward_timings(prog, flat, rays7, NEURAL_STEPS, m_rays7,
                                    2, mats=mats)
    thread_times, _ = backward_timings(prog, flat, rays7, NEURAL_STEPS,
                                       m_rays7, 1, mats=mats, route="thread",
                                       plain=False)
    plain_fwd_ms = cuda_ms(lambda: rk._reference_march(
        prog, flat, rays7, NEURAL_STEPS, 0.0, 5e-2, log_hist=True,
        mats=mats), 1)
    step_ev_ms, prof = train_step_profile(
        main, params, NEURAL_TRAINABLE, NEURAL_Q, NEURAL_T, target, 1, 1e-3,
        2, 2, times, fwd_kernel="render_fwd_train_tc_kernel")
    bwd_dev_ms = next((v for k, v in prof.items()
                       if k.startswith("void render_bwd_kernel<float")), None)
    fwd_dev_ms = next((v for k, v in prof.items()
                       if k.startswith("render_fwd_train_tc_kernel")), None)
    busy_ms = sum(prof.values())
    print(f"neural training timing on {card} ({NEURAL_RES}x{NEURAL_RES}, "
          f"{NEURAL_STEPS} steps, f32), tensor cores: "
          + ", ".join(f"{m} {v:.3f} ms" for m, v in times.items())
          + " (turns " + ", ".join(f"{n} {v:.3f}" for n, v in turns)
          + "); per thread: "
          + ", ".join(f"{m} {v:.3f} ms" for m, v in thread_times.items())
          + f"; plain forward with history {plain_fwd_ms:.3f} ms; training "
          f"step {step_ev_ms:.3f} ms (CUDA events), device busy {busy_ms} "
          f"ms, backward kernel {bwd_dev_ms} ms, training forward "
          f"{fwd_dev_ms} ms (profiler)")

    # Bounds: operations from the op counts (the MLP's VJP dominates), its
    # three 256 x 256 products on the tensor cores; bytes from the planes,
    # the history, the matrices and the partial rows.
    work, partial_bytes = backward_work(prog, rays7, NEURAL_STEPS, m_rays7,
                                        mats)
    simt = bounds_of(work)
    n_valid = int((rays7[6] > 0.5).sum())
    m_valid = int((m_rays7[6] > 0.5).sum())
    swept, k = n_valid * NEURAL_STEPS, bk.CKPT_INTERVAL
    evals_vjps = {
        "history": (0, n_valid * 5 + swept),
        "recompute": (swept, n_valid * 5 + swept),
        "two-level": (swept + swept * (k - 1) // k, n_valid * 5 + swept),
        "march-only": (m_valid * NEURAL_STEPS, m_valid * (1 + NEURAL_STEPS)),
    }
    bounds = {}
    for m, (ops, nbytes) in work.items():
        t_ops = tc_bound_ms(prog, ops, *evals_vjps[m])
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bounds[m] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    # The training forward: the serving forward's operations, its 8 planes
    # and history, the live-step plane, the matrices.
    plane_bytes = rays7.shape[1] * rays7.shape[2] * rays7.element_size()
    mat_bytes = sum(m.numel() for m in mats) * rays7.element_size()
    f_ops = rk.kernel_ops(prog, n_valid, NEURAL_STEPS)
    f_t_ops = tc_bound_ms(prog, f_ops, n_valid * (NEURAL_STEPS + 5))
    f_t_bytes = ((7 + 8 + 1 + 3 * (NEURAL_STEPS + 1)) * plane_bytes
                 + mat_bytes) / PEAK_BYTES * 1e3
    f_bound = (max(f_t_ops, f_t_bytes),
               "operations" if f_t_ops >= f_t_bytes else "bytes")
    log = rk.BUILD_LOG.get(rk.kernel_key(prog), "")
    regs = {name: ptxas_entry(log, kernel, args) for name, kernel, args in (
        ("backward history, tensor cores", "render_bwd_kernel",
         "IfLb0ELb0ELb0ELb1ELb0EE"),
        ("backward two-level, tensor cores", "render_bwd_kernel",
         "IfLb0ELb1ELb0ELb1ELb1EE"),
        ("backward march-only, tensor cores", "render_bwd_kernel",
         "IfLb0ELb0ELb1ELb1ELb1EE"),
        ("backward history, per thread", "render_bwd_kernel",
         "IfLb0ELb0ELb0ELb0ELb0EE"),
        ("training forward, tensor cores", "render_fwd_train_tc_kernel",
         "PKf"),
        ("training forward, per thread", "render_fwd_train_kernel", "IfE"))}
    smem_tc = rk._load(prog).rm_render_bwd_tc_smem()
    step_bound = bounds["history"][0] + f_bound[0]
    print(f"neural backward bounds ({prog.vjp_ops_per_eval} ops per SDF VJP, "
          f"{prog.ops_per_eval} per evaluation; partial rows "
          f"{partial_bytes} bytes per launch): "
          + "; ".join(f"{m} {o} ops, {nb} bytes -> tensor cores "
                      f"{bounds[m][0]:.4f} ms ({bounds[m][1]}), f32 SIMT "
                      f"{simt[m][0]:.4f} ms" for m, (o, nb) in work.items())
          + f"; training forward with history {f_ops} ops -> tensor cores "
          f"{f_bound[0]:.4f} ms ({f_bound[1]}); the step's two kernels "
          f"{step_bound:.4f} ms; ptxas (f32; registers, stack, spill stores, "
          f"static shared memory): "
          + "; ".join(f"{k_} {v[0]}, {v[1]} B, {v[2]} B, {v[3]} B"
                      for k_, v in regs.items())
          + f"; dynamic shared memory of the tensor-core backward {smem_tc} B")

    source = ("ray_marching_tpu_torch/ops/csrc/render_bwd.cu + "
              "ray_marching_tpu_torch/ops/csrc/neural.cuh")
    rows = [kernel_row(
        name, source, replaces + " + ray_marching_tpu/scene/neural.py:232",
        launches, times[mode], times[f"plain {mode}"
                                     if mode != "history" else "plain"],
        bounds[mode], card, max_abs_err=err[3], max_rel_err_rays=err[0],
        max_rel_err_flat=err[1], max_rel_err_mats=err[2],
        mlp="tensor cores, mma.sync 3xTF32", ms_per_thread=thread_times[mode],
        bound_ms_simt=simt[mode][0], registers=regs[reg][0],
        stack_bytes=regs[reg][1], spill_store_bytes=regs[reg][2],
        dynamic_smem_bytes=smem_tc)
        for name, mode, replaces, launches, err, reg in (
            ("render_bwd_neural", "history",
             "ray_marching_tpu/ops/pallas_backward.py:119", train_launches,
             errs, "backward history, tensor cores"),
            ("render_bwd_two_level_neural", "two-level",
             "ray_marching_tpu/ops/pallas_backward.py:377",
             two_level_launches, errs, "backward two-level, tensor cores"),
            ("march_bwd_neural", "march-only",
             "ray_marching_tpu/ops/pallas_march.py:358", mod_counts[3],
             mb_errs, "backward march-only, tensor cores"))]
    rows[0].update(ms_recompute=times["recompute"],
                   ms_recompute_per_thread=thread_times["recompute"],
                   bound_ms_recompute=bounds["recompute"][0],
                   launches_render_with_alpha=alpha_counts[1],
                   launches_implicit=ift_counts[1],
                   optimize_step_ms=step_ms, step_ms=step_ev_ms,
                   step_busy_ms=busy_ms, step_bound_ms=step_bound,
                   profiler_kernel_ms=bwd_dev_ms,
                   partial_bytes=partial_bytes,
                   max_rel_err_tau_1e_3=max(loose["tau"][:3]),
                   max_rel_err_min_f=max(loose["min_f"][:3]),
                   bf16_share_rays_within=loose["bf16"]["sound"][0],
                   bf16_share_rays_within_control=loose["bf16"]["control"][0],
                   max_rel_err_bf16_mats=loose["bf16"]["sound"][2],
                   registers_per_thread_route=regs[
                       "backward history, per thread"][0])
    rows.append(kernel_row(
        "render_fwd_train_neural",
        "ray_marching_tpu_torch/ops/csrc/render_fwd.cu + "
        "ray_marching_tpu_torch/ops/csrc/neural.cuh",
        "ray_marching_tpu/ops/pallas_render.py:227 + "
        "ray_marching_tpu/scene/neural.py:232",
        train_launches, times["forward with history"], plain_fwd_ms,
        f_bound, card, max_abs_err=fwd_err,
        launches_render_with_alpha=alpha_counts[0],
        mlp="tensor cores, mma.sync 3xTF32",
        ms_per_thread=thread_times["forward with history"],
        bound_ms_simt=max(f_ops / PEAK_F32_FLOPS * 1e3, f_t_bytes),
        profiler_kernel_ms=fwd_dev_ms,
        registers=regs["training forward, tensor cores"][0],
        stack_bytes=regs["training forward, tensor cores"][1],
        spill_store_bytes=regs["training forward, tensor cores"][2],
        registers_per_thread_route=regs["training forward, per thread"][0]))
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


#: SASS opcode (its name before the first dot) -> class, for sass_classes.
SASS_CLASSES = {
    **dict.fromkeys(("FADD", "FMUL", "FFMA", "FMNMX", "FADD32I", "FMUL32I",
                     "FFMA32I", "FRND", "DADD", "DMUL", "DFMA", "DMNMX"),
                    "fp"),
    "MUFU": "mufu",
    **dict.fromkeys(("FSETP", "FSEL", "SEL", "ISETP", "FCHK", "PLOP3", "DSETP",
                     "FSET", "ISET", "P2R", "R2P"), "select/compare"),
    **dict.fromkeys(("LDG", "STG", "LDL", "STL", "LDS", "STS", "LD", "ST",
                     "LDC", "ULDC", "ATOM", "ATOMG", "ATOMS", "RED", "REDG"),
                    "memory"),
    **dict.fromkeys(("BRA", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BAR",
                     "WARPSYNC", "BREAK", "BMOV", "JMP", "VOTE", "VOTEU"),
                    "control"),
}
#: Bytes of one SASS instruction on sm_90.
SASS_BYTES = 16
#: The probe kernels of sass_probe: one SDF evaluation and one SDF VJP per
#: thread, at inputs and outputs in global memory.
SASS_PROBE = """#include <cuda_runtime.h>
#include "sdf_prims.cuh"
#include "scene_sdf.cuh"
template <typename T>
__global__ void probe_sdf(const T* __restrict__ P, T* __restrict__ io, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  io[i] = scene_sdf<T>(P, nullptr, io[i], io[n + i], io[2 * n + i]);
}
template <typename T>
__global__ void probe_vjp(const T* __restrict__ P, T* __restrict__ io, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T gP[SCENE_N_ACC > 0 ? SCENE_N_ACC : 1] = {};
  T gx, gy, gz;
  io[i] = scene_sdf_vjp<T>(P, nullptr, io[i], io[n + i], io[2 * n + i],
                           io[3 * n + i], gx, gy, gz, gP);
  io[n + i] = gx;
  io[2 * n + i] = gy;
  io[3 * n + i] = gz;
  for (int k = 0; k < SCENE_N_ACC; ++k) io[(4 + k) * n + i] = gP[k];
}
template __global__ void probe_sdf<float>(const float*, float*, int);
template __global__ void probe_vjp<float>(const float*, float*, int);
#ifdef SCENE_PRUNE
// The union short-circuit's SDF with its guards; the bounds a parameter.
template <typename T>
__global__ void probe_sdf_fwd(const T* __restrict__ P, const SceneBounds<T> B,
                              T* __restrict__ io, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  io[i] = scene_sdf_fwd<T>(P, nullptr, B, io[i], io[n + i], io[2 * n + i]);
}
template __global__ void probe_sdf_fwd<float>(const float*,
                                              const SceneBounds<float>,
                                              float*, int);
#endif
"""


def sass_functions(path):
    """{mangled kernel name: [(address, opcode, text)]} of the SASS that
    ``cuobjdump -sass`` prints for a library or cubin, with every label's
    address under the key ``(name, "labels")``."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    tool = Path(rk._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=600).stdout
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        lab = re.match(r"\s*(\S+):\s*$", line)
        if lab and not line.strip().startswith("/*"):
            pending.append(lab.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins:
            addr = int(ins.group(1), 16)
            for lab_name in pending:
                labels[name][lab_name] = addr
            pending = []
            body = ins.group(2)
            words = body.split()
            op = words[1] if words[0].startswith("@") else words[0]
            funcs[name].append((addr, op, body))
    return {k: (v, labels[k]) for k, v in funcs.items()}


def sass_summary(instrs, labels, trips=None):
    """What one kernel's SASS holds: instructions and code bytes of the main
    code (the subroutines it calls, the IEEE square root's and division's
    slow paths, counted apart), its instructions by class
    (:data:`SASS_CLASSES`), its loops' code bytes (each backward branch:
    its span), and, where ``trips`` gives each loop's trip count in address
    order, the instructions one call runs outside the slow paths."""

    def target(body):
        m = re.search(r"`\(([^)]+)\)", body)
        if m:
            return labels.get(m.group(1))
        m = re.search(r"(0x[0-9a-f]+)\s*$", body)
        return int(m.group(1), 16) if m else None

    calls = {}
    for addr, op, body in instrs:
        if op.startswith("CALL"):
            to = target(body)
            calls[to] = calls.get(to, 0) + 1
    sub, slow = set(), {}
    for start, n in calls.items():
        ops = []
        for addr, op, _ in instrs:
            if start is not None and addr >= start:
                sub.add(addr)
                ops.append(op)
                if op.startswith("RET"):
                    break
        kind = ("sqrt" if "MUFU.RSQ" in ops else
                "division" if "MUFU.RCP" in ops or "FCHK" in ops else "other")
        slow[kind] = {"calls": n, "instructions": len(ops)}
    main = [(a, op, b) for a, op, b in instrs if a not in sub and op != "NOP"]
    classes = {}
    for _, op, _ in main:
        c = SASS_CLASSES.get(op.split(".")[0], "other")
        classes[c] = classes.get(c, 0) + 1
    loops = []
    for addr, op, body in main:
        start = target(body) if op.startswith("BRA") else None
        if start is not None and start < addr:
            loops.append((start, addr, sum(1 for a, _, _ in main
                                           if start <= a <= addr)))
    loops.sort()
    out = {"instructions": len(main), "code_bytes": len(main) * SASS_BYTES,
           "classes": classes, "slow_paths": slow,
           "loop_bytes": [(b - a + SASS_BYTES) for a, b, _ in loops],
           "local_memory": sum(1 for _, op, _ in main
                               if op.split(".")[0] in ("LDL", "STL"))}
    if trips is not None:
        out["dynamic"] = (len(main) + sum((t - 1) * n for t, (_, _, n)
                                          in zip(trips, loops))
                          if len(trips) == len(loops) else None)
    return out


def start_sass_probes(programs):
    """Start one nvcc per scene without neural leaves: the probe kernels of
    :data:`SASS_PROBE` on the scene's generated SDF, into a cubin under the
    build directory. Returns {label: (cubin path, process)}."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    out = {}
    for label, prog in programs.items():
        if prog.mlps:
            continue
        d = rk.BUILD_DIR / "sass_probe" / rk.kernel_key(prog)
        d.mkdir(parents=True, exist_ok=True)
        (d / "scene_sdf.cuh").write_text(prog.cuda_source())
        (d / "probe.cu").write_text(SASS_PROBE)
        cubin = d / "probe.cubin"
        flags = [f for f in rk.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        out[label] = (cubin, subprocess.Popen(
            [rk._nvcc(), *flags, "-cubin", "-I", str(rk.CSRC), "-I", str(d),
             "-o", str(cubin), str(d / "probe.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return out


def sass_report(label, prog, probe):
    """SASS of one scene (sass_summary): per SDF evaluation and per SDF
    VJP from the probe kernels (``probe``: start_sass_probes' entry; the
    probe's own loads and stores included), and the f32 per-thread serving
    forwards (one thread per ray, and lane refill), marches (the same two)
    and backward (history mode) of the scene's library, with their loops'
    code bytes. Prints it and returns it."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    cubin, proc = probe
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"{label}: SASS probe build failed:\n{log}")
    # A package from before the rolled loops has none.
    trips = list(getattr(prog, "loop_trips", ()))
    report = {}
    for name, (instrs, labels) in sass_functions(cubin).items():
        kind = ("sdf_fwd" if "probe_sdf_fwd" in name else
                "sdf" if "probe_sdf" in name else "vjp")
        # The VJP runs each loop forward (its tape) and then in reverse.
        report[kind] = sass_summary(
            instrs, labels, trips if kind == "sdf" else trips + trips[::-1])
    lib = sass_functions(rk._lib_path(rk.kernel_key(prog)))
    for kind, pattern in (("forward", r"_Z\d+render_fwd_kernelIfE"),
                          ("refill", r"_Z\d+render_fwd_refill_kernelIfE"),
                          ("march", r"_Z\d+march_kernelIfLb1EE"),
                          ("march_refill", r"_Z\d+march_refill_kernelIfE"),
                          ("backward", r"_Z\d+render_bwd_kernelIfLb0ELb0E"
                                       r"Lb0ELb0ELb0EE")):
        # A package from before the lane-refill forward (march) has no
        # refill (march_refill).
        name = next((n for n in lib if re.match(pattern, n)), None)
        if name is not None:
            report[kind] = sass_summary(*lib[name])
    print(f"SASS ({label}, f32): " + "; ".join(
        f"{k}: {v['instructions']} instructions ({v.get('dynamic')} run per "
        f"call), {v['code_bytes']} code bytes, classes {v['classes']}, "
        f"slow paths {v['slow_paths']}, loops (bytes) "
        f"{v['loop_bytes']}, local loads/stores {v['local_memory']}"
        for k, v in report.items()))
    return report


def lane_efficiency(nlive, valid, steps, tail=5):
    """Share of a warp's SDF evaluations that its lanes use when each warp
    of 32 consecutive slots runs until its slowest ray stops: Σ evaluations
    over Σ 32 × the warp's largest (a ray evaluates once per live step and
    once more where it froze; an invalid slot not at all); then the same
    with the ``tail`` evaluations every valid ray adds after its march."""
    import torch

    n = nlive.reshape(-1).long()
    v = valid.reshape(-1)
    e = torch.where(v, torch.where(n < steps, n + 1, n), 0).reshape(-1, 32)
    w = e.max(dim=1).values
    t = tail * v.reshape(-1, 32).any(dim=1).long()
    return (float(e.sum()) / float(32 * w.sum()),
            float(e.sum() + tail * v.sum()) / float(32 * (w + t).sum()))


def bulb_backward_digest(prog, flat, rays7):
    """sha256 of the bulb's f32 backward (with the forward's history, 24
    steps, tau = 0, at the fit's start, the scale at BULB_SCALE0): the flat
    parameter cotangent and the ray cotangents for a cotangent drawn from
    seed 67 (BULB_BACKWARD_DIGEST). ``flat`` holds the start's
    parameters."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    _, ex = rk.march_forward(prog, flat, rays7, BULB_TRAIN_MARCH, 0.0, 5e-2,
                             log_hist=True)
    g = torch.as_tensor(np.random.default_rng(67).standard_normal(
        (8,) + tuple(rays7.shape[1:])), dtype=torch.float32).to(rays7.device)
    run = bk.fused_backward(prog, flat, rays7, g, BULB_TRAIN_MARCH, 0.0, 5e-2,
                            hist=ex["hist"], nlive=ex["nlive"])
    digest = hashlib.sha256()
    for t in (run[0], run[2]):
        digest.update(t.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


def bulb_planes_digest(prog, flat, rays7, m_flat, m_rays7):
    """sha256 of the bulb's f32 serving-forward planes (64 steps, tau = 1e-4
    and 0) and march planes (tau = 1e-4) at the main path's inputs
    (BULB_PLANES_DIGEST)."""
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    digest = hashlib.sha256()
    for tau in (BULB_TAU, 0.0):
        out, _ = rk.march_forward(prog, flat, rays7, BULB_STEPS, tau, 5e-2)
        digest.update(out.contiguous().cpu().numpy().tobytes())
    planes = mk.march_planes(prog, m_flat, m_rays7, BULB_STEPS, BULB_TAU)
    digest.update(planes.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


def bulb_slice(card, out_dir: Path, sass):
    """The Mandelbulb slice on the card: the bulb's library (registers,
    stack; no spill store in its f32 per-thread backward), the SASS of
    ``sass`` (sass_report of the bulb and test_scene2), the serving
    forward's and march's planes against the parent commit's digest, the
    lane efficiency of the serving march and of the march with one thread
    per ray, every kernel against its plain version (forward at tau = 1e-4
    and 0 with the agreement limit and its control, the training outputs,
    the backward with history and recompute, the march and its backward,
    the march's lane-refill and one-thread-per-ray entries against each
    other, the two-level backward; each backward mode ray by ray and leaf by
    leaf with its controls; f32 at 1440×900, f64 at 256×160), then the main
    paths, counted: the README's serving command, 20 FastRenderer frames and
    20 Renderer(use_pallas=True) frames (one lane-refill march each), 3
    optimize() steps on the scale
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
          f"{prog.vjp_ops_per_eval} per SDF VJP (+{prog.vjp_recompute_ops} "
          "recomputed in its reverse loop); ptxas (registers, stack "
          "bytes, spill store bytes): "
          + "; ".join(f"{e[:40]} {r} {f} {sp}" for e, r, f, sp in entries))
    simt_bwd = [(e, sp) for e, r, f, sp in entries if re.match(
        r"_Z\d+render_bwd_kernelIfLb\dELb\dELb\dELb0ELb\dEE", e)]
    check(len(simt_bwd) == 6, f"bulb: no ptxas report of the six f32 "
          f"per-thread backward instantiations ({len(simt_bwd)} found)")
    check(all(sp == 0 for _, sp in simt_bwd),
          f"bulb: spill stores in the f32 per-thread backward: {simt_bwd}")
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
    digest = bulb_planes_digest(prog, flat, rays7, m_flat, m_rays7)
    print(f"bulb planes digest (serving forward at tau = {BULB_TAU:g} and 0, "
          f"march): {digest}, the parent commit's {BULB_PLANES_DIGEST}")
    check(digest == BULB_PLANES_DIGEST,
          "bulb: the forward's or the march's planes moved")
    bwd_digest = bulb_backward_digest(prog, split_params_padded(
        with_scale(main.init_params, BULB_SCALE0), torch.float32,
        main.device)[0], rays7)
    print(f"bulb backward digest: {bwd_digest}, the parent commit's "
          f"{BULB_BACKWARD_DIGEST}")
    check(bwd_digest == BULB_BACKWARD_DIGEST,
          "bulb: the backward's cotangents moved")
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
    march_entries(f"{label} tau={BULB_TAU:g}", prog, m_flat, m_rays7,
                  BULB_STEPS, BULB_TAU)
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
    march_entries(f"{label64} tau={BULB_TAU:g}", prog, mf_flat, mf_rays,
                  BULB_STEPS, BULB_TAU)
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
        counter.LAUNCHES = mk.REFILL_LAUNCHES = 0
        with torch.no_grad(), PlainMarchCalls() as plain:
            start.record()
            for _ in range(BULB_FRAMES):
                img = renderer.render(params, BENCH_Q, BENCH_T,
                                      mode=BULB_MODE, degree=2)
            stop.record()
            torch.cuda.synchronize()
        return (img, counter.LAUNCHES, mk.REFILL_LAUNCHES, plain.n,
                start.elapsed_time(stop) / BULB_FRAMES)

    frame, launches, _, n_plain, frame_ms = frames(main, rk)
    mod_frame, mod_launches, mod_refill, m_plain, mod_ms = frames(modular,
                                                                  mk)
    print(f"bulb serving ({BULB_W}x{BULB_H}, {BULB_STEPS} steps, tau "
          f"{BULB_TAU:g}, mode normal): cli render 1 launch; FastRenderer "
          f"{BULB_FRAMES} frames, forward launches {launches}, plain marches "
          f"{n_plain}, {frame_ms:.4f} ms per frame; Renderer(use_pallas="
          f"True) {BULB_FRAMES} frames, march launches {mod_launches} (lane "
          f"refill {mod_refill}), plain marches {m_plain}, {mod_ms:.4f} ms "
          "per frame (CUDA events)")
    check((launches, n_plain, mod_launches, mod_refill, m_plain)
          == (BULB_FRAMES, 0, BULB_FRAMES, BULB_FRAMES, 0),
          "bulb serving: launches")
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
        expect={"void render_fwd_refill_kernel<float>": (ms, 1)})

    def modular_frame():
        with torch.no_grad():
            modular.render(params, BENCH_Q, BENCH_T, mode=BULB_MODE, degree=2)

    mod_prof = profile_frames(
        modular_frame, mod_ms, frames=3,
        expect={"void march_refill_kernel<float>": (march_ms, 1)})
    march_prof_ms = next((v for k_, v in mod_prof.items() if k_.startswith(
        "void march_refill_kernel<float>")), None)
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
          f"{sum(frame_prof.values()):.4f} ms; modular frame {mod_ms:.4f} "
          f"ms, busy {sum(mod_prof.values()):.4f} ms, of which the march "
          f"{march_prof_ms:.4f} ms (profiler)")

    # 5. Bounds from this run's inputs: operations from the op counts and
    # the steps the rays really took, bytes from the planes, the history
    # and the partial rows, each read or written once.
    n_valid = int((rays7[6] > 0.5).sum())
    live_sum, n_frozen = live_steps(prog, flat, rays7, BULB_STEPS, BULB_TAU)
    _, ex_l = rk.march_forward(prog, flat, rays7, BULB_STEPS, BULB_TAU, 5e-2,
                               log_hist=True)
    lanes = lane_efficiency(ex_l["nlive"], rays7[6] > 0.5, BULB_STEPS)
    del ex_l
    # The march's own: the modular rays, one terminal evaluation a ray.
    _, ex_m = rk.march_forward(prog, m_flat, m_rays7, BULB_STEPS, BULB_TAU,
                               5e-2, log_hist=True)
    m_lanes = lane_efficiency(ex_m["nlive"], m_rays7[6] > 0.5, BULB_STEPS,
                              tail=1)
    del ex_m
    print(f"bulb lane efficiency of one thread per ray (warps of 32 slots, "
          f"serving): forward {lanes[0]:.4f}, with its 5 tail evaluations "
          f"{lanes[1]:.4f}; march (modular rays) {m_lanes[0]:.4f}, with its "
          f"terminal evaluation {m_lanes[1]:.4f}; the refill kernels' warps "
          "evaluate on every lane")
    m_valid = int((m_rays7[6] > 0.5).sum())
    m_live, _ = live_steps(prog, m_flat, m_rays7, BULB_STEPS, BULB_TAU)
    plane = rays7.shape[1] * rays7.shape[2] * rays7.element_size()
    m_plane = m_rays7.shape[1] * m_rays7.shape[2] * m_rays7.element_size()
    work, _ = backward_work(prog, rays7, s2, m_rays7)
    work.update({
        "forward": (forward_ops_live(prog, n_valid, live_sum, n_frozen),
                    15 * plane),
        # A march evaluates once per live step and once more: where it
        # froze (that evaluation is its terminal distance) or at its end.
        "march": ((m_live + m_valid) * prog.ops_per_eval
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
             march_ms, march_plain_ms, "march", ("march_refill_kernel",
                                                 "IfE"),
             {"max_abs_err": errs["march"]}),
            ("render_bwd_bulb", "render_bwd.cu", "pallas_backward.py:119",
             train_launches, times["history"], times["plain"], "history",
             ("render_bwd_kernel", "IfLb0ELb0ELb0ELb0ELb0EE"),
             errs[("history", s2, 0.0, False)]),
            ("render_bwd_two_level_bulb", "render_bwd.cu",
             "pallas_backward.py:377", two_level_launches,
             times["two-level"], times["plain two-level"], "two-level",
             ("render_bwd_kernel", "IfLb0ELb1ELb0ELb0ELb1EE"),
             errs[("two-level", s2, 0.0, False)]),
            ("march_bwd_bulb", "render_bwd.cu", "pallas_march.py:358",
             mod_counts[3], times["march-only"], times["plain march-only"],
             "march-only", ("render_bwd_kernel", "IfLb0ELb0ELb1ELb0ELb1EE"),
             errs[("march-only", s2, 0.0, False)]))]
    rows[0].update(ms_tau_0=ms_tau0, frame_ms=frame_ms,
                   lane_efficiency_one_thread_per_ray=lanes[0],
                   lane_efficiency_with_tail=lanes[1],
                   sass_per_eval=sass["mandelbulb"]["sdf"]["dynamic"],
                   sass_classes_per_eval=sass["mandelbulb"]["sdf"]["classes"],
                   sass_loop_bytes=sass["mandelbulb"]["refill"]["loop_bytes"],
                   code_bytes=sass["mandelbulb"]["refill"]["code_bytes"],
                   agree_share=errs["agree"][0],
                   disagreeing_rays=errs["agree"][1],
                   agree_share_control=errs["agree"][2],
                   profiler_kernel_ms=next(
                       (v for k_, v in frame_prof.items()
                        if k_.startswith(
                            "void render_fwd_refill_kernel<float>")),
                       None))
    rows[1].update(frame_ms=mod_ms, refill_launches=mod_refill,
                   lane_efficiency_one_thread_per_ray=m_lanes[0],
                   lane_efficiency_with_terminal=m_lanes[1],
                   sass_loop_bytes=sass["mandelbulb"]["march_refill"][
                       "loop_bytes"],
                   code_bytes=sass["mandelbulb"]["march_refill"][
                       "code_bytes"],
                   profiler_kernel_ms=march_prof_ms)
    serving = {mode: errs[(mode, BULB_STEPS, BULB_TAU, False)]
               for mode in ("history", "march-only")}
    for row in rows[2:]:
        row.update(steps=s2, f64_min_ray_share_within=min(
            r["ray_share_within"] for r in f64_runs),
            f64_max_rel_err_leaves=max(
                r["max_rel_err_leaves"] for r in f64_runs))
    rows[2].update(sass_per_vjp=sass["mandelbulb"]["vjp"]["dynamic"],
                   sass_classes_per_vjp=sass["mandelbulb"]["vjp"]["classes"],
                   sass_loop_bytes=sass["mandelbulb"]["backward"][
                       "loop_bytes"],
                   code_bytes=sass["mandelbulb"]["backward"]["code_bytes"],
                   vjp_recompute_ops=prog.vjp_recompute_ops,
                   ms_recompute=times["recompute"],
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


class WithoutRemat:
    """The XLA route as it was before its per-step remat: the same plain
    march differentiated without checkpoints (``remat=False`` forced on
    ``render_kernel._reference_march`` while active)."""

    def __enter__(self):
        from ray_marching_tpu_torch.ops import render_kernel as rk

        self.rk, self.fn = rk, rk._reference_march
        rk._reference_march = lambda *a, **k: self.fn(*a, **dict(k,
                                                                remat=False))
        return self

    def __exit__(self, *exc):
        self.rk._reference_march = self.fn


class PerThreadRoute:
    """The kernels' per-thread MLP route forced on a scene with a
    tensor-core leaf (``render_kernel.mlp_route`` answers ``"thread"``
    while active; the backward takes its forward's route)."""

    def __enter__(self):
        from ray_marching_tpu_torch.ops import render_kernel as rk

        self.rk, self.fn = rk, rk.mlp_route
        rk.mlp_route = lambda program, dtype: "thread"
        return self

    def __exit__(self, *exc):
        self.rk.mlp_route = self.fn


def host_strip_planes(tiled, s):
    """``TiledRenderer._strip_planes`` with the strip's ray planes built on
    the host: numpy's one-pass grid formula (``camera._pixel_center_grid``)
    over the strip's rows, copied to the card by ``bake_ray_planes``."""
    import torch

    from ray_marching_tpu_torch.camera import _sensor_axes
    from ray_marching_tpu_torch.render.fast import LANES, bake_ray_planes

    cam, gd, fast = tiled.config.camera_config, tiled.grid_dtype, tiled.fast
    r0 = s * tiled.strip_height
    px, py = _sensor_axes(cam, gd, (r0, r0 + tiled.strip_height))
    pos = np.zeros((len(py), len(px), 3), dtype=gd)
    pos[:, :, 0] = px[None, :]
    pos[:, :, 1] = py[:, None]
    rel = pos - np.asarray([0.0, 0.0, -cam.focal_length], dtype=gd)
    dirs = rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    pos0, dir0 = bake_ray_planes(pos.transpose(2, 0, 1),
                                 dirs.transpose(2, 0, 1), fast.rows_per_cam,
                                 tiled.dtype, tiled.device)
    rows_real = min(tiled.strip_height, cam.px_height - r0)
    slot = torch.arange(fast.rows_per_cam * LANES, device=tiled.device)
    valid = (slot < rows_real * cam.px_width).to(tiled.dtype)
    return pos0, dir0, valid.reshape(fast.rows_per_cam, LANES), rows_real


def measured(fn, reps=1):
    """``fn()`` after one warm-up call: (host ms per call, each call ending in
    a synchronise; peak device bytes a call allocates above what was
    allocated before it; the last result). An out-of-memory error gives
    (None, None, None)."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        return ms, torch.cuda.max_memory_allocated() - base, out
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None, None, None


def image_agreement(label, got, want, conv, atol):
    """Images (N, H, W, C) on the pixels ``conv`` (N, H, W) marks: the share
    outside ``atol`` (or NaN in one only) at most MAX_SHARE_OUT_F32; returns
    (max abs difference, bitwise-equal share)."""
    import torch

    got, want = got.to(want.device), want
    m = conv[..., None].expand_as(want)
    diff = (got - want).abs()
    both_nan = torch.isnan(got) & torch.isnan(want)
    bad = ((diff > atol) | (torch.isnan(got) != torch.isnan(want))) & m
    share = float(bad.sum()) / max(int(m.sum()), 1)
    same = float((((got == want) | both_nan) & m).sum()) / max(int(m.sum()),
                                                                1)
    worst = float(torch.where(m & ~both_nan, diff, 0.0).max())
    print(f"  {label}: {int(conv.sum())} converged pixels, max abs diff "
          f"{worst:.3e}, share outside {atol:g} {share:.3e}, bitwise-equal "
          f"share {same:.6f}")
    check(share <= MAX_SHARE_OUT_F32, f"{label}: {share:.3e} of the converged "
                                      f"pixels outside {atol:g}")
    return worst, same


def converged_pixels(renderer, params, q, t, steps=STEPS):
    """(N, H, W) bool: the pixels whose plain march ends within CONVERGED."""
    import torch

    with torch.no_grad():
        qq, tt = renderer._pose(q, t)
        hit, _ = renderer._march_planes(params, *renderer._pose_planes(qq, tt),
                                        steps)
        return renderer._assemble([(hit[3].abs() < CONVERGED).to(
            renderer.dtype)])[..., 0] > 0.5


def _leaf_scales(tree):
    """Per leaf, the scale a difference is measured against: the largest
    entry among the scalar leaves (the flat parameter cotangent, as the
    kernel-vs-plain checks hold it), a matrix leaf's own largest entry."""
    flat = max((float(w.abs().max()) for w in tree.values() if w.dim() < 2),
               default=0.0)
    return {k: (float(w.abs().max()) if w.dim() >= 2 else flat) or 1.0
            for k, w in tree.items()}


def _leaf_dist(a, b):
    return float((a.to(b.device, b.dtype) - b).abs().max())


def grads_agreement(label, got, want, rtol, ref=None):
    """Gradient trees as ``{path: tensor}``: ``got`` against ``want`` on
    :func:`_leaf_scales`, every leaf printed (with ``ref``, an f64
    gradient of the same loss, both trees' distances from it too, a report
    its caller does not check). Returns whether every entry is finite and
    every leaf within ``rtol``."""
    import torch

    scales = _leaf_scales(want if ref is None else ref)
    ok = all(bool(torch.isfinite(got[k]).all() and torch.isfinite(w).all())
             for k, w in want.items())
    worst = 0.0
    for k, w in want.items():
        rel = _leaf_dist(got[k], w) / scales[k]
        worst = max(worst, rel)
        line = f"    {k}: {rel:.3e} apart"
        if ref is not None:
            line += (f"; from f64 {_leaf_dist(got[k], ref[k]) / scales[k]:.3e}"
                     f" and {_leaf_dist(w, ref[k]) / scales[k]:.3e}")
        print(line)
    ok = ok and worst <= rtol
    verdict = (" (reported, not checked)" if ref is not None
               else "" if ok else ": outside the limit")
    print(f"  {label}: {len(want)} leaves, largest difference {worst:.3e} "
          f"(scalar leaves against the largest scalar entry, matrices "
          f"against their own; limit {rtol:g}){verdict}")
    return ok


def w256_witness(routes, p0, conv_w, target, gradient, figures):
    """Where the w256 kernel pair's f32 gradient departs from the plain
    march in f64: three losses (the frame's mean square on converged pixels
    and on every pixel, and the training loss, the frame against the frame
    of weights 1.02x) through the tensor-core kernel pair, the per-thread
    kernel pair (PerThreadRoute), the plain march in f32, and the kernel
    pair in f64 (per thread) against the plain march in f64, checked as
    W256_TRAIN_GRAD_RTOL says. Then a few Adam steps of the training loss
    on each f32 route: the losses they reach, reported."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.scene.graph import param_paths

    def launches():
        return rk.LAUNCHES, bk.LAUNCHES, rk.TC_LAUNCHES, bk.TC_LAUNCHES

    r64, p64 = neural_renderer(NEURAL_RES, torch.float64, march_impl="xla")
    k64, _ = neural_renderer(NEURAL_RES, torch.float64)
    names = {"fused": "tensor cores", "thread": "per thread",
             "xla": "plain f32"}
    for name, w_, tgt in (("converged pixels", conv_w, None),
                          ("every pixel", 1.0, None),
                          ("training loss", 1.0, target)):
        w64 = w_ if isinstance(w_, float) else w_.double()
        t64 = None if tgt is None else tgt.double()
        g64 = gradient(r64, p64, w64, t64)
        g32 = {k: gradient(routes[k], p0, w_, tgt) for k in ("fused", "xla")}
        before = launches()
        with PerThreadRoute():
            g32["thread"] = gradient(routes["fused"], p0, w_, tgt)
        check(tuple(b - a for a, b in zip(before, launches()))
              == (1, 1, 0, 0), "w256 witness: the per-thread kernel pair "
                               "did not run as one forward and one backward")
        gk64 = gradient(k64, p64, w64, t64)
        for a in ("fused", "thread"):
            grads_agreement(f"w256 gradient ({name}), {names[a]} vs plain "
                            "f32, with f64", g32[a], g32["xla"],
                            XLA_GRAD_RTOL["w256"], ref=g64)
        scales = _leaf_scales(g64)
        far = {k: max(_leaf_dist(g[n], g64[n]) / scales[n] for n in g64)
               for k, g in g32.items()}
        far["kernel_f64"] = max(_leaf_dist(gk64[n], g64[n]) / scales[n]
                                for n in g64)
        key = name.replace(" ", "_")
        figures.update({f"w256_grad_{key}_from_f64_{k}": v
                        for k, v in far.items()})
        print(f"  w256 gradient ({name}), largest leaf distance from the "
              "plain march in f64: "
              + ", ".join(f"{names[k]} {far[k]:.3e}" for k in names)
              + f"; the kernel pair in f64 {far['kernel_f64']:.3e}")
        finite = all(bool(torch.isfinite(v).all())
                     for g in (*g32.values(), gk64) for v in g.values())
        check(finite, f"w256 gradient ({name}): non-finite")
        if name != "converged pixels":
            check(far["kernel_f64"] <= TOL_NEURAL_BWD["f64"],
                  f"w256 gradient ({name}): the kernel pair in f64 against "
                  "the plain march in f64")
    # ``far`` is the training loss's, the loop's last.
    check(far["thread"] <= W256_TRAIN_GRAD_RTOL["thread"]
          and far["fused"] <= W256_TRAIN_GRAD_RTOL["tc"],
          "w256 training loss's gradient: a kernel pair in f32 too far from "
          "the plain march in f64")
    del r64, p64, k64, g64, g32, gk64

    def adam_losses(r, steps=4):
        p = leaf_params(p0)
        opt = torch.optim.Adam(list(param_paths(p).values()), lr=1e-4)
        losses = []
        for _ in range(steps + 1):
            opt.zero_grad(set_to_none=True)
            img = r.render(p, NEURAL_Q, NEURAL_T, mode=0, degree=1)
            loss = torch.mean((torch.nan_to_num(img) - target) ** 2)
            losses.append(float(loss))
            loss.backward()
            opt.step()
        return losses

    losses = {"fused": adam_losses(routes["fused"]),
              "xla": adam_losses(routes["xla"])}
    with PerThreadRoute():
        losses["thread"] = adam_losses(routes["fused"])
    figures.update({f"w256_adam_losses_{k}": v for k, v in losses.items()})
    print("  w256 training loss over 4 Adam steps (lr 1e-4): "
          + "; ".join(f"{names[k]} " + " ".join(f"{v:.9e}" for v in losses[k])
                      for k in names))


def lighting_tiled_xla(card, out_dir: Path):
    """The lighting modes, the Fourier colourmap, the tiled renderer and the
    XLA route's backwards on the card, each path counted (the counters set
    to 0 just before it and read just after) and held against its
    reference; returns the launch counts and figures for the kernels line."""
    import torch

    from ray_marching_tpu_torch.cli import main as cli_main
    from ray_marching_tpu_torch.io.image import write_png
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.lighting import EXTRA_MODES
    from ray_marching_tpu_torch.render.pipeline import Renderer
    from ray_marching_tpu_torch.render.shaders import MODES
    from ray_marching_tpu_torch.render.tiled import (
        TWO_PASS_MODES,
        TiledRenderer,
    )
    from ray_marching_tpu_torch.scene import registry
    from ray_marching_tpu_torch.scene.graph import param_paths

    t_phase = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    q, t = BENCH_Q, BENCH_T
    scene2 = registry.make_scene("test_scene2")
    cfg = config(1920, 1080)
    fast = FastRenderer(scene2, cfg, dtype=torch.float32)
    params = fast.init_params
    plain_fast = FastRenderer(scene2, cfg, dtype=torch.float32,
                              march_impl="xla")
    modular = Renderer(scene2, dataclasses.replace(cfg, use_pallas=True),
                       dtype=torch.float32)
    plain_modular = Renderer(scene2, cfg, dtype=torch.float32)
    conv = converged_pixels(plain_fast, params, q, t)
    counts, figures = {}, {}

    # 1. The lighting modes, counted: one march-kernel launch a frame, the
    # image against the plain march's; then every mode with the extras from
    # one launch, the lighting images bit for bit the single-mode ones.
    print(f"lighting modes (test_scene2 1920x1080, {STEPS} steps, f32) on "
          f"{card}:")
    singles = {}
    for name, r, plain_r, counter in (
            ("fast", fast, plain_fast, rk),
            ("modular", modular, plain_modular, mk)):
        for mode in EXTRA_MODES:
            with torch.no_grad():
                counter.LAUNCHES = 0
                img = r.render(params, q, t, mode=mode, degree=2)
                torch.cuda.synchronize()
                n = counter.LAUNCHES
                want = plain_r.render(params, q, t, mode=mode, degree=2)
            check(n == 1, f"{name} {mode}: {n} kernel launches for a frame")
            counts[f"{name}_{mode}"] = n
            image_agreement(f"{name} {mode} vs the plain march", img, want,
                            conv, LIGHT_ATOL)
            check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
                  f"{name} {mode}: outside [0, 1]")
            singles[name, mode] = img
            write_png(out_dir / f"test_scene2_{name}_{mode}.png", img)
        counter.LAUNCHES = 0
        with torch.no_grad():
            images = r.render_all_modes(params, q, t, degree=2, extras=True)
        torch.cuda.synchronize()
        check(counter.LAUNCHES == 1 and set(images)
              == set(MODES) | set(EXTRA_MODES),
              f"{name} extras: {counter.LAUNCHES} launches, {sorted(images)}")
        counts[f"{name}_extras"] = counter.LAUNCHES
        for mode in EXTRA_MODES:
            check(torch.equal(images[mode], singles[name, mode]),
                  f"{name} extras: {mode} differs from its single render")
        print(f"  {name} render_all_modes(extras=True): 10 images from 1 "
              "launch, the lighting images bitwise the single renders")
        del images
    with torch.no_grad():
        fourier = FastRenderer(scene2, dataclasses.replace(
            cfg, cmap_fourier=True), dtype=torch.float32)
        spin_f = fourier.render(params, q, t, mode=7, degree=2)
        spin_g = fast.render(params, q, t, mode=7, degree=2)
        spin_m = Renderer(scene2, dataclasses.replace(
            cfg, cmap_fourier=True, use_pallas=True),
            dtype=torch.float32).render(params, q, t, mode=7, degree=2)
    image_agreement("spin, Fourier colourmap vs the gather", spin_f, spin_g,
                    conv, 0.02)
    image_agreement("spin, Fourier colourmap, fast vs modular", spin_f,
                    spin_m, conv, MODULAR_VS_FAST_ATOL)
    write_png(out_dir / "test_scene2_spin_fourier.png", spin_f)
    del fourier, spin_f, spin_g, spin_m

    # Times: frames by CUDA events, and the profiler's split between the
    # kernel and the plain-torch SDF queries.
    flat, rays7 = main_rays(fast, q, t)
    fwd_ms = kernel_ms(lambda: rk.fused_march_normals(
        fast.program, flat, rays7, STEPS, 0.0, 5e-2), 20)
    m_flat, m_rays7 = modular_rays(modular, q, t)
    march_ms = kernel_ms(lambda: mk.march_planes(
        modular.program, m_flat, m_rays7, STEPS, 0.0), 20)
    del flat, rays7, m_flat, m_rays7
    for name, r, kernel, k_ms in (
            ("fast", fast, "void render_fwd_kernel<float>", fwd_ms),
            ("modular", modular, "void march_kernel<float, false>",
             march_ms)):
        for mode in (0,) + EXTRA_MODES:
            def frame():
                with torch.no_grad():
                    return r.render(params, q, t, mode=mode, degree=2)

            ms = cuda_ms(frame, LIGHT_FRAMES)
            prof = profile_frames(frame, ms, frames=3,
                                  expect={kernel: (k_ms, 1)})
            busy = sum(prof.values())
            k_dev = sum(v for k, v in prof.items() if k.startswith(kernel))
            figures[f"{name}_{mode}_frame_ms"] = ms
            figures[f"{name}_{mode}_busy_ms"] = busy
            figures[f"{name}_{mode}_kernel_ms"] = k_dev
            print(f"lighting frame {name} mode {mode}: {ms:.4f} ms per frame "
                  f"(CUDA events, {LIGHT_FRAMES} frames); device busy "
                  f"{busy:.4f} ms ({busy / ms:.3f} of the frame): the kernel "
                  f"{k_dev:.4f} ms, plain torch (posing, SDF queries, "
                  f"shading) {busy - k_dev:.4f} ms ({(busy - k_dev) / busy:.3f}"
                  " of busy)")

    # 2. The shaded gradient, counted: one forward and one backward launch
    # through FastRenderer, the march and its backward through the modular
    # renderer; fast against modular.
    with torch.no_grad():
        target = fast.render(perturbed(params, "c1/c0/radius", 1.2), q, t,
                             mode="shaded", degree=2)

    def shaded_grad(r):
        p = leaf_params(params)
        img = r.render(p, q, t, mode="shaded", degree=2)
        loss = torch.mean((torch.nan_to_num(img) - target) ** 2)
        loss.backward()
        return ({k: v.grad for k, v in param_paths(p).items()},
                float(loss.detach()))

    rk.LAUNCHES = bk.LAUNCHES = 0
    g_fast, l_fast = shaded_grad(fast)
    torch.cuda.synchronize()
    counts["fast_shaded_grad"] = (rk.LAUNCHES, bk.LAUNCHES)
    mk.LAUNCHES = bk.MARCH_LAUNCHES = 0
    g_mod, l_mod = shaded_grad(modular)
    torch.cuda.synchronize()
    counts["modular_shaded_grad"] = (mk.LAUNCHES, bk.MARCH_LAUNCHES)
    print(f"shaded gradient (1080p, MSE against the frame with c1/c0/radius "
          f"x1.2): FastRenderer loss {l_fast:.6e}, forward/backward launches "
          f"{counts['fast_shaded_grad']}; Renderer(use_pallas=True) loss "
          f"{l_mod:.6e}, march/march-backward launches "
          f"{counts['modular_shaded_grad']}")
    check(counts["fast_shaded_grad"] == (1, 1)
          and counts["modular_shaded_grad"] == (1, 1),
          "shaded gradient: launches")
    check(l_fast > 0 and abs(l_fast - l_mod) <= 1e-3 * l_fast,
          f"shaded gradient: losses {l_fast} and {l_mod}")
    check(grads_agreement("shaded gradient, fast vs modular", g_fast, g_mod,
                          SHADED_GRAD_RTOL), "shaded gradient: fast vs modular")
    del g_fast, g_mod, target

    # The bulb's shaded frame at its serving size (875 ops a query).
    bulb = bulb_renderer(FastRenderer, BULB_W, BULB_H, torch.float32)

    def bulb_frame():
        with torch.no_grad():
            return bulb.render(bulb.init_params, q, t, mode="shaded", degree=2)

    rk.LAUNCHES = 0
    img = bulb_frame()
    torch.cuda.synchronize()
    counts["bulb_shaded"] = rk.LAUNCHES
    check(rk.LAUNCHES == 1 and bool(torch.isfinite(img).all()),
          "bulb shaded frame: launches or non-finite")
    write_png(out_dir / "mandelbulb_shaded.png", img)
    ms = cuda_ms(bulb_frame, 5)
    prof = profile_frames(bulb_frame, ms, frames=2)
    busy = sum(prof.values())
    k_dev = sum(v for k, v in prof.items() if k.startswith("void render_fwd"))
    figures.update(bulb_shaded_frame_ms=ms, bulb_shaded_busy_ms=busy,
                   bulb_shaded_kernel_ms=k_dev)
    print(f"bulb shaded frame ({BULB_W}x{BULB_H}, {BULB_STEPS} steps, tau "
          f"{BULB_TAU:g}): {ms:.4f} ms, busy {busy:.4f} ms, the kernel "
          f"{k_dev:.4f} ms, the SDF queries and shading {busy - k_dev:.4f} ms")
    del bulb, img

    # 3. Tiled frames at 8K against one pass.
    big = config(*TILED_8K)
    tiled = TiledRenderer(scene2, big, strip_height=STRIP,
                          dtype=torch.float32)
    one = FastRenderer(scene2, big, dtype=torch.float32)
    conv8k = converged_pixels(one, params, q, t).cpu()
    print(f"tiled 8K ({TILED_8K[0]}x{TILED_8K[1]}, {tiled.num_strips} strips "
          f"of {STRIP} rows, {STEPS} steps, f32) on {card}:")
    for mode in TILED_MODES:
        two = (mode if isinstance(mode, str) else MODES[mode]) \
            in TWO_PASS_MODES

        def tiled_frame():
            rk.LAUNCHES = 0
            return tiled.render(params, q, t, mode=mode, degree=2)

        def one_frame():
            with torch.no_grad():
                return one.render(params, q, t, mode=mode, degree=2)

        t_ms, t_peak, img_t = measured(tiled_frame, 2)
        t_launches = rk.LAUNCHES
        o_ms, o_peak, img_o = measured(one_frame, 2)
        check(t_ms is not None and o_ms is not None,
              f"tiled 8K mode {mode}: out of memory")
        check(t_launches == tiled.num_strips * (2 if two else 1),
              f"tiled 8K mode {mode}: {t_launches} forward launches")
        counts[f"tiled_8k_{mode}"] = t_launches
        img_o = img_o.cpu()
        worst, same = image_agreement(f"tiled vs one pass, mode {mode}",
                                      img_t, img_o, conv8k, TOL_F32[4])
        figures.update({f"tiled_8k_{mode}_ms": t_ms,
                        f"tiled_8k_{mode}_peak_bytes": t_peak,
                        f"one_pass_8k_{mode}_ms": o_ms,
                        f"one_pass_8k_{mode}_peak_bytes": o_peak,
                        f"tiled_8k_{mode}_bitwise_share": same})
        print(f"  mode {mode}: tiled {t_ms:.1f} ms ({t_launches} forward "
              f"launches, peak {t_peak / 2**30:.3f} GiB above the baseline, "
              f"the frame copied to the host), one pass {o_ms:.1f} ms (1 "
              f"launch, peak {o_peak / 2**30:.3f} GiB, the frame on the "
              "card)")
        if mode == "shaded":
            write_png(out_dir / "test_scene2_8k_tiled_shaded.png", img_t)
        del img_t, img_o
    # The strips' planes built on the host (host_strip_planes) against the
    # device builder the renderer takes (camera.pixel_center_rows): the
    # same bits, and the mode-0 frame's time with each, in turns.
    same_planes = all(
        all(torch.equal(a, b) for a, b in zip(
            sum(host_strip_planes(tiled, s)[:2], ()),
            sum(tiled._strip_planes(s)[:2], ())))
        for s in range(tiled.num_strips))
    check(same_planes, "tiled 8K: host-built and device-built strip planes "
                       "differ")

    def frame0():
        return tiled.render(params, q, t, mode=0, degree=2)

    turns = {"device": [], "host": []}
    for _ in range(2):
        for how in turns:
            if how == "host":
                tiled._strip_planes = lambda s: host_strip_planes(tiled, s)
            turns[how].append(measured(frame0, 2)[0])
            tiled.__dict__.pop("_strip_planes", None)
    figures.update(tiled_8k_0_ms_device_planes=turns["device"],
                   tiled_8k_0_ms_host_planes=turns["host"])
    print("  mode 0, strip planes built on the card / on the host (numpy, "
          "copied), in turns: "
          + " / ".join(" ".join(f"{v:.1f}" for v in turns[h])
                       for h in ("device", "host"))
          + " ms; the planes bitwise equal")
    del tiled, one, conv8k
    torch.cuda.empty_cache()

    # 4. The tiled gradient at 4K against one pass.
    cfg4 = config(*TILED_4K)
    tiled4 = TiledRenderer(scene2, cfg4, strip_height=STRIP,
                           dtype=torch.float32)
    one4 = FastRenderer(scene2, cfg4, dtype=torch.float32)
    with torch.no_grad():
        target = one4.render(perturbed(params, "c1/c0/radius", 1.2), q, t,
                             mode=0, degree=2)

    def tiled_grad():
        rk.LAUNCHES = bk.LAUNCHES = 0
        return tiled4.loss_and_grad(params, q, t, target, mode=0, degree=2)

    def one_grad():
        rk.LAUNCHES = bk.LAUNCHES = 0
        p = leaf_params(params)
        img = one4.render(p, q, t, mode=0, degree=2)
        loss = torch.mean((torch.nan_to_num(img) - target) ** 2)
        loss.backward()
        return loss.detach(), {k: v.grad for k, v in param_paths(p).items()}

    t_ms, t_peak, (loss_t, g_t) = measured(tiled_grad, 2)
    t_launches = (rk.LAUNCHES, bk.LAUNCHES)
    o_ms, o_peak, (loss_o, g_o) = measured(one_grad, 2)
    o_launches = (rk.LAUNCHES, bk.LAUNCHES)
    counts["tiled_4k_grad"], counts["one_pass_4k_grad"] = t_launches, o_launches
    print(f"tiled gradient at 4K ({TILED_4K[0]}x{TILED_4K[1]}, "
          f"{tiled4.num_strips} strips, mode 0, pixel MSE): loss_and_grad "
          f"{t_ms:.1f} ms, forward/backward launches {t_launches}, peak "
          f"{t_peak / 2**30:.3f} GiB; one pass render + MSE + backward() "
          f"{o_ms:.1f} ms, launches {o_launches}, peak "
          f"{o_peak / 2**30:.3f} GiB; losses {float(loss_t):.8e} and "
          f"{float(loss_o):.8e}")
    check(t_launches == (tiled4.num_strips,) * 2 and o_launches == (1, 1),
          "tiled 4K gradient: launches")
    check(abs(float(loss_t) - float(loss_o)) <= TILED_LOSS_RTOL
          * abs(float(loss_o)), "tiled 4K gradient: loss")
    check(grads_agreement("tiled 4K gradient vs one pass", param_paths(g_t),
                          g_o, TOL_BWD["f32"]), "tiled 4K gradient")
    figures.update(tiled_4k_grad_ms=t_ms, tiled_4k_grad_peak_bytes=t_peak,
                   one_pass_4k_grad_ms=o_ms, one_pass_4k_grad_peak_bytes=o_peak)
    del tiled4, one4, target, g_t, g_o
    torch.cuda.empty_cache()

    # 5. The XLA route's training step against the kernel pair.
    w256, w256_params = neural_renderer(NEURAL_RES, torch.float32)
    for label, scene, r_cfg, p0, q_, t_, degree in (
            ("analytic", scene2, cfg, params, q, t, 2),
            ("w256", neural_scene(), w256.config, w256_params, NEURAL_Q,
             NEURAL_T, 1)):
        routes = {
            "fused": FastRenderer(scene, r_cfg, dtype=torch.float32),
            "xla": FastRenderer(scene, r_cfg, dtype=torch.float32,
                                march_impl="xla"),
            "fused_implicit": FastRenderer(scene, dataclasses.replace(
                r_cfg, backward="implicit"), dtype=torch.float32),
            "xla_implicit": FastRenderer(scene, dataclasses.replace(
                r_cfg, backward="implicit"), dtype=torch.float32,
                march_impl="xla"),
        }
        with torch.no_grad():
            frames = {k: r.render(p0, q_, t_, mode=0, degree=degree)
                      for k, r in routes.items() if k in ("fused", "xla")}
            target = routes["fused"].render(
                _scaled_tree(p0, 1.02), q_, t_, mode=0, degree=degree)
        conv_ = converged_pixels(routes["xla"], p0, q_, t_,
                                 r_cfg.marching_steps)
        print(f"XLA route ({label}, {r_cfg.px_width}x{r_cfg.px_height}, "
              f"{r_cfg.marching_steps} steps, f32) on {card}:")
        image_agreement(f"{label} frame, xla vs fused", frames["xla"],
                        frames["fused"], conv_, LIGHT_ATOL)
        def gradient(r, p0_, weight, target_=None):
            p = leaf_params(p0_)
            img = torch.nan_to_num(r.render(p, q_, t_, mode=0, degree=degree))
            err = img if target_ is None else img - target_
            torch.mean((err * weight) ** 2).backward()
            return {n: v.grad for n, v in param_paths(p).items()}

        # The routes against each other on JAX's parity loss, the mean
        # square of the frame (tests/test_xla_march.py), weighted to the
        # converged pixels: a ray that has not converged carries a
        # derivative that its march's rounding moves at will.
        conv_w = conv_[..., None].to(torch.float32)
        grads = {k: gradient(r, p0, conv_w) for k, r in routes.items()}
        agree = [grads_agreement(f"{label} gradient, {b} vs {a}", grads[b],
                                 grads[a], XLA_GRAD_RTOL[label])
                 for a, b in (("xla", "fused"),
                              ("xla_implicit", "fused_implicit"))]
        if label == "w256":
            w256_witness(routes, p0, conv_w, target, gradient, figures)
        check(all(agree), f"{label}: the XLA route's gradient against the "
                          "kernel route's")
        del grads
        def step_fn(r):
            p = leaf_params(p0)
            leaves = list(param_paths(p).values())
            opt = torch.optim.Adam(leaves, lr=1e-4)

            def step():
                opt.zero_grad(set_to_none=True)
                img = r.render(p, q_, t_, mode=0, degree=degree)
                loss = torch.mean((torch.nan_to_num(img) - target) ** 2)
                loss.backward()
                opt.step()
                return loss.detach()

            return step

        runs = {k: step_fn(r) for k, r in routes.items()}
        for k, step in runs.items():
            rk.LAUNCHES = bk.LAUNCHES = 0
            with PlainMarchCalls() as plain:
                ms, peak, _ = measured(step, XLA_STEPS)
            launches = (rk.LAUNCHES, bk.LAUNCHES, plain.n)
            counts[f"{label}_{k}_step"] = launches
            kernel_route = k.startswith("fused")
            check(ms is not None, f"{label} {k} step: out of memory")
            calls = XLA_STEPS + 1  # measured() warms up with one more
            check(launches == ((calls, calls if k == "fused" else 0, 0)
                               if kernel_route else (0, 0, calls)),
                  f"{label} {k} step: launches (forward, backward, plain "
                  f"marches) {launches}")
            figures[f"{label}_{k}_step_ms"] = ms
            figures[f"{label}_{k}_step_peak_bytes"] = peak
            print(f"  {k} step: {ms:.3f} ms (host clock, {XLA_STEPS} steps), "
                  f"peak {peak / 2**30:.3f} GiB, forward/backward launches "
                  f"and plain marches {launches}")
        with WithoutRemat():
            ms, peak, _ = measured(step_fn(routes["xla"]), XLA_STEPS)
        figures[f"{label}_xla_no_remat_step_ms"] = ms
        figures[f"{label}_xla_no_remat_step_peak_bytes"] = peak
        print("  xla step without the per-step remat (the route before it): "
              + ("does not fit the card (out of memory)" if ms is None else
                 f"{ms:.3f} ms, peak {peak / 2**30:.3f} GiB"))
        del routes, runs, frames, target
        torch.cuda.empty_cache()
    del w256, w256_params

    # 6. The CLI: a shaded frame in strips, and the gallery.
    rk.LAUNCHES = 0
    cli_main(["render", "--scene", "test_scene2", "--mode", "shaded",
              "--width", "1920", "--height", "1080", "--strip-height", "256",
              "-o", str(out_dir / "cli_shaded_strips.png")])
    cli_main(["gallery", "--scene", "test_scene2", "--width", "960",
              "--height", "540", "--fast", "--cmap-fourier",
              "-o", str(out_dir / "gallery")])
    torch.cuda.synchronize()
    counts["cli"] = rk.LAUNCHES
    check(rk.LAUNCHES == 5 + 1 and len(list(
        (out_dir / "gallery").glob("*.png"))) == 10,
          f"cli: {rk.LAUNCHES} launches, gallery PNGs")
    print(f"cli render --mode shaded --strip-height 256 (5 strips) and cli "
          f"gallery --fast: {rk.LAUNCHES} forward launches, 10 PNGs")
    print(f"lighting_tiled_xla: {time.perf_counter() - t_phase:.1f} s")
    return counts, figures


#: The host side's 1080p requests: the main path's pose and four near it.
HOST_POSES = ("0,0,1,0/0,0.2,2.5", "0,0,1,0/0.1,0.2,2.5",
              "0.05,0,1,0/0,0.2,2.4", "0,0.05,1,0/0,0.25,2.5",
              "0.1,0,1,0.02/-0.1,0.2,2.6")
#: Frames of the viewer's pipeline figure, per turn.
HOST_VIEW_FRAMES = 8


def host_side(card, out_dir: Path):
    """I/O and the host side on the card, each path counted: the artifact
    server at 1080p (5 requests, each reply ``encode_png`` of the direct
    frame byte for byte, one forward launch each and one for the warm-up)
    and on the w256 field (one request on the tensor-core entry); the
    browser viewer with POSTed input (the pose ``control.apply_input`` of
    the snapshots the loop consumed, bit for bit); ``cli interactive
    --orbit --apng`` at 1080p and the viewer's frames per second with the
    pinned-copy pipeline and with a serial fetch, in turns; ``cli optimize
    --target <png>`` (3 steps, 3 backward launches, the loss falls); ``cli
    profile --grad`` (the trace names the forward and backward kernels).
    Returns the launch counts and figures."""
    import urllib.error
    import urllib.request

    import torch

    from ray_marching_tpu_torch import control
    from ray_marching_tpu_torch import viewer as tviewer
    from ray_marching_tpu_torch.cli import _parse_pose, _scale_leaves
    from ray_marching_tpu_torch.cli import main as cli_main
    from ray_marching_tpu_torch.io.checkpoint import save_pytree
    from ray_marching_tpu_torch.io.export import export_render
    from ray_marching_tpu_torch.io.image import encode_png
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.scene import registry
    from ray_marching_tpu_torch.serve import RenderServer
    from ray_marching_tpu_torch.web import LiveViewer

    t_phase = time.perf_counter()
    d = out_dir / "host_side"
    d.mkdir(parents=True, exist_ok=True)
    counts, figures = {}, {}
    fast = FastRenderer(registry.make_scene("test_scene2"), config(1920, 1080),
                        dtype=torch.float32)

    def direct_png(renderer, params, pose, degree):
        q, t = _parse_pose(pose)
        with torch.no_grad():
            img = renderer.render(params, q, t, mode=0, degree=degree)
        return encode_png(img[0].cpu().numpy())

    def get(url):
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=120) as r:
            body = r.read()
        return body, (time.perf_counter() - t0) * 1e3

    # 1. The artifact server at 1080p.
    art = export_render(fast, d / "scene2_1080p.rmx", mode=0, degree=2)
    rk.LAUNCHES = 0
    server = RenderServer(art, port=0)
    warm = rk.LAUNCHES
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        meta, _ = get(f"{base}/meta")
        rk.LAUNCHES = 0
        replies = [get(f"{base}/render?pose={pose}") for pose in HOST_POSES]
        torch.cuda.synchronize()
        launches = rk.LAUNCHES
        try:
            get(f"{base}/render?pose=1,0,0/0,0,0")
            bad = None
        except urllib.error.HTTPError as exc:
            bad = exc.code
        stats = json.loads(get(f"{base}/stats")[0])
    finally:
        server.close()
    same = [body == direct_png(fast, fast.init_params, pose, 2)
            for pose, (body, _) in zip(HOST_POSES, replies)]
    lat = [ms for _, ms in replies]
    # The host's share: the PNG encode of one 1080p frame, uint8 as the
    # server hands it over, at the server's level 6 and the viewer's 1.
    frame8 = tviewer.quantize(fast.render(fast.init_params, *_parse_pose(
        HOST_POSES[0]), mode=0, degree=2))[0].cpu().numpy()
    enc = {}
    for level in (6, 1):
        t0 = time.perf_counter()
        encode_png(frame8, level)
        enc[level] = (time.perf_counter() - t0) * 1e3
    counts["server_1080p"] = launches
    figures.update(server_1080p_request_ms=lat,
                   server_1080p_png_bytes=[len(b) for b, _ in replies],
                   encode_png_1080p_level6_ms=enc[6],
                   encode_png_1080p_level1_ms=enc[1])
    print(f"host side: RenderServer on the 1080p test_scene2 artifact "
          f"({json.loads(meta)['renderer']}, mode 0): warm-up launches "
          f"{warm}; {len(HOST_POSES)} GET /render, forward launches "
          f"{launches}, replies == encode_png(direct frame) {same}; latency "
          f"per request (host clock, PNG encode included) "
          + ", ".join(f"{v:.2f}" for v in lat) + f" ms (encode_png of the "
          f"frame alone: {enc[6]:.2f} ms at level 6, {enc[1]:.2f} ms at "
          f"level 1); malformed pose -> "
          f"{bad}; stats {stats}")
    check(warm == 1 and launches == len(HOST_POSES) and all(same)
          and bad == 400 and stats["errors_400"] == 1,
          "host side: the 1080p artifact server")

    # 2. One request from a w256 artifact.
    w256, w_params = neural_renderer(NEURAL_RES, torch.float32)
    art_w = export_render(w256, d / "w256.rmx", mode=0, degree=1,
                          params=w_params)
    server = RenderServer(art_w, port=0)
    server.start()
    pose_w = "0,0,1,0/0,0.2,2.2"  # NEURAL_Q, NEURAL_T
    try:
        rk.LAUNCHES = rk.TC_LAUNCHES = 0
        body, ms_w = get(f"http://127.0.0.1:{server.port}/render?pose="
                         f"{pose_w}")
        torch.cuda.synchronize()
        w_launches = (rk.LAUNCHES, rk.TC_LAUNCHES)
    finally:
        server.close()
    same_w = body == direct_png(w256, w_params, pose_w, 1)
    counts["server_w256"] = w_launches
    figures["server_w256_request_ms"] = ms_w
    print(f"host side: RenderServer on the w256 artifact ({NEURAL_RES}x"
          f"{NEURAL_RES}): forward/tensor-core launches {w_launches}, reply "
          f"== encode_png(direct frame) {same_w}, {ms_w:.2f} ms")
    check(w_launches == (1, 1) and same_w, "host side: the w256 server")

    # 3. The browser viewer: POSTed input, the pose against apply_input.
    viewer = LiveViewer(fast, port=0, max_fps=1000.0)
    consumed = []
    poll = viewer.input.poll

    def logged_poll():
        snap = poll()
        consumed.append(snap)
        return snap

    viewer.input.poll = logged_poll
    base = f"http://127.0.0.1:{viewer.port}"

    def post(obj):
        req = urllib.request.Request(f"{base}/input", method="POST",
                                     data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status

    def frame_after(seq):
        with urllib.request.urlopen(f"{base}/frame.png?after={seq}",
                                    timeout=60) as r:
            return int(r.headers.get("X-Seq", "0")), r.read()

    rk.LAUNCHES = 0
    viewer.start()
    try:
        post({"pressed": ["w"]})
        seq, png = frame_after(0)
        seq, _ = frame_after(seq)
        post({"pressed": [], "mouse_ndc": [0.3, -0.2]})
        seq, _ = frame_after(seq)
        seq, _ = frame_after(seq)
        post({"mouse_ndc": [0.0, 0.0], "quit": True})
        ended = viewer.wait(60)
        state = viewer.state()
    finally:
        viewer.close()
    torch.cuda.synchronize()
    cam = control.CameraState.initial(device=fast.device)
    applied = 0
    for snap in consumed:
        if snap.quit:
            break
        cam = control.apply_input(cam, snap)
        applied += 1
    follows = (state["position"] == cam.position[0].tolist()
               and state["orientation"] == cam.orientation[0].tolist())
    counts["live_viewer"] = rk.LAUNCHES
    print(f"host side: LiveViewer at 1080p: {applied} frames, forward "
          f"launches {rk.LAUNCHES}, first frame PNG {len(png)} B, ended on "
          f"q {ended}; pose {state['position']} / {state['orientation']} == "
          f"apply_input over the consumed snapshots {follows}")
    check(ended and follows and applied >= 4 and rk.LAUNCHES == applied
          and state["position"][2] > 1.0 and png[:4] == b"\x89PNG",
          "host side: the live viewer's pose or launches")

    # 4. cli interactive at 1080p, and the pipeline against a serial fetch.
    size = ["--width", "1920", "--height", "1080", "--steps", str(STEPS)]
    rk.LAUNCHES = 0
    cli_main(["interactive", "--fast", "--orbit", "--frames", "8", "--apng",
              str(d / "orbit.png"), "-o", str(d / "frames"), *size])
    torch.cuda.synchronize()
    counts["cli_interactive"] = rk.LAUNCHES
    check(rk.LAUNCHES == 8 and (d / "orbit.png").stat().st_size > 0
          and len(list((d / "frames").glob("*.png"))) == 8,
          "host side: cli interactive")

    def viewer_fps(renderer, params, camera, pipeline):
        frames = []

        def sink(idx, image, session):  # the browser viewer's encode
            frames.append(encode_png(tviewer._display_frame(image), level=1))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tviewer.run_viewer(renderer, tviewer.orbit_script(HOST_VIEW_FRAMES),
                           sink, params=params, camera=camera,
                           print_fps=False, pipeline=pipeline)
        return HOST_VIEW_FRAMES / (time.perf_counter() - t0), frames

    # The pipeline on test_scene2 at 1080p (a few ms of card a frame) and on
    # the w256 field at 512² from its pose (a frame of the card's time
    # comparable to the encode's), each in turns.
    w_cam = control.CameraState(
        position=torch.tensor(NEURAL_T, device=fast.device),
        orientation=torch.tensor(NEURAL_Q, device=fast.device))
    for label, args in (("1080p", (fast, None, None)),
                        ("w256", (w256, w_params, w_cam))):
        viewer_fps(*args, True)  # warm-up
        turns = [(p, viewer_fps(*args, p)) for p in (True, False, False,
                                                      True)]
        fps = {p: [v[0] for q, v in turns if q == p] for p in (True, False)}
        same_frames = turns[0][1][1] == turns[1][1][1]
        key = "" if label == "1080p" else "_w256"
        figures.update({f"viewer_fps_pipelined{key}": fps[True],
                        f"viewer_fps_serial{key}": fps[False]})
        print(f"host side: viewer on {label} ({HOST_VIEW_FRAMES} orbit "
              f"frames, uint8 on the device, PNG level 1 per frame), frames "
              f"per second with the pinned-copy pipeline {fps[True]}, with a "
              f"serial fetch {fps[False]} (in turns); the same frames "
              f"{same_frames}")
        check(same_frames, f"host side: {label} pipelined and serial frames "
              "differ")
    # What the w256 frame's pipeline can overlap: the render call's time on
    # the host (it queues), the frame's on the card, the encode's.
    q_w, t_w = w_cam.orientation, w_cam.position
    host_ms, frame_ms, enc_ms = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = tviewer.quantize(w256.render(w_params, q_w, t_w, mode=0,
                                           degree=1))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = img.cpu().numpy()
        t3 = time.perf_counter()
        encode_png(tviewer._display_frame(host), level=1)
        enc_ms.append((time.perf_counter() - t3) * 1e3)
        host_ms.append((t1 - t0) * 1e3)
        frame_ms.append((t2 - t0) * 1e3)
    figures.update(w256_render_call_host_ms=host_ms,
                   w256_frame_ms=frame_ms, w256_encode_ms=enc_ms)
    print(f"host side: w256 frame at {NEURAL_RES}x{NEURAL_RES}: the render "
          f"call returns after {host_ms} ms, the frame is done after "
          f"{frame_ms} ms, its level-1 encode {enc_ms} ms")
    del w256, w_params

    # 5. cli optimize against a PNG written by cli render.
    p12 = save_pytree(d / "radius_1.2.npz", _scale_leaves(
        fast.init_params, ["c1/c0/radius"], 1.2))
    cli_main(["render", "--fast", *size, "--params", str(p12), "-o",
              str(d / "target.png")])
    metrics = d / "optimize.jsonl"
    metrics.unlink(missing_ok=True)
    rk.LAUNCHES = bk.LAUNCHES = 0
    cli_main(["optimize", *size, "--target", str(d / "target.png"),
              "--opt-steps", "3", "--trainable", "c1/c0/radius",
              "--metrics", str(metrics)])
    torch.cuda.synchronize()
    losses = [json.loads(v)["loss"] for v in metrics.read_text().splitlines()]
    counts["cli_optimize_png"] = (rk.LAUNCHES, bk.LAUNCHES)
    figures["cli_optimize_png_losses"] = losses
    print(f"host side: cli optimize --target <png> (1080p, radius 1.2x): "
          f"losses {losses}, forward/backward launches "
          f"{counts['cli_optimize_png']}")
    check(counts["cli_optimize_png"] == (3, 3) and losses[-1] < losses[0],
          "host side: cli optimize --target <png>")

    # 6. cli profile --grad: the trace names both kernels.
    cli_main(["profile", "--fast", "--grad", "--frames", "2", *size, "-o",
              str(d / "trace")])
    names = {e.get("name", "") for e in json.loads(
        (d / "trace" / "trace.json").read_text()).get("traceEvents", [])}
    fwd = sorted(n for n in names if n.startswith("void render_fwd_train"))
    bwd = sorted(n for n in names if n.startswith("void render_bwd_kernel"))
    print(f"host side: cli profile --grad: trace events {len(names)} names; "
          f"forward {fwd}, backward {bwd}")
    check(fwd and bwd, "host side: the profile trace lacks a kernel")
    figures["seconds"] = time.perf_counter() - t_phase
    print(f"host_side: {figures['seconds']:.1f} s")
    return counts, figures


# -- the parallel phase: the sharded paths on torch.distributed -------------

#: Shader modes of the parallel phase: lambertian and two modes whose
#: whole-image min/max reduce across the ranks.
PARALLEL_MODES = (0, 1, 5)
PARALLEL_STEPS, PARALLEL_LR = 3, 1e-2
#: Losses of a sharded train step against the unsharded step, f32: each
#: rank sums its shard's squared errors in plane space and the all-reduce
#: adds the sums, where the unsharded loss is one mean over 6.2M elements,
#: and each rank's backward sums its own block partials; f32 sums of this
#: length round at ~1e-6 relative, and three Adam steps carry that into the
#: parameters the later losses see.
PARALLEL_LOSS_RTOL = 1e-4
#: Parameters after those steps: an Adam step moves a leaf by about the rate
#: (1e-2) whatever the rounding of its gradient, unless that is near zero.
PARALLEL_PARAM_ATOL = 1e-5
#: The sharded tiled frame: 3840×2160 in 512-row strips, mode 1 (distance:
#: pass 1's bounds reduce across the ranks).
PARALLEL_TILED = dict(width=3840, height=2160, strip_height=512, mode=1)
PARALLEL_CHILD_TIMEOUT = 240


def bits_digest(t):
    """sha256 of a tensor's bytes (on the host)."""
    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def params_digest(tree):
    """sha256 of every leaf's path and bytes, in path order."""
    from ray_marching_tpu_torch.scene.graph import param_paths

    h = hashlib.sha256()
    for k, v in param_paths(tree).items():
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def params_distance(a, b):
    """Largest absolute difference between two parameter trees."""
    from ray_marching_tpu_torch.scene.graph import param_paths

    pb = param_paths(b)
    return max(float((v.detach() - pb[k].detach()).abs().max())
               for k, v in param_paths(a).items())


def reset_launches():
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    rk.LAUNCHES = rk.TC_LAUNCHES = 0
    bk.LAUNCHES = bk.TC_LAUNCHES = bk.MARCH_LAUNCHES = 0
    mk.LAUNCHES = 0


def launches():
    """The launch counters since :func:`reset_launches`."""
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    return {"fwd": rk.LAUNCHES, "fwd_tc": rk.TC_LAUNCHES, "bwd": bk.LAUNCHES,
            "bwd_tc": bk.TC_LAUNCHES, "march": mk.LAUNCHES,
            "march_bwd": bk.MARCH_LAUNCHES}


def unsharded_steps(r, target, q, t, steps):
    """``steps`` Adam steps on the whole image's MSE through
    ``FastRenderer.render``, built by hand: ``(losses, params, step)``."""
    import torch

    from ray_marching_tpu_torch.scene.graph import param_paths

    params = leaf_params(r.init_params)
    opt = torch.optim.Adam(list(param_paths(params).values()),
                           lr=PARALLEL_LR)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((r.render(params, q, t, mode=0, degree=2)
                           - target) ** 2)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [float(step()) for _ in range(steps)]
    return losses, params, step


def sharded_steps(r, mesh, target, q, t, steps):
    """``steps`` of ``fast_train_step`` on the same objective: ``(losses,
    params, launches per step, one step from the start)``."""
    import torch

    from ray_marching_tpu_torch.parallel import fast_sharding as fs

    step = fs.fast_train_step(r, mesh, functools.partial(
        torch.optim.Adam, lr=PARALLEL_LR), mode=0, degree=2)
    tp = fs.target_planes(r, mesh, target)
    p, state, losses = r.init_params, None, []
    reset_launches()
    for _ in range(steps):
        p, state, loss = step(p, state, tp, q, t)
        losses.append(float(loss))
    per_step = {k: v / steps for k, v in launches().items()}
    return losses, p, per_step, lambda: step(r.init_params, None, tp, q, t)


def parallel_one_rank(card, main, modular, q, t, target, figures, counts):
    """(a) One rank on NCCL, in this process: the sharded frames and steps
    against the unsharded ones, and what the wrappers cost at world size 1."""
    import torch

    from ray_marching_tpu_torch.parallel import fast_sharding as fs
    from ray_marching_tpu_torch.parallel import (make_mesh, make_train_step,
                                                 shard_render)

    mesh = make_mesh((1,), ("rows",))
    p0 = main.init_params
    for mode in PARALLEL_MODES:
        render = fs.fast_shard_render(main, mesh, mode=mode, degree=2)
        with torch.no_grad():
            want = main.render(p0, q, t, mode=mode, degree=2)
            reset_launches()
            got = render(p0, q, t)
            counts[f"fast_frame_mode{mode}"] = launches()
        check(bool(same_bits(got, want).all()),
              f"parallel: the one-rank sharded frame in mode {mode} is not "
              "FastRenderer.render's, bit for bit")
        check(counts[f"fast_frame_mode{mode}"]["fwd"] == 1,
              f"parallel: mode {mode} frame launched "
              f"{counts[f'fast_frame_mode{mode}']}")
        if mode == 0:
            with torch.no_grad():
                figures["frame_ms_1rank"] = cuda_ms(lambda: render(p0, q, t),
                                                    20)
                figures["frame_ms_unsharded"] = cuda_ms(
                    lambda: main.render(p0, q, t, mode=0, degree=2), 20)

    want_losses, want_params, unsharded = unsharded_steps(
        main, target, q, t, PARALLEL_STEPS)
    losses, params, per_step, sharded = sharded_steps(
        main, mesh, target, q, t, PARALLEL_STEPS)
    counts["fast_step_1rank_per_step"] = per_step
    check(per_step["fwd"] == 1 and per_step["bwd"] == 1,
          f"parallel: a one-rank step launched {per_step}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    param_err = params_distance(params, want_params)
    check(loss_err <= PARALLEL_LOSS_RTOL and param_err <= PARALLEL_PARAM_ATOL,
          f"parallel: one-rank steps {losses} against {want_losses} (rel "
          f"{loss_err:.3e}), parameters {param_err:.3e} apart")
    figures.update(
        losses_1rank=losses, losses_unsharded=want_losses,
        loss_rel_err_1rank=loss_err, param_err_1rank=param_err,
        losses_bitwise_1rank=losses == want_losses,
        params_bitwise_1rank=params_digest(params) == params_digest(
            want_params),
        step_ms_1rank=cuda_ms(sharded, 10),
        step_ms_unsharded=cuda_ms(unsharded, 10))

    # The modular path: the march kernel and its march-only backward.
    with torch.no_grad():
        want = modular.render(modular.init_params, q, t, mode=0, degree=2)
        reset_launches()
        got = shard_render(modular, mesh, mode=0, degree=2)(
            modular.init_params, q, t)
        counts["modular_frame"] = launches()
    check(bool(same_bits(got, want).all()),
          "parallel: the one-rank modular frame is not Renderer.render's")
    step = make_train_step(modular, mesh, functools.partial(
        torch.optim.Adam, lr=PARALLEL_LR), mode=0, degree=2)
    reset_launches()
    _, _, loss = step(modular.init_params, None, target, q, t)
    counts["modular_step"] = launches()
    check(bool(torch.isfinite(loss)) and counts["modular_frame"]["march"] == 1
          and counts["modular_step"]["march"] == 1
          and counts["modular_step"]["march_bwd"] == 1,
          f"parallel: modular launches {counts['modular_frame']}, "
          f"{counts['modular_step']}, loss {float(loss)}")
    print(f"parallel (a) one rank on NCCL, {card}: sharded frame "
          f"{figures['frame_ms_1rank']:.4f} ms against "
          f"{figures['frame_ms_unsharded']:.4f} ms; sharded step "
          f"{figures['step_ms_1rank']:.4f} ms against the hand-built "
          f"{figures['step_ms_unsharded']:.4f} ms; losses bitwise "
          f"{figures['losses_bitwise_1rank']}, parameters bitwise "
          f"{figures['params_bitwise_1rank']} (rel {loss_err:.3e}, "
          f"{param_err:.3e})")
    return want_losses


def parallel_rank(rank, store, out_dir: Path):
    """(b)'s rank ``rank`` of two on the one card, over gloo: writes what it
    saw to ``out_dir/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    from ray_marching_tpu_torch.io.export import (export_train_step,
                                                  load_train_step)
    from ray_marching_tpu_torch.parallel import fast_sharding as fs
    from ray_marching_tpu_torch.parallel import make_mesh, multihost
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.tiled import TiledRenderer
    from ray_marching_tpu_torch.scene import registry

    # A rank that hangs prints its stacks and exits before the parent's
    # limit.
    faulthandler.dump_traceback_later(PARALLEL_CHILD_TIMEOUT - 30, exit=True)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    res = {"counts": {}}
    try:
        mesh = make_mesh((2,), ("rows",))
        main = FastRenderer(registry.make_scene("test_scene2"),
                            config(1920, 1080), dtype=torch.float32,
                            row_multiple=fs.SHARD_ROWS * 2)
        q, t = main._pose(BENCH_Q, BENCH_T)
        p0 = main.init_params
        for mode in PARALLEL_MODES:
            render = fs.fast_shard_render(main, mesh, mode=mode, degree=2)
            with torch.no_grad():
                reset_launches()
                res[f"frame{mode}"] = bits_digest(render(p0, q, t))
                res["counts"][f"fast_frame_mode{mode}"] = launches()
                if mode == 0:
                    res["frame_ms"] = cuda_ms(lambda: render(p0, q, t), 10)
        with torch.no_grad():
            target = main.render(perturbed(p0, "c1/c0/radius", 1.2), q, t,
                                 mode=0, degree=2)
        losses, params, per_step, step = sharded_steps(
            main, mesh, target, q, t, PARALLEL_STEPS)
        res.update(losses=losses, params=params_digest(params),
                   step_ms=cuda_ms(step, 5))
        res["counts"]["fast_step_per_step"] = per_step

        # The w256 field on the tensor-core entries.
        w256, wp = neural_renderer(NEURAL_RES, torch.float32,
                                   row_multiple=fs.SHARD_ROWS * 2)
        nq, nt = w256._pose(NEURAL_Q, NEURAL_T)
        with torch.no_grad():
            reset_launches()
            frame = fs.fast_shard_render(w256, mesh, mode=0, degree=2)(
                wp, nq, nt)
            res["counts"]["w256_frame"] = launches()
        res["w256_frame"] = bits_digest(frame)
        step = fs.fast_train_step(w256, mesh, functools.partial(
            torch.optim.Adam, lr=PARALLEL_LR), mode=0, degree=2)
        reset_launches()
        _, _, loss = step(wp, None, fs.target_planes(w256, mesh, frame * 0.9),
                          nq, nt)
        res["counts"]["w256_step"] = launches()
        res["w256_loss"] = float(loss)
        del w256, wp, frame

        # Strips of the 4K frame sharded over the two ranks.
        cfg = PARALLEL_TILED
        tiled = TiledRenderer(registry.make_scene("test_scene2"),
                              config(cfg["width"], cfg["height"]),
                              strip_height=cfg["strip_height"],
                              dtype=torch.float32, mesh=mesh)
        reset_launches()
        res["tiled"] = bits_digest(tiled.render(tiled.init_params, q, t,
                                                mode=cfg["mode"], degree=2))
        res["counts"]["tiled_4k"] = launches()
        del tiled

        # The exported step, loaded by both ranks, against the direct one.
        path = out_dir / "step2.rmxs"
        adam = functools.partial(torch.optim.Adam, lr=PARALLEL_LR)
        if rank == 0:
            export_train_step(main, mesh, path, optimizer=adam)
        multihost.barrier(120)
        loaded, meta = load_train_step(path)
        direct = fs.fast_train_step(main, mesh, adam)
        tp = fs.target_planes(main, mesh, target)
        pd, _, ld = direct(p0, None, tp, q, t)
        pl, _, ll = loaded(loaded.params, None, tp, q, t)
        res.update(export_loss_bitwise=float(ld) == float(ll),
                   export_params_bitwise=params_digest(pd)
                   == params_digest(pl),
                   export_meta={k: meta[k] for k in (
                       "kind", "mesh_shape", "num_devices", "rows")})
    finally:
        dist.destroy_process_group()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))


def parallel_two_ranks(card, main, q, t, target, want_losses, out_dir,
                       figures, counts):
    """(b) Two ranks on the one card over gloo, spawned as this script with
    ``--parallel-rank``: frames, steps, the w256 shards, the sharded 4K
    tiled frame and the exported step, against this process's unsharded
    results."""
    import torch

    from ray_marching_tpu_torch.render.tiled import TiledRenderer
    from ray_marching_tpu_torch.scene import registry

    p0 = main.init_params
    with torch.no_grad():
        want = {f"frame{m}": bits_digest(main.render(p0, q, t, mode=m,
                                                     degree=2))
                for m in PARALLEL_MODES}
        w256, wp = neural_renderer(NEURAL_RES, torch.float32)
        nq, nt = w256._pose(NEURAL_Q, NEURAL_T)
        want["w256_frame"] = bits_digest(w256.render(wp, nq, nt, mode=0,
                                                     degree=2))
        del w256, wp
        cfg = PARALLEL_TILED
        tiled = TiledRenderer(registry.make_scene("test_scene2"),
                              config(cfg["width"], cfg["height"]),
                              strip_height=cfg["strip_height"],
                              dtype=torch.float32)
        want["tiled"] = bits_digest(tiled.render(tiled.init_params, q, t,
                                                 mode=cfg["mode"], degree=2))
        del tiled
    torch.cuda.synchronize()
    rank_dir = (out_dir / "parallel").resolve()
    shutil.rmtree(rank_dir, ignore_errors=True)
    rank_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for rank in range(2):
            log = open(rank_dir / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--parallel-rank", str(rank), "--store",
                 str(rank_dir / "store"), "--out", str(rank_dir)],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
        for proc, log in procs:
            rc = proc.wait(timeout=PARALLEL_CHILD_TIMEOUT)
            log.close()
            check(rc == 0, f"parallel: a rank exited with {rc}:\n"
                  + (rank_dir / Path(log.name).name).read_text()[-4000:])
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    figures["two_ranks_s"] = time.perf_counter() - t0
    ranks = [json.loads((rank_dir / f"rank{r}.json").read_text())
             for r in range(2)]
    for r, res in enumerate(ranks):
        for key in want:
            check(res[key] == want[key],
                  f"parallel: rank {r}'s {key} is not one process's, bit "
                  "for bit")
        err = max(abs(a - b) / abs(b)
                  for a, b in zip(res["losses"], want_losses))
        check(err <= PARALLEL_LOSS_RTOL,
              f"parallel: rank {r}'s losses {res['losses']} against one "
              f"process's {want_losses} (rel {err:.3e})")
        c = res["counts"]
        check(all(c[f"fast_frame_mode{m}"]["fwd"] == 1
                  for m in PARALLEL_MODES)
              and c["fast_step_per_step"]["fwd"] == 1
              and c["fast_step_per_step"]["bwd"] == 1,
              f"parallel: rank {r} launched {c}")
        check(c["w256_frame"]["fwd_tc"] == 1 and c["w256_step"]["fwd_tc"] == 1
              and c["w256_step"]["bwd_tc"] == 1,
              f"parallel: rank {r}'s w256 shards left the tensor cores: "
              f"{c['w256_frame']}, {c['w256_step']}")
        check(res["export_loss_bitwise"] and res["export_params_bitwise"],
              f"parallel: rank {r}'s loaded step is not the direct step")
        check(res["export_meta"]["num_devices"] == 2,
              f"parallel: exported meta {res['export_meta']}")
        figures[f"loss_rel_err_rank{r}"] = err
    check(ranks[0]["params"] == ranks[1]["params"],
          "parallel: the ranks' parameters differ after the steps")
    counts.update({f"two_ranks_{k}": v for k, v in ranks[0]["counts"].items()})
    figures.update(losses_2ranks=ranks[0]["losses"],
                   frame_ms_2ranks=[res["frame_ms"] for res in ranks],
                   step_ms_2ranks=[res["step_ms"] for res in ranks])
    print(f"parallel (b) two ranks on one card over gloo, {card}: frames "
          "(modes " + ", ".join(map(str, PARALLEL_MODES)) + "), the w256 "
          "frame and the 4K tiled frame bitwise one process's; parameters "
          "bitwise equal across the ranks after "
          f"{PARALLEL_STEPS} steps; losses {ranks[0]['losses']} against "
          f"{want_losses}; frame {figures['frame_ms_2ranks']} ms, step "
          f"{figures['step_ms_2ranks']} ms per rank (two ranks share the "
          "card: no scaling figure)")


def parallel_phase(card, out_dir: Path):
    """The sharded paths (``parallel/``) on torch.distributed: (a) one rank
    on NCCL in this process, (b) two ranks on the one card over gloo. The
    process group is destroyed before it returns."""
    import torch
    import torch.distributed as dist

    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer
    from ray_marching_tpu_torch.scene import registry

    t0 = time.perf_counter()
    check(not dist.is_initialized(), "parallel: a process group exists "
          "before the phase")
    counts, figures = {}, {}
    main = FastRenderer(registry.make_scene("test_scene2"), config(1920, 1080),
                        dtype=torch.float32)
    modular = Renderer(registry.make_scene("test_scene2"),
                       config(1920, 1080, use_pallas=True),
                       dtype=torch.float32)
    q, t = main._pose(BENCH_Q, BENCH_T)
    with torch.no_grad():
        target = main.render(perturbed(main.init_params, "c1/c0/radius", 1.2),
                             q, t, mode=0, degree=2)
    try:
        want_losses = parallel_one_rank(card, main, modular, q, t, target,
                                        figures, counts)
    finally:
        dist.destroy_process_group()
    del modular
    parallel_two_ranks(card, main, q, t, target, want_losses, out_dir,
                       figures, counts)
    check(not dist.is_initialized(), "parallel: a process group is left")
    figures["seconds"] = time.perf_counter() - t0
    print(f"parallel: {figures['seconds']:.1f} s")
    return counts, figures

#: The prune phase's tensor-core scene: a w256 tensor-core leaf before a
#: guarded analytic union, at the neural configuration's 512² and steps.
PRUNE_TC_RES = NEURAL_RES
#: Timing rounds of the prune phase (unpruned, pruned, pruned, unpruned).
PRUNE_TURNS = ("unpruned", "pruned", "pruned", "unpruned")


@contextlib.contextmanager
def prune_switch():
    """``RM_TPU_CSG_PRUNE=1`` around the constructions that read it."""
    import os

    old = os.environ.get("RM_TPU_CSG_PRUNE")
    os.environ["RM_TPU_CSG_PRUNE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["RM_TPU_CSG_PRUNE"]
        else:
            os.environ["RM_TPU_CSG_PRUNE"] = old


def mixed_tc_scene():
    """``Union(room, Affine(NeuralSDF w256), Union(sphere, torus))``: the
    MLP (tensor cores in f32) comes before a guarded analytic union, so a
    warp's divergent guard precedes the next step's ``mma.sync``. Random
    weights from the leaf's seed."""
    from ray_marching_tpu_torch.scene.graph import (
        Affine,
        Sphere,
        Torus,
        Union,
    )

    room, leaf = neural_scene().children
    return Union(children=(
        room,
        Affine(child=leaf, orientation=(1.0, 0.0, 0.0, 0.0),
               translation=(-1.2, 0.0, 0.0)),
        Union(children=(Sphere(radius=0.5),
                        Torus(radius1=1.0, radius2=0.25)))))


def guard_skip_shares(node, params, points):
    """Share of the points at which the kernels' short-circuit skips each
    guarded child of the scene's top-level union (the scenes of this phase
    have no other guard): ``lb > d`` per point, from the port's
    ``bounding_sphere_fn`` and the running minimum of the children before
    it, as a thread of the pruned kernels decides. ``points``: an iterable
    of (x, y, z) plane triples, every valid ray's evaluation points."""
    import torch

    from ray_marching_tpu_torch.scene import graph
    from ray_marching_tpu_torch.utils import vmin

    bounds = graph.pruned_children(node)
    fns = [graph.compile_node(c) for c in node.children]
    skipped = [0] * len(fns)
    total = 0
    with torch.no_grad():
        for x, y, z in points:
            d = fns[0](params["c0"], x, y, z)
            for i in range(1, len(fns)):
                pi = params[f"c{i}"]
                if bounds[i] is not None:
                    lb = graph.guard_lower_bound(bounds[i](pi), x, y, z)
                    skipped[i] += int((lb > d).sum())
                d = vmin(d, fns[i](pi, x, y, z))
            total += x.numel()
    return [n / total for i, n in enumerate(skipped) if bounds[i] is not None]


def prune_optimize(r, steps, path):
    """``optimize`` on ``c1/c0/radius`` (the selftest target, radius 1.2×)
    through ``r``'s kernels with the backward's ``path`` (history,
    recompute or two-level), counted: ``(result, launch counts)``."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize

    with torch.no_grad():
        target = r.render(perturbed(r.init_params, "c1/c0/radius", 1.2),
                          BENCH_Q, BENCH_T, mode=0, degree=2)
    cfg = InverseConfig(learning_rate=1e-2, steps=steps, mode=0, degree=2,
                        trainable=["c1/c0/radius"])
    torch.cuda.synchronize()
    rk.LAUNCHES = rk.PRUNE_LAUNCHES = bk.LAUNCHES = bk.PRUNE_LAUNCHES = 0
    saved = rk.BWD_TWO_LEVEL, rk.BWD_HIST
    rk.BWD_TWO_LEVEL, rk.BWD_HIST = path == "two-level", path == "history"
    try:
        out = optimize(r, target, BENCH_Q, BENCH_T, cfg)
    finally:
        rk.BWD_TWO_LEVEL, rk.BWD_HIST = saved
    torch.cuda.synchronize()
    check(bk.LAST_PATH.get("two_level") is (path == "two-level")
          and bk.LAST_PATH.get("use_hist") is (path == "history"),
          f"prune optimize ({path}): LAST_PATH says {bk.LAST_PATH}")
    return out, {"fwd": rk.LAUNCHES, "fwd_pruned": rk.PRUNE_LAUNCHES,
                 "bwd": bk.LAUNCHES, "bwd_pruned": bk.PRUNE_LAUNCHES}


def prune_phase(card, main, sass):
    """The union short-circuit on the card, at the main path's
    configuration (test_scene2, 1080p, 32 steps, tau = 0, f32, mode 0,
    degree 2): ``FastRenderer`` built under ``RM_TPU_CSG_PRUNE=1`` against
    ``main``, built without it. The pruned forward kernels (serving,
    training) bitwise their plain versions and sha256-equal to the unpruned
    kernels' outputs; the backward's history, recompute and two-level
    gradients sha256-equal across both libraries, and the pruned recompute
    and two-level kernels within TOL_BWD of their plain versions; 3
    ``optimize`` steps on each backward path bitwise the unpruned
    parameters, one pruned forward launch a step and one pruned backward
    launch a recompute or two-level step; a tensor-core scene with a guarded
    union frame bitwise; the skip share from the plain march's history; the
    kernels and the frame timed in turns; the SASS with the guard. Returns
    the three kernel rows and the phase's figures."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.scene import registry

    t0 = time.perf_counter()
    with prune_switch():
        pr = FastRenderer(registry.make_scene("test_scene2"),
                          config(1920, 1080), dtype=torch.float32)
    prog, plain_prog = pr.program, main.program
    check(prog.pruned and not plain_prog.pruned
          and rk.kernel_key(prog) != rk.kernel_key(plain_prog),
          "prune: the renderer built under the switch has no pruned library")
    figures = {"guard_ops": prog.guard_ops, "ops_per_eval": prog.ops_per_eval}
    flat, rays7 = main_rays(main, BENCH_Q, BENCH_T)
    valid = rays7[6] > 0.5
    n_valid = int(valid.sum())

    def digest(*tensors):
        return hashlib.sha256(b"".join(
            t.detach().contiguous().cpu().numpy().tobytes()
            for t in tensors)).hexdigest()

    # (a) The forward kernels: serving and training configuration, pruned
    # against unpruned (sha256) and against the plain version, whose plain
    # SDF gives the same values (bitwise on the valid rays).
    rk.PRUNE_LAUNCHES = 0
    serve = {p: rk.march_forward(p, flat, rays7, STEPS, 0.0, 5e-2)[0]
             for p in (plain_prog, prog)}
    train = {p: rk.march_forward(p, flat, rays7, STEPS, 0.0, 5e-2,
                                 track_min=True, log_hist=True,
                                 track_argpos=True) for p in (plain_prog, prog)}
    check(rk.PRUNE_LAUNCHES == 2, f"prune: {rk.PRUNE_LAUNCHES} pruned "
                                  "launches of 2")
    plain_serve = rk.reference_march_normals(prog, flat, rays7, STEPS, 0.0,
                                             5e-2)
    plain_train = rk._reference_march(prog, flat, rays7, STEPS, 0.0, 5e-2,
                                      track_min=True, log_hist=True,
                                      track_argpos=True)
    torch.cuda.synchronize()
    outs = {}
    for p in (plain_prog, prog):
        out, ex = train[p]
        # A pad slot's history holds its terminal entry only.
        outs[p] = [serve[p], out, ex["hist"][:, :, valid], ex["amin"],
                   ex["argpos"], ex["nlive"]]
    names = ("planes", "training planes", "history", "arg-min", "arg-min "
             "position", "live steps")
    for name, a, b in zip(names, outs[plain_prog], outs[prog]):
        check(digest(a) == digest(b), f"prune: the pruned forward's {name} "
                                      "differ from the unpruned kernel's")
    for name, got, want in (
            ("serving planes", serve[prog], plain_serve),
            ("training planes", train[prog][0], plain_train[0]),
            ("history", train[prog][1]["hist"], plain_train[1]["hist"]),
            ("arg-min", train[prog][1]["amin"], plain_train[1]["amin"]),
            ("arg-min position", train[prog][1]["argpos"],
             plain_train[1]["argpos"]),
            ("live steps", train[prog][1]["nlive"], plain_train[1]["nlive"])):
        eq = same_bits(got, want)
        while eq.dim() > 2:
            eq = eq.all(0)
        check(bool(eq[valid].all()), f"prune: the pruned kernel's {name} "
                                     "differ from its plain version")
    # Serving planes on the valid rays, a NaN against a NaN counted as 0.
    fwd_diff = (serve[prog] - plain_serve)[:, valid].abs()
    fwd_err = float(torch.where(
        torch.isnan(serve[prog][:, valid]) & torch.isnan(plain_serve[:, valid]),
        0.0, fwd_diff).max())
    print("prune forward (f32 1080p test_scene2 tau=0): serving and training "
          "kernels sha256-equal to the unpruned kernels' (planes, history, "
          "min_f, arg-min, arg-min position, live steps) and bitwise equal "
          "to its plain version on every valid ray")

    # The skip share, from the history of the march and the tail's points.
    hist = train[plain_prog][1]["hist"]
    off, _, _, _ = rk._plain_consts(torch.float32, 0.0, 5e-2)
    params = pr.init_params
    pick = lambda t: t[valid]  # noqa: E731
    march_pts = ([pick(hist[s, c]) for c in range(3)] for s in range(STEPS))
    end = [pick(hist[STEPS, c]) for c in range(3)]
    tail_pts = [end] + [[end[c] + off[k][c] for c in range(3)]
                        for k in range(4)]
    march_share = guard_skip_shares(pr.scene, params, march_pts)
    tail_share = guard_skip_shares(pr.scene, params, tail_pts)
    check(len(march_share) == len(prog.guard_ops) == 1,
          "prune: test_scene2 has one guard, at its top-level union")
    evals = STEPS + 5
    share = (STEPS * march_share[0] + 5 * tail_share[0]) / evals
    figures.update(skip_share=share, skip_share_march=march_share[0],
                   skip_share_tail=tail_share[0])
    (test_ops, region_ops), = prog.guard_ops
    ev = prog.ops_per_eval

    def pruned_ev(s):
        return ev + test_ops - s * region_ops

    fwd_ops = (n_valid * (STEPS * pruned_ev(march_share[0])
                          + 5 * pruned_ev(tail_share[0])
                          + STEPS * rk.OPS_PER_STEP + rk.OPS_TAIL))
    plane_bytes = rays7.shape[1] * rays7.shape[2] * rays7.element_size()
    bound = lambda ops, nbytes: (  # noqa: E731
        max(ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3),
        "operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES
        else "bytes")
    print(f"prune skip share (guard of c1, from the history and the tail's "
          f"points): {share:.6f} of {evals} evaluations a ray (march "
          f"{march_share[0]:.6f}, tail {tail_share[0]:.6f}); the guard's test "
          f"{test_ops} ops, its region {region_ops} of the SDF's {ev}; ops "
          f"per evaluation run {pruned_ev(share):.3f}")

    # (b) The backward: history, recompute and two levels on both
    # libraries, all six sha256-equal.
    g8 = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (8,) + tuple(rays7.shape[1:])), dtype=rays7.dtype).to(rays7.device)
    grads, pruned_grads = {}, {}
    bk.PRUNE_LAUNCHES = 0
    for p in (plain_prog, prog):
        ex = train[p][1]
        for path, kw in (("history", dict(hist=ex["hist"],
                                          nlive=ex["nlive"])),
                         ("recompute", {}), ("two-level",
                                             dict(two_level=True))):
            gflat, _, grays = bk.fused_backward(p, flat, rays7, g8, STEPS,
                                                0.0, 5e-2, **kw)
            check(bk.LAST_PATH["two_level"] == (path == "two-level"),
                  f"prune: {path} ran {bk.LAST_PATH}")
            grads[(p.pruned, path)] = digest(gflat, grays)
            if p is prog:
                pruned_grads[path] = (gflat, grays)
    # The history path marches nothing: only the other two ran the guard.
    check(bk.PRUNE_LAUNCHES == 2, f"prune: {bk.PRUNE_LAUNCHES} pruned "
                                  "backward launches of 2")
    check(len(set(grads.values())) == 1, f"prune: backward digests differ: "
                                         f"{grads}")
    # The pruned recompute and two-level kernels against their plain
    # versions (the same plain SDF: the values the guard keeps), as
    # compare_backward and compare_two_level hold the unpruned ones.
    conv = valid & (plain_train[0][3].abs() < CONVERGED)
    tol = TOL_BWD["f32"]
    bwd_errs = {}
    for path, kw in (("recompute", {}), ("two-level", dict(two_level=True))):
        want = bk.reference_backward(prog, flat, rays7, g8, STEPS, 0.0, 5e-2,
                                     **kw)[::2]
        got = pruned_grads[path]
        e_flat = float((got[0] - want[0]).abs().max())
        s_flat = float(want[0].abs().max())
        e_rays = float((got[1] - want[1])[:, conv].abs().max())
        s_rays = float(want[1][:, conv].abs().max())
        print(f"prune backward {path} vs plain: ray cotangents max abs diff "
              f"{e_rays:.3e} of {s_rays:.3e}, parameter cotangent "
              f"{e_flat:.3e} of {s_flat:.3e} (tolerance {tol:g} relative)")
        check(bool(torch.isfinite(got[0]).all())
              and bool(torch.isfinite(got[1][:, conv]).all()),
              f"prune: the pruned {path} backward's cotangents are not finite")
        check(e_rays <= tol * s_rays and e_flat <= tol * s_flat,
              f"prune: the pruned {path} backward and its plain version "
              "disagree")
        bwd_errs[path] = (e_rays, e_flat)
    del pruned_grads
    print("prune backward: history, recompute and two-level gradients of "
          "both libraries sha256-equal " + next(iter(grads.values()))[:16])

    # (c) The main path with the switch on: 3 frames and 3 optimize steps
    # on each backward path (history, recompute, two levels), counted,
    # bitwise the unpruned ones.
    poses = [(BENCH_Q, BENCH_T),
             ([[0.9914449, 0.0, 0.1305262, 0.0]], [[0.3, 0.1, -2.4]]),
             ([[0.0, 0.0, 0.9659258, 0.258819]], [[-0.4, 0.5, 2.2]])]
    rk.LAUNCHES = rk.PRUNE_LAUNCHES = 0
    frames = [pr.render(pr.init_params, q, t, mode=0, degree=2)
              for q, t in poses]
    torch.cuda.synchronize()
    frame_launches = (rk.LAUNCHES, rk.PRUNE_LAUNCHES)
    check(frame_launches == (3, 3), f"prune: frames launched {frame_launches}")
    want = [main.render(main.init_params, q, t, mode=0, degree=2)
            for q, t in poses]
    check(all(digest(a) == digest(b) for a, b in zip(frames, want)),
          "prune: a pruned frame differs from the unpruned one")
    opt = {}
    n = TRAIN_STEPS_PRUNE
    bwd_paths = ("history", "recompute", "two-level")
    for name, r in (("unpruned", main), ("pruned", pr)):
        for path in bwd_paths:
            out, counts = prune_optimize(r, n, path)
            opt[(name, path)] = (params_digest(out["params"]), out["losses"],
                                 counts)
    for path in bwd_paths:
        counts = opt[("pruned", path)][2]
        # The history path's backward launches run no short-circuit.
        want = {"fwd": n, "fwd_pruned": n, "bwd": n,
                "bwd_pruned": 0 if path == "history" else n}
        check(counts == want,
              f"prune: optimize ({path}) launched {counts} in {n} steps")
    check(len({v[0] for v in opt.values()}) == 1,
          "prune: optimize's parameters differ between the libraries or "
          "the backward paths")
    print(f"prune main path: 3 frames bitwise the unpruned ones (3 pruned "
          f"launches); {n} optimize steps on each backward path, parameters "
          f"bitwise the unpruned runs' (losses "
          + " ".join(f"{v:.6e}" for v in opt[("pruned", "history")][1])
          + "), launches " + "; ".join(
              f"{path} {opt[('pruned', path)][2]}" for path in bwd_paths))

    # (d) The tensor-core scene: the frame pruned against unpruned.
    scene = mixed_tc_scene()
    tc_cfg = dataclasses.replace(config(PRUNE_TC_RES, PRUNE_TC_RES),
                                 marching_steps=NEURAL_STEPS)
    tc_plain = FastRenderer(scene, tc_cfg, dtype=torch.float32)
    with prune_switch():
        tc_pr = FastRenderer(scene, tc_cfg, dtype=torch.float32)
    check(tc_pr.program.pruned and tc_pr.program.tc
          and not tc_plain.program.pruned, "prune: the tensor-core scene")
    rk.TC_LAUNCHES = rk.PRUNE_LAUNCHES = 0
    tc_frames = [r.render(r.init_params, NEURAL_Q, NEURAL_T, mode=0, degree=1)
                 for r in (tc_plain, tc_pr)]
    torch.cuda.synchronize()
    check(rk.TC_LAUNCHES == 2 and rk.PRUNE_LAUNCHES == 1,
          f"prune: tensor-core launches {rk.TC_LAUNCHES}, pruned "
          f"{rk.PRUNE_LAUNCHES}")
    check(digest(tc_frames[0]) == digest(tc_frames[1])
          and bool(torch.isfinite(tc_frames[1]).all()),
          "prune: the tensor-core scene's pruned frame differs")
    tc_ms = {name: cuda_ms(lambda r=r: r.render(
        r.init_params, NEURAL_Q, NEURAL_T, mode=0, degree=1), 10)
        for name, r in (("unpruned", tc_plain), ("pruned", tc_pr))}
    figures["tc_frame_ms"] = tc_ms
    print(f"prune tensor-core scene ({PRUNE_TC_RES}², {NEURAL_STEPS} steps, "
          f"w256 leaf before a guarded union): frame bitwise the unpruned "
          f"one; {tc_ms['pruned']:.4f} ms against {tc_ms['unpruned']:.4f}")
    del tc_plain, tc_pr, tc_frames

    # (e) Timings in turns, and the plain versions.
    ex_h = {p: train[p][1] for p in (plain_prog, prog)}
    by = {"unpruned": plain_prog, "pruned": prog}
    rend = {"unpruned": main, "pruned": pr}
    q, t = BENCH_Q, BENCH_T
    work = {
        "serving": lambda p: rk.march_forward(p, flat, rays7, STEPS, 0.0,
                                              5e-2),
        "training": lambda p: rk.march_forward(p, flat, rays7, STEPS, 0.0,
                                               5e-2, log_hist=True),
        "history": lambda p: bk.fused_backward(
            p, flat, rays7, g8, STEPS, 0.0, 5e-2, hist=ex_h[p]["hist"],
            nlive=ex_h[p]["nlive"]),
        "recompute": lambda p: bk.fused_backward(p, flat, rays7, g8, STEPS,
                                                 0.0, 5e-2),
        "two-level": lambda p: bk.fused_backward(p, flat, rays7, g8, STEPS,
                                                 0.0, 5e-2, two_level=True),
    }
    times = {}
    for name, fn in work.items():
        reps = 50 if name in ("serving", "training") else 10
        for turn in PRUNE_TURNS:
            times.setdefault((name, turn), []).append(
                kernel_ms(lambda: fn(by[turn]), reps))
    for turn in PRUNE_TURNS:
        times.setdefault(("frame", turn), []).append(cuda_ms(
            lambda: rend[turn].render(rend[turn].init_params, q, t, mode=0,
                                      degree=2), 50))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    figures["turns_ms"] = {f"{k[0]} {k[1]}": v for k, v in times.items()}
    plain_ms = {
        "serving": cuda_ms(lambda: rk.reference_march_normals(
            prog, flat, rays7, STEPS, 0.0, 5e-2), 2),
        "recompute": cuda_ms(lambda: bk.reference_backward(
            prog, flat, rays7, g8, STEPS, 0.0, 5e-2), 1),
        "two-level": cuda_ms(lambda: bk.reference_backward(
            prog, flat, rays7, g8, STEPS, 0.0, 5e-2, two_level=True), 1),
    }
    print(f"prune timings on {card} (unpruned, pruned, pruned, unpruned): "
          + "; ".join(f"{name} " + " ".join(
              f"{v:.4f}" for v in (times[(name, PRUNE_TURNS[0])][0],
                                   times[(name, "pruned")][0],
                                   times[(name, "pruned")][1],
                                   times[(name, PRUNE_TURNS[0])][1]))
              + f" ms ({mean[(name, 'unpruned')] / mean[(name, 'pruned')]:.3f}"
              "x)" for name in list(work) + ["frame"])
          + "; plain versions " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in plain_ms.items()))

    # Bounds: the evaluations run, the skip share's regions left out.
    swept = n_valid * STEPS
    k = bk.CKPT_INTERVAL
    n_blocks = -(-rays7.shape[1] * rays7.shape[2] // 128)
    partial_bytes = n_blocks * len(prog.scalar_offsets) * rays7.element_size()
    saved = ev - pruned_ev(march_share[0])  # per recomputed march step
    rec_ops = (bk.backward_ops(prog, n_valid, swept, recomputed_steps=swept)
               - swept * saved)
    tl_steps = swept + swept * (k - 1) // k
    tl_ops = (bk.backward_ops(prog, n_valid, swept,
                              recomputed_steps=tl_steps) - tl_steps * saved)
    rec_bytes = 21 * plane_bytes + partial_bytes
    bounds = {"serving": bound(fwd_ops, 15 * plane_bytes),
              "recompute": bound(rec_ops, rec_bytes),
              "two-level": bound(tl_ops, rec_bytes)}
    figures["bounds_ms"] = bounds
    sdf = sass["test_scene2 pruned"]
    figures["sass"] = {kind: sdf[kind]["instructions"]
                       for kind in ("sdf", "sdf_fwd", "forward", "backward")
                       if kind in sdf}
    print(f"prune SASS (f32): scene_sdf {sdf['sdf']['instructions']}, "
          f"scene_sdf_fwd with its guard {sdf['sdf_fwd']['instructions']} "
          "instructions (static; a skip jumps over the region)")
    src = "ray_marching_tpu_torch/ops/csrc/"
    fwd_opt = sum(opt[("pruned", path)][2]["fwd_pruned"]
                  for path in bwd_paths)
    bwd_opt = {path: opt[("pruned", path)][2]["bwd_pruned"]
               for path in bwd_paths}
    common = dict(scene="test_scene2, pruned", skip_share=share,
                  sass_per_eval_unpruned=figures["sass"].get("sdf"),
                  sass_per_eval_with_guard=figures["sass"].get("sdf_fwd"))
    rows = [
        kernel_row("render_fwd_pruned", src + "render_fwd.cu",
                   "ray_marching_tpu/ops/pallas_render.py:227",
                   frame_launches[1] + fwd_opt, mean[("serving", "pruned")],
                   plain_ms["serving"], bounds["serving"], card, row="1p",
                   max_abs_err=fwd_err,
                   ms_unpruned=mean[("serving", "unpruned")],
                   ms_training=mean[("training", "pruned")],
                   ms_training_unpruned=mean[("training", "unpruned")],
                   frame_ms=mean[("frame", "pruned")],
                   frame_ms_unpruned=mean[("frame", "unpruned")],
                   launches_frames=frame_launches[1],
                   launches_optimize=fwd_opt, **common),
        kernel_row("render_bwd_pruned", src + "render_bwd.cu",
                   "ray_marching_tpu/ops/pallas_backward.py:119",
                   bwd_opt["recompute"], mean[("recompute", "pruned")],
                   plain_ms["recompute"], bounds["recompute"], card,
                   row="2p", max_abs_err=bwd_errs["recompute"][0],
                   max_abs_err_params=bwd_errs["recompute"][1],
                   launches_history_path=opt[("pruned", "history")][2]["bwd"],
                   launches_history_path_pruned=bwd_opt["history"],
                   ms_unpruned=mean[("recompute", "unpruned")],
                   ms_history=mean[("history", "pruned")],
                   ms_history_unpruned=mean[("history", "unpruned")],
                   **common),
        kernel_row("render_bwd_two_level_pruned", src + "render_bwd.cu",
                   "ray_marching_tpu/ops/pallas_backward.py:377",
                   bwd_opt["two-level"], mean[("two-level", "pruned")],
                   plain_ms["two-level"], bounds["two-level"], card,
                   row="3p", max_abs_err=bwd_errs["two-level"][0],
                   max_abs_err_params=bwd_errs["two-level"][1],
                   ms_unpruned=mean[("two-level", "unpruned")], **common)]
    figures["seconds"] = time.perf_counter() - t0
    print(f"prune: {figures['seconds']:.1f} s")
    return rows, figures


#: The libraries of :func:`run_programs` that only the prune phase uses.
PRUNE_BUILDS = ("test_scene2 pruned", "mixed tc", "mixed tc pruned")
#: The scenes whose SDF the SASS probes compile beside the build.
SASS_SCENES = ("test_scene2", "mandelbulb", "test_scene2 pruned")


class OneBlockPerRayBlock:
    """While active, a backward launch that marches again runs one block
    per ray block, each in a scratch slot of its own, in place of the
    persistent grid, which must give the same bits."""

    def __enter__(self):
        from ray_marching_tpu_torch.ops import backward_kernel as bk

        self._fn, bk._resident = bk._resident, lambda *args: 1 << 62
        return self

    def __exit__(self, *exc):
        from ray_marching_tpu_torch.ops import backward_kernel as bk

        bk._resident = self._fn


def grads_digest(grads):
    """sha256 of a backward's cotangents (flat, matrices, rays), in order."""
    flat, mats, rays = grads
    h = hashlib.sha256()
    for t in (flat, *mats, rays):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def scratch_paths(label, prog, flat, rays7, steps, seed, mats=()):
    """Every backward path at one configuration (tau 0): the recompute and
    the two levels sha256-equal to the history path, and the recompute, the
    two levels and the march-only mode sha256-equal to their launches with
    one block per ray block (:class:`OneBlockPerRayBlock`). Returns the
    digests and each launch's grid and scratch bytes."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    _, ex = rk.march_forward(prog, flat, rays7, steps, 0.0, 5e-2,
                             log_hist=True, mats=mats)
    rng = np.random.default_rng(seed)
    shape = tuple(rays7.shape[1:])
    g8, g4 = (torch.as_tensor(rng.standard_normal((n,) + shape),
                              dtype=rays7.dtype).to(rays7.device)
              for n in (8, 4))
    calls = {
        "history": lambda: bk.fused_backward(
            prog, flat, rays7, g8, steps, 0.0, 5e-2, hist=ex["hist"],
            nlive=ex["nlive"], mats=mats),
        "recompute": lambda: bk.fused_backward(prog, flat, rays7, g8, steps,
                                               0.0, 5e-2, mats=mats),
        "two-level": lambda: bk.fused_backward(prog, flat, rays7, g8, steps,
                                               0.0, 5e-2, two_level=True,
                                               mats=mats),
        "march-only": lambda: bk.march_backward(prog, flat, rays7, g4,
                                                steps, 0.0, mats=mats),
    }
    digests, launches = {}, {}
    for name, fn in calls.items():
        digests[name] = grads_digest(fn())
        launches[name] = dict(bk.LAST_LAUNCH)
        if name != "history":
            with OneBlockPerRayBlock():
                digests[name + " one block per ray block"] = grads_digest(
                    fn())
                launches[name + " one block per ray block"] = dict(
                    bk.LAST_LAUNCH)
    del ex
    n_blocks = rays7.shape[1]
    for name in ("recompute", "two-level"):
        check(digests[name] == digests["history"],
              f"scratch {label}: {name} differs from the history path")
    for name in ("recompute", "two-level", "march-only"):
        check(digests[name] == digests[name + " one block per ray block"],
              f"scratch {label}: {name} differs from its launch with one "
              "block per ray block")
        check(1 <= launches[name]["grid"] <= n_blocks
              and launches[name + " one block per ray block"]["grid"]
              == n_blocks, f"scratch {label}: {name} grid {launches[name]}")
    check(launches["history"] == {"grid": n_blocks, "scratch_bytes": 0},
          f"scratch {label}: history launch {launches['history']}")
    print(f"scratch {label}: recompute == two-level == history, and each "
          f"of recompute, two-level, march-only == its launch with one "
          f"block per ray block (sha256 {digests['history'][:16]}, "
          f"march-only {digests['march-only'][:16]}); grids and scratch "
          "bytes: " + json.dumps(launches))
    return {"sha256": digests, "launches": launches}


def scratch_step(renderer, hist=None):
    """One training step of ``renderer`` (render, pixel MSE against a grey
    target, ``backward()``) on ``c1/c0/radius``, with the history decision
    as ``hist`` says: None the default rule, True or False the module's
    switch. Returns a function that runs it and records
    ``backward_kernel.LAST_PATH``."""
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    params = leaf_params(renderer.init_params)
    leaf = params["c1"]["c0"]["radius"]
    paths = []

    def step():
        leaf.grad = None
        default = rk.BWD_HIST
        if hist is not None:
            rk.BWD_HIST = hist
        try:
            img = renderer.render(params, BENCH_Q, BENCH_T, mode=0, degree=2)
            torch.mean((img - 0.5) ** 2).backward()
        finally:
            rk.BWD_HIST = default
        paths.append(dict(bk.LAST_PATH))
        return leaf.grad

    step.paths = paths
    return step


def scratch_phase(card, main, bulb_prog):
    """The backward's bounded scratch: every backward path sha256-equal to
    the history path (recompute, two levels) and to its launch with one
    block per ray block (also the march-only mode) on the analytic 1080p
    main path, the bulb at 1440×900 (24 steps) and the w256 field at 512² on
    the tensor cores; the 1080p recompute's scratch against the frame's
    history; peak memory and time of training steps at 1080p and at 4K
    with 32 and 64 steps, where the 64-step history is above the default
    cap and the forward must log none. Returns the figures."""
    import os

    import torch

    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.scene import registry

    t0 = time.perf_counter()
    figures = {"card": card}
    flat, rays7 = main_rays(main, BENCH_Q, BENCH_T)
    figures["analytic 1080p"] = scratch_paths(
        "analytic 1080p", main.program, flat, rays7, STEPS, 160)
    rec = figures["analytic 1080p"]["launches"]["recompute"]
    frame_bytes = rk.hist_bytes(rays7, STEPS)
    figures["analytic 1080p"]["history_bytes"] = frame_bytes
    check(rec["scratch_bytes"] <= SCRATCH_MAX_1080P
          and rec["grid"] < rays7.shape[1],
          f"scratch: the 1080p recompute took {rec}, the frame's history "
          f"{frame_bytes} bytes")
    del flat, rays7
    bulb = bulb_renderer(FastRenderer, BULB_W, BULB_H, torch.float32,
                         steps=BULB_TRAIN_MARCH, tau=0.0)
    check(bulb.program.cuda_source() == bulb_prog.cuda_source(),
          "scratch: the bulb's program is not the built one")
    flat, rays7 = main_rays(bulb, BENCH_Q, BENCH_T)
    figures["bulb 1440x900"] = scratch_paths(
        "bulb 1440x900", bulb.program, flat, rays7, BULB_TRAIN_MARCH, 161)
    del bulb, flat, rays7
    nr, nparams = neural_renderer(NEURAL_RES, torch.float32)
    check(rk.mlp_route(nr.program, torch.float32) == "tc",
          "scratch: the w256 field is not on the tensor cores")
    flat, mats, rays7 = neural_rays(nr, nparams)
    figures["w256 512 tc"] = scratch_paths(
        "w256 512 tc", nr.program, flat, rays7, NEURAL_STEPS, 162, mats)
    del nr, nparams, flat, mats, rays7

    # Peak memory (measured(), one step after a warm-up) and time (CUDA
    # events over 5 steps, cuda_ms) of training steps. 1080p: the recompute
    # against the history. 4K: each step count with the default rule
    # against the other path (the switch off at 32 steps; the cap raised at
    # 64).
    steps_fig = {}
    for label, hist in (("1080p recompute", False),
                        ("1080p history", True)):
        step = scratch_step(main, hist)
        _, peak, _ = measured(step)
        ms = cuda_ms(step, 5)
        steps_fig[label] = {"step_ms": ms, "peak_bytes": peak,
                            "use_hist": step.paths[-1]["use_hist"],
                            "scratch_bytes":
                            step.paths[-1].get("scratch_bytes")}
    check(not steps_fig["1080p recompute"]["use_hist"]
          and steps_fig["1080p history"]["use_hist"],
          f"scratch: 1080p paths {steps_fig}")
    cap = os.environ.get("RM_TPU_BWD_HIST_MAX")
    for n in SCRATCH_4K_STEPS:
        r4k = FastRenderer(registry.make_scene("test_scene2"),
                           dataclasses.replace(config(3840, 2160),
                                               marching_steps=n),
                           dtype=torch.float32)
        hist_bytes = rk.hist_bytes(main_rays(r4k, BENCH_Q, BENCH_T)[1], n)
        for label, hist, raise_cap in (("default", None, False),
                                       ("recompute", False, False),
                                       ("history", True, True)):
            if raise_cap:
                os.environ["RM_TPU_BWD_HIST_MAX"] = str(1 << 40)
            try:
                step = scratch_step(r4k, hist)
                _, peak, _ = measured(step)
                ms = cuda_ms(step, 5)
            finally:
                if cap is None:
                    os.environ.pop("RM_TPU_BWD_HIST_MAX", None)
                else:
                    os.environ["RM_TPU_BWD_HIST_MAX"] = cap
            last = step.paths[-1]
            steps_fig[f"4k {n} steps {label}"] = {
                "step_ms": ms, "peak_bytes": peak,
                "use_hist": last["use_hist"], "grid": last.get("grid"),
                "scratch_bytes": last.get("scratch_bytes"),
                "history_bytes": hist_bytes}
        over = hist_bytes > rk.HIST_MAX_DEFAULT
        default = steps_fig[f"4k {n} steps default"]
        check(default["use_hist"] == (not over),
              f"scratch: 4K {n} steps, history {hist_bytes} bytes, cap "
              f"{rk.HIST_MAX_DEFAULT}: use_hist {default['use_hist']}")
        if over:
            check(default["peak_bytes"] is not None
                  and default["peak_bytes"] < hist_bytes,
                  f"scratch: 4K {n} steps peak {default['peak_bytes']} "
                  f"bytes, the history alone {hist_bytes}")
        del r4k
    figures["steps"] = steps_fig
    for label, v in steps_fig.items():
        print(f"scratch step {label} on {card}: {v}")
    figures["phase_s"] = time.perf_counter() - t0
    print(f"scratch phase: {figures['phase_s']:.1f} s")
    return figures


def run_programs():
    """Every scene program the run builds, by label: the analytic scenes,
    the neural slices' scenes, the analytic target of the weights check,
    the Mandelbulb, and the prune phase's (test_scene2 with the union
    short-circuit, and a tensor-core scene with a guarded union, without
    and with it)."""
    from ray_marching_tpu_torch.scene import registry
    from ray_marching_tpu_torch.scene.codegen import SdfProgram

    programs = {s: SdfProgram(registry.make_scene(s))
                for s in ("test_scene2", "test_scene")}
    programs.update({
        "neural w256": SdfProgram(neural_scene()),
        "neural w256 bf16": SdfProgram(neural_scene("bfloat16")),
        "neural_demo": SdfProgram(registry.make_scene("neural_demo")),
        "distillation target": SdfProgram(target_scene()),
        "mandelbulb": SdfProgram(registry.make_scene("mandelbulb")),
        "test_scene2 pruned": SdfProgram(registry.make_scene("test_scene2"),
                                         prune=True),
        "mixed tc": SdfProgram(mixed_tc_scene()),
        "mixed tc pruned": SdfProgram(mixed_tc_scene(), prune=True),
    })
    return programs


def _scaled_tree(tree, factor):
    """Every leaf of ``tree`` times ``factor``."""
    return {k: _scaled_tree(v, factor) if isinstance(v, dict) else v * factor
            for k, v in tree.items()}


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
    programs = run_programs()
    t0 = time.perf_counter()
    # The bulb's spill check reads this run's ptxas report: a library left by
    # an earlier run is built again.
    shutil.rmtree(rk.BUILD_DIR / rk.kernel_key(programs["mandelbulb"]),
                  ignore_errors=True)
    probes = start_sass_probes({s: programs[s] for s in SASS_SCENES})
    rk.build_kernels(programs.values())
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(programs)} "
          "scene libraries")
    sass = {s: sass_report(s, programs[s], probe)
            for s, probe in probes.items()}
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
    bwd_two_level()
    ckpt_bytes = bk.LAST_LAUNCH["scratch_bytes"]
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
          f"{ckpt_bytes} bytes (frame-wide checkpoints "
          f"{STEPS // k * 3 * plane_bytes}) against a history of "
          f"{hist_bytes}")
    del out_h, ex_h

    # 5e. Where the history stops being small: 128 steps.
    long_hist_bytes = (LONG_STEPS + 1) * 3 * plane_bytes
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
    long_ckpt_bytes = bk.LAST_PATH["scratch_bytes"]
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
        "void march_kernel<float, false>": (march_ms, 1)})
    march_dev_ms = next((v for k_, v in mod_prof.items()
                         if k_.startswith("void march_kernel<float, false>")),
                        None)
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
    kernels["kernels"] += bulb_slice(card, out_dir, sass)
    # 9. The lighting modes, the tiled renderer and the XLA route's
    # backwards, through the same kernels.
    counts, figures = lighting_tiled_xla(card, out_dir)
    rows = {row["name"]: row for row in kernels["kernels"]}
    rows["render_fwd"].update(
        launches_lighting=sum(v for k, v in counts.items()
                              if isinstance(v, int) and k.startswith("fast")),
        launches_tiled_8k={k[9:]: v for k, v in counts.items()
                           if k.startswith("tiled_8k")},
        launches_tiled_4k_grad=counts["tiled_4k_grad"][0])
    rows["render_bwd"].update(
        launches_shaded_grad=counts["fast_shaded_grad"][1],
        launches_tiled_4k_grad=counts["tiled_4k_grad"][1])
    rows["march"].update(
        launches_lighting=sum(v for k, v in counts.items()
                              if isinstance(v, int)
                              and k.startswith("modular")))
    # The phase's own figures (plain-torch paths among them) and launch
    # counts, apart from the kernel rows.
    print("lighting_tiled_xla figures: " + json.dumps(
        {"counts": counts, "figures": figures}))
    # 10. I/O and the host side: the artifact server, the viewers, the CLI.
    h_counts, h_figures = host_side(card, out_dir)
    rows["render_fwd"].update(
        launches_host_side={k: v for k, v in h_counts.items()
                            if k != "cli_optimize_png"},
        launches_cli_optimize_png=h_counts["cli_optimize_png"][0])
    rows["render_bwd"].update(
        launches_cli_optimize_png=h_counts["cli_optimize_png"][1])
    print("host_side figures: " + json.dumps(
        {"counts": h_counts, "figures": h_figures}))
    # 11. The sharded paths on torch.distributed: one rank on NCCL, two
    # ranks on the one card over gloo.
    p_counts, p_figures = parallel_phase(card, out_dir)
    rows["render_fwd"].update(launches_sharded_per_rank={
        k: v["fwd"] for k, v in p_counts.items() if v["fwd"]},
        launches_sharded_tc_per_rank={
        k: v["fwd_tc"] for k, v in p_counts.items() if v["fwd_tc"]})
    rows["render_bwd"].update(launches_sharded_per_rank={
        k: v["bwd"] for k, v in p_counts.items() if v["bwd"]},
        launches_sharded_tc_per_rank={
        k: v["bwd_tc"] for k, v in p_counts.items() if v["bwd_tc"]})
    rows["march"].update(launches_sharded_per_rank={
        k: v["march"] for k, v in p_counts.items() if v["march"]})
    rows["march_bwd"].update(launches_sharded_per_rank={
        k: v["march_bwd"] for k, v in p_counts.items() if v["march_bwd"]})
    print("parallel figures: " + json.dumps(
        {"counts": p_counts, "figures": p_figures}))
    # 12. The union short-circuit at the main path's configuration.
    prune_rows, prune_figures = prune_phase(card, main, sass)
    kernels["kernels"] += prune_rows
    print("prune figures: " + json.dumps(prune_figures))
    # 13. The backward's bounded scratch and the history size rule.
    s_fig = scratch_phase(card, main, programs["mandelbulb"])
    s_launch = s_fig["analytic 1080p"]["launches"]
    rows["render_bwd"].update(
        grid_recompute=s_launch["recompute"]["grid"],
        scratch_bytes_recompute=s_launch["recompute"]["scratch_bytes"],
        history_bytes=s_fig["analytic 1080p"]["history_bytes"],
        step_peak_bytes={k: v["peak_bytes"]
                         for k, v in s_fig["steps"].items()})
    rows["render_bwd_two_level"].update(
        grid=s_launch["two-level"]["grid"],
        scratch_bytes=s_launch["two-level"]["scratch_bytes"])
    print("scratch figures: " + json.dumps(s_fig))
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
    parser.add_argument("--parallel-rank", type=int, default=None,
                        help=argparse.SUPPRESS)  # a rank of the phase's (b)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if args.parallel_rank is not None:
        parallel_rank(args.parallel_rank, args.store, Path(args.out))
        return 0
    result = run(Path(args.out))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
