"""The readings the limits of ``correct`` are set from (on the card):

    python3 perfbench/calibrate.py --workload <name> --seeds 12 --controls 3

Lower readings: the program on each seed, the whole run with a short window
(a training cell needs none: its numbers come from set-up's first steps).
Upper readings: the control, the reference put in the program's place in
the precision below the configuration's (bfloat16 for an analytic scene;
TF32 matrix products for a neural one, and for the served camera's pose,
which has none, bfloat16), on ``--controls`` seeds; for a training cell
also the faults of ``--faults`` planted in that reference (``half``: half
of each view's pixels left out, the mean over the rest; ``shift``: every
intensity one level brighter where it is produced; ``reset``: Adam's
moments set to zero before each step). A state left unchanged reads 1 on
``change1_gap`` and needs no run. Each reading prints as one JSON line;
the last line holds, per number, the largest program reading and the
smallest of the others.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import numpy as np  # noqa: E402

from perfbench.harness import compare, poses, serve, train  # noqa: E402
from perfbench.harness.spec import load_cell  # noqa: E402
from perfbench.reference.adam import Adam  # noqa: E402
from perfbench.reference.render import Reference  # noqa: E402

SEED_BASE = 3_000_000_000


@contextlib.contextmanager
def tf32(on):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def control_dtype(cfg):
    """bfloat16 for a scene without matrix products, else float32 with
    TF32 products."""
    neural = cfg["work"]["matmul_flops_per_eval"] > 0
    return (torch.float32, True) if neural else (torch.bfloat16, False)


class FaultyReference(Reference):
    """The reference with a fault planted where its image is produced:
    ``half`` leaves out the second half of each view's pixels and takes the
    mean over the rest; ``shift`` makes every intensity one level (1/255)
    brighter."""

    fault = None

    def _shade(self, params, q, t, lo, hi):
        v = super()._shade(params, q, t, lo, hi)
        return v + 1.0 / 255.0 if self.fault == "shift" else v

    def loss_and_grad(self, params, poses_, target):
        if self.fault != "half":
            return super().loss_and_grad(params, poses_, target)
        npix, self.npix = self.npix, self.npix // 2
        try:
            return super().loss_and_grad(params, poses_, target)
        finally:
            self.npix = npix


def faulty(name):
    return type(f"Faulty_{name}", (FaultyReference,), {"fault": name})


class ResetAdam(Adam):
    """Adam whose moments are set to zero before each step."""

    def step(self, params, grads, frozen=()):
        self.m = {k: torch.zeros_like(v) for k, v in self.m.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.v.items()}
        return super().step(params, grads, frozen)


def train_control(cell, seed, device, fault=None):
    cfg, traffic = cell.config, cell.traffic
    views = poses.views(seed, cfg["pose"], traffic["views"],
                        traffic["view_spacing"])
    target = train.make_target(cfg, views, device)
    _, start = train.reference_start(cfg, device)
    ref = train.follow_reference(cfg, traffic, views, target, device)
    own = dict(steps=train.CHECKED, dtype=train.port.dtype_of(cfg))
    if fault == "reset":
        prog = train.follow_reference(cfg, traffic, views, target, device,
                                      adam=ResetAdam, **own)
    elif fault:
        prog = train.follow_reference(cfg, traffic, views, target, device,
                                      ref_cls=faulty(fault), **own)
    else:
        dtype, tf = control_dtype(cfg)
        with tf32(tf):
            prog = train.follow_reference(cfg, traffic, views, target,
                                          device, dtype, train.CHECKED)
    trainable = train.trainable_paths(cfg, list(start))
    return (compare.train_numbers(prog, ref, start, trainable,
                                  traffic["learning_rate"]),
            compare.train_detail(prog, ref, start, trainable))


def _multiply(p, q):
    """Hamilton product of two wxyz quaternions (1-D tensors)."""
    pw, px, py, pz = p
    qw, qx, qy, qz = q
    return torch.stack([pw * qw - px * qx - py * qy - pz * qz,
                        pw * qx + px * qw + py * qz - pz * qy,
                        pw * qy + py * qw + pz * qx - px * qz,
                        pw * qz + px * qy + pz * qw - py * qx])


def turn_low(seed, cfg, mix, frames, dtype):
    """The control's camera: the scripted turn integrated frame by frame
    in ``dtype``, as a viewer does (``q <- normalize(q * (sqrt(1 - v^2),
    0, v, 0))``); ``(q, t)`` of frame indices ``frames``."""
    q0, t0 = poses.orbit_pose(poses.start_yaw(seed), cfg["pose"]["distance"],
                              cfg["pose"]["height"])
    q = torch.as_tensor(q0, dtype=dtype)
    v = torch.tensor(mix["yaw_per_frame"] * mix["rotation_sensitivity"],
                     dtype=dtype)
    turn = torch.stack([torch.sqrt(1 - v * v), 0 * v, v, 0 * v])
    want, out = set(frames), {}
    for k in range(max(frames) + 1):
        q = _multiply(q, turn)
        q = q / torch.sqrt(torch.sum(q * q))
        if k in want:
            out[k] = q.float()
    t = torch.as_tensor(t0).to(dtype).float()
    return [(out[k], t) for k in frames]


def serve_control(cell, seed, device, frames, run_frames=900):
    """The control of a served cell on ``frames`` frames spread over a
    run of ``run_frames``, the last among them: its camera integrated in
    bfloat16, and each frame rendered with TF32 products at that camera,
    against the reference's float64 pose and float32 frame."""
    cfg, mix = cell.config, cell.traffic
    field, params = train.reference_start(cfg, device)
    dtype, tf = control_dtype(cfg)
    ref, low = (Reference(field, cfg["render"], d, device,
                          cfg["reference_block"])
                for d in (torch.float32, dtype))
    low_params = {k: v.to(dtype) for k, v in params.items()}
    idx = [int(k) for k in
           np.linspace(run_frames - 1, 0, frames, endpoint=False)[::-1]]
    ref_q, ref_t = poses.viewer_turn(seed, cfg["pose"], mix, idx)
    cams = turn_low(seed, cfg, mix, idx, torch.bfloat16)
    per = []
    for i, (q, t) in enumerate(cams):
        pose = [(q.to(device), t.to(device))]
        with tf32(tf):
            img = low.render(low_params, [(p.to(dtype), tt.to(dtype))
                                          for p, tt in pose])[0].float()
        img = torch.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
        u8 = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        per.append(compare.frame_numbers(u8.cpu().numpy(),
                                         ref.render(params, pose)[0],
                                         (q, t), (ref_q[i], ref_t[i])))
    return compare.worst(per)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", default="half,shift,reset")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None,
                    help="WxH in place of the configuration's (rehearsals "
                         "on the CPU)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    cell = load_cell(args.workload)
    if args.size:
        w, h = (int(v) for v in args.size.split("x"))
        cell.config["render"].update(width=w, height=h)
    kind = cell.traffic["kind"]
    readings = {"program": [], "control": []}
    runs = [{}]

    def emit(role, seed, numbers, extra=None):
        print(json.dumps({"role": role, "seed": seed, "numbers": numbers,
                          **(extra or {})}), flush=True)

    for i in range(args.seeds):
        seed = SEED_BASE + 7919 * i + 1
        t0 = time.perf_counter()
        drive = train.run if kind == "train_fit" else serve.run
        res = drive(cell, seed, 0.0 if kind == "train_fit" else args.seconds,
                    False, device, t0)
        readings["program"].append(res.numbers)
        runs.append(res.notes)
        emit("program", seed, res.numbers,
             {"seconds": time.perf_counter() - t0, "notes": res.notes,
              "e2e": res.e2e, "setup_s": res.setup_s})
    roles = [("control", None)] + (
        [(f, f) for f in args.faults.split(",") if f]
        if kind == "train_fit" else [])
    for role, fault in roles:
        readings.setdefault(role, [])
        for i in range(args.controls):
            seed = SEED_BASE + 104729 * i + 3
            t0 = time.perf_counter()
            detail = None
            if kind == "train_fit":
                nums, detail = train_control(cell, seed, device, fault)
            else:
                nums = serve_control(cell, seed, device,
                                     cell.traffic["judged_frames"],
                                     max(r.get("frames", 900) for r in runs))
            readings[role].append(nums)
            emit(role, seed, nums, {"seconds": time.perf_counter() - t0,
                                    "detail": detail})
    summary = {}
    for name in readings["program"][0]:
        summary[name] = {"lower": max(r[name] for r in readings["program"])}
        for role in readings:
            if role != "program" and readings[role]:
                summary[name][role] = min(r[name] for r in readings[role])
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
