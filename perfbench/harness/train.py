"""The ``train_fit`` traffic: a closed loop of ``optimize`` steps.

Set-up makes the views from the seed (:mod:`.poses`), the target frames
with the reference (the configuration's ``fit.target``), builds the
program's renderer and starting parameters, and starts one ``optimize``
call. Its first ``CHECKED`` steps are set-up too (the first builds or loads
the kernels); the program's losses, its first two gradients, its
parameters after the first two and after all of them, and its optimizer's
moments after the second are kept. From the end of the last of them the window runs: each step
is ``optimize``'s own (render, l2 loss, ``backward()``, Adam, the loss read
back as a float), and the window closes at the first step that ends after
``seconds``. The window's time over its steps is ``train_step_ms``.

Once the window has closed and the peak memory is read, the program's
state is freed and the reference follows the same first steps (the mix's
``reference_steps``) from the same parameters, views and target
(:mod:`perfbench.reference.fit`), in the precision the configuration's
``fit`` names (``reference_dtype``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from perfbench.harness import compare, port, poses
from perfbench.harness.result import RunResult
from perfbench.harness.trace import Summary, Tracer, is_backward, is_forward
from perfbench.harness import yardstick
from perfbench.reference import fit, sdf
from perfbench.reference.adam import Adam
from perfbench.reference.render import Reference

#: Steps the reference follows; they run in set-up.
CHECKED = 3
TRACE_CYCLES = 5


class WindowClosed(Exception):
    pass


def trainable_paths(cfg, paths):
    names = cfg["fit"]["trainable"]
    return [p for p in paths if names is None or any(n in p for n in names)]


def reference_start(cfg, device, dtype=torch.float32):
    """The reference's field and its starting parameters (the description's
    values, or the weights file's)."""
    field, leaves = sdf.build(cfg["scene"])
    wfile = port.weights_file(cfg)
    weights = fit.load_weights(wfile) if wfile else None
    return field, sdf.leaf_tensors(leaves, dtype, device, weights)


def make_target(cfg, views, device):
    """The fit's target frames, rendered by the reference: the
    configuration's scene with some leaves scaled (``perturb``), or another
    scene (``scene``)."""
    spec = cfg["fit"]["target"]
    if "scene" in spec:
        field, leaves = sdf.build(spec["scene"])
        params = sdf.leaf_tensors(leaves, torch.float32, device)
    else:
        field, params = reference_start(cfg, device)
        params = {k: v * spec["perturb"].get(k, 1.0)
                  for k, v in params.items()}
    ref = Reference(field, cfg["render"], torch.float32, device,
                    cfg["reference_block"])
    return ref.render(params, views)


def run(cell, seed, seconds, trace, device, t0) -> RunResult:
    cfg, traffic = cell.config, cell.traffic
    from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize

    phases = {"start": time.perf_counter() - t0}
    views = poses.views(seed, cfg["pose"], traffic["views"],
                        traffic["view_spacing"])
    target = make_target(cfg, views, device)
    phases["target"] = time.perf_counter() - t0
    cfg_n = dict(cfg, render=dict(cfg["render"], num_cameras=len(views)))
    renderer = port.build_renderer(cfg_n, device)
    p0 = port.initial_params(cfg, renderer)
    phases["renderer"] = time.perf_counter() - t0
    start = {k: v.detach().clone() for k, v in port.flat(p0).items()}
    q, t = port.poses_tensor(views, port.dtype_of(cfg), renderer.device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    rays = cfg["render"]["width"] * cfg["render"]["height"] * len(views)
    tracer = Tracer(TRACE_CYCLES) if trace else None
    rec = {"losses": [], "grads": [], "params_after": [], "window": None,
           "steps": 0, "failed": 0, "last_loss": None}
    marks, stamps = {}, []
    # The program's optimizer, as its step hands itself to the hook: its
    # moments after the second step are read from it (optimize keeps it
    # to itself).
    hook = register_optimizer_step_post_hook(
        lambda opt, args, kwargs: marks.setdefault("optimizer", opt))

    def snapshot(state):
        return {k: v.detach().clone()
                for k, v in port.flat(state["params"]).items()}

    def callback(step, loss, state):
        now = time.perf_counter()
        stamps.append(now)
        if step < CHECKED:
            phases[f"step{step}"] = now - t0
            rec["losses"].append(loss)
            if tracer and step == 0:
                tracer.begin()
            if tracer and step == 1:
                tracer.discard()
            rec["params_after"].append(snapshot(state))
            if step < 2:
                live = port.flat(state["params"])
                rec["grads"].append({k: v.grad.detach().clone()
                                     for k, v in live.items()})
            if step == 1:
                opt = marks.get("optimizer")
                st = opt.state if opt is not None else {}
                # A moment the optimizer never made reads as zeros, as
                # optimize's own checkpoint template has it.
                rec["moments"] = tuple(
                    {k: st.get(v, {}).get(key, torch.zeros_like(v))
                     .detach().clone() for k, v in live.items()}
                    for key in ("exp_avg", "exp_avg_sq"))
                hook.remove()
            if step == CHECKED - 1:
                if tracer:
                    marks["counters"] = port.launch_counters()
                    tracer.begin()
                rec["window"] = [time.perf_counter(), None]
            return
        rec["steps"] += 1
        rec["last_loss"] = loss
        if not math.isfinite(loss):
            rec["failed"] += 1
        if tracer and not tracer.done:
            c1, c0 = port.launch_counters(), marks["counters"]
            tracer.end({"forward": (is_forward, c1["forward"] - c0["forward"]),
                        "backward": (is_backward,
                                     c1["backward"] - c0["backward"])})
            if not tracer.done:
                marks["counters"] = port.launch_counters()
                tracer.begin()
        if now - rec["window"][0] >= seconds:
            rec["window"][1] = now
            raise WindowClosed

    icfg = InverseConfig(
        learning_rate=traffic["learning_rate"], steps=2**62,
        mode=cfg["render"]["mode"], degree=cfg["render"]["degree"],
        optimizer=traffic["optimizer"], trainable=cfg["fit"]["trainable"],
        loss=traffic["loss"])
    try:
        optimize(renderer, target, q, t, icfg, init_params=p0,
                 callback=callback)
    except WindowClosed:
        pass
    finally:
        hook.remove()
    w0, w1 = rec["window"]
    result = RunResult(attempted=rec["steps"], failed=rec["failed"])
    result.setup_s = w0 - t0
    result.e2e = {"train_step_ms": (w1 - w0) * 1e3 / rec["steps"]}
    steps_ms = np.diff(stamps[CHECKED - 1:]) * 1e3
    result.notes = {"steps": rec["steps"], "window_s": w1 - w0,
                    "setup_phases_s": phases,
                    "step_ms_quartiles": np.percentile(
                        steps_ms, [0, 25, 50, 75, 100]).tolist(),
                    "last_loss": rec["last_loss"],
                    "first_losses": rec["losses"],
                    "backward_path": port.backward_path()}
    result.read_memory(device)
    if tracer:
        result.summary = Summary(
            kind="train", cycles=tracer.kept,
            work={"forward": yardstick.forward_work(cfg, rays),
                  "backward": yardstick.backward_work(cfg, rays),
                  "step": yardstick.train_step_work(cfg, rays)},
            peaks=cfg["peaks"])
    prog = {k: rec[k] for k in ("losses", "grads", "params_after",
                                "moments")}
    del renderer, p0, q, t
    result.free(device)

    ref = follow_reference(cfg, traffic, views, target, device)
    trainable = trainable_paths(cfg, list(start))
    result.numbers = compare.train_numbers(prog, ref, start, trainable,
                                           traffic["learning_rate"])
    result.notes["detail"] = compare.train_detail(prog, ref, start, trainable)
    return result


def follow_reference(cfg, traffic, views, target, device, dtype=None,
                     steps=None, ref_cls=Reference, adam=Adam):
    """The reference's first steps: by default the mix's
    ``reference_steps`` in the fit's ``reference_dtype``.
    calibrate.py puts it in the program's place: ``CHECKED`` steps in a
    ``dtype`` below the configuration's, or with a ``ref_cls`` or ``adam``
    that has a fault planted."""
    dtype = dtype or getattr(torch, cfg["fit"]["reference_dtype"])
    steps = steps or traffic["reference_steps"]
    field, params = reference_start(cfg, device, dtype)
    ref = ref_cls(field, cfg["render"], dtype, device,
                  cfg["reference_block"])
    trainable = set(trainable_paths(cfg, list(params)))
    frozen = {k for k in params if k not in trainable}

    def poses_for_step(i):
        # optimize renormalizes the camera quaternion after each update.
        out = []
        for q, t in views:
            qt = torch.as_tensor(q).to(device)
            if i > 0:
                qt = qt / torch.linalg.norm(qt)
            out.append((qt.to(dtype), torch.as_tensor(t).to(device, dtype)))
        return out

    return fit.follow(ref, params, poses_for_step, target.to(dtype),
                      traffic["learning_rate"], steps, frozen, adam)
