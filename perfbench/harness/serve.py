"""The ``serve_orbit`` traffic: one viewer session over a scripted turn.

The window is one call of the viewer's frame loop, ``viewer.run_viewer``,
as ``cli interactive --orbit`` makes it: pipelined (frame n + 1 is queued
on the card before frame n is fetched), frames quantized to bytes on the
card and copied through pinned memory. Its input is the scripted orbit's
(``viewer.orbit_script``): every frame the mouse moves by the mix's
``yaw_per_frame``, which turns the camera about its own vertical axis, from
the seed's pose on the circle (:mod:`.poses`). A frame's latency runs from
the loop handing its pose to the ``pose_callback`` to its bytes reaching
the sink on the host. Set-up makes a three-frame call of the same loop, and
the window call's first frame (which fills the pipeline); the window runs
from that frame's delivery and closes at the first frame delivered after
``seconds``. Its frames over its time are ``frames_per_s``, and the 95th
percentile of all its latencies ``frame_ms_p95``.

Once the window has closed, the program's state is freed and the reference
renders a sample of the window's frames, drawn from the seed and holding
its last, at the poses the program rendered them at; those poses are held
to the reference's own integration of the script (``pose_gap``).

A traced run profiles ``TRACE_CYCLES`` stretches of ``CYCLE_FRAMES``
frames inside the loop; each is read between the starts of its first and
last forward kernels, whole frame periods of the pipeline.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.harness import compare, port, poses
from perfbench.harness.result import RunResult
from perfbench.harness.trace import Summary, Tracer, is_forward
from perfbench.harness import yardstick
from perfbench.harness.train import reference_start
from perfbench.reference.render import Reference

TRACE_CYCLES = 5
CYCLE_FRAMES = 6
WARM_FRAMES = 3


class Viewer:
    """One viewer session: the program's loop, its scripted input, and the
    start camera of the seed."""

    def __init__(self, renderer, params, cfg, mix, q0, t0):
        from ray_marching_tpu_torch.control import (
            CameraState,
            ControlConfig,
            InputSnapshot,
            SessionState,
        )
        from ray_marching_tpu_torch.viewer import ScriptedInput, run_viewer

        self.renderer, self.params = renderer, params
        self._scripted, self._run = ScriptedInput, run_viewer
        self._turn = InputSnapshot(mouse_ndc=(mix["yaw_per_frame"], 0.0))
        self._control = ControlConfig(
            rotation_sensitivity=mix["rotation_sensitivity"])
        r = cfg["render"]
        self._session = SessionState(mode=r["mode"], degree=r["degree"],
                                     marching_steps=r["marching_steps"])
        self._camera = CameraState(position=t0, orientation=q0)
        self.stop = False

    def _script(self, frames):
        n = 0
        while not self.stop and (frames is None or n < frames):
            n += 1
            yield self._turn

    def run(self, sink, pose_callback=None, frames=None):
        """One loop from the start camera, ``frames`` frames or until
        :attr:`stop` is set."""
        self.stop = False
        self._run(self.renderer, self._scripted(self._script(frames)), sink,
                  camera=self._camera, session=self._session,
                  control=self._control, print_fps=False, params=self.params,
                  pose_callback=pose_callback)


class Window:
    """What the window call's pose callback and sink record: each frame's
    pose (the camera's own tensors, kept without a copy), its latency, the
    sampled frames, and the traced stretches."""

    def __init__(self, viewer, seed, seconds, judged, tracer):
        self.viewer, self.seconds, self.tracer = viewer, seconds, tracer
        self.sent, self.latencies, self.cams = {}, [], {}
        self.judged = Reservoir(seed, judged)
        self.w0 = self.w1 = None
        self.trace_from = self.counter0 = None

    def pose(self, idx, camera, session):
        self.sent[idx] = time.perf_counter()
        self.cams[idx] = (camera.orientation, camera.position)
        tr = self.tracer
        if (tr and not tr.done and self.trace_from is None
                and self.w0 is not None):
            self.counter0 = port.launch_counters()["forward"]
            self.trace_from = idx
            tr.begin()

    def sink(self, idx, image, session):
        done = time.perf_counter()
        if self.w1 is not None:
            return  # the frame queued when the window closed
        if self.w0 is None:
            self.w0 = done
            return
        self.latencies.append(done - self.sent[idx])
        self.judged.add(idx, image)
        tr = self.tracer
        if (self.trace_from is not None
                and idx >= self.trace_from + CYCLE_FRAMES - 1):
            tr.end({"forward": (is_forward, port.launch_counters()["forward"]
                                - self.counter0)}, clip=is_forward)
            self.trace_from = None
        if done - self.w0 >= self.seconds:
            self.w1 = done
            self.viewer.stop = True


def run(cell, seed, seconds, trace, device, t0) -> RunResult:
    cfg, mix = cell.config, cell.traffic
    phases = {"start": time.perf_counter() - t0}
    renderer = port.build_renderer(cfg, device)
    q0, t0_ = poses.orbit_pose(poses.start_yaw(seed), cfg["pose"]["distance"],
                               cfg["pose"]["height"])
    q0, t0_ = (torch.as_tensor(a[None]).to(renderer.device, renderer.dtype)
               for a in (q0, t0_))
    viewer = Viewer(renderer, port.initial_params(cfg, renderer), cfg, mix,
                    q0, t0_)
    phases["renderer"] = time.perf_counter() - t0
    tracer = Tracer(TRACE_CYCLES) if trace else None
    if tracer:
        tracer.begin()
    viewer.run(lambda idx, image, session: None, frames=WARM_FRAMES)
    if tracer:
        tracer.discard()
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases["warm"] = time.perf_counter() - t0

    win = Window(viewer, seed, seconds, mix["judged_frames"], tracer)
    viewer.run(win.sink, pose_callback=win.pose)
    if win.trace_from is not None:
        tracer.discard()  # a stretch the window's close cut short
    n = len(win.latencies)
    result = RunResult(attempted=n, failed=0)
    result.setup_s = win.w0 - t0
    result.e2e = {"frames_per_s": n / (win.w1 - win.w0),
                  "frame_ms_p95": float(np.percentile(win.latencies, 95))
                  * 1e3}
    result.notes = {"frames": n, "window_s": win.w1 - win.w0,
                    "setup_phases_s": phases,
                    "frame_ms_quartiles": (np.percentile(
                        win.latencies, [0, 25, 50, 75, 100]) * 1e3).tolist()}
    result.read_memory(device)
    rays = cfg["render"]["width"] * cfg["render"]["height"]
    if tracer:
        result.summary = Summary(
            kind="serve", cycles=tracer.kept,
            work={"forward": yardstick.forward_work(cfg, rays),
                  "frame": yardstick.serve_frame_work(cfg, rays)},
            peaks=cfg["peaks"])
    judged = [(k, frame, tuple(c[0].detach().cpu() for c in win.cams[k]))
              for k, frame in win.judged.frames()]
    del viewer, win, renderer, q0, t0_
    result.free(device)

    field, params = reference_start(cfg, device)
    ref = Reference(field, cfg["render"], torch.float32, device,
                    cfg["reference_block"])
    ref_q, ref_t = poses.viewer_turn(seed, cfg["pose"], mix,
                                     [k for k, _, _ in judged])
    per_frame, px_off = [], []
    for i, (k, frame, (q, t)) in enumerate(judged):
        image = ref.render(params, [(q.to(device), t.to(device))])[0]
        per_frame.append(compare.frame_numbers(frame[0], image, (q, t),
                                               (ref_q[i], ref_t[i])))
        px_off.append(compare.frame_detail(frame[0], image))
    result.numbers = compare.worst(per_frame)
    result.notes["judged_frames"] = [k for k, _, _ in judged]
    result.notes["detail"] = {"frame_px_off": px_off}
    return result


class Reservoir:
    """The frames to judge: the window's last, and ``k - 1`` of the others
    drawn uniformly from the seed as they come (reservoir sampling), so a
    run holds ``k`` frames however many it serves. A frame is copied out
    of the pinned buffer the viewer handed over, so that the buffer goes
    back to the pinned pool as a sink's would: held buffers make the pool
    allocate anew, a stall of tens of milliseconds."""

    def __init__(self, seed, k):
        self.keep, self.draw = k - 1, poses.rng(seed, 1)
        self.kept, self.last, self.seen = [], None, 0

    def add(self, index, frame):
        if self.last is not None:
            if self.seen < self.keep:
                self.kept.append(self.last)
            elif (r := int(self.draw.integers(0, self.seen + 1))) < self.keep:
                self.kept[r] = self.last
            self.seen += 1
        self.last = (index, np.array(frame))

    def frames(self):
        return sorted(self.kept, key=lambda kf: kf[0]) + [self.last]
