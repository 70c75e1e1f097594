"""Interactive frame loop: input → pose integration → render → sink
(counterpart of ``ray_marching_tpu/viewer.py``).

Frames come back from the card to the host and go to a pluggable sink (a
PNG stream, a terminal preview, an animated PNG, the browser viewer's frame
buffer of ``web.py``). Input comes from a pluggable source: a scripted one
for tests and headless runs, or a pynput-backed one where a keyboard and a
mouse are present, with a single-writer snapshot handoff.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ray_marching_tpu_torch.control import (
    CameraState,
    ControlConfig,
    InputSnapshot,
    SessionState,
    apply_input,
)
from ray_marching_tpu_torch.io.image import encode_png, write_apng, write_png
from ray_marching_tpu_torch.spans import (
    VIEWER_COPY,
    VIEWER_FRAME,
    VIEWER_INPUT,
    VIEWER_RENDER,
    VIEWER_SINK,
    VIEWER_WAIT,
    span,
)


class ScriptedInput:
    """Replays a fixed sequence of snapshots, then quits."""

    def __init__(self, snapshots: Iterable[InputSnapshot]):
        self._it = iter(snapshots)

    def poll(self) -> InputSnapshot:
        try:
            return next(self._it)
        except StopIteration:
            return InputSnapshot(quit=True)

    def close(self):
        pass


class PynputInput:
    """Mouse and keyboard listener (needs pynput and a display server;
    imported here, when a session asks for it). Listener callbacks write
    private fields under a lock; :meth:`poll` snapshots them."""

    def __init__(self, screen_size=(1920, 1080)):
        from pynput import keyboard, mouse

        self._mouse_pos = (screen_size[0] // 2, screen_size[1] // 2)
        self._centre = (screen_size[0] // 2, screen_size[1] // 2)
        self._pressed = set()
        self._scroll = 0
        self._quit = False
        self._save = False
        self._lock = threading.Lock()

        def on_move(x, y):
            self._mouse_pos = (x, y)

        def on_scroll(x, y, dx, dy):
            with self._lock:
                self._scroll += 1 if dy > 0 else -1 if dy < 0 else 0

        def on_press(key):
            char = getattr(key, "char", None)
            if char:
                with self._lock:
                    self._pressed.add(char)
                    if char == "q":
                        self._quit = True
                    if char == "p":
                        self._save = True

        def on_release(key):
            char = getattr(key, "char", None)
            if char:
                with self._lock:
                    self._pressed.discard(char)

        self._listeners = [
            mouse.Listener(on_move=on_move, on_scroll=on_scroll),
            keyboard.Listener(on_press=on_press, on_release=on_release),
        ]
        for listener in self._listeners:
            listener.start()

    def poll(self) -> InputSnapshot:
        with self._lock:
            scroll, self._scroll = self._scroll, 0
            save, self._save = self._save, False
            pressed = frozenset(self._pressed)
            quit_ = self._quit
        return InputSnapshot(
            mouse_ndc=(
                (self._mouse_pos[0] - self._centre[0]) / self._centre[0],
                (self._mouse_pos[1] - self._centre[1]) / self._centre[1],
            ),
            pressed=pressed, scroll=scroll, quit=quit_, save_frame=save)

    def close(self):
        for listener in self._listeners:
            listener.stop()


def orbit_script(frames: int, yaw_per_frame: float = 0.02):
    """A scripted input that slowly orbits (demos and smoke runs)."""
    return ScriptedInput(
        [InputSnapshot(mouse_ndc=(yaw_per_frame, 0.0)) for _ in range(frames)])


def _display_frame(image):
    """(N, H, W, C) → (H, W, C): the camera axis averaged away, as
    ``write_png`` does (uint8 frames stay uint8; one camera's frame is
    taken as it is, the mean's values without its pass over the frame)."""
    img = np.asarray(image)
    if img.ndim == 4 and img.shape[0] == 1:
        return img[0]
    if img.ndim == 4:
        was_uint8 = img.dtype == np.uint8
        img = img.mean(axis=0)
        if was_uint8:
            img = (img + 0.5).astype(np.uint8)
    return img


def _quantized(img):
    """A float frame (numpy) as display bytes: NaN black, ±inf clamped."""
    if img.dtype == np.uint8:
        return img
    img = np.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    return (np.clip(img, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)


@dataclass
class PNGSink:
    """Writes every Nth frame (and every save-requested frame) as PNG."""

    directory: str
    every: int = 1

    def __call__(self, frame_idx, image, session):
        if session.save_frame or frame_idx % self.every == 0:
            write_png(Path(self.directory) / f"frame_{frame_idx:05d}.png",
                      image)


class TerminalSink:
    """Live preview in a 24-bit-colour terminal: each character cell shows
    two vertical pixels through '▀' with the top pixel as foreground and
    the bottom one as background colour. NaN pixels render black."""

    def __init__(self, max_cols: int = 100, max_rows: int = 48, file=None):
        self.max_cols = max_cols
        self.max_rows = max_rows  # character rows: 2 * max_rows pixels
        self.file = file or sys.stdout
        self._first = True

    def __call__(self, frame_idx, image, session):
        img = _display_frame(image)
        if img.dtype != np.uint8:  # as the JAX sink: truncating, no + 0.5
            img = np.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        h, w = img.shape[:2]
        step = max(1, -(-w // self.max_cols), -(-h // (2 * self.max_rows)))
        img = img[::step, ::step]
        if img.shape[0] % 2:  # an even row count pairs top and bottom
            img = img[:-1]
        lines = []
        for tr, br in zip(img[0::2], img[1::2]):
            cells = [
                f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                for t, b in zip(tr, br)
            ]
            lines.append("".join(cells) + "\x1b[0m")
        # Repaint in place after the first frame (cursor up, column 0).
        prefix = "" if self._first else f"\x1b[{len(lines)}F"
        self._first = False
        self.file.write(prefix + "\n".join(lines) + "\n")
        self.file.flush()


class KittySink:
    """Live full-resolution preview through the kitty graphics protocol
    (APC ``\\x1b_G…\\x1b\\\\`` escapes carrying base64 PNG). Each frame
    deletes the previous placement and transmits at the saved cursor;
    ``q=2`` suppresses the terminal's responses."""

    CHUNK = 4096

    def __init__(self, file=None):
        self.file = file or sys.stdout
        self._first = True

    def __call__(self, frame_idx, image, session):
        import base64

        # zlib level 1: a live frame is drawn once.
        payload = base64.standard_b64encode(
            encode_png(_display_frame(image), level=1))
        out = []
        if self._first:
            out.append("\x1b[s")  # save the cursor
            self._first = False
        else:
            out.append("\x1b[u\x1b[s")  # restore it: repaint in place
            out.append("\x1b_Ga=d,d=A,q=2\x1b\\")  # delete old placements
        pos = 0
        first_chunk = True
        while pos < len(payload):
            chunk = payload[pos:pos + self.CHUNK]
            pos += self.CHUNK
            more = 1 if pos < len(payload) else 0
            ctrl = f"a=T,f=100,q=2,m={more}" if first_chunk else f"m={more}"
            first_chunk = False
            out.append(f"\x1b_G{ctrl};{chunk.decode('ascii')}\x1b\\")
        self.file.write("".join(out))
        self.file.flush()


class APNGSink:
    """Collects frames (uint8 on the host) and writes one looping animated
    PNG on :meth:`close`, which ``run_viewer`` calls when the loop ends."""

    def __init__(self, path, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self.frames = []

    def __call__(self, frame_idx, image, session):
        self.frames.append(_quantized(_display_frame(image)))

    def close(self):
        if self.frames:
            write_apng(self.path, self.frames, fps=self.fps)


class MultiSink:
    """Fans a frame out to several sinks (a terminal preview and PNGs)."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def __call__(self, frame_idx, image, session):
        for sink in self.sinks:
            sink(frame_idx, image, session)

    def close(self):
        for sink in self.sinks:
            if hasattr(sink, "close"):
                sink.close()


def quantize(img, fetch_stride: int = 1):
    """A frame on its device as display bytes, before it is copied to the
    host (the JAX viewer's ``quantize``): every ``fetch_stride``-th pixel,
    NaN black, ±inf clamped, ``uint8(clip(v, 0, 1) * 255 + 0.5)``."""
    if fetch_stride > 1:
        img = img[:, ::fetch_stride, ::fetch_stride]
    img = torch.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _frame_fn(renderer, mode, steps, degree, transfer, fetch_stride):
    """``f(params, q, t)``: one frame as ``run_viewer`` fetches it."""
    def fn(p, q, t):
        with span(VIEWER_RENDER):
            img = renderer.render(p, q, t, mode=mode, marching_steps=steps,
                                  degree=degree)
            if transfer == "uint8":
                return quantize(img, fetch_stride)
            return img[:, ::fetch_stride, ::fetch_stride]
    return fn


class _HostCopy:
    """One frame on its way to the host. On a card: copied as soon as its
    render is queued, without waiting, into pinned memory, with an event
    recorded behind the copy; :meth:`get` waits for that event only, so the
    frames queued after it keep the card busy (a plain ``.cpu()`` would
    wait for them too)."""

    def __init__(self, image):
        with span(VIEWER_COPY):
            self.event = None
            if image.device.type == "cpu":
                self.host = image
                return
            self.host = torch.empty(image.shape, dtype=image.dtype,
                                    pin_memory=True)
            self.host.copy_(image, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> np.ndarray:
        with span(VIEWER_WAIT):
            if self.event is not None:
                self.event.synchronize()
        return self.host.numpy()


def run_viewer(renderer, input_source, sink: Callable, *,
               camera: Optional[CameraState] = None,
               session: Optional[SessionState] = None,
               control: ControlConfig = ControlConfig(),
               max_frames: Optional[int] = None,
               print_fps: bool = True,
               transfer: str = "uint8",
               fetch_stride: int = 1,
               params=None,
               modes=None,
               pose_callback: Optional[Callable] = None,
               device_lock=None,
               pipeline: bool = True):
    """The frame loop. Returns ``(camera, session, frames)``.

    ``params``: the scene parameters to render with (default the
    renderer's). ``modes``: the shader modes the scroll wheel walks
    (integers and named lighting modes; default ``range(8)``).
    ``transfer='uint8'`` quantizes on the device before the copy to the
    host (:func:`quantize`; a quarter of the bytes), ``'float32'`` copies
    the shader's output; ``fetch_stride=k`` keeps every k-th pixel on the
    device first. ``pose_callback(frame_idx, camera, session)`` sees each
    frame's pose before its render. ``device_lock`` (a lock) is held around
    each frame's device work: the kernel wrappers' launch counters are
    module globals, and a caller with other device work on other threads
    serializes it with the same lock. ``pipeline``: frame n+1 is queued
    before frame n is handed to the sink, so the card renders while the
    host encodes (one frame of latency); ``False`` fetches each frame
    before the next is queued.
    """
    if transfer not in ("uint8", "float32"):
        raise ValueError(f"transfer must be 'uint8' or 'float32', got "
                         f"{transfer!r}")
    device = torch.device(renderer.device)
    camera = camera or CameraState.initial(dtype=renderer.dtype,
                                           device=device)
    session = session or SessionState(
        marching_steps=renderer.config.marching_steps)
    params = renderer.init_params if params is None else params
    modes = tuple(range(8)) if modes is None else tuple(modes)
    lock = device_lock or contextlib.nullcontext()

    frame_idx = 0
    old_time = time.perf_counter()
    pending = None  # (frame_idx, _HostCopy, session at dispatch)

    def flush(pending):
        nonlocal old_time
        idx, copy, sess = pending
        image = copy.get()
        with span(VIEWER_SINK):
            sink(idx, image, sess)
        new_time = time.perf_counter()
        if print_fps:
            print(f"{1.0 / (new_time - old_time):.2f} frames per second")
        old_time = new_time

    ctx = (torch.cuda.device(device) if device.type == "cuda"
           else contextlib.nullcontext())
    with ctx, torch.no_grad():
        while session.running and (max_frames is None
                                   or frame_idx < max_frames):
            with span(VIEWER_FRAME):
                with span(VIEWER_INPUT):
                    snap = input_source.poll()
                    session = session.step(snap)
                    if session.running:
                        with lock:
                            camera = apply_input(camera, snap, control)
                if not session.running:
                    break
                if pose_callback is not None:
                    pose_callback(frame_idx, camera, session)
                frame = _frame_fn(renderer, modes[session.mode % len(modes)],
                                  session.marching_steps, session.degree,
                                  transfer, fetch_stride)
                with lock:
                    copy = _HostCopy(frame(params, camera.orientation,
                                           camera.position))
                if pending is not None:
                    flush(pending)
                pending = (frame_idx, copy, session)
                if not pipeline:
                    flush(pending)
                    pending = None
                frame_idx += 1
        if pending is not None:
            flush(pending)
    input_source.close()
    if hasattr(sink, "close"):  # finalize accumulating sinks (APNGSink)
        sink.close()
    return camera, session, frame_idx
