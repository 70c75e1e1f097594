"""Browser live viewer: mouse-look and WASD over HTTP (counterpart of
``ray_marching_tpu/web.py``).

A machine with a card usually has no display server, so the interactive
session runs in a browser: this module serves an HTML page whose JavaScript
streams input events (mouse NDC, pressed keys, scroll) to the render process
and pulls frames back as PNGs; stdlib ``http.server`` and the package's PNG
encoder, nothing else.

A :class:`BrowserInput` is the viewer's input source (``poll() ->
InputSnapshot``), so the session runs through the same
:func:`ray_marching_tpu_torch.viewer.run_viewer` loop as the terminal viewer:
the same pose integration (``control.apply_input``), the same session keys
and the same one-frame pipeline.
The loop runs on a worker thread, on the renderer's device, and holds
:attr:`LiveViewer.device_lock` around its device work; the HTTP threads take
the same lock for theirs (reading the pose).

Endpoints:
    GET  /            -> the interactive HTML page
    GET  /frame.png   -> the latest frame (long-polls ?after=<seq> for a new one)
    POST /input       -> a JSON input snapshot from the browser
    GET  /state       -> pose, session and counters (JSON)
    GET  /healthz     -> 200 once the server is up

Rotation follows the cursor's offset from the image centre, but only while a
mouse button is held (a browser cursor is always somewhere).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

from ray_marching_tpu_torch.control import (
    ControlConfig,
    InputSnapshot,
    SessionState,
)
from ray_marching_tpu_torch.io.httpserver import CountingHandler, new_stats
from ray_marching_tpu_torch.io.image import encode_png, write_png

log = logging.getLogger("ray_marching_tpu_torch.web")

# Keys the browser may hold down: the motion keys and the session keys (i/o
# degree, m/n steps, p save, q quit).
ALLOWED_KEYS = frozenset("adexwsr" "iomnpq")


class BrowserInput:
    """Input source fed by HTTP POSTs; single-writer snapshot handoff.

    Handler threads write the latest browser state under a lock;
    :meth:`poll` (the render loop's thread) snapshots it. Scroll deltas
    accumulate between polls. ``max_fps`` throttles the loop. After
    ``pause_after`` seconds without client contact the loop pauses (no
    device work) and resumes on the next input or frame fetch;
    ``idle_timeout`` ends the session after that many contact-free seconds
    (None: a paused session lives on).
    """

    def __init__(self, max_fps: float = 30.0,
                 idle_timeout: float | None = None,
                 pause_after: float = 5.0):
        self._lock = threading.Lock()
        self._mouse_ndc = (0.0, 0.0)
        self._pressed: set[str] = set()
        self._scroll = 0
        self._quit = False
        self._save = False
        self._last_contact = time.monotonic()
        self._first_contact = threading.Event()
        self._contact = threading.Event()  # set on every client touch
        self._min_dt = 1.0 / max_fps if max_fps else 0.0
        self._idle_timeout = idle_timeout
        self._pause_after = pause_after
        self._last_poll = 0.0
        self._stop = False  # server shutdown overrides everything

    def update(self, data: dict) -> None:
        """Fold one browser POST into the pending state."""
        with self._lock:
            ndc = data.get("mouse_ndc")
            if ndc is not None:
                x, y = float(ndc[0]), float(ndc[1])
                self._mouse_ndc = (max(-1.0, min(1.0, x)),
                                   max(-1.0, min(1.0, y)))
            pressed = data.get("pressed")
            if pressed is not None:
                self._pressed = {k for k in pressed if k in ALLOWED_KEYS}
            self._scroll += int(data.get("scroll", 0))
            if data.get("save"):
                self._save = True
            if data.get("quit") or "q" in self._pressed:
                self._quit = True
            self._last_contact = time.monotonic()
        self._first_contact.set()
        self._contact.set()

    def touch(self) -> None:
        """Record client contact without input (frame fetches count)."""
        self._last_contact = time.monotonic()
        self._first_contact.set()
        self._contact.set()

    def stop(self) -> None:
        self._stop = True
        self._first_contact.set()
        self._contact.set()

    def paused(self) -> bool:
        """Whether the loop would pause now for want of contact."""
        idle = time.monotonic() - self._last_contact
        return (not self._stop and not self._quit
                and idle > self._pause_after
                and (self._idle_timeout is None or idle < self._idle_timeout))

    def poll(self) -> InputSnapshot:
        # No device work before a client has connected...
        while not self._first_contact.is_set() and not self._stop:
            self._first_contact.wait(0.1)
        # ...or after the last one went away, until fresh contact (or the
        # idle_timeout below ends the session).
        while self.paused():
            self._contact.clear()
            self._contact.wait(0.5)
        if self._stop:
            return InputSnapshot(quit=True)
        wait = self._min_dt - (time.monotonic() - self._last_poll)
        if wait > 0:
            time.sleep(wait)
        self._last_poll = time.monotonic()
        with self._lock:
            scroll, self._scroll = self._scroll, 0
            save, self._save = self._save, False
            quit_ = self._quit or (
                self._idle_timeout is not None
                and time.monotonic() - self._last_contact
                > self._idle_timeout)
            return InputSnapshot(mouse_ndc=self._mouse_ndc,
                                 pressed=frozenset(self._pressed),
                                 scroll=scroll, quit=quit_, save_frame=save)

    def close(self):
        pass


class FrameBuffer:
    """Viewer sink holding the latest frame as PNG, with long-poll wakeups.

    Each frame (already quantized on the device) is encoded once and
    published under an increasing ``seq``; a browser long-polls
    ``?after=seq`` and always gets the newest frame, never a backlog.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self.seq = 0
        self.png: bytes | None = None
        self.frames_rendered = 0

    def __call__(self, frame_idx, image, session):
        from ray_marching_tpu_torch.viewer import _display_frame

        # zlib level 1: a live frame is drawn once.
        png = encode_png(_display_frame(image), level=1)
        with self._cond:
            self.seq += 1
            self.png = png
            self.frames_rendered = frame_idx + 1
            self._cond.notify_all()

    def wait(self, after: int, timeout: float = 10.0):
        """Block until a frame newer than ``after`` exists (or timeout);
        returns ``(seq, png)``, png None on a timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self.seq <= after:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break
            if self.seq <= after:
                return self.seq, None
            return self.seq, self.png

    def close(self):
        with self._cond:
            self._cond.notify_all()


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_marching_tpu_torch live</title>
<style>
 html,body{margin:0;height:100%;background:#111;color:#9a9a9a;
   font:12px monospace;overflow:hidden}
 #v{display:block;margin:auto;max-width:100vw;max-height:94vh;
   image-rendering:auto;cursor:crosshair}
 #hud{position:fixed;left:8px;bottom:6px;white-space:pre}
</style></head><body>
<img id="v" draggable="false">
<div id="hud">connecting…</div>
<script>
const img = document.getElementById('v'), hud = document.getElementById('hud');
let seq = 0, pressed = new Set(), scroll = 0, looking = false,
    ndc = [0, 0], quit = false, save = false, fps = 0, lastT = performance.now();
const KEYS = new Set('adexwsrio mnpq'.replace(' ',''));
document.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if (KEYS.has(k)) { pressed.add(k); e.preventDefault(); }
  if (k === 'p') save = true;
  if (k === 'q') quit = true;
});
document.addEventListener('keyup', e => pressed.delete(e.key.toLowerCase()));
img.addEventListener('mousedown', e => { looking = true; e.preventDefault(); });
document.addEventListener('mouseup', () => { looking = false; ndc = [0, 0]; });
img.addEventListener('mousemove', e => {
  if (!looking) return;
  const r = img.getBoundingClientRect();
  ndc = [ (e.clientX - r.left - r.width / 2) / (r.width / 2),
          (e.clientY - r.top - r.height / 2) / (r.height / 2) ];
});
img.addEventListener('wheel', e => {
  scroll += e.deltaY < 0 ? 1 : -1; e.preventDefault();
}, {passive: false});
async function pushInput() {
  const body = {mouse_ndc: looking ? ndc : [0, 0],
                pressed: [...pressed], scroll, quit, save};
  scroll = 0; save = false;
  try { await fetch('/input', {method: 'POST', body: JSON.stringify(body)}); }
  catch (e) {}
  if (!quit) setTimeout(pushInput, 50);
}
async function pullFrames() {
  while (!quit) {
    try {
      const r = await fetch('/frame.png?after=' + seq);
      if (r.status === 200) {
        seq = parseInt(r.headers.get('X-Seq')) || (seq + 1);
        const url = URL.createObjectURL(await r.blob());
        img.onload = () => URL.revokeObjectURL(url);
        img.src = url;
        const t = performance.now(); fps = 1000 / (t - lastT); lastT = t;
        const s = await (await fetch('/state')).json();
        hud.textContent = `mode ${s.mode}  degree ${s.degree}  steps ` +
          `${s.marching_steps}  ${fps.toFixed(1)} fps  drag=look wasd/ex=move ` +
          `r=roll wheel=shader i/o=degree m/n=steps p=save q=quit`;
      }
    } catch (e) { await new Promise(res => setTimeout(res, 500)); }
  }
  hud.textContent = 'session ended';
}
pushInput(); pullFrames();
</script></body></html>"""


class LiveViewer:
    """One interactive browser session: an HTTP server and the
    :func:`run_viewer` loop.

    ``start()`` runs the loop on a worker thread (tests, embedding);
    ``run()`` runs it on the calling thread (the CLI). The HTTP side runs on
    daemon threads. One session is one camera; several tabs share it (last
    writer wins).
    """

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8372,
                 *, params=None, modes=None,
                 session: SessionState | None = None,
                 control: ControlConfig = ControlConfig(),
                 max_fps: float = 30.0, idle_timeout: float | None = None,
                 pause_after: float = 5.0,
                 fetch_stride: int = 1, max_frames: int | None = None,
                 save_dir: str | None = None):
        self.renderer = renderer
        self.params = params
        self.modes = modes
        self.session0 = session or SessionState(
            marching_steps=renderer.config.marching_steps)
        self.control = control
        self.fetch_stride = fetch_stride
        self.max_frames = max_frames
        self.save_dir = save_dir
        self.input = BrowserInput(max_fps=max_fps, idle_timeout=idle_timeout,
                                  pause_after=pause_after)
        self.frames = FrameBuffer()
        #: Serializes the device work of the loop and the HTTP threads.
        self.device_lock = threading.Lock()
        self._pose_lock = threading.Lock()
        self._camera = None  # the last frame's pose (tensors on the device)
        self._session_now = self.session0
        self._loop_thread: threading.Thread | None = None
        self._done = threading.Event()
        self.stats = new_stats()
        viewer = self

        class Handler(CountingHandler):
            stats = viewer.stats
            log = globals()["log"]

            def handle_route(self, method):
                url = urlparse(self.path)
                if method == "POST":
                    if url.path != "/input":
                        self._send(404, b"not found", "text/plain")
                        return
                    length = int(self.headers.get("Content-Length", "0"))
                    try:
                        data = json.loads(self.rfile.read(length) or b"{}")
                        if not isinstance(data, dict):
                            raise ValueError("input body must be an object")
                    except ValueError as exc:
                        self.bump("errors_400")
                        self.log.warning("400 %s: %s", self.path, exc)
                        self._send(400, str(exc).encode(), "text/plain")
                        return
                    viewer.input.update(data)
                    self._send(200, b"ok", "text/plain")
                elif url.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif url.path == "/healthz":
                    self._send(200, b"ok", "text/plain")
                elif url.path == "/state":
                    self._send(200, json.dumps(viewer.state()).encode(),
                               "application/json")
                elif url.path == "/frame.png":
                    qs = parse_qs(url.query)
                    try:
                        after = int(qs.get("after", ["0"])[0])
                    except ValueError:
                        self.bump("errors_400")
                        self._send(400, b"after must be an int",
                                   "text/plain")
                        return
                    viewer.input.touch()  # fetches keep the session live
                    seq, png = viewer.frames.wait(after, timeout=10.0)
                    if png is None:
                        self._send(204, b"", "text/plain", seq=seq)
                    else:
                        self._send(200, png, "image/png", seq=seq)
                else:
                    self._send(404, b"not found", "text/plain")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(target=self.httpd.serve_forever,
                                             daemon=True)
        self._http_thread.start()

    # ---- the render loop ----

    def _on_pose(self, frame_idx, camera, session):
        with self._pose_lock:
            self._camera = camera
            self._session_now = session

    def _sink(self, frame_idx, image, session):
        self.frames(frame_idx, image, session)
        if self.save_dir and session.save_frame:
            write_png(Path(self.save_dir) / f"frame_{frame_idx:05d}.png",
                      image)

    def _run_loop(self):
        from ray_marching_tpu_torch.viewer import run_viewer

        try:
            run_viewer(self.renderer, self.input, self._sink,
                       session=self.session0, control=self.control,
                       max_frames=self.max_frames, print_fps=False,
                       fetch_stride=self.fetch_stride, params=self.params,
                       modes=self.modes, pose_callback=self._on_pose,
                       device_lock=self.device_lock)
        finally:
            self._done.set()

    def start(self) -> threading.Thread:
        self._loop_thread = threading.Thread(target=self._run_loop,
                                             daemon=True)
        self._loop_thread.start()
        return self._loop_thread

    def run(self) -> None:
        self._run_loop()

    def state(self) -> dict:
        with self._pose_lock:
            camera, session = self._camera, self._session_now
        if camera is None:
            pose = {"position": [0.0, 0.0, 1.0],
                    "orientation": [1.0, 0.0, 0.0, 0.0]}
        else:
            with self.device_lock:  # a copy from the card is device work
                pose = {"position": camera.position[0].tolist(),
                        "orientation": camera.orientation[0].tolist()}
        return {
            **pose,
            "mode": session.mode,
            "degree": session.degree,
            "marching_steps": session.marching_steps,
            "running": not self._done.is_set(),
            "paused": self.input.paused(),
            "seq": self.frames.seq,
            "frames_rendered": self.frames.frames_rendered,
            "stats": dict(self.stats),
        }

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the render loop ends; True if it did."""
        return self._done.wait(timeout)

    def close(self):
        self.input.stop()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)
        self.httpd.shutdown()
        self.httpd.server_close()
