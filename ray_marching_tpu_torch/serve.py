"""Render server over an exported ``.rmx`` artifact (counterpart of
``ray_marching_tpu/serve.py``).

A stdlib HTTP front end for artifacts written by
:func:`ray_marching_tpu_torch.io.export.export_render`. The server process
needs no scene code: it rebuilds the renderer from the artifact, renders one
warm-up frame (which builds or loads the scene's kernels), and answers pose
queries with PNG frames.

    GET /meta                            -> artifact metadata (JSON)
    GET /render?pose=qw,qx,qy,qz/x,y,z   -> image/png
    GET /stats                           -> request and error counters
    GET /healthz                         -> 200 once warmed up

Each frame is averaged over the cameras and quantized on the device
(:func:`ray_marching_tpu_torch.viewer.quantize`, the arithmetic of
``encode_png``'s float path), so a reply is ``encode_png`` of the frame the
renderer returns, byte for byte, and the copy to the host is a quarter of
the float frame.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ray_marching_tpu_torch.io.checkpoint import load_pytree
from ray_marching_tpu_torch.io.export import load_render
from ray_marching_tpu_torch.io.httpserver import CountingHandler, new_stats
from ray_marching_tpu_torch.io.image import encode_png

log = logging.getLogger("ray_marching_tpu_torch.serve")


def _parse_pose(spec: str):
    """``qw,qx,qy,qz/x,y,z`` → ((1, 4) unit quaternion, (1, 3)) float64;
    ``ValueError`` for a malformed string (the caller's fault: a 400)."""
    q_str, t_str = spec.split("/")
    q = np.asarray([float(v) for v in q_str.split(",")], np.float64)
    t = np.asarray([float(v) for v in t_str.split(",")], np.float64)
    if q.shape != (4,) or t.shape != (3,):
        raise ValueError(
            f"pose must be 'qw,qx,qy,qz/x,y,z' (got {q.shape[0]} quaternion "
            f"and {t.shape[0]} translation components)")
    return (q / np.linalg.norm(q))[None], t[None]


class RenderServer:
    """Load an artifact, warm it up, and serve frames.

    ``handle_request()`` (one request) and ``serve_forever()`` mirror
    ``http.server``; ``start()`` serves on a daemon thread and returns.
    ``params_npz``: scene parameters (``cli optimize --save-params``) that
    replace the artifact's. ``device``: where the renderer runs (``"cpu"``:
    the kernels' plain versions). Device work is serialized by
    :attr:`device_lock` (the kernel wrappers' launch counters are module
    globals).
    """

    def __init__(self, artifact, host: str = "127.0.0.1", port: int = 8371,
                 params_npz=None, device="cuda"):
        self.render_fn, self.params, self.meta = load_render(artifact, device)
        self.device = self.render_fn.renderer.device
        if params_npz is not None:
            self.params = load_pytree(params_npz, self.params)
        self.device_lock = threading.Lock()
        self.render_png("1,0,0,0/0,0,0")  # warm-up: builds the kernels
        self.stats = new_stats()
        server = self

        class Handler(CountingHandler):
            stats = server.stats
            log = globals()["log"]

            def handle_route(self, method):
                url = urlparse(self.path)
                if method != "GET":
                    self._send(404, b"not found", "text/plain")
                elif url.path == "/healthz":
                    self._send(200, b"ok", "text/plain")
                elif url.path == "/meta":
                    self._send(200, json.dumps(server.meta).encode(),
                               "application/json")
                elif url.path == "/stats":
                    self._send(200, json.dumps(server.stats).encode(),
                               "application/json")
                elif url.path == "/render":
                    qs = parse_qs(url.query)
                    pose = qs.get("pose", ["1,0,0,0/0,0,0"])[0]
                    try:
                        q, t = _parse_pose(pose)
                    except (ValueError, IndexError) as exc:
                        self.bump("errors_400")
                        self.log.warning("400 %s: %s", self.path, exc)
                        self._send(400, str(exc).encode(), "text/plain")
                        return
                    self._send(200, server.render_png_arrays(q, t),
                               "image/png")
                else:
                    self._send(404, b"not found", "text/plain")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def render_png(self, pose: str) -> bytes:
        return self.render_png_arrays(*_parse_pose(pose))

    def render_png_arrays(self, q, t) -> bytes:
        """The PNG of the frame at pose (q, t) ((1, 4), (1, 3); repeated
        for every camera of the artifact)."""
        from ray_marching_tpu_torch.viewer import quantize

        n = self.meta["num_cameras"]
        q, t = np.repeat(np.asarray(q), n, 0), np.repeat(np.asarray(t), n, 0)
        with self.device_lock, torch.no_grad():
            img = self.render_fn(self.params, q, t)
            img = quantize(img.mean(dim=0, keepdim=True))[0].cpu().numpy()
        return encode_png(img)

    def handle_request(self):
        self.httpd.handle_request()

    def serve_forever(self):
        self.httpd.serve_forever()

    def start(self):
        thread = threading.Thread(target=self.serve_forever, daemon=True)
        thread.start()
        return thread

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
