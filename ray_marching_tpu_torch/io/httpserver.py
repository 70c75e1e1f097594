"""Shared scaffolding of the package's stdlib HTTP servers (counterpart of
``ray_marching_tpu/io/httpserver.py``).

The artifact server (``serve.py``) and the browser viewer (``web.py``) share
quiet request logging, a Content-Length-correct ``_send``, request and error
counters safe under ``ThreadingHTTPServer``'s per-request threads, and the
split between a client that vanished mid-response (not a 500) and a server
error. Subclasses implement ``handle_route(method)``.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler


def new_stats() -> dict:
    """Fresh counters (monotonic; read through a server's /stats or
    /state)."""
    return {"requests": 0, "errors_400": 0, "errors_500": 0,
            "client_drops": 0}


class CountingHandler(BaseHTTPRequestHandler):
    """Route-dispatching handler with locked counters and the error split.

    Subclasses set the class attributes ``stats`` (a :func:`new_stats`
    dict) and ``log`` (a logger), implement :meth:`handle_route`, and count
    their own 400s with :meth:`bump`.
    """

    stats: dict = None
    log = logging.getLogger("ray_marching_tpu_torch.http")
    _stats_lock = threading.Lock()

    def log_message(self, fmt, *args):  # quiet
        pass

    def bump(self, key: str) -> None:
        with self._stats_lock:  # += on a dict entry is not atomic
            self.stats[key] += 1

    def _send(self, code, body: bytes, ctype: str, seq=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        if seq is not None:
            self.send_header("X-Seq", str(seq))
        self.end_headers()
        self.wfile.write(body)

    def handle_route(self, method: str) -> None:
        raise NotImplementedError

    def _dispatch(self, method: str) -> None:
        self.bump("requests")
        try:
            self.handle_route(method)
        except OSError as exc:
            # The client went away mid-response: nothing left to write.
            self.bump("client_drops")
            self.log.info("client dropped %s: %s", self.path, exc)
        except Exception as exc:  # a device or handler failure: ours
            self.bump("errors_500")
            self.log.exception("500 %s", self.path)
            try:
                self._send(500, str(exc).encode(), "text/plain")
            except OSError:
                self.bump("client_drops")

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")
