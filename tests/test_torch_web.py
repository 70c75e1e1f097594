"""The port's browser viewer (``web.py`` ``LiveViewer``) driven over HTTP
as the page's JavaScript drives it, on the CPU: mouse-look, wasd, scroll,
malformed input, quit, the q key, idle pause and resume and the idle
timeout. The session's final pose is ``control.apply_input`` over the
snapshots the loop consumed, bit for bit, and the JAX package's
``apply_input`` over the same snapshots within 1e-6 (f32: the packages
round the same ops, up to a few ulps of the pose).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ray_marching_tpu import control as jcontrol
from ray_marching_tpu_torch import control as tcontrol
from ray_marching_tpu_torch.render.pipeline import Renderer, RenderConfig
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.web import LiveViewer

PX = 3.45e-6


def _renderer():
    w, h = 48, 32
    cfg = RenderConfig(px_width=w, px_height=h, focal_length=PX * h,
                       sensor_width=PX * w, sensor_height=PX * h,
                       marching_steps=4)
    return Renderer(registry.make_scene("single_sphere"), cfg, device="cpu")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def _post(port, obj, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/input", method="POST",
        data=json.dumps(obj).encode() if body is None else body)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def _state(port):
    return json.loads(_get(port, "/state")[2])


def _next_frame(port, after):
    status, headers, body = _get(port, f"/frame.png?after={after}")
    return status, int(headers.get("X-Seq", "0")), body


def _wait_for(port, cond, timeout=20.0):
    """The /state once ``cond`` holds for it: the loop has consumed the
    input posted before (a frame published after a POST may have been
    polled before it)."""
    deadline = time.time() + timeout
    while True:
        state = _state(port)
        if cond(state) or time.time() > deadline:
            return state
        time.sleep(0.02)


@pytest.fixture()
def viewer():
    v = LiveViewer(_renderer(), port=0, max_fps=200.0)
    consumed = []
    poll = v.input.poll

    def logged():
        snap = poll()
        consumed.append(snap)
        return snap

    v.input.poll = logged
    v.consumed = consumed
    v.start()
    try:
        yield v
    finally:
        v.close()


def test_live_session(viewer):
    port = viewer.port
    status, _, page = _get(port, "/")
    assert status == 200 and b"frame.png" in page and b"/input" in page
    assert _get(port, "/healthz")[0] == 200

    _post(port, {})  # first contact starts the loop
    status, seq, body = _next_frame(port, after=0)
    assert status == 200 and seq >= 1 and body[:8] == b"\x89PNG\r\n\x1a\n"

    z0 = _state(port)["position"][2]
    _post(port, {"pressed": ["w"]})
    state = _wait_for(port, lambda s: s["position"][2] > z0 + 1e-4)
    _post(port, {"pressed": []})
    assert state["position"][2] > z0 + 1e-4

    q0 = np.asarray(_state(port)["orientation"])
    _post(port, {"mouse_ndc": [0.5, -0.25]})
    state = _wait_for(port, lambda s: not np.allclose(
        q0, s["orientation"], atol=1e-5))
    _post(port, {"mouse_ndc": [0.0, 0.0]})
    assert not np.allclose(q0, state["orientation"], atol=1e-5)

    mode0 = _state(port)["mode"]
    _post(port, {"scroll": 1})
    assert _wait_for(port, lambda s: s["mode"] != mode0)["mode"] == mode0 + 1
    _, seq, _ = _next_frame(port, after=seq)

    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, None, body=b"not json")
    assert exc.value.code == 400
    assert _state(port)["stats"]["errors_400"] == 1

    _post(port, {"quit": True})
    assert viewer.wait(timeout=30.0)
    state = _state(port)
    assert state["running"] is False and state["frames_rendered"] >= 5

    # The pose is apply_input over what the loop consumed, bit for bit, and
    # the JAX package's within f32 rounding.
    applied = [s for s in viewer.consumed if not s.quit]
    assert len(applied) == len(viewer.consumed) - 1
    cam = tcontrol.CameraState.initial(device="cpu")
    jcam = jcontrol.CameraState.initial()
    for snap in applied:
        cam = tcontrol.apply_input(cam, snap)
        jcam = jcontrol.apply_input(jcam, jcontrol.InputSnapshot(
            mouse_ndc=snap.mouse_ndc, pressed=snap.pressed,
            scroll=snap.scroll, quit=snap.quit, save_frame=snap.save_frame))
    assert state["position"] == cam.position[0].tolist()
    assert state["orientation"] == cam.orientation[0].tolist()
    np.testing.assert_allclose(state["position"],
                               np.asarray(jcam.position, np.float64)[0],
                               atol=1e-6)
    np.testing.assert_allclose(state["orientation"],
                               np.asarray(jcam.orientation, np.float64)[0],
                               atol=1e-6)


def test_q_key_quits(viewer):
    _post(viewer.port, {"pressed": ["q"]})
    assert viewer.wait(timeout=30.0)
    assert viewer.consumed[-1].quit


def test_frame_buffer_and_save_dir(tmp_path):
    v = LiveViewer(_renderer(), port=0, max_fps=200.0, save_dir=tmp_path)
    v.start()
    try:
        _post(v.port, {"save": True})
        status, seq, _ = _next_frame(v.port, after=0)
        assert status == 200
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(v.port, "/frame.png?after=x")
        assert exc.value.code == 400
        _post(v.port, {"quit": True})
        assert v.wait(timeout=30.0)
    finally:
        v.close()
    assert [p.name for p in tmp_path.iterdir()] == ["frame_00000.png"]


def test_idle_timeout_ends_the_session():
    v = LiveViewer(_renderer(), port=0, max_fps=200.0, idle_timeout=0.2)
    v.start()
    try:
        _post(v.port, {})  # connect, then go silent
        assert v.wait(timeout=30.0)
    finally:
        v.close()


def test_idle_pause_and_resume():
    v = LiveViewer(_renderer(), port=0, max_fps=200.0, pause_after=0.3)
    v.start()
    try:
        _post(v.port, {})
        _next_frame(v.port, after=0)
        time.sleep(1.0)  # silent past pause_after
        n1 = _state(v.port)["frames_rendered"]  # /state is no contact
        assert _state(v.port)["paused"]
        time.sleep(0.7)
        n2 = _state(v.port)["frames_rendered"]
        assert n2 <= n1 + 1  # paused: no frames while unattended
        status, _, _ = _next_frame(v.port, after=n2)  # a fetch is contact
        assert status in (200, 204)
        deadline = time.time() + 5.0
        while (time.time() < deadline
               and _state(v.port)["frames_rendered"] <= n2 + 1):
            time.sleep(0.05)
        assert _state(v.port)["frames_rendered"] > n2 + 1  # resumed
        _post(v.port, {"quit": True})
        assert v.wait(timeout=30.0)
    finally:
        v.close()
