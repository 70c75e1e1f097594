"""The port's render artifacts (``io/export.py``) and artifact server
(``serve.py``) on the CPU, held against the JAX package's.

An artifact round trip renders the exporting renderer's frame bit for bit;
its parameters stay an input. The port's ``RenderServer`` on a port
artifact and the JAX ``RenderServer`` on a JAX artifact of the same scene
(modular renderers, f64, 32x24, 8 steps) answer the same poses with PNGs
whose decoded frames are at most 1 count apart on at most 0.1 % of the
values (a quantization tie can round either way on an ulp). Each port reply
is ``encode_png`` of the frame its renderer returns, byte for byte.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu.io.export import export_render as jexport_render
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu.serve import RenderServer as JaxRenderServer
from ray_marching_tpu_torch.cli import _read_png
from ray_marching_tpu_torch.io.checkpoint import save_pytree
from ray_marching_tpu_torch.io.export import export_render, load_render
from ray_marching_tpu_torch.io.image import encode_png
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import Renderer, RenderConfig
from ray_marching_tpu_torch.scene import registry as treg
from ray_marching_tpu_torch.scene.serialize import load_scene
from ray_marching_tpu_torch.serve import RenderServer, _parse_pose

REPO = Path(__file__).resolve().parent.parent
PX = 3.45e-6
W, H = 32, 24
POSES = ("0,0,1,0/0,0.2,2.5", "0.1,0,1,0.05/0.1,0.2,2.4")


def _kw(w=W, h=H, steps=8):
    return dict(px_width=w, px_height=h, focal_length=PX * h,
                sensor_width=PX * w, sensor_height=PX * h,
                marching_steps=steps)


@pytest.fixture(scope="module")
def fast():
    return FastRenderer(treg.make_scene("test_scene2"), RenderConfig(**_kw()),
                        dtype=torch.float32, device="cpu")


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def test_export_round_trip_bitwise(fast, tmp_path):
    path = export_render(fast, tmp_path / "m.rmx", mode=4, degree=2)
    fn, params, meta = load_render(path, device="cpu")
    q, t = fast.default_pose()
    with torch.no_grad():
        got = fn(params, q, t)
        want = fast.render(fast.init_params, q, t, mode=4, degree=2)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    jmeta = {"format_version", "mode", "degree", "marching_steps",
             "platforms", "num_cameras", "px_width", "px_height", "dtype"}
    assert jmeta <= set(meta) and meta["platforms"] == ["cuda"]
    assert (meta["renderer"], meta["mode"], meta["dtype"]) == ("fast", 4,
                                                               "float32")
    assert meta["config"]["px_width"] == W
    assert fn.renderer.march_impl == fast.march_impl


def test_export_params_stay_inputs(fast, tmp_path):
    path = export_render(fast, tmp_path / "m.rmx", mode=0)
    fn, params, _ = load_render(path, device="cpu")
    q, t = fast.default_pose()
    with torch.no_grad():
        a = fn(params, q, t)
        params["c1"]["c0"]["radius"] = torch.tensor(0.9)
        b = fn(params, q, t)
    assert not torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_params_npz_layout_is_the_jax_one(tmp_path):
    """leaf_i in both packages' order, for the same scene and values."""
    import io
    import zipfile

    jr = JaxRenderer(jreg.make_scene("test_scene2"), JaxRenderConfig(**_kw()),
                     dtype=jnp.float32)
    tr = Renderer(treg.make_scene("test_scene2"), RenderConfig(**_kw()),
                  device="cpu")
    leaves = {}
    for name, path in (("j", jexport_render(jr, tmp_path / "j.rmx")),
                       ("t", export_render(tr, tmp_path / "t.rmx"))):
        with zipfile.ZipFile(path) as zf, np.load(io.BytesIO(
                zf.read("params.npz"))) as z:
            leaves[name] = [z[f"leaf_{i}"] for i in range(len(z.files))]
    assert len(leaves["t"]) == len(leaves["j"])
    for a, b in zip(leaves["t"], leaves["j"]):
        np.testing.assert_array_equal(a, b)


def test_render_server_against_jax(tmp_path):
    jr = JaxRenderer(jreg.make_scene("test_scene2"), JaxRenderConfig(**_kw()),
                     dtype=jnp.float64, grid_dtype=np.float64)
    tr = Renderer(treg.make_scene("test_scene2"), RenderConfig(**_kw()),
                  dtype=torch.float64, grid_dtype=np.float64, device="cpu")
    jserver = JaxRenderServer(jexport_render(jr, tmp_path / "j.rmx",
                                             mode=0, degree=2), port=0)
    tserver = RenderServer(export_render(tr, tmp_path / "t.rmx", mode=0,
                                         degree=2), port=0, device="cpu")
    jserver.start()
    tserver.start()
    try:
        base = f"http://127.0.0.1:{tserver.port}"
        assert _get(f"{base}/healthz") == b"ok"
        meta = json.loads(_get(f"{base}/meta"))
        assert meta["px_height"] == H and meta["renderer"] == "modular"
        for pose in POSES:
            got = _get(f"{base}/render?pose={pose}")
            want = _get(f"http://127.0.0.1:{jserver.port}/render?pose={pose}")
            q, t = _parse_pose(pose)
            with torch.no_grad():
                frame = tr.render(tr.init_params, q, t, mode=0, degree=2)
            assert got == encode_png(frame[0].numpy())
            a, b = (tmp_path / "a.png"), (tmp_path / "b.png")
            a.write_bytes(got)
            b.write_bytes(want)
            diff = np.abs(np.rint(_read_png(a) * 255) - np.rint(
                _read_png(b) * 255))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        for bad in ("junk", "1,0,0/0,0,0", "1,0,0,0/0,0"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(f"{base}/render?pose={bad}")
            assert exc.value.code == 400, bad
        stats = json.loads(_get(f"{base}/stats"))
        assert stats["errors_400"] == 3 and stats["errors_500"] == 0
    finally:
        jserver.close()
        tserver.close()


def test_server_params_hot_swap(fast, tmp_path):
    """``params_npz`` (a ``cli optimize --save-params`` file) replaces the
    artifact's parameters without a new export."""
    art = export_render(fast, tmp_path / "m.rmx", mode=0, degree=2)
    tree = load_render(art, device="cpu")[1]
    tree["c1"]["c0"]["radius"] = torch.tensor(0.7)
    save_pytree(tmp_path / "p.npz", tree)
    plain = RenderServer(art, port=0, device="cpu")
    hot = RenderServer(art, port=0, params_npz=tmp_path / "p.npz",
                       device="cpu")
    try:
        assert float(hot.params["c1"]["c0"]["radius"]) == pytest.approx(0.7)
        assert hot.render_png(POSES[0]) != plain.render_png(POSES[0])
    finally:
        plain.httpd.server_close()
        hot.httpd.server_close()


def test_neural_scene_file_artifact(tmp_path):
    scene = load_scene(REPO / "docs" / "examples" / "neural_demo.json")
    r = FastRenderer(scene, RenderConfig(**_kw(16, 12, 6)),
                     dtype=torch.float32, device="cpu")
    fn, params, meta = load_render(export_render(r, tmp_path / "n.rmx",
                                                 mode=0, degree=1),
                                   device="cpu")
    q, t = _parse_pose(POSES[0])
    with torch.no_grad():
        got = fn(params, q, t)
        want = r.render(r.init_params, q, t, mode=0, degree=1)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert fn.renderer.program.mlps


def _serve(args):
    """``cli serve`` in a process of its own; returns it and its port."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_marching_tpu_torch.cli", "serve",
         "--device", "cpu", "--port", "0", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    for line in proc.stdout:
        if "http://" in line:
            return proc, int(line.split("http://127.0.0.1:")[1].split("/")[0]
                             .split()[0])
    proc.wait()
    raise AssertionError(f"cli serve ended with {proc.returncode}")


def test_cli_export_and_serve(tmp_path):
    from ray_marching_tpu_torch.cli import main

    small = ["--device", "cpu", "--width", str(W), "--height", str(H),
             "--steps", "8", "--fast"]
    art = tmp_path / "cli.rmx"
    main(["export", *small, "--mode", "normal", "-o", str(art)])
    assert load_render(art, device="cpu")[2]["mode"] == 4
    proc, port = _serve(["--artifact", str(art)])
    try:
        png = _get(f"http://127.0.0.1:{port}/render?pose={POSES[0]}")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    proc, port = _serve(["--interactive", *small[2:]])
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/input", method="POST",
            data=json.dumps({"quit": True}).encode())
        urllib.request.urlopen(req, timeout=30).read()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with pytest.raises(SystemExit, match="--artifact is required"):
        main(["serve", "--device", "cpu"])
