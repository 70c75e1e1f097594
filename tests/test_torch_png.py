"""The port's PNG side (``io/image.py`` ``encode_png`` / ``write_apng``,
``cli._read_png``, ``cli optimize --target <png>``) against the JAX
package's, on the CPU.

``encode_png`` and ``write_apng`` must give the JAX package's bytes for the
same arrays; ``_read_png`` the JAX reader's arrays (exactly: both divide the
same bytes by 255 in float32), with PIL and with the zlib/numpy reader
alone. ``cli optimize --target`` fits a 32x24 PNG (8 steps, f64) and its
first loss equals the JAX ``optimize``'s on the same target and the JAX
modular renderer's frame within 1e-9 relative (the two renders agree to
f64 rounding).
"""

import json
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu import cli as jcli
from ray_marching_tpu.io import image as jimage
from ray_marching_tpu_torch import cli as tcli
from ray_marching_tpu_torch.io import image as timage
from ray_marching_tpu_torch.io.checkpoint import save_pytree
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import registry as treg

W, H = 32, 24


def _frames(seed, n=1, c=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return [rng.integers(0, 256, (H, W, c), dtype=np.uint8)
                for _ in range(n)]
    out = [rng.uniform(-0.2, 1.2, (H, W, c)).astype(dtype) for _ in range(n)]
    for f in out:
        f[0, :3] = np.nan
    return out


@pytest.mark.parametrize("c,dtype,level", [(1, np.uint8, 6),
                                           (3, np.uint8, 6),
                                           (4, np.uint8, 1),
                                           (3, np.float32, 6),
                                           (3, np.float64, 1)])
def test_encode_png_bytes_equal_jax(c, dtype, level):
    img = _frames(c, c=c, dtype=dtype)[0]
    assert timage.encode_png(img, level) == jimage.encode_png(img, level)


def _chunks(data):
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def test_write_apng_round_trip_and_jax_bytes(tmp_path):
    frames = _frames(5, n=3) + _frames(6, dtype=np.float32)
    got = timage.write_apng(tmp_path / "t.png", frames, fps=12.5).read_bytes()
    want = jimage.write_apng(tmp_path / "j.png", frames,
                             fps=12.5).read_bytes()
    assert got == want
    chunks = _chunks(got)
    tags = [t for t, _ in chunks]
    assert tags[:2] == [b"IHDR", b"acTL"] and tags[-1] == b"IEND"
    assert struct.unpack(">II", chunks[1][1]) == (4, 0)
    assert tags.count(b"fcTL") == 4 and tags.count(b"fdAT") == 3
    seqs = [struct.unpack(">I", p[:4])[0] for t, p in chunks
            if t in (b"fcTL", b"fdAT")]
    assert seqs == list(range(7))
    datas = [p if t == b"IDAT" else p[4:] for t, p in chunks
             if t in (b"IDAT", b"fdAT")]
    for data, frame in zip(datas, frames):
        raw = np.frombuffer(zlib.decompress(data), np.uint8).reshape(
            H, 1 + W * 3)
        assert not raw[:, 0].any()  # filter 0 on every scanline
        np.testing.assert_array_equal(raw[:, 1:].reshape(H, W, 3),
                                      timage._to_uint8(frame))
    with pytest.raises(ValueError):
        timage.write_apng(tmp_path / "e.png", [])
    with pytest.raises(ValueError):
        timage.write_apng(tmp_path / "e.png", [frames[0], frames[0][:-1]])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _png_every_filter(img):
    """``img`` (H, W, c) uint8 as a PNG whose scanlines cycle through the
    five filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * c, np.int64)
    for r in range(h):
        line, f = rows[r], r % 5
        enc = []
        for i in range(w * c):
            a = int(line[i - c]) if i >= c else 0
            b = int(prev[i])
            cc = int(prev[i - c]) if i >= c else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, cc)][f]
            enc.append((int(line[i]) - pred) & 0xFF)
        out += bytes([f]) + bytes(enc)
        prev = line
    return (b"\x89PNG\r\n\x1a\n"
            + timage._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                 0, 0, 0))
            + timage._chunk(b"IDAT", zlib.compress(bytes(out)))
            + timage._chunk(b"IEND", b""))


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "zlib"])
@pytest.mark.parametrize("c", [1, 2, 3, 4],
                         ids=["grey", "grey_alpha", "rgb", "rgba"])
def test_read_png_equals_jax(tmp_path, monkeypatch, c, pil):
    if pil:
        pytest.importorskip("PIL")
    else:  # the reader without PIL, in both packages
        monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.random.default_rng(c).integers(0, 256, (7, 9, c),
                                            dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_every_filter(img))
    got = tcli._read_png(path)
    np.testing.assert_array_equal(got, jcli._read_png(path))
    want = img[..., :3] if c >= 3 else np.repeat(img[..., :1], 3, -1)
    assert got.dtype == np.float32 and got.shape == (7, 9, 3)
    np.testing.assert_array_equal(got, want.astype(np.float32) / 255.0)


def _render_args():
    return ["--device", "cpu", "--width", str(W), "--height", str(H),
            "--steps", "8", "--dtype", "float64", "--fast"]


def test_cli_optimize_png_target(tmp_path, capsys):
    """A PNG rendered from the radius 1.2x is the target: 3 steps lower
    the loss, and the first loss is the JAX package's on the same file."""
    from ray_marching_tpu.optim.inverse import InverseConfig, optimize
    from ray_marching_tpu.render.pipeline import Renderer, RenderConfig
    from ray_marching_tpu.scene import registry as jreg

    init = tgraph.init_params(treg.make_scene("test_scene2"), torch.float64)
    scaled = tcli._scale_leaves(init, ["c1/c0/radius"], 1.2)
    save_pytree(tmp_path / "p.npz", scaled)
    png = tmp_path / "target.png"
    tcli.main(["render", *_render_args(), "--params",
               str(tmp_path / "p.npz"), "-o", str(png)])
    capsys.readouterr()
    metrics = tmp_path / "m.jsonl"
    tcli.main(["optimize", *_render_args(), "--target", str(png),
               "--opt-steps", "3", "--lr", "1e-2", "--trainable",
               "c1/c0/radius", "--metrics", str(metrics)])
    assert "final loss" in capsys.readouterr().out
    losses = [json.loads(v)["loss"]
              for v in metrics.read_text().splitlines()]
    first = losses[0]
    assert len(losses) == 3 and losses[-1] < first

    px = 3.45e-6
    jcfg = RenderConfig(px_width=W, px_height=H, focal_length=px * H,
                        sensor_width=px * W, sensor_height=px * H,
                        marching_steps=8)
    jr = Renderer(jreg.make_scene("test_scene2"), jcfg, dtype=jnp.float64)
    q, t = jcli._parse_pose("0,0,1,0/0,0.2,2.5", jnp.float64)
    target = jnp.asarray(jcli._read_png(png)[None], jnp.float64)
    out = optimize(jr, target, q, t, InverseConfig(
        learning_rate=1e-2, steps=1, mode=0, degree=2,
        trainable=["c1/c0/radius"]))
    assert first == pytest.approx(out["losses"][0], rel=1e-9)


def test_cli_optimize_png_target_wrong_size(tmp_path):
    png = tmp_path / "small.png"
    timage.write_png(png, np.zeros((H - 1, W, 3), np.float32))
    with pytest.raises(SystemExit, match="the render is 32x24"):
        tcli.main(["optimize", *_render_args(), "--target", str(png),
                   "--opt-steps", "1"])
