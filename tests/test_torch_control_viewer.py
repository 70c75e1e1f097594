"""The port's camera control (``control.py``) and frame loop
(``viewer.py``) against the JAX package's, on the CPU.

Pose integration: a scripted sequence of snapshots (mouse, every bound key,
roll, opposing keys) through ``apply_input`` in both packages, f64, each
pose within 1e-12. ``run_viewer``: the uint8 frames of an orbit with mode,
degree and step changes, f64 modular renderers at 32x24: at most 1 count
apart on at most 0.1 % of the values (a quantization tie can round either
way on an ulp), the sessions equal. Sinks: the bytes (files, terminal and
kitty escapes) equal the JAX sinks' for the same frames.
"""

import dataclasses
import io
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_marching_tpu import control as jcontrol
from ray_marching_tpu import viewer as jviewer
from ray_marching_tpu.render.pipeline import Renderer as JaxRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import registry as jreg
from ray_marching_tpu_torch import control as tcontrol
from ray_marching_tpu_torch import viewer as tviewer
from ray_marching_tpu_torch.render.pipeline import Renderer, RenderConfig
from ray_marching_tpu_torch.scene import registry as treg

PX = 3.45e-6
W, H = 32, 24

SCRIPT = [
    dict(mouse_ndc=(0.1, -0.05)),
    dict(pressed=frozenset("w")),
    dict(pressed=frozenset("wd"), mouse_ndc=(-0.2, 0.3)),
    dict(pressed=frozenset("ex")),
    dict(pressed=frozenset("r"), scroll=1),
    dict(pressed=frozenset("asr"), mouse_ndc=(0.4, 0.1)),
    dict(pressed=frozenset("im"), scroll=-2),
    dict(pressed=frozenset("on"), save_frame=True),
    dict(mouse_ndc=(0.02, 0.0)),
]


def _snaps(module):
    return [module.InputSnapshot(**kw) for kw in SCRIPT]


def test_apply_input_matches_jax_f64():
    jcam = jcontrol.CameraState.initial(num_cameras=2, dtype=jnp.float64)
    tcam = tcontrol.CameraState.initial(num_cameras=2, dtype=torch.float64,
                                        device="cpu")
    for js, ts in zip(_snaps(jcontrol), _snaps(tcontrol)):
        assert (tcontrol.input_components(ts, tcontrol.ControlConfig())
                == jcontrol.input_components(js, jcontrol.ControlConfig()))
        jcam = jcontrol.apply_input(jcam, js)
        tcam = tcontrol.apply_input(tcam, ts)
        assert tcam.position.dtype == torch.float64
        np.testing.assert_allclose(tcam.position.numpy(),
                                   np.asarray(jcam.position), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(tcam.orientation.numpy(),
                                   np.asarray(jcam.orientation), rtol=0,
                                   atol=1e-12)
    assert float(tcam.position[0, 2]) != 1.0  # the script moved it


def test_session_state_and_key_bindings_match_jax():
    js, ts = jcontrol.SessionState(), tcontrol.SessionState()
    for jsnap, tsnap in zip(_snaps(jcontrol) + [jcontrol.InputSnapshot(
            pressed=frozenset("oo"), quit=True)], _snaps(tcontrol)
            + [tcontrol.InputSnapshot(pressed=frozenset("oo"), quit=True)]):
        js, ts = js.step(jsnap), ts.step(tsnap)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert not ts.running
    from pathlib import Path

    import ray_marching_tpu_torch

    csv = Path(ray_marching_tpu_torch.__file__).parent / "data" \
        / "key_bindings.csv"
    assert (tcontrol.load_key_bindings(csv) == tcontrol.DEFAULT_KEY_BINDINGS
            == jcontrol.DEFAULT_KEY_BINDINGS)


def _renderers():
    kw = dict(px_width=W, px_height=H, focal_length=PX * H,
              sensor_width=PX * W, sensor_height=PX * H, marching_steps=6)
    return (JaxRenderer(jreg.make_scene("test_scene2"), JaxRenderConfig(**kw),
                        dtype=jnp.float64, grid_dtype=np.float64),
            Renderer(treg.make_scene("test_scene2"), RenderConfig(**kw),
                     dtype=torch.float64, grid_dtype=np.float64,
                     device="cpu"))


def _run(module, renderer, snaps, **kw):
    frames = []

    def sink(idx, image, session):
        frames.append((idx, np.array(image), dataclasses.asdict(session)))

    cam = module.CameraState.initial(dtype=renderer.dtype) if module is \
        jviewer else tcontrol.CameraState.initial(dtype=renderer.dtype,
                                                  device="cpu")
    out = module.run_viewer(renderer, module.ScriptedInput(snaps), sink,
                            camera=cam, print_fps=False, **kw)
    return frames, out


@pytest.mark.parametrize("stride", [1, 2])
def test_run_viewer_frames_match_jax(stride):
    jr, tr = _renderers()
    script = [dict(mouse_ndc=(0.05, 0.0)), dict(scroll=4),
              dict(pressed=frozenset("w"), scroll=1),
              dict(pressed=frozenset("n"))]
    jframes, (jcam, jsess, jn) = _run(
        jviewer, jr, [jcontrol.InputSnapshot(**k) for k in script],
        fetch_stride=stride)
    tframes, (tcam, tsess, tn) = _run(
        tviewer, tr, [tcontrol.InputSnapshot(**k) for k in script],
        fetch_stride=stride)
    assert tn == jn == len(script)
    assert dataclasses.asdict(tsess) == dataclasses.asdict(jsess)
    np.testing.assert_allclose(tcam.position.numpy(),
                               np.asarray(jcam.position), atol=1e-12)
    for (ti, timg, tses), (ji, jimg, jses) in zip(tframes, jframes):
        assert ti == ji and tses == jses
        assert timg.dtype == np.uint8 and timg.shape == jimg.shape
        assert timg.shape == (1, -(-H // stride), -(-W // stride), 3)
        diff = np.abs(timg.astype(int) - jimg.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_sinks_write_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    frame = rng.uniform(-0.1, 1.1, (1, 12, 10, 3)).astype(np.float32)
    frame[0, 0, 0] = np.nan
    q8 = (np.clip(np.nan_to_num(frame), 0, 1) * 255 + 0.5).astype(np.uint8)
    sess_t = tcontrol.SessionState(save_frame=True)
    sess_j = jcontrol.SessionState(save_frame=True)
    for img in (frame, q8):
        for name in ("TerminalSink", "KittySink"):
            outs = []
            for module, sess in ((tviewer, sess_t), (jviewer, sess_j)):
                buf = io.StringIO()
                sink = getattr(module, name)(file=buf)
                sink(0, img, sess)
                sink(1, img, sess)  # the repaint-in-place escapes
                outs.append(buf.getvalue())
            assert outs[0] == outs[1], name
        paths = {}
        for module, sess, d in ((tviewer, sess_t, "t"), (jviewer, sess_j,
                                                         "j")):
            png = module.PNGSink(str(tmp_path / d), every=5)
            apng = module.APNGSink(tmp_path / d / "a.png", fps=10)
            multi = module.MultiSink(png, apng)
            for i in range(3):
                multi(i, img, sess if i == 1 else dataclasses.replace(
                    sess, save_frame=False))
            multi.close()
            paths[d] = sorted(p.name for p in (tmp_path / d).iterdir())
            assert paths[d] == ["a.png", "frame_00000.png",
                                "frame_00001.png"]
        for name in paths["t"]:
            assert ((tmp_path / "t" / name).read_bytes()
                    == (tmp_path / "j" / name).read_bytes()), name


def test_scroll_walks_the_given_modes():
    """``modes=`` (integers and named lighting modes): the scroll wheel walks
    them in order and wraps, each frame the renderer's frame in its mode."""
    _, tr = _renderers()
    modes = (4, "occlusion")
    snaps = [tcontrol.InputSnapshot(scroll=s) for s in (0, 1, 1)]
    frames, _ = _run(tviewer, tr, snaps, modes=modes)
    cam = tcontrol.CameraState.initial(dtype=tr.dtype, device="cpu")
    for (_, got, sess), mode in zip(frames, (4, "occlusion", 4)):
        assert modes[sess["mode"] % 2] == mode
        want = tviewer.quantize(tr.render(
            tr.init_params, cam.orientation, cam.position, mode=mode,
            marching_steps=sess["marching_steps"], degree=sess["degree"]))
        np.testing.assert_array_equal(got, want.numpy())


def test_serial_fetch_and_float_transfer_give_the_pipelined_frames():
    _, tr = _renderers()
    snaps = [tcontrol.InputSnapshot(mouse_ndc=(0.1 * i, 0.0))
             for i in range(3)]
    runs = {}
    for kw in (dict(), dict(pipeline=False),
               dict(transfer="float32", fetch_stride=3)):
        frames, _ = _run(tviewer, tr, snaps, **kw)
        runs[tuple(kw.items())] = [f[1] for f in frames]
    a, b, c = runs.values()
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        assert z.dtype == np.float64 and z.shape == (1, 8, 11, 3)
    with pytest.raises(ValueError, match="transfer"):
        tviewer.run_viewer(tr, tviewer.ScriptedInput([]), lambda *a: None,
                           transfer="float16")


def test_pynput_input_with_a_stubbed_backend(monkeypatch):
    """Both packages' PynputInput, driven by the same listener callbacks
    through a stubbed pynput, give the same snapshots."""
    captured = {"t": {}, "j": {}}

    def fake_module(store):
        class FakeListener:
            def __init__(self, **callbacks):
                store.update(callbacks)

            def start(self):
                pass

            def stop(self):
                pass

        fake = types.ModuleType("pynput")
        fake.mouse = types.SimpleNamespace(Listener=FakeListener)
        fake.keyboard = types.SimpleNamespace(Listener=FakeListener)
        return fake

    srcs = {}
    for key, module in (("t", tviewer), ("j", jviewer)):
        monkeypatch.setitem(sys.modules, "pynput",
                            fake_module(captured[key]))
        srcs[key] = module.PynputInput(screen_size=(200, 100))

    def both(event, *args):
        for key in "tj":
            captured[key][event](*args)

    def polls():
        t, j = srcs["t"].poll(), srcs["j"].poll()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        return t

    assert polls().mouse_ndc == (0.0, 0.0)
    both("on_move", 150, 75)
    both("on_scroll", 0, 0, 0, 1)
    both("on_scroll", 0, 0, 0, -1)
    both("on_scroll", 0, 0, 0, 1)
    key_w = types.SimpleNamespace(char="w")
    both("on_press", key_w)
    snap = polls()
    assert snap.mouse_ndc == (0.5, 0.5) and snap.scroll == 1
    assert snap.pressed == frozenset("w")
    assert polls().scroll == 0
    both("on_release", key_w)
    both("on_press", types.SimpleNamespace(char="p"))
    assert polls().save_frame and not polls().save_frame
    both("on_press", types.SimpleNamespace(char="q"))
    assert polls().quit
    for src in srcs.values():
        src.close()


def test_orbit_script_quits_after_its_frames():
    src = tviewer.orbit_script(2, yaw_per_frame=0.5)
    assert [src.poll().mouse_ndc for _ in range(2)] == [(0.5, 0.0)] * 2
    assert src.poll().quit
