"""Command-line entry point of the PyTorch port (``render``, ``gallery``,
``optimize``, ``interactive``, ``export``, ``serve``, ``profile``).

``render`` builds the modular ``Renderer`` (``--pallas``: with the CUDA march
kernel), with ``--fast`` the plane-native ``FastRenderer`` and with
``--strip-height`` the ``TiledRenderer``, as the JAX package's CLI does;
``gallery`` writes every shader mode (the 8 and the lighting modes) as one
PNG each; ``optimize`` always runs on the ``FastRenderer``. Every command
runs on ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions). The JAX package's ``--compile-cache`` has no counterpart: the
kernels' nvcc build cache (``ops/_build/``) is always on. ``bench`` waits
for the port's benchmark.

  python -m ray_marching_tpu_torch.cli render --scene test_scene2 -o out.png
  python -m ray_marching_tpu_torch.cli render --pallas --bounces 1 -o out.png
  python -m ray_marching_tpu_torch.cli render --fast --device cpu --width 96 \
      --height 64 --mode normal -o small.png
  python -m ray_marching_tpu_torch.cli render --fast \
      --scene-file docs/examples/neural_demo.json -o neural.png
  python -m ray_marching_tpu_torch.cli render --mode shaded --width 7680 \
      --height 4320 --strip-height 512 -o poster.png
  python -m ray_marching_tpu_torch.cli gallery -o gallery_out
  python -m ray_marching_tpu_torch.cli optimize --target selftest \
      --trainable c1/c0/radius --opt-steps 50
  python -m ray_marching_tpu_torch.cli optimize --target target.png \
      --trainable c1/c0/radius --opt-steps 50
  python -m ray_marching_tpu_torch.cli interactive --fast --orbit \
      --frames 100 --apng orbit.png -o frames
  python -m ray_marching_tpu_torch.cli export --fast -o model.rmx
  python -m ray_marching_tpu_torch.cli serve --artifact model.rmx
  python -m ray_marching_tpu_torch.cli serve --interactive --fast
  python -m ray_marching_tpu_torch.cli profile --fast --grad -o trace_dir
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ray_marching_tpu_torch.io.checkpoint import load_pytree, save_pytree
from ray_marching_tpu_torch.io.image import write_png
from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.lighting import EXTRA_MODES
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.render.shaders import MODES
from ray_marching_tpu_torch.render.tiled import TiledRenderer
from ray_marching_tpu_torch.scene import registry
from ray_marching_tpu_torch.scene.serialize import load_scene


def _parse_mode(spec):
    """Shader mode from a name ('spin'), a lighting mode's name ('occlusion',
    'shaded'), or an index string ('7')."""
    if spec in EXTRA_MODES:
        return spec
    return MODES.index(spec) if spec in MODES else int(spec)


def _parse_pose(spec):
    """``qw,qx,qy,qz/x,y,z`` → ((1, 4) unit quaternion, (1, 3)) float64."""
    q_str, t_str = spec.split("/")
    q = np.asarray([float(v) for v in q_str.split(",")], np.float64)
    q = q / np.linalg.norm(q)
    t = np.asarray([float(v) for v in t_str.split(",")], np.float64)
    return q[None], t[None]


def _build_renderer(args, fast):
    px = args.px_size
    cfg = RenderConfig(
        px_width=args.width,
        px_height=args.height,
        focal_length=px * args.height,
        sensor_width=px * args.width,
        sensor_height=px * args.height,
        marching_steps=args.steps,
        normals_eps=args.normals_eps,
        tau=args.tau,
        reflection_bounces=args.bounces,
        use_pallas=args.pallas,
        backward=args.backward,
        cmap_fourier=args.cmap_fourier,
    )
    if args.scene_file:
        if not Path(args.scene_file).exists():
            raise SystemExit(f"error: scene file not found: {args.scene_file}")
        scene = load_scene(args.scene_file)
    else:
        scene = registry.make_scene(args.scene)
    dtype = getattr(torch, args.dtype)
    grid_dtype = getattr(np, args.grid_dtype)
    if getattr(args, "strip_height", None):
        return TiledRenderer(scene, cfg, strip_height=args.strip_height,
                             dtype=dtype, grid_dtype=grid_dtype,
                             device=args.device)
    cls = FastRenderer if fast else Renderer
    return cls(scene, cfg, dtype=dtype, grid_dtype=grid_dtype,
               device=args.device)


def _initial_params(args, renderer):
    """The renderer's initial parameters, or those of ``--params`` (a file
    written by ``--save-params`` of either package)."""
    if not args.params:
        return renderer.init_params
    if not Path(args.params).exists():
        raise SystemExit(f"error: params checkpoint not found: {args.params}")
    return load_pytree(args.params, renderer.init_params)


def cmd_render(args):
    renderer = _build_renderer(args, fast=args.fast)
    q, t = _parse_pose(args.pose)
    with torch.no_grad():
        image = renderer.render(_initial_params(args, renderer), q, t,
                                mode=_parse_mode(args.mode),
                                degree=args.degree)
    print(f"wrote {write_png(args.out, image)}")


def cmd_gallery(args):
    renderer = _build_renderer(args, fast=args.fast)
    q, t = _parse_pose(args.pose)
    with torch.no_grad():
        images = renderer.render_all_modes(
            _initial_params(args, renderer), q, t, degree=args.degree,
            extras=not args.no_extras)
    for name, image in images.items():
        print(f"wrote {write_png(Path(args.out) / f'{name}.png', image)}")


def _scale_leaves(params, wanted, factor, prefix=""):
    """``params`` with every leaf whose path contains one of ``wanted``
    (every leaf when ``wanted`` is empty) multiplied by ``factor``."""
    out = {}
    for key, val in params.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            out[key] = _scale_leaves(val, wanted, factor, path)
        elif not wanted or any(w in path for w in wanted):
            out[key] = val * factor
        else:
            out[key] = val
    return out


def _read_png(path):
    """A PNG as float32 (H, W, 3) in [0, 1] (the JAX package's
    ``cli._read_png``).

    PIL when it is installed (every colour type); otherwise a small reader
    of 8-bit RGB, RGBA, grey and grey+alpha without interlacing, with every
    scanline filter. Grey is repeated into the three channels; alpha is
    dropped."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.uint8)
        return arr.astype(np.float32) / 255.0
    except ImportError:
        pass
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, meta = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                payload)
            if depth != 8 or interlace != 0 or ctype not in (0, 2, 4, 6):
                raise ValueError(f"{path}: unsupported PNG (bit depth "
                                 f"{depth}, colour type {ctype}, interlace "
                                 f"{interlace})")
            meta = (w, h, {0: 1, 2: 3, 4: 2, 6: 4}[ctype])
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    w, h, c = meta
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for row in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if filt == 1:  # Sub: a prefix sum per channel (mod 256)
            line = np.cumsum(line.reshape(w, c), axis=0,
                             dtype=np.uint8).reshape(-1)
        elif filt == 2:  # Up
            line = line + prev
        elif filt == 3:  # Average
            for i in range(stride):
                left = int(line[i - c]) if i >= c else 0
                line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - c]) if i >= c else 0
                b = int(prev[i])
                cc = int(prev[i - c]) if i >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pr = a if pa <= pb and pa <= pc else b if pb <= pc else cc
                line[i] = (int(line[i]) + pr) & 0xFF
        out[row] = line
        prev = line
    img = out.reshape(h, w, c).astype(np.float32) / 255.0
    if c >= 3:
        return img[:, :, :3]
    return np.repeat(img[:, :, :1], 3, axis=-1)  # grey (and alpha dropped)


def cmd_optimize(args):
    renderer = _build_renderer(args, fast=True)
    q, t = _parse_pose(args.pose)
    # nargs='*' can give an empty list, which would mean "perturb every
    # leaf" to the selftest but "train no leaf" to the mask: None (all
    # trainable) makes the two agree.
    trainable = args.trainable or None
    if args.target == "selftest":
        # Built-in demo: the target is rendered from the trainable leaves
        # perturbed by +20 %, then recovered from the unperturbed start.
        with torch.no_grad():
            target = renderer.render(
                _scale_leaves(renderer.init_params, trainable or [], 1.2), q,
                t, mode=args.optimize_mode, degree=args.degree)
    else:
        if not Path(args.target).exists():
            raise SystemExit(f"error: target not found: {args.target}")
        image = _read_png(args.target)
        want = (renderer.config.px_height, renderer.config.px_width)
        if image.shape[:2] != want:
            raise SystemExit(
                f"error: target {args.target} is {image.shape[1]}x"
                f"{image.shape[0]}, the render is {want[1]}x{want[0]} "
                "(--width/--height)")
        target = renderer._tensor(image[None])
    cfg = InverseConfig(
        learning_rate=args.lr,
        steps=args.opt_steps,
        mode=args.optimize_mode,
        degree=args.degree,
        trainable=trainable,
        optimize_pose=args.optimize_pose,
        checkpoint_dir=args.checkpoint_dir,
        metrics_path=args.metrics,
    )
    out = optimize(renderer, target, q, t, cfg,
                   init_params=_initial_params(args, renderer))
    print(f"first loss: {out['losses'][0]:.3e}, final loss: "
          f"{out['losses'][-1]:.3e} after {out['steps_run']} steps")
    if args.save_params:
        print(f"wrote {save_pytree(args.save_params, out['params'])}")


def _mode_cycle(args):
    """The scroll wheel's modes (the 8, and the lighting modes with
    ``--all-modes`` or a lighting ``--mode``) and the index of ``--mode``."""
    mode0 = _parse_mode(args.mode)
    modes = list(range(8))
    if args.all_modes or isinstance(mode0, str):
        modes += list(EXTRA_MODES)
    return modes, modes.index(mode0 if isinstance(mode0, str) else mode0 % 8)


def cmd_interactive(args):
    from ray_marching_tpu_torch.control import SessionState
    from ray_marching_tpu_torch.viewer import (
        APNGSink,
        KittySink,
        MultiSink,
        PNGSink,
        PynputInput,
        TerminalSink,
        orbit_script,
        run_viewer,
    )

    renderer = _build_renderer(args, fast=args.fast)
    if args.orbit:
        source = orbit_script(args.frames)
    else:
        try:
            source = PynputInput()
        except Exception as exc:  # no pynput, or no display server
            print(f"pynput unavailable ({exc}); falling back to --orbit")
            source = orbit_script(args.frames)
    sink = PNGSink(args.out, every=args.save_every)
    if args.apng:
        sink = MultiSink(sink, APNGSink(args.apng, fps=args.apng_fps))
    if args.display == "term":
        sink = MultiSink(TerminalSink(), sink)
    elif args.display == "kitty":
        sink = MultiSink(KittySink(), sink)
    modes, start = _mode_cycle(args)
    _, _, frames = run_viewer(
        renderer, source, sink, max_frames=args.frames,
        params=_initial_params(args, renderer), modes=modes,
        session=SessionState(mode=start, marching_steps=args.steps),
        # A line per frame would break both terminal sinks' repaint.
        print_fps=args.display not in ("term", "kitty"),
        fetch_stride=args.fetch_stride)
    print(f"rendered {frames} frames to {args.out}")


def cmd_export(args):
    from ray_marching_tpu_torch.io.export import export_render

    renderer = _build_renderer(args, fast=args.fast)
    path = export_render(renderer, args.out, mode=_parse_mode(args.mode),
                         degree=args.degree,
                         params=_initial_params(args, renderer))
    print(f"wrote {path}")


def cmd_serve(args):
    if args.interactive:
        from ray_marching_tpu_torch.control import SessionState
        from ray_marching_tpu_torch.web import LiveViewer

        renderer = _build_renderer(args, fast=args.fast)
        modes, start = _mode_cycle(args)
        viewer = LiveViewer(
            renderer, host=args.host, port=args.port,
            params=_initial_params(args, renderer), modes=modes,
            session=SessionState(mode=start, marching_steps=args.steps),
            max_fps=args.max_fps, idle_timeout=args.idle_timeout,
            fetch_stride=args.fetch_stride, save_dir=args.save_dir)
        print(f"live viewer on http://{args.host}:{viewer.port}/ (open in a "
              "browser; q in the page or Ctrl-C here quits)", flush=True)
        try:
            viewer.run()
        except KeyboardInterrupt:
            pass
        finally:
            viewer.close()
        return
    if not args.artifact:
        raise SystemExit("serve: --artifact is required (or pass "
                         "--interactive for the browser live viewer)")
    from ray_marching_tpu_torch.serve import RenderServer

    server = RenderServer(args.artifact, host=args.host, port=args.port,
                          params_npz=args.params, device=args.device)
    print(f"serving {args.artifact} on http://{args.host}:{server.port} "
          "(GET /render?pose=qw,qx,qy,qz/x,y,z)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def cmd_profile(args):
    """A ``torch.profiler`` Chrome trace of ``--frames`` renders (with
    ``--grad``: forward and backward of the frame's mean square against
    zero, w.r.t. the parameters and the pose, the JAX command's loss) in
    ``--out``/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    from ray_marching_tpu_torch.scene.graph import map_params, param_paths

    renderer = _build_renderer(args, fast=args.fast)
    q, t = _parse_pose(args.pose)
    params = _initial_params(args, renderer)
    kw = dict(mode=args.profile_mode, degree=args.degree)

    def frame():
        if not args.grad:
            with torch.no_grad():
                return renderer.render(params, q, t, **kw)
        p = map_params(params, lambda v: renderer._tensor(v).detach()
                       .requires_grad_(True))
        qq, tt = (renderer._tensor(v).requires_grad_(True) for v in (q, t))
        img = renderer.render(p, qq, tt, **kw)
        loss = torch.mean(torch.square(torch.nan_to_num(img, nan=0.0)))
        torch.autograd.grad(loss, [*param_paths(p).values(), qq, tt],
                            allow_unused=True)
        return loss.detach()

    cuda = renderer.device.type == "cuda"
    frame()  # build the kernels outside the trace
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(args.frames):
            out = frame()
        if cuda:
            torch.cuda.synchronize(renderer.device)
    del out
    path = Path(args.out) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    print(f"wrote Chrome trace {path}")


def _add_render_args(p):
    p.add_argument("--scene", default="test_scene2")
    p.add_argument("--scene-file", default=None,
                   help="JSON scene file (overrides --scene; the JAX "
                        "package's format)")
    p.add_argument("--degree", type=int, default=2)
    p.add_argument("--width", type=int, default=1440)
    p.add_argument("--height", type=int, default=900)
    p.add_argument("--px-size", type=float, default=3.45e-6)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--normals-eps", type=float, default=5e-2)
    p.add_argument("--tau", type=float, default=0.0,
                   help="early-exit threshold (0 = reference-exact)")
    p.add_argument("--bounces", type=int, default=0,
                   help="reflection bounces")
    p.add_argument("--pallas", action="store_true",
                   help="march through the hand-written CUDA march kernel "
                        "(the flag keeps the JAX package's name; modular "
                        "renderer only)")
    p.add_argument("--fast", action="store_true",
                   help="plane-native renderer with the fused march + "
                        "normals kernel (render; optimize always uses it)")
    p.add_argument("--backward", default="unroll",
                   choices=["unroll", "implicit"])
    p.add_argument("--pose", default="0,0,1,0/0,0.2,2.5",
                   help="qw,qx,qy,qz/x,y,z (default looks at the origin)")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--grid-dtype", default="float32",
                   choices=["float32", "float64"],
                   help="camera ray-grid construction dtype (float32 "
                        "reproduces the reference's f32 grid quirk, "
                        "camera.py; float64 builds exact pixel centers)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--params", default=None,
                   help="scene parameters saved by --save-params")
    p.add_argument("--cmap-fourier", action="store_true",
                   help="tangent/spin hue from the colourmap's Fourier fit "
                        "instead of the table gather")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray_marching_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render one frame to PNG")
    _add_render_args(p)
    p.add_argument("--mode", default="lambertian",
                   help=f"shader: one of {', '.join(MODES + EXTRA_MODES)} "
                        "or an index")
    p.add_argument("-o", "--out", default="render.png")
    p.add_argument("--strip-height", type=int, default=None, metavar="ROWS",
                   help="render in horizontal strips of this many pixel rows "
                        "(two passes for the normalized modes): frames "
                        "bigger than one device pass")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("gallery", help="render every shader mode (the 8 "
                                       "and occlusion/shaded) to PNGs")
    _add_render_args(p)
    p.add_argument("--no-extras", action="store_true",
                   help="only the 8 geometric modes")
    p.add_argument("-o", "--out", default="gallery_out",
                   help="directory for <mode>.png")
    p.add_argument("--strip-height", type=int, default=None, metavar="ROWS",
                   help="render each mode in horizontal strips")
    p.set_defaults(fn=cmd_gallery)

    p = sub.add_parser("optimize", help="inverse rendering against a target")
    _add_render_args(p)
    p.add_argument("--target", default="selftest",
                   help="a PNG of the configured size, or 'selftest'")
    p.add_argument("--optimize-mode", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--opt-steps", type=int, default=100)
    p.add_argument("--trainable", nargs="*", default=None)
    p.add_argument("--optimize-pose", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--metrics", default=None)
    p.add_argument("--save-params", default=None)
    p.set_defaults(fn=cmd_optimize)

    p = sub.add_parser("interactive", help="interactive or orbit frame loop")
    _add_render_args(p)
    p.add_argument("--mode", default="lambertian",
                   help="initial shader: a name, an index (0..7) or a "
                        "lighting mode (occlusion/shaded)")
    p.add_argument("--all-modes", action="store_true",
                   help="the lighting modes in the scroll-wheel cycle too")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--orbit", action="store_true",
                   help="a scripted orbit instead of mouse and keyboard")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("-o", "--out", default="frames")
    p.add_argument("--display", choices=["none", "term", "kitty"],
                   default="none",
                   help="'term': a live half-block preview in the terminal; "
                        "'kitty': a full-resolution kitty-graphics preview")
    p.add_argument("--fetch-stride", type=int, default=1,
                   help="keep every k-th pixel on the device before the "
                        "copy to the host (saved PNGs are strided too)")
    p.add_argument("--apng", default=None, metavar="PATH",
                   help="also write every frame into one looping animated "
                        "PNG")
    p.add_argument("--apng-fps", type=float, default=30.0)
    p.set_defaults(fn=cmd_interactive)

    p = sub.add_parser("export", help="export a serving artifact (.rmx: "
                                      "scene, config and parameters)")
    _add_render_args(p)
    p.add_argument("--mode", default="lambertian",
                   help="shader name or index (0..7)")
    p.add_argument("-o", "--out", default="model.rmx")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("serve", help="HTTP server: an exported artifact's "
                                     "pose endpoint (--artifact), or the "
                                     "browser live viewer (--interactive)")
    _add_render_args(p)
    p.add_argument("--artifact", default=None,
                   help=".rmx artifact (ignored with --interactive)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8371)
    p.add_argument("--interactive", action="store_true",
                   help="the live browser session (mouse-look, wasd) over "
                        "the renderer the render arguments build")
    p.add_argument("--mode", default="lambertian",
                   help="initial shader for --interactive")
    p.add_argument("--all-modes", action="store_true",
                   help="the lighting modes in the scroll cycle "
                        "(--interactive)")
    p.add_argument("--max-fps", type=float, default=30.0,
                   help="the render loop's throttle (--interactive)")
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="end the --interactive session after this many "
                        "seconds without client contact")
    p.add_argument("--fetch-stride", type=int, default=1,
                   help="device-side pixel subsampling before the copy "
                        "(--interactive)")
    p.add_argument("--save-dir", default=None,
                   help="directory for the p key's frames (--interactive)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("profile", help="write a torch.profiler trace")
    _add_render_args(p)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--grad", action="store_true",
                   help="trace forward and backward of the frame's mean "
                        "square instead of the forward alone")
    p.add_argument("--profile-mode", type=int, default=0,
                   help="shader mode index to profile")
    p.add_argument("-o", "--out", default="trace_out",
                   help="directory for trace.json")
    p.set_defaults(fn=cmd_profile)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
