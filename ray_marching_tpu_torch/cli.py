"""Command-line entry point of the PyTorch port (``render``, ``gallery``,
``optimize``).

``render`` builds the modular ``Renderer`` (``--pallas``: with the CUDA march
kernel), with ``--fast`` the plane-native ``FastRenderer`` and with
``--strip-height`` the ``TiledRenderer``, as the JAX package's CLI does;
``gallery`` writes every shader mode (the 8 and the lighting modes) as one
PNG each; ``optimize`` always runs on the ``FastRenderer``.

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
    if getattr(args, "strip_height", None):
        return TiledRenderer(scene, cfg, strip_height=args.strip_height,
                             dtype=dtype, device=args.device)
    cls = FastRenderer if fast else Renderer
    return cls(scene, cfg, dtype=dtype, device=args.device)


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


def cmd_optimize(args):
    renderer = _build_renderer(args, fast=True)
    q, t = _parse_pose(args.pose)
    # nargs='*' can give an empty list, which would mean "perturb every
    # leaf" to the selftest but "train no leaf" to the mask: None (all
    # trainable) makes the two agree.
    trainable = args.trainable or None
    if args.target != "selftest":
        raise NotImplementedError(
            "a PNG file as target is not ported yet (see ROADMAP.md); use "
            "--target selftest")
    # Built-in demo: the target is rendered from the trainable leaves
    # perturbed by +20 %, then recovered from the unperturbed start.
    with torch.no_grad():
        target = renderer.render(
            _scale_leaves(renderer.init_params, trainable or [], 1.2), q, t,
            mode=args.optimize_mode, degree=args.degree)
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
                   help="'selftest' (a PNG target is not ported yet)")
    p.add_argument("--optimize-mode", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--opt-steps", type=int, default=100)
    p.add_argument("--trainable", nargs="*", default=None)
    p.add_argument("--optimize-pose", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--metrics", default=None)
    p.add_argument("--save-params", default=None)
    p.set_defaults(fn=cmd_optimize)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
