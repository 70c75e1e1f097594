"""Command-line entry point of the PyTorch port (``render`` only so far).

  python -m ray_marching_tpu_torch.cli render --scene test_scene2 -o out.png
  python -m ray_marching_tpu_torch.cli render --device cpu --width 96 \
      --height 64 --mode normal -o small.png
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ray_marching_tpu_torch.io.image import write_png
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.render.shaders import MODES
from ray_marching_tpu_torch.scene import registry


def _parse_mode(spec):
    """Shader mode from a name ('spin') or an index string ('7')."""
    return MODES.index(spec) if spec in MODES else int(spec)


def _parse_pose(spec):
    """``qw,qx,qy,qz/x,y,z`` → ((1, 4) unit quaternion, (1, 3)) float64."""
    q_str, t_str = spec.split("/")
    q = np.asarray([float(v) for v in q_str.split(",")], np.float64)
    q = q / np.linalg.norm(q)
    t = np.asarray([float(v) for v in t_str.split(",")], np.float64)
    return q[None], t[None]


def cmd_render(args):
    px = args.px_size
    cfg = RenderConfig(
        px_width=args.width,
        px_height=args.height,
        focal_length=px * args.height,
        sensor_width=px * args.width,
        sensor_height=px * args.height,
        marching_steps=args.steps,
        tau=args.tau,
    )
    renderer = FastRenderer(registry.make_scene(args.scene), cfg,
                            dtype=getattr(torch, args.dtype),
                            device=args.device)
    q, t = _parse_pose(args.pose)
    image = renderer.render(renderer.init_params, q, t,
                            mode=_parse_mode(args.mode), degree=args.degree)
    print(f"wrote {write_png(args.out, image)}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray_marching_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render one frame to PNG")
    p.add_argument("--scene", default="test_scene2")
    p.add_argument("--mode", default="lambertian",
                   help=f"shader: one of {', '.join(MODES)} or an index")
    p.add_argument("--degree", type=int, default=2)
    p.add_argument("--width", type=int, default=1440)
    p.add_argument("--height", type=int, default=900)
    p.add_argument("--px-size", type=float, default=3.45e-6)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--tau", type=float, default=0.0,
                   help="early-exit threshold (0 = reference-exact)")
    p.add_argument("--pose", default="0,0,1,0/0,0.2,2.5",
                   help="qw,qx,qy,qz/x,y,z (default looks at the origin)")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("-o", "--out", default="render.png")
    p.set_defaults(fn=cmd_render)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
