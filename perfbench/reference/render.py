"""Plain PyTorch sphere tracing, the benchmark's reference renderer.

A pinhole camera (sensor at z = 0, focus at ``(0, 0, -focal)``, pixel
centres, unit directions), posed by a unit quaternion and a translation;
a fixed number of sphere-tracing steps ``p += d(p)·dir`` (tau = 0: every
ray takes every step); normals from four SDF samples at tetrahedral offsets
of size ``normals_eps`` through the inverse of their difference matrix;
mode 0 shading ``clamp(-dir·n, 0, 1)`` on three channels. The loss is the
mean squared difference to a target over every pixel and channel, and its
gradient comes from autograd through the whole march.

Rays are processed in blocks so that autograd's saved tensors fit; a
block's loss is summed into a float64 total and its gradients accumulate in
the leaves. Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.sdf import clamp, rotate

_TETRA = np.asarray([[1.0, 0.0, -np.sqrt(0.5)], [-1.0, 0.0, -np.sqrt(0.5)],
                     [0.0, 1.0, np.sqrt(0.5)], [0.0, -1.0, np.sqrt(0.5)]])


def pixel_rays(width, height, pixel_size):
    """Sensor positions and unit directions of every pixel centre, each
    (H·W, 3) float32 numpy, rows top to bottom."""
    f32 = np.float32
    xs = (2.0 * np.arange(width, dtype=f32) + 1.0) / width - 1.0
    ys = (2.0 * np.arange(height, dtype=f32) + 1.0) / height - 1.0
    px = np.asarray(pixel_size * width / 2.0, f32) * xs
    py = np.asarray(-pixel_size * height / 2.0, f32) * ys
    pos = np.zeros((height, width, 3), f32)
    pos[:, :, 0] = px[None, :]
    pos[:, :, 1] = py[:, None]
    rel = pos - np.asarray([0.0, 0.0, -pixel_size * height], f32)
    dirs = rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    return pos.reshape(-1, 3), dirs.reshape(-1, 3)


def normal_constants(normals_eps):
    """Tetrahedral offsets (4, 3) and the inverse of their difference
    matrix (3, 3), float32 numpy (the inverse taken in float64)."""
    unit = _TETRA / np.linalg.norm(_TETRA, axis=-1, keepdims=True)
    off = (unit * normals_eps).astype(np.float32)
    inv = np.linalg.inv((off[1:] - off[:1]).astype(np.float64))
    return off, inv.astype(np.float32)


class Camera:
    """One view's world rays from a pose, on ``device`` in ``dtype``."""

    def __init__(self, render_cfg, dtype, device):
        pos, dirs = pixel_rays(render_cfg["width"], render_cfg["height"],
                               render_cfg["pixel_size"])
        self.pos = torch.as_tensor(pos.T.copy()).to(device=device, dtype=dtype)
        self.dirs = torch.as_tensor(dirs.T.copy()).to(device=device,
                                                      dtype=dtype)
        self.dtype, self.device = dtype, device

    def world(self, q, t, lo, hi):
        """Origins and directions of pixels ``lo:hi`` posed by ``q`` (4,),
        ``t`` (3,)."""
        q = [v for v in torch.as_tensor(q).to(self.device, self.dtype)]
        t = torch.as_tensor(t).to(self.device, self.dtype)
        ox, oy, oz = rotate(q, *self.pos[:, lo:hi])
        origin = (ox + t[0], oy + t[1], oz + t[2])
        return origin, rotate(q, *self.dirs[:, lo:hi])


def shade_block(sdf, params, origin, dirs, steps, off, inv):
    """Mode 0 intensity of each ray: march ``steps`` steps, normals by
    tetrahedral differences at the end point, ``clamp(-dir·n, 0, 1)``."""
    x, y, z = origin
    dx, dy, dz = dirs
    for _ in range(steps):
        d = sdf(params, x, y, z)
        x, y, z = x + d * dx, y + d * dy, z + d * dz
    f = [sdf(params, x + o[0], y + o[1], z + o[2]) for o in off]
    dd = [f[1] - f[0], f[2] - f[0], f[3] - f[0]]
    n = [inv[r][0] * dd[0] + inv[r][1] * dd[1] + inv[r][2] * dd[2]
         for r in range(3)]
    norm = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    lam = -(dx * (n[0] / norm) + dy * (n[1] / norm) + dz * (n[2] / norm))
    return clamp(lam, 0.0, 1.0)


class Reference:
    """The reference renderer of one configuration on one device.

    ``render(params, poses)`` gives the (N, H, W, 3) frames without a
    gradient; ``loss_and_grad(params, poses, target)`` the mean squared
    difference to ``target`` and, per leaf, its gradient."""

    def __init__(self, sdf, render_cfg, dtype=torch.float32, device="cpu",
                 block=1 << 20):
        self.sdf, self.cfg = sdf, render_cfg
        self.dtype, self.device, self.block = dtype, device, block
        self.camera = Camera(render_cfg, dtype, device)
        off, inv = normal_constants(render_cfg["normals_eps"])
        self.off = [[float(v) for v in row] for row in off]
        self.inv = [[float(v) for v in row] for row in inv]
        self.npix = render_cfg["width"] * render_cfg["height"]

    def _blocks(self):
        for lo in range(0, self.npix, self.block):
            yield lo, min(lo + self.block, self.npix)

    def _shade(self, params, q, t, lo, hi):
        origin, dirs = self.camera.world(q, t, lo, hi)
        return shade_block(self.sdf, params, origin, dirs,
                           self.cfg["marching_steps"], self.off, self.inv)

    def render(self, params, poses):
        h, w = self.cfg["height"], self.cfg["width"]
        frames = []
        with torch.no_grad():
            for q, t in poses:
                v = torch.cat([self._shade(params, q, t, lo, hi)
                               for lo, hi in self._blocks()])
                frames.append(v.reshape(h, w, 1).expand(h, w, 3))
        return torch.stack(frames)

    def loss_and_grad(self, params, poses, target):
        """``(loss, grads)``: ``target`` is (N, H, W, 3); ``grads`` maps
        each leaf of ``params`` to its gradient (zeros where none)."""
        live = {k: v.detach().clone().requires_grad_(True)
                for k, v in params.items()}
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = float(len(poses) * self.npix * 3)
        for n, (q, t) in enumerate(poses):
            tgt = target[n].reshape(-1, 3).to(self.device, self.dtype)
            for lo, hi in self._blocks():
                v = self._shade(live, q, t, lo, hi)
                err = v[:, None] - tgt[lo:hi]
                part = torch.sum(err * err)
                (part / count).backward()
                total += part.detach().to(torch.float64)
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in live.items()}
        return float(total / count), grads
