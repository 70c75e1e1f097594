"""Plane-native (structure-of-arrays) fast renderer (counterpart of
``ray_marching_tpu/render/fast.py::FastRenderer``).

Rays stay in coordinate planes of shape ``(rows, 128)`` from ray generation
to shading, with the JAX renderer's row padding, so planes compare one to
one:

  pose planes → fused march + normals kernel
  (:mod:`ray_marching_tpu_torch.ops.render_kernel`, CUDA on the card, its
  plain PyTorch version on the CPU) → componentwise shaders → one reshape
  to ``(N, H, W, 3)``.

``render`` and ``render_with_alpha`` are differentiable in the scene
parameters and the camera pose: the march is a ``torch.autograd.Function``
whose backward is the backward kernel, posing and shading are plain torch.
``RenderConfig.backward="implicit"`` swaps the backward kernel for the
implicit-function-theorem backward (plain torch at the endpoint). Both reach
the matrices of ``NeuralSDF`` leaves. Not ported yet (they raise
``NotImplementedError``): the extra lighting modes (``occlusion``,
``shaded``), ``cmap_fourier``.

``march_impl`` chooses the march as in the JAX package: ``'fused'`` is the
kernel, ``'xla'`` the counterpart of ``ops/xla_render.py``, the kernel's plain
PyTorch version on whatever device the renderer is on, which the caller asks
for by name (differentiable through autograd, which keeps every step's
activations: the JAX package rematerializes them instead).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_marching_tpu_torch import quat
from ray_marching_tpu_torch.camera import _pixel_center_grid
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.ops.render_kernel import (
    _reference_march,
    fused_march_normals,
    fused_march_normals_cov,
    fused_march_normals_ift,
)
from ray_marching_tpu_torch.render import shaders
from ray_marching_tpu_torch.render.pipeline import EXTRA_MODES, RenderConfig
from ray_marching_tpu_torch.render.silhouette import soft_coverage
from ray_marching_tpu_torch.scene.codegen import SdfProgram
from ray_marching_tpu_torch.scene.graph import Node, compile_scene
from ray_marching_tpu_torch.scene.neural import NeuralSDF, resolve_impl
from ray_marching_tpu_torch.utils import clamp, resolve_device, rmax, rmin
from ray_marching_tpu_torch.utils import not_ported as _not_ported

LANES = 128
ROWS_PER_TILE = 256
_GAMMA = 1.0 / 2.33


def _nodes(node):
    yield node
    child = getattr(node, "child", None)
    if child is not None:
        yield from _nodes(child)
    for c in getattr(node, "children", ()):
        yield from _nodes(c)


def _matmul_leaves(node):
    return [n for n in _nodes(node)
            if isinstance(n, NeuralSDF) and resolve_impl(n) == "matmul"]


def scene_has_exact_sine(node) -> bool:
    """True when any matmul-resolving NeuralSDF uses ``activation='sine'``."""
    return any(n.activation == "sine" for n in _matmul_leaves(node))


def scene_contains_matmul_neural(node) -> bool:
    """True when the scene contains a NeuralSDF that resolves to the matmul
    evaluator (the JAX package's ``march_impl='auto'`` predicate)."""
    return bool(_matmul_leaves(node))


def max_matmul_neural_width(node) -> int:
    """Widest hidden layer among the scene's matmul-resolving NeuralSDF
    nodes (0 when there are none)."""
    return max((max(n.hidden, default=0) for n in _matmul_leaves(node)),
               default=0)


def _to_planes(flat: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows, LANES), flat.dtype)
    out.reshape(-1)[: flat.shape[0]] = flat
    return out


class FastRenderer:
    """Fast forward/backward renderer over ``(rows, 128)`` planes.

    Multi-camera batches stack each camera's ray grid along the plane rows;
    the kernel runs once over all cameras, and the global min/max shader
    normalizations span the whole batch.
    """

    def __init__(self, scene: Node, config: RenderConfig, dtype=torch.float32,
                 grid_dtype=np.float32, device="cuda",
                 march_impl: str = "auto"):
        if config.backward not in ("unroll", "implicit"):
            raise ValueError(f"backward must be unroll|implicit, got "
                             f"{config.backward!r}")
        if config.cmap_fourier:
            raise _not_ported("cmap_fourier")
        if march_impl not in ("auto", "fused", "xla"):
            raise ValueError(f"march_impl must be auto|fused|xla, "
                             f"got {march_impl!r}")
        if march_impl == "xla" and config.backward == "implicit":
            raise _not_ported("march_impl='xla' with backward='implicit'")
        # 'auto' takes the kernel for every scene. The JAX package sends
        # narrow matmul scenes to its XLA march by thresholds measured on a
        # TPU v5e (NEURAL_MARCH_FUSED_MIN_WIDTH*), which do not carry over.
        # chip_smoke.py times both marches on the H100: the kernel won at
        # widths 16 and 256 there (PERF.md).
        self.march_impl = "fused" if march_impl == "auto" else march_impl
        self.device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.scene = scene
        self.program = SdfProgram(scene)
        _, self.sdf_c, self.init_params = compile_scene(scene, dtype,
                                                        self.device)
        self.cyclic_cmap = shaders.load_cyclic_cmap(dtype, self.device)

        h, w = config.px_height, config.px_width
        self.num_cameras = config.num_cameras
        self.total = h * w  # rays per camera
        tile = ROWS_PER_TILE if self.total >= ROWS_PER_TILE * LANES else 8
        self.rows_per_cam = -(-self.total // (LANES * tile)) * tile
        self.rows = self.rows_per_cam * self.num_cameras

        positions, directions = _pixel_center_grid(config.camera_config,
                                                   grid_dtype)
        self._pos0, self._dir0 = (
            tuple(self._tensor(_to_planes(a[..., i].reshape(-1),
                                          self.rows_per_cam))
                  for i in range(3))
            for a in (positions, directions)
        )
        valid = np.zeros((self.rows_per_cam * LANES,), np.float32)
        valid[: self.total] = 1.0
        valid = valid.reshape(self.rows_per_cam, LANES)
        self._valid = self._tensor(
            np.concatenate([valid] * self.num_cameras, axis=0))
        self._valid_b = self._valid > 0.5

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- pure pieces -------------------------------------------------------

    def _pose_planes(self, orientation, translation):
        """World-space position/direction planes, cameras stacked row-wise."""
        pos, dirs = [], []
        for n in range(self.num_cameras):
            qw, qx, qy, qz = (orientation[n, i] for i in range(4))
            tx, ty, tz = (translation[n, i] for i in range(3))
            px, py, pz = quat.rotate_c(qw, qx, qy, qz, *self._pos0)
            pos.append((px + tx, py + ty, pz + tz))
            dirs.append(quat.rotate_c(qw, qx, qy, qz, *self._dir0))
        if self.num_cameras == 1:
            return pos[0], dirs[0]
        return (
            tuple(torch.cat([p[i] for p in pos], dim=0) for i in range(3)),
            tuple(torch.cat([d[i] for d in dirs], dim=0) for i in range(3)),
        )

    def _per_camera(self, fn, *plane_groups):
        """Apply fn(cam_idx, *per-camera plane slices) and re-concat rows."""
        if self.num_cameras == 1:
            return fn(0, *plane_groups)
        outs = []
        for n in range(self.num_cameras):
            lo = n * self.rows_per_cam
            hi = lo + self.rows_per_cam
            outs.append(fn(n, *[[p[lo:hi] for p in group]
                                for group in plane_groups]))
        return [torch.cat([o[c] for o in outs], dim=0) for c in range(3)]

    def _masked_min(self, v):
        big = float(np.finfo(np.float32).max)
        return rmin(torch.where(self._valid_b, v, big))

    def _masked_max(self, v):
        big = float(np.finfo(np.float32).max)
        return rmax(torch.where(self._valid_b, v, -big))

    def _log_minmax_norm(self, dists):
        log_d = torch.log(clamp(dists, 1e-2))
        lo = self._masked_min(log_d)
        hi = self._masked_max(log_d)
        return ((log_d - lo) / (hi - lo)) ** _GAMMA

    def _shade(self, mode, degree, orientation, origin, dirs, hit):
        """Componentwise shaders on planes; returns [r, g, b] planes."""
        x, y, z, d, nx, ny, nz, lap = hit
        dx, dy, dz = dirs
        if isinstance(mode, str) and mode in EXTRA_MODES:
            raise _not_ported(f"lighting mode {mode!r}")
        name = mode if isinstance(mode, str) \
            else shaders.MODES[mode % len(shaders.MODES)]
        if name == "lambertian":
            v = clamp(-(dx * nx + dy * ny + dz * nz), 0.0, 1.0)
            return [v, v, v]
        if name == "distance":
            ox, oy, oz = origin
            ex, ey, ez = ox - x, oy - y, oz - z
            dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
            v = self._log_minmax_norm(dist)
            return [v, v, v]
        if name == "proximity":
            v = self._log_minmax_norm(d)
            return [v, v, v]
        if name == "vignette":
            def vignette_cam(n, dirs_n):
                dxn, dyn, dzn = dirs_n
                w_, i_, j_, k_ = (orientation[n, c] for c in range(4))
                ax = 2 * (w_ * j_ + i_ * k_)
                ay = 2 * (j_ * k_ - w_ * i_)
                az = w_ * w_ - i_ * i_ - j_ * j_ + k_ * k_
                s = dxn * ax + dyn * ay + dzn * az
                v = s * s * s
                return [v, v, v]
            return self._per_camera(vignette_cam, [dx, dy, dz])
        if name == "normal":
            return [clamp(torch.abs(c), 0.0, 1.0) for c in (nx, ny, nz)]
        if name == "laplacian":
            hi = self._masked_max(torch.abs(lap))
            v = clamp((1.0 - lap / hi) / 2.0, 0.0, 1.0) ** _GAMMA
            return [v, v, v]
        if name == "tangent":
            def tangent_cam(n, dirs_n, normals_n):
                dxn, dyn, dzn = dirs_n
                nxn, nyn, nzn = normals_n
                qc = [orientation[n, 0], -orientation[n, 1],
                      -orientation[n, 2], -orientation[n, 3]]
                ndotv = nxn * dxn + nyn * dyn + nzn * dzn
                tx_, ty_, tz_ = (
                    nxn - ndotv * dxn, nyn - ndotv * dyn, nzn - ndotv * dzn
                )
                prx, pry, _ = quat.rotate_c(*qc, tx_, ty_, tz_)
                return shaders.domain_colouring(prx, pry, self.cyclic_cmap,
                                                degree)
            return self._per_camera(tangent_cam, [dx, dy, dz], [nx, ny, nz])
        if name != "spin":
            raise ValueError(f"unknown shader mode {mode!r}")

        # spin: q̄·(0, N); the (im, re) pair goes into the (re, im) slots.
        def spin_cam(n, normals_n):
            nxn, nyn, nzn = normals_n
            qc = [orientation[n, 0], -orientation[n, 1],
                  -orientation[n, 2], -orientation[n, 3]]
            zero = torch.zeros_like(nxn)
            a, bx, by, bz = quat.multiply_c(zero, nxn, nyn, nzn, *qc)
            b2 = bx * bx + by * by + bz * bz
            real_part = a * a - b2
            imag_part = torch.sqrt(b2) * a * 2.0
            return shaders.domain_colouring(imag_part, real_part,
                                            self.cyclic_cmap, degree)
        return self._per_camera(spin_cam, [nx, ny, nz])

    # -- public API --------------------------------------------------------

    def _march_planes(self, params, origin, dirs, steps, with_closest=False):
        """Fused march (+ reflection bounces, mirror formula of the JAX
        renderer); returns the 8 hit planes and the final direction planes.
        ``with_closest`` also returns the closest-approach plane ``min_f``
        (primary visibility only: no reflection bounces)."""
        cfg = self.config
        flat, mats, _ = split_params_padded(params, self.dtype, self.device)
        march = fused_march_normals_cov if with_closest else fused_march_normals

        def run(origin, dirs):
            rays7 = torch.stack(list(origin) + list(dirs) + [self._valid], 0)
            if self.march_impl == "xla":
                out = _reference_march(self.program, flat, rays7, steps,
                                       cfg.tau, cfg.normals_eps,
                                       track_min=with_closest, mats=mats)[0]
            elif cfg.backward == "implicit":
                out = fused_march_normals_ift(
                    self.program, flat, rays7, steps, cfg.tau,
                    cfg.normals_eps, cfg.ift_hit_threshold,
                    cfg.ift_denom_eps, track_min=with_closest, mats=mats)
            else:
                out = march(self.program, flat, rays7, steps, cfg.tau,
                            cfg.normals_eps, mats=mats)
            return list(out.unbind(0))

        hit = run(origin, dirs)
        if with_closest:
            if cfg.reflection_bounces:
                raise ValueError("the closest-approach plane excludes "
                                 "reflection bounces")
            return hit[:8], dirs, hit[8]
        dx, dy, dz = dirs
        eps = float(torch.tensor(cfg.normals_eps, dtype=self.dtype))
        for _ in range(cfg.reflection_bounces):
            x, y, z, _, nx, ny, nz, _ = hit
            proj = nx * (-dx) + ny * (-dy) + nz * (-dz)
            dx, dy, dz = (2 * proj * nx + dx, 2 * proj * ny + dy,
                          2 * proj * nz + dz)
            # Escape the |f| ≈ 0 shell before re-marching.
            hit = run((x + dx * eps, y + dy * eps, z + dz * eps), (dx, dy, dz))
        return hit, (dx, dy, dz)

    def _pose(self, orientation, translation):
        return self._tensor(orientation), self._tensor(translation)

    def render(self, params, orientation, translation, *, mode: int = 0,
               degree: int = 1, marching_steps: Optional[int] = None):
        """Render one frame → (N, H, W, 3)."""
        cfg = self.config
        steps = cfg.marching_steps if marching_steps is None else marching_steps
        orientation, translation = self._pose(orientation, translation)
        origin, dirs = self._pose_planes(orientation, translation)
        hit, final_dirs = self._march_planes(params, origin, dirs, steps)
        channels = self._shade(mode, degree, orientation, origin, final_dirs,
                               hit)
        return self._assemble(channels)

    def render_with_alpha(self, params, orientation, translation, *,
                          mode: int = 0, degree: int = 1,
                          marching_steps: Optional[int] = None,
                          beta: Optional[float] = None):
        """Render one frame plus a soft silhouette coverage mask
        ``α = σ(shift − min_f/β)`` (render/silhouette.py); ``min_f`` is the
        kernel's 9th plane and its gradient is routed to the arg-min march
        step inside the backward kernel.

        Returns ``(image (N, H, W, 3), alpha (N, H, W, 1))``."""
        cfg = self.config
        if cfg.reflection_bounces:
            raise ValueError("render_with_alpha: reflection bounces unsupported")
        steps = cfg.marching_steps if marching_steps is None else marching_steps
        beta = cfg.silhouette_beta if beta is None else beta
        orientation, translation = self._pose(orientation, translation)
        origin, dirs = self._pose_planes(orientation, translation)
        hit, final_dirs, minf = self._march_planes(params, origin, dirs, steps,
                                                   with_closest=True)
        channels = self._shade(mode, degree, orientation, origin, final_dirs,
                               hit)
        return (self._assemble(channels),
                self._assemble([soft_coverage(minf, beta)]))

    def _assemble(self, channels):
        h, w = self.config.px_height, self.config.px_width
        frames = []
        for n in range(self.num_cameras):
            lo = n * self.rows_per_cam
            hi = lo + self.rows_per_cam
            frames.append(torch.stack(
                [c[lo:hi].reshape(-1)[: self.total].reshape(h, w)
                 for c in channels],
                dim=-1,
            ))
        return torch.stack(frames, dim=0)

    def image_to_planes(self, image):
        """Inverse of :meth:`_assemble`: (N, H, W, C) image → (C, rows, 128)
        channel planes (pad slots zero)."""
        chans = []
        for c in range(image.shape[-1]):
            blocks = []
            for n in range(self.num_cameras):
                flat = image[n, :, :, c].reshape(-1)
                flat = torch.nn.functional.pad(
                    flat, (0, self.rows_per_cam * LANES - self.total))
                blocks.append(flat.reshape(self.rows_per_cam, LANES))
            chans.append(torch.cat(blocks, dim=0))
        return torch.stack(chans, dim=0)

    def render_all_modes(self, params, orientation, translation, *,
                         degree: int = 1, marching_steps: Optional[int] = None,
                         extras: bool = False):
        """All 8 geometric shader modes from ONE fused march+normals pass."""
        if extras:
            raise _not_ported("render_all_modes(extras=True)")
        cfg = self.config
        steps = cfg.marching_steps if marching_steps is None else marching_steps
        orientation, translation = self._pose(orientation, translation)
        origin, dirs = self._pose_planes(orientation, translation)
        hit, final_dirs = self._march_planes(params, origin, dirs, steps)
        return {
            name: self._assemble(self._shade(mode, degree, orientation, origin,
                                             final_dirs, hit))
            for mode, name in enumerate(shaders.MODES)
        }

    def default_pose(self):
        n = self.num_cameras
        return (
            self._tensor([[1.0, 0.0, 0.0, 0.0]] * n),
            self._tensor([[0.0, 0.0, 1.0]] * n),
        )

