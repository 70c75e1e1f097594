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
the matrices of ``NeuralSDF`` leaves. The named lighting modes (``occlusion``,
``shaded``; :mod:`.lighting`) shade the hit planes with further plain-torch
SDF queries; ``RenderConfig.cmap_fourier`` swaps the colourmap gather of the
tangent and spin modes for its Fourier fit.

``march_impl`` chooses the march as in the JAX package: ``'fused'`` is the
kernel, ``'xla'`` the counterpart of ``ops/xla_render.py``
(:mod:`ray_marching_tpu_torch.ops.xla_render`): the kernel's plain PyTorch
version on whatever device the renderer is on, which the caller asks for by
name, differentiated by autograd with every step rematerialized, or with
``backward="implicit"`` by the kernel route's IFT backward.

The tiled renderer (:mod:`.tiled`) drives one of these per strip through
the hooks :func:`bake_ray_planes`, :func:`pose_plane_group`,
``_march_planes(valid=)``, :meth:`FastRenderer.norm_bounds` and
``_shade(valid_b=, norm_bounds=)``; the sharded paths
(:mod:`ray_marching_tpu_torch.parallel.fast_sharding`) drive one row shard
per rank through the same hooks with ``axis_names`` and ``cameras=1``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import math

import numpy as np
import torch

from ray_marching_tpu_torch import quat
from ray_marching_tpu_torch.camera import _pixel_center_grid
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.ops.render_kernel import (
    fused_march_normals,
    fused_march_normals_cov,
    fused_march_normals_ift,
)
from ray_marching_tpu_torch.ops.xla_render import (
    xla_march_normals,
    xla_march_normals_cov,
    xla_march_normals_cov_ift,
    xla_march_normals_ift,
)
from ray_marching_tpu_torch.render import lighting, shaders
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.render.silhouette import soft_coverage
from ray_marching_tpu_torch.scene.codegen import SdfProgram
from ray_marching_tpu_torch.scene.graph import (
    Node,
    _prune_enabled,
    compile_scene,
)
from ray_marching_tpu_torch.scene.neural import NeuralSDF, resolve_impl
from ray_marching_tpu_torch.spans import (
    RENDER_MARCH,
    RENDER_POSE,
    RENDER_SHADE,
    span,
)
from ray_marching_tpu_torch.utils import (
    clamp,
    prmax,
    prmin,
    resolve_device,
    rmax,
    rmin,
)

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


def bake_ray_planes(positions, directions, rows, dtype, device):
    """Two triples of (H, W) pixel-grid components (numpy arrays or
    tensors) → two triples of (rows, 128) planes in ``dtype`` on ``device``,
    pad slots zero."""
    def plane(c):
        c = torch.as_tensor(c, device=device).reshape(-1).to(dtype)
        out = torch.zeros(rows * LANES, dtype=dtype, device=device)
        out[: c.shape[0]] = c
        return out.reshape(rows, LANES)

    return (tuple(plane(c) for c in positions),
            tuple(plane(c) for c in directions))


def _travel(origin, hit):
    """Each ray's travel distance from its origin to its hit point."""
    ex, ey, ez = (o - h for o, h in zip(origin, hit[:3]))
    return torch.sqrt(ex * ex + ey * ey + ez * ez)


def pose_plane_group(q, t, pos0, dir0):
    """World-pose one camera's baked planes: rotate by the (1, 4) unit
    quaternion row, translate positions by the (1, 3) row. Returns
    ``(origin, dirs)`` triples (the plain and tiled paths share it)."""
    qw, qx, qy, qz = (q[0, i] for i in range(4))
    px, py, pz = quat.rotate_c(qw, qx, qy, qz, *pos0)
    origin = (px + t[0, 0], py + t[0, 1], pz + t[0, 2])
    return origin, quat.rotate_c(qw, qx, qy, qz, *dir0)


class FastRenderer:
    """Fast forward/backward renderer over ``(rows, 128)`` planes.

    Multi-camera batches stack each camera's ray grid along the plane rows;
    the kernel runs once over all cameras, and the global min/max shader
    normalizations span the whole batch.

    ``row_multiple`` makes each camera's row count a multiple of it too (the
    JAX rule: the least common multiple with the tile). The sharded paths
    need ``parallel.fast_sharding.SHARD_ROWS`` (8) × shards per camera: then
    every rank's shard is a whole number of 8-row groups, that is whole
    blocks of every kernel launch on the H100 (the largest block is 256
    threads, two 128-ray rows; a tensor-core launch takes whole rows), so a
    shard's launch runs the same blocks over the same rays as one process's
    launch would, and the planes are laid out as the JAX renderer's with the
    same ``row_multiple``.
    """

    def __init__(self, scene: Node, config: RenderConfig, dtype=torch.float32,
                 grid_dtype=np.float32, device="cuda",
                 march_impl: str = "auto", row_multiple: Optional[int] = None):
        if config.backward not in ("unroll", "implicit"):
            raise ValueError(f"backward must be unroll|implicit, got "
                             f"{config.backward!r}")
        if march_impl not in ("auto", "fused", "xla"):
            raise ValueError(f"march_impl must be auto|fused|xla, "
                             f"got {march_impl!r}")
        # 'auto' takes the kernel for every scene. The JAX package sends
        # narrow matmul scenes to its XLA march by thresholds measured on a
        # TPU v5e (NEURAL_MARCH_FUSED_MIN_WIDTH*), which do not carry over.
        # chip_smoke.py times both marches on the H100: the kernel won at
        # widths 16 and 256 there (PERF.md).
        self.march_impl = "fused" if march_impl == "auto" else march_impl
        self.device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.grid_dtype = np.dtype(grid_dtype)
        self.scene = scene
        # The union short-circuit (RM_TPU_CSG_PRUNE=1, read here as the JAX
        # renderer reads it): the fused route's forward kernels and the
        # backward's marches skip a guarded union child where it cannot be
        # the minimum; same values. The XLA route keeps the plain SDF, and
        # the tiled and sharded renderers inherit this program.
        self.program = SdfProgram(
            scene, prune=_prune_enabled() and self.march_impl == "fused")
        _, self.sdf_c, self.init_params = compile_scene(scene, dtype,
                                                        self.device)
        self.cyclic_cmap = shaders.load_cyclic_cmap(dtype, self.device)
        self.cmap_coeffs = (shaders.fourier_cmap_coeffs()
                            if config.cmap_fourier else None)

        h, w = config.px_height, config.px_width
        self.num_cameras = config.num_cameras
        self.total = h * w  # rays per camera
        tile = ROWS_PER_TILE if self.total >= ROWS_PER_TILE * LANES else 8
        self.row_multiple = row_multiple
        if row_multiple:
            tile = tile * row_multiple // math.gcd(tile, row_multiple)
        self.rows_per_cam = -(-self.total // (LANES * tile)) * tile
        self.rows = self.rows_per_cam * self.num_cameras

        positions, directions = _pixel_center_grid(config.camera_config,
                                                   grid_dtype)
        self._pos0, self._dir0 = bake_ray_planes(
            [positions[..., i] for i in range(3)],
            [directions[..., i] for i in range(3)], self.rows_per_cam, dtype,
            self.device)
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
            o, d = pose_plane_group(orientation[n:n + 1],
                                    translation[n:n + 1], self._pos0,
                                    self._dir0)
            pos.append(o)
            dirs.append(d)
        if self.num_cameras == 1:
            return pos[0], dirs[0]
        return (
            tuple(torch.cat([p[i] for p in pos], dim=0) for i in range(3)),
            tuple(torch.cat([d[i] for d in dirs], dim=0) for i in range(3)),
        )

    def _per_camera(self, fn, *plane_groups, cameras=None):
        """Apply fn(cam_idx, *per-camera plane slices) and re-concat rows.
        ``cameras`` overrides the camera count (a row shard is one camera's
        rows, shaded with that camera's pose row as camera 0)."""
        cameras = self.num_cameras if cameras is None else cameras
        if cameras == 1:
            return fn(0, *plane_groups)
        outs = []
        for n in range(cameras):
            lo = n * self.rows_per_cam
            hi = lo + self.rows_per_cam
            outs.append(fn(n, *[[p[lo:hi] for p in group]
                                for group in plane_groups]))
        return [torch.cat([o[c] for o in outs], dim=0) for c in range(3)]

    def _masked_min(self, v, valid_b=None, axis_names=()):
        """Whole-batch min over the valid slots (``valid_b`` overrides the
        renderer's own mask: a tiled strip's or a row shard's).
        ``axis_names`` (process groups) extends it across the ranks; a
        shard without a valid slot joins with ``big``."""
        valid_b = self._valid_b if valid_b is None else valid_b
        big = float(np.finfo(np.float32).max)
        filled = torch.where(valid_b, v, big)
        return prmin(filled, axis_names) if axis_names else rmin(filled)

    def _masked_max(self, v, valid_b=None, axis_names=()):
        valid_b = self._valid_b if valid_b is None else valid_b
        big = float(np.finfo(np.float32).max)
        filled = torch.where(valid_b, v, -big)
        return prmax(filled, axis_names) if axis_names else rmax(filled)

    def _log_minmax_norm(self, dists, valid_b=None, axis_names=(),
                         bounds=None):
        log_d = torch.log(clamp(dists, 1e-2))
        if bounds is not None:  # precomputed whole-image bounds (tiled)
            lo, hi = bounds
        else:
            lo = self._masked_min(log_d, valid_b, axis_names)
            hi = self._masked_max(log_d, valid_b, axis_names)
        return ((log_d - lo) / (hi - lo)) ** _GAMMA

    def norm_bounds(self, mode, origin, hit, valid_b=None, axis_names=()):
        """``(lo, hi)`` of ``mode``'s whole-image normalization statistic over
        this renderer's valid rays: pass 1 of the tiled renderer's two
        passes, where the whole-image min/max must span every strip before
        any strip can shade. The formulas of the matching :meth:`_shade`
        branches; modes without a normalization give ``(0, 1)``.
        ``axis_names`` extends the reductions across ranks (a sharded
        strip's)."""
        name = mode if isinstance(mode, str) \
            else shaders.MODES[mode % len(shaders.MODES)]
        if name == "distance":
            raw = torch.log(clamp(_travel(origin, hit), 1e-2))
        elif name == "proximity":
            raw = torch.log(clamp(hit[3], 1e-2))
        elif name == "laplacian":
            raw = torch.abs(hit[7])
        else:
            zero = torch.zeros((), dtype=hit[0].dtype, device=hit[0].device)
            return zero, zero + 1.0
        return (self._masked_min(raw, valid_b, axis_names),
                self._masked_max(raw, valid_b, axis_names))

    def _shade(self, mode, degree, orientation, origin, dirs, hit,
               valid_b=None, axis_names=(), cameras=None, norm_bounds=None,
               params=None):
        """Componentwise shaders on planes; returns [r, g, b] planes.

        ``valid_b`` overrides the mask of the whole-batch normalizations,
        ``axis_names`` (process groups) extends them across the ranks that
        hold the other row shards, and ``norm_bounds`` replaces them with
        precomputed whole-image bounds (:meth:`norm_bounds`; the tiled
        renderer's pass 2). ``cameras`` overrides the camera count (a row
        shard is one camera's, with that camera's ``orientation`` row).
        ``params`` is needed by the lighting modes only (they query the SDF
        again)."""
        x, y, z, d, nx, ny, nz, lap = hit
        dx, dy, dz = dirs
        name = mode if isinstance(mode, str) \
            else shaders.MODES[mode % len(shaders.MODES)]
        if name in lighting.EXTRA_MODES:
            if params is None:
                raise ValueError(f"mode {name!r} needs scene params (extra "
                                 "SDF queries)")
            v = lighting.shade_extra(name, self.sdf_c, params, (x, y, z),
                                     (nx, ny, nz), self.config)
            return [v, v, v]
        if name == "lambertian":
            v = clamp(-(dx * nx + dy * ny + dz * nz), 0.0, 1.0)
            return [v, v, v]
        if name == "distance":
            v = self._log_minmax_norm(_travel(origin, hit), valid_b,
                                      axis_names, norm_bounds)
            return [v, v, v]
        if name == "proximity":
            v = self._log_minmax_norm(d, valid_b, axis_names, norm_bounds)
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
            return self._per_camera(vignette_cam, [dx, dy, dz],
                                    cameras=cameras)
        if name == "normal":
            return [clamp(torch.abs(c), 0.0, 1.0) for c in (nx, ny, nz)]
        if name == "laplacian":
            hi = (norm_bounds[1] if norm_bounds is not None
                  else self._masked_max(torch.abs(lap), valid_b, axis_names))
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
                                                degree, self.cmap_coeffs)
            return self._per_camera(tangent_cam, [dx, dy, dz], [nx, ny, nz],
                                    cameras=cameras)
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
                                            self.cyclic_cmap, degree,
                                            self.cmap_coeffs)
        return self._per_camera(spin_cam, [nx, ny, nz], cameras=cameras)

    # -- public API --------------------------------------------------------

    def _march_planes(self, params, origin, dirs, steps, valid=None,
                      with_closest=False):
        """Fused march (+ reflection bounces, mirror formula of the JAX
        renderer); returns the 8 hit planes and the final direction planes.
        ``valid`` overrides the renderer's validity plane (a tiled strip's).
        ``with_closest`` also returns the closest-approach plane ``min_f``
        (primary visibility only: no reflection bounces)."""
        cfg = self.config
        valid = self._valid if valid is None else valid
        flat, mats, _ = split_params_padded(params, self.dtype, self.device)
        if self.march_impl == "xla":
            plain, cov = xla_march_normals, xla_march_normals_cov
            ift, cov_ift = xla_march_normals_ift, xla_march_normals_cov_ift
        else:
            plain, cov = fused_march_normals, fused_march_normals_cov
            ift = fused_march_normals_ift
            cov_ift = partial(fused_march_normals_ift, track_min=True)
        if cfg.backward == "implicit":
            march = partial(cov_ift if with_closest else ift,
                            hit_threshold=cfg.ift_hit_threshold,
                            denom_eps=cfg.ift_denom_eps)
        else:
            march = cov if with_closest else plain

        def run(origin, dirs):
            rays7 = torch.stack(list(origin) + list(dirs) + [valid], 0)
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
        with span(RENDER_POSE):
            orientation, translation = self._pose(orientation, translation)
            origin, dirs = self._pose_planes(orientation, translation)
        with span(RENDER_MARCH):
            hit, final_dirs = self._march_planes(params, origin, dirs, steps)
        with span(RENDER_SHADE):
            channels = self._shade(mode, degree, orientation, origin,
                                   final_dirs, hit, params=params)
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
        with span(RENDER_POSE):
            orientation, translation = self._pose(orientation, translation)
            origin, dirs = self._pose_planes(orientation, translation)
        with span(RENDER_MARCH):
            hit, final_dirs, minf = self._march_planes(
                params, origin, dirs, steps, with_closest=True)
        with span(RENDER_SHADE):
            channels = self._shade(mode, degree, orientation, origin,
                                   final_dirs, hit, params=params)
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
        """All 8 geometric shader modes from ONE fused march+normals pass;
        ``extras=True`` adds the named lighting modes, shaded from the same
        hit planes."""
        cfg = self.config
        steps = cfg.marching_steps if marching_steps is None else marching_steps
        orientation, translation = self._pose(orientation, translation)
        origin, dirs = self._pose_planes(orientation, translation)
        hit, final_dirs = self._march_planes(params, origin, dirs, steps)
        modes = list(enumerate(shaders.MODES))
        if extras:
            modes += [(name, name) for name in lighting.EXTRA_MODES]
        return {
            name: self._assemble(self._shade(mode, degree, orientation, origin,
                                             final_dirs, hit, params=params))
            for mode, name in modes
        }

    def jitted(self, **render_kwargs):
        """``f(params, orientation, translation) -> image`` with
        ``render_kwargs`` bound; nothing is compiled (the name is the JAX
        package's)."""
        return partial(self.render, **render_kwargs)

    def default_pose(self):
        n = self.num_cameras
        return (
            self._tensor([[1.0, 0.0, 0.0, 0.0]] * n),
            self._tensor([[0.0, 0.0, 1.0]] * n),
        )
