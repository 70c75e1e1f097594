"""Tiled (strip) rendering: frames and gradients larger than one device pass
(counterpart of ``ray_marching_tpu/render/tiled.py``).

Frames of any size are marched in horizontal strips of pixel rows through
one :class:`~ray_marching_tpu_torch.render.fast.FastRenderer` sized to a
strip (the fused kernel on the card) and assembled on the host, so device
memory is bounded by the strip, not the image. Strips differ only in their
ray planes, which are computed on the device from the sensor axes
(:func:`camera.pixel_center_rows`, the same values as the one-pass grid).

The distance, proximity and laplacian shaders normalize by whole-image
extrema, which a strip cannot see. Those modes run two passes: pass 1
marches every strip and reduces its statistic
(:meth:`FastRenderer.norm_bounds`), the strips' bounds are merged (a NaN
poisons them as it would the one-pass reduction), and pass 2 marches again
and shades with the merged bounds. The last strip's rows past the image
extrapolate the pixel grid; they are masked out of the statistics and
cropped.

:meth:`TiledRenderer.loss_and_grad` sums a pixel loss and its gradients
strip by strip, in a fixed order, for resolutions whose one-pass backward
(the march history and the planes) would not fit.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch

from ray_marching_tpu_torch.camera import pixel_center_rows
from ray_marching_tpu_torch.render import lighting, shaders
from ray_marching_tpu_torch.render.fast import (
    LANES,
    FastRenderer,
    bake_ray_planes,
    pose_plane_group,
)
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.render.silhouette import soft_coverage
from ray_marching_tpu_torch.scene.graph import Node, map_params, param_paths

TWO_PASS_MODES = frozenset({"distance", "proximity", "laplacian"})


def _squared_error(img, tgt):
    """The default per-pixel loss: render NaNs compare as 0."""
    return torch.square(torch.nan_to_num(img, nan=0.0) - tgt)


class TiledRenderer:
    """Strip-at-a-time renderer over the fused-kernel fast path.

    One single-camera :class:`FastRenderer` of ``(px_width, strip_height)``
    does all device work; multi-camera batches loop (camera, strip) pairs on
    the host, and the whole-image normalizations span the whole batch, as in
    the one-pass renderers. ``mesh`` (strips sharded over several devices)
    is not ported.
    """

    def __init__(self, scene: Node, config: RenderConfig, *,
                 strip_height: int = 512, dtype=torch.float32,
                 grid_dtype=np.float32, device="cuda", mesh=None):
        if strip_height < 1:
            raise ValueError(f"strip_height must be >= 1, got {strip_height}")
        if mesh is not None:
            raise NotImplementedError(
                "TiledRenderer(mesh=...) is not ported yet: strips sharded "
                "over a mesh come with the parallel slice (ROADMAP.md queue "
                "1 item 8)")
        self.config = config
        self.num_cameras = config.num_cameras
        self.strip_height = min(strip_height, config.px_height)
        self.grid_dtype = grid_dtype
        strip_cfg = dataclasses.replace(config, px_height=self.strip_height,
                                        num_cameras=1)
        self.fast = FastRenderer(scene, strip_cfg, dtype=dtype,
                                 grid_dtype=grid_dtype, device=device)
        self.dtype = dtype
        self.device = self.fast.device
        self.init_params = self.fast.init_params
        self.num_strips = -(-config.px_height // self.strip_height)

    # -- per-strip constants -------------------------------------------------

    def _strip_planes(self, s: int):
        """Strip ``s``'s ray planes, validity plane and its real row count."""
        cfg = self.config
        fast = self.fast
        r0 = s * self.strip_height
        pos, dirs = pixel_center_rows(cfg.camera_config, self.grid_dtype,
                                      (r0, r0 + self.strip_height),
                                      self.device)
        pos0, dir0 = bake_ray_planes(pos, dirs, fast.rows_per_cam, self.dtype,
                                     self.device)
        rows_real = min(self.strip_height, cfg.px_height - r0)
        slot = torch.arange(fast.rows_per_cam * LANES, device=self.device)
        valid = (slot < rows_real * cfg.px_width).to(self.dtype)
        return pos0, dir0, valid.reshape(fast.rows_per_cam, LANES), rows_real

    def _strips(self, poses):
        """``(camera, strip, q row, t row, planes...)`` in the fixed order."""
        for n, (qn, tn) in enumerate(poses):
            for s in range(self.num_strips):
                yield (n, s, qn, tn) + self._strip_planes(s)

    def _march(self, params, q, t, pos0, dir0, valid, with_closest=False):
        origin, dirs = pose_plane_group(q, t, pos0, dir0)
        out = self.fast._march_planes(params, origin, dirs,
                                      self.config.marching_steps, valid=valid,
                                      with_closest=with_closest)
        return (origin,) + tuple(out)

    def _shade(self, mode, degree, params, q, t, pos0, dir0, valid, bounds):
        origin, hit, dirs = self._march(params, q, t, pos0, dir0, valid)
        return self.fast._assemble(self.fast._shade(
            mode, degree, q, origin, dirs, hit, valid_b=valid > 0.5,
            norm_bounds=bounds, params=params))

    def _merged_bounds(self, modes, params, poses):
        """Pass 1: every (camera, strip) pair's statistics of ``modes``,
        merged into whole-batch ``{mode: (lo, hi)}`` 0-d tensors. The merge
        is ``amin``/``amax``, so a NaN statistic poisons the bounds as the
        one-pass reduction would."""
        per_mode = {m: ([], []) for m in modes}
        with torch.no_grad():
            for _, _, qn, tn, pos0, dir0, valid, _ in self._strips(poses):
                origin, hit, _ = self._march(params, qn, tn, pos0, dir0,
                                             valid)
                for m in modes:
                    lo, hi = self.fast.norm_bounds(m, origin, hit,
                                                   valid_b=valid > 0.5)
                    per_mode[m][0].append(lo)
                    per_mode[m][1].append(hi)
        return {m: (torch.stack(lo).amin(), torch.stack(hi).amax())
                for m, (lo, hi) in per_mode.items()}

    def _poses(self, orientation, translation):
        q, t = self.fast._pose(orientation, translation)
        return q, t, [(q[n:n + 1], t[n:n + 1])
                      for n in range(self.num_cameras)]

    @staticmethod
    def _two_pass(mode):
        name = mode if isinstance(mode, str) \
            else shaders.MODES[mode % len(shaders.MODES)]
        return name in TWO_PASS_MODES

    # -- public API ------------------------------------------------------------

    def _host_frame(self):
        """The (N, H, W, 3) CPU tensor the strips are copied into."""
        cfg = self.config
        return torch.empty((self.num_cameras, cfg.px_height, cfg.px_width, 3),
                           dtype=self.dtype)

    def render(self, params, orientation, translation, *, mode: int = 0,
               degree: int = 1):
        """Render one frame strip by strip → a CPU tensor (N, H, W, 3)."""
        _, _, poses = self._poses(orientation, translation)
        bounds = (self._merged_bounds([mode], params, poses)[mode]
                  if self._two_pass(mode) else None)
        frame = self._host_frame()
        with torch.no_grad():
            for n, s, qn, tn, pos0, dir0, valid, rows in self._strips(poses):
                img = self._shade(mode, degree, params, qn, tn, pos0, dir0,
                                  valid, bounds)
                r0 = s * self.strip_height
                frame[n, r0:r0 + rows].copy_(img[0, :rows])
        return frame

    def render_all_modes(self, params, orientation, translation, *,
                         degree: int = 1, extras: bool = False):
        """All 8 shader modes (``extras``: and the lighting modes) strip by
        strip: two marches per strip in all, one stats pass for the three
        normalized modes together and one pass that shades every mode.
        Returns ``{mode_name: CPU tensor (N, H, W, 3)}``."""
        modes = list(enumerate(shaders.MODES))
        if extras:
            modes += [(name, name) for name in lighting.EXTRA_MODES]
        _, _, poses = self._poses(orientation, translation)
        bounds = self._merged_bounds(
            [m for m, name in modes if name in TWO_PASS_MODES], params, poses)
        frames = {name: self._host_frame() for _, name in modes}
        fast = self.fast
        with torch.no_grad():
            for n, s, qn, tn, pos0, dir0, valid, rows in self._strips(poses):
                origin, hit, dirs = self._march(params, qn, tn, pos0, dir0,
                                                valid)
                r0 = s * self.strip_height
                for m, name in modes:
                    img = fast._assemble(fast._shade(
                        m, degree, qn, origin, dirs, hit,
                        valid_b=valid > 0.5, norm_bounds=bounds.get(m),
                        params=params))
                    frames[name][n, r0:r0 + rows].copy_(img[0, :rows])
        return frames

    def loss_and_grad(self, params, orientation, translation, target, *,
                      mode: int = 0, degree: int = 1, with_pose=False,
                      loss_fn=None, alpha_target=None, alpha_weight=1.0,
                      beta: Optional[float] = None):
        """A pixel loss and its gradients, summed strip by strip in a fixed
        order (camera, then strip).

        ``target`` is (N, H, W, 3); the default per-pixel loss is the
        squared error with render NaNs compared as 0, normalized by the
        whole batch's pixel count, so the value is the one-pass MSE.
        ``loss_fn(img_rows, tgt_rows)`` replaces it (summed, same
        normalization). ``alpha_target`` (N, H, W, 1) adds ``alpha_weight ·
        MSE(soft_coverage(min_f, beta), alpha_target)`` from one more march
        per strip with the closest-approach plane (``min_f`` is per ray, so
        strips compose exactly). For distance, proximity and laplacian the
        merged bounds are constants (detached): the loss is exact, and the
        measure-zero gradient through the arg-extremum pixel is dropped.

        Returns ``(loss, grads)``, a 0-d tensor and a gradient tree shaped
        like ``params``; with ``with_pose``, ``(loss, (grads, grad_q
        (N, 4), grad_t (N, 3)))``."""
        cfg = self.config
        if alpha_target is not None and cfg.reflection_bounces:
            raise ValueError("alpha_target: reflection bounces unsupported")
        loss_fn = _squared_error if loss_fn is None else loss_fn
        beta = cfg.silhouette_beta if beta is None else beta
        q, t, poses = self._poses(orientation, translation)
        bounds = (self._merged_bounds([mode], params, poses)[mode]
                  if self._two_pass(mode) else None)
        target = torch.as_tensor(target, dtype=self.dtype, device=self.device)
        if alpha_target is not None:
            alpha_target = torch.as_tensor(alpha_target, dtype=self.dtype,
                                           device=self.device)
        n_apx = self.num_cameras * cfg.px_height * cfg.px_width
        work = map_params(params, lambda v: v.detach().requires_grad_(True))
        leaves = list(param_paths(work).values())
        sums = [torch.zeros_like(v) for v in leaves]
        pose_sums = [(torch.zeros_like(q[n:n + 1]), torch.zeros_like(
            t[n:n + 1])) for n in range(self.num_cameras)]
        loss = torch.zeros((), dtype=self.dtype, device=self.device)
        for n, s, qn, tn, pos0, dir0, valid, rows in self._strips(poses):
            qn = qn.detach().requires_grad_(with_pose)
            tn = tn.detach().requires_grad_(with_pose)
            r0 = s * self.strip_height
            img = self._shade(mode, degree, work, qn, tn, pos0, dir0, valid,
                              bounds)
            strip_loss = torch.sum(loss_fn(
                img[0, :rows], target[n, r0:r0 + rows])) / (n_apx * 3)
            if alpha_target is not None:
                _, _, _, minf = self._march(work, qn, tn, pos0, dir0, valid,
                                            with_closest=True)
                alpha = self.fast._assemble([soft_coverage(minf, beta)])
                aerr = torch.square(alpha[0, :rows]
                                    - alpha_target[n, r0:r0 + rows])
                strip_loss = strip_loss + alpha_weight * torch.sum(aerr) / n_apx
            inputs = leaves + ([qn, tn] if with_pose else [])
            got = torch.autograd.grad(strip_loss, inputs, allow_unused=True)
            for i, g in enumerate(got[:len(leaves)]):
                if g is not None:
                    sums[i] = sums[i] + g
            if with_pose:
                gq, gt = pose_sums[n]
                pose_sums[n] = (gq + got[-2], gt + got[-1])
            loss = loss + strip_loss.detach()
        by_leaf = {id(v): g for v, g in zip(leaves, sums)}
        grads = map_params(work, lambda v: by_leaf[id(v)])
        if with_pose:
            return loss, (grads, torch.cat([g[0] for g in pose_sums]),
                          torch.cat([g[1] for g in pose_sums]))
        return loss, grads

    def jitted(self, **render_kwargs):
        """``f(params, orientation, translation) -> image`` with
        ``render_kwargs`` bound (the JAX package's name; nothing compiles)."""
        return partial(self.render, **render_kwargs)

    def default_pose(self):
        q1, t1 = self.fast.default_pose()
        n = self.num_cameras
        return q1.repeat(n, 1), t1.repeat(n, 1)
