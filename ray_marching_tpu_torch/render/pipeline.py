"""The modular differentiable render pipeline and the static render
configuration (counterpart of ``ray_marching_tpu/render/pipeline.py``).

One function from (scene parameters, camera pose) to an (N, H, W, 3) image:

  camera pose → sphere-trace march → terminal SDF evaluation → tetrahedral
  normals + Laplacian → one of 8 shaders → broadcast to RGB.

Everything is plain tensor code on ``(N, H, W, 3)`` tensors except the march
with ``RenderConfig.use_pallas``: the flag keeps its JAX name (one
configuration reads the same in both packages) and selects the hand-written
CUDA march kernel (:mod:`ray_marching_tpu_torch.ops.march_kernel`; its plain
version for CPU tensors). ``RenderConfig`` has the same fields and defaults
as the JAX one; options this port does not run yet are rejected by the
renderer that reads them. The named lighting modes (``mode="occlusion"`` /
``"shaded"``, :mod:`.lighting`) shade the marched points with further SDF
queries, on the same componentwise core as the plane-native renderer.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from ray_marching_tpu_torch.camera import Camera, CameraConfig
from ray_marching_tpu_torch.render import lighting
from ray_marching_tpu_torch.render import march as march_mod
from ray_marching_tpu_torch.render import shaders
from ray_marching_tpu_torch.render.normals import (
    NormalsEstimator,
    autodiff_normals,
)
from ray_marching_tpu_torch.scene.graph import Node, compile_scene
from ray_marching_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class RenderConfig:
    num_cameras: int = 1
    px_width: int = 800
    px_height: int = 800
    focal_length: float = 17e-3
    sensor_width: float = 17e-3
    sensor_height: float = 17e-3
    marching_steps: int = 32
    normals_eps: float = 5e-2
    tau: float = 0.0
    remat: bool = False
    backward: str = "unroll"  # 'unroll' | 'implicit' (IFT)
    ift_hit_threshold: float = 0.05
    ift_denom_eps: float = 1e-6
    silhouette_beta: float = 5e-2
    reflection_bounces: int = 0
    use_autodiff_normals: bool = False
    use_pallas: bool = False
    light_direction: tuple = (0.4, 0.7, 0.6)
    ambient: float = 0.15
    ao_samples: int = 5
    ao_step: float = 0.05
    ao_strength: float = 1.0
    shadow_steps: int = 16
    shadow_sharpness: float = 16.0
    cmap_fourier: bool = False

    @property
    def camera_config(self) -> CameraConfig:
        return CameraConfig(
            num_cameras=self.num_cameras,
            px_width=self.px_width,
            px_height=self.px_height,
            focal_length=self.focal_length,
            sensor_width=self.sensor_width,
            sensor_height=self.sensor_height,
        )


class Renderer:
    """Owns the per-config constants (ray grid, normal offsets, colourmap) on
    ``device`` and exposes render functions over them, differentiable in the
    scene parameters and the camera pose."""

    def __init__(self, scene: Node, config: RenderConfig, dtype=torch.float32,
                 grid_dtype=np.float32, device="cuda"):
        if config.backward not in ("unroll", "implicit"):
            raise ValueError(f"backward must be unroll|implicit, got "
                             f"{config.backward!r}")
        self.device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.grid_dtype = np.dtype(grid_dtype)
        self.scene = scene
        self.sdf_vec, self.sdf_c, self.init_params = compile_scene(
            scene, dtype, self.device)
        self.program = None
        if config.use_pallas:
            from ray_marching_tpu_torch.scene.codegen import SdfProgram

            self.program = SdfProgram(scene)
        self.camera = Camera(config.camera_config, dtype=dtype,
                             grid_dtype=grid_dtype, device=self.device)
        self.normals = NormalsEstimator(config.normals_eps, dtype=dtype,
                                        device=self.device)
        self.cyclic_cmap = shaders.load_cyclic_cmap(dtype, self.device)
        self.cmap_coeffs = (shaders.fourier_cmap_coeffs()
                            if config.cmap_fourier else None)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- the frame function ------------------------------------------------

    def render(self, params, orientation, translation, *, mode: int = 0,
               degree: int = 1, marching_steps: Optional[int] = None,
               axis_names=()):
        """Render one frame → (N, H, W, 3).

        ``orientation`` (N, 4) are unit quaternions and ``translation``
        (N, 3) camera positions; ``mode`` is the shader index (0..7, wraps
        mod 8) or a lighting mode's name, ``degree`` the winding degree of
        the tangent/spin colouring, ``marching_steps`` overrides the
        configuration's. ``axis_names`` is a tuple of ``torch.distributed``
        process groups (a mesh's per-dimension groups) over which the
        distance, proximity and laplacian normalizations reduce, for a grid
        sharded across ranks (:func:`ray_marching_tpu_torch.parallel.
        shard_render`); empty, the frame is this process's alone."""
        orientation = self._tensor(orientation)
        translation = self._tensor(translation)
        pixel_pos, pixel_frames, ray_pos, ray_dirs = self.camera.pose(
            orientation, translation)
        return self.render_from_rays(
            params, orientation, pixel_pos, pixel_frames, ray_pos, ray_dirs,
            mode=mode, degree=degree, marching_steps=marching_steps,
            axis_names=axis_names)

    def _steps(self, marching_steps):
        return (self.config.marching_steps if marching_steps is None
                else marching_steps)

    def _surface(self, params, surface_coords, autodiff=False):
        """Terminal distances, normals and Laplacian at the marched points."""
        distances = self.sdf_vec(params, surface_coords)
        normals, laplacian = self.normals(self.sdf_vec, params,
                                          surface_coords)
        if autodiff:
            normals = autodiff_normals(self.sdf_vec, params, surface_coords)
        return distances, normals, laplacian

    def _shade(self, mode, degree, axis_names, params, **fields):
        if isinstance(mode, str) and mode in lighting.EXTRA_MODES:
            image = self._shade_extra(mode, params, fields["surface_coords"],
                                      fields["surface_normals"])
        else:
            image = shaders.shade(mode, cyclic_cmap=self.cyclic_cmap,
                                  cmap_coeffs=self.cmap_coeffs, degree=degree,
                                  axis_names=axis_names, **fields)
        return self._broadcast(image)

    def _shade_extra(self, name, params, surface_coords, surface_normals):
        """One lighting mode on the (N, H, W, 3) grids → (N, H, W, 1)."""
        return lighting.shade_extra(
            name, self.sdf_c, params,
            tuple(surface_coords[..., i] for i in range(3)),
            tuple(surface_normals[..., i] for i in range(3)),
            self.config)[..., None]

    @staticmethod
    def _broadcast(image):
        """(N, H, W, 1 or 3) → (N, H, W, 3); H and W are the image's (a
        rank's block of the frame when sharded)."""
        return image.expand(*image.shape[:3], 3)

    def render_from_rays(self, params, orientation, pixel_pos, pixel_frames,
                         ray_pos, ray_dirs, *, mode: int = 0, degree: int = 1,
                         marching_steps: Optional[int] = None,
                         axis_names=()):
        """March → normals → shade from an already-posed ray grid: the body
        of :meth:`render`."""
        surface_coords, ray_dirs = self._march(params, ray_pos, ray_dirs,
                                               self._steps(marching_steps))
        distances, normals, laplacian = self._surface(
            params, surface_coords, self.config.use_autodiff_normals)
        return self._shade(
            mode, degree, axis_names, params,
            px_coords=pixel_pos, camera_orientation=orientation,
            pixel_frames=pixel_frames, ray_directions=ray_dirs,
            surface_coords=surface_coords, surface_normals=normals,
            surface_laplacian=laplacian, surface_distances=distances)

    def render_with_alpha(self, params, orientation, translation, *,
                          mode: int = 0, degree: int = 1,
                          marching_steps: Optional[int] = None,
                          beta: Optional[float] = None, axis_names=()):
        """Render one frame plus a soft silhouette coverage mask
        ``α = σ(shift − min_f/β)`` (render/silhouette.py), where ``min_f`` is
        the along-ray closest approach: ≈1 for rays that hit, ≈0 for clear
        misses, and smooth in the scene parameters across the silhouette.
        Reflection bounces are not supported on this path, and the march is
        plain tensor code whatever ``use_pallas`` says (the march kernel
        tracks no closest approach), as in the JAX package.

        Returns ``(image (N, H, W, 3), alpha (N, H, W, 1))``."""
        from ray_marching_tpu_torch.render.silhouette import soft_coverage

        cfg = self.config
        if cfg.reflection_bounces:
            raise ValueError("render_with_alpha: reflection bounces unsupported")
        steps = self._steps(marching_steps)
        beta = cfg.silhouette_beta if beta is None else beta
        orientation = self._tensor(orientation)
        translation = self._tensor(translation)
        pixel_pos, pixel_frames, ray_pos, ray_dirs = self.camera.pose(
            orientation, translation)
        if cfg.backward == "implicit":
            from ray_marching_tpu_torch.render.implicit import (
                march_with_closest_implicit,
            )

            surface_coords, min_f = march_with_closest_implicit(
                self.sdf_vec, params, ray_pos, ray_dirs, steps, cfg.tau,
                cfg.ift_hit_threshold, cfg.ift_denom_eps)
        else:
            surface_coords, min_f = march_mod.march_with_closest(
                self.sdf_vec, params, ray_pos, ray_dirs, steps, tau=cfg.tau,
                remat=cfg.remat)
        distances, normals, laplacian = self._surface(params, surface_coords)
        image = self._shade(
            mode, degree, axis_names, params,
            px_coords=pixel_pos, camera_orientation=orientation,
            pixel_frames=pixel_frames, ray_directions=ray_dirs,
            surface_coords=surface_coords, surface_normals=normals,
            surface_laplacian=laplacian, surface_distances=distances)
        return image, soft_coverage(min_f, beta)

    def render_all_modes(self, params, orientation, translation, *, degree=1,
                         marching_steps=None, axis_names=(), extras=False):
        """All 8 shader modes from one march: ``{mode_name: image}``;
        ``extras=True`` adds the named lighting modes from the same march."""
        orientation = self._tensor(orientation)
        translation = self._tensor(translation)
        pixel_pos, pixel_frames, ray_pos, ray_dirs = self.camera.pose(
            orientation, translation)
        surface_coords, ray_dirs = self._march(params, ray_pos, ray_dirs,
                                               self._steps(marching_steps))
        distances, normals, laplacian = self._surface(params, surface_coords)
        images = shaders.shade_all(
            px_coords=pixel_pos, camera_orientation=orientation,
            pixel_frames=pixel_frames, ray_directions=ray_dirs,
            surface_coords=surface_coords, surface_normals=normals,
            surface_laplacian=laplacian, surface_distances=distances,
            cyclic_cmap=self.cyclic_cmap, cmap_coeffs=self.cmap_coeffs,
            degree=degree, axis_names=axis_names)
        if extras:
            for name in lighting.EXTRA_MODES:
                images[name] = self._shade_extra(name, params, surface_coords,
                                                 normals)
        return {k: self._broadcast(v) for k, v in images.items()}

    # -- internals ---------------------------------------------------------

    def _march(self, params, ray_pos, ray_dirs, steps):
        """March (with optional reflection bounces); returns the final
        positions and the (possibly reflected) final ray directions."""
        cfg = self.config
        if cfg.use_pallas:
            from ray_marching_tpu_torch.ops.march_kernel import kernel_march

            def marcher(p, v):
                return kernel_march(self.program, params, p, v, steps,
                                    tau=cfg.tau)
        elif cfg.backward == "implicit":
            from ray_marching_tpu_torch.render.implicit import march_implicit

            def marcher(p, v):
                return march_implicit(
                    self.sdf_vec, params, p, v, steps, cfg.tau,
                    cfg.ift_hit_threshold, cfg.ift_denom_eps)
        else:
            def marcher(p, v):
                return march_mod.march(self.sdf_vec, params, p, v, steps,
                                       tau=cfg.tau, remat=cfg.remat)

        p = marcher(ray_pos, ray_dirs)
        v = ray_dirs
        for _ in range(cfg.reflection_bounces):
            n, _ = self.normals(self.sdf_vec, params, p)
            v = march_mod.reflect(v, n)
            # Step off the surface before marching again, so that the next
            # march does not stall on the |f| ≈ 0 shell.
            p = p + v * self._tensor(cfg.normals_eps)
            p = marcher(p, v)
        return p, v

    # -- convenience -------------------------------------------------------

    def jitted(self, **render_kwargs):
        """``f(params, orientation, translation) -> image`` with
        ``render_kwargs`` bound. The name is the JAX package's; nothing is
        compiled here (PyTorch runs eagerly, and the port uses no
        ``torch.compile``)."""
        return partial(self.render, **render_kwargs)

    def default_pose(self):
        """Camera at (0, 0, 1), identity orientation."""
        n = self.config.num_cameras
        return (self._tensor([[1.0, 0.0, 0.0, 0.0]] * n),
                self._tensor([[0.0, 0.0, 1.0]] * n))
