"""Static render configuration (counterpart of
``ray_marching_tpu/render/pipeline.py::RenderConfig``).

The same fields and defaults as the JAX ``RenderConfig``, so one
configuration reads the same in both packages; options of the JAX package
that this port does not run yet are rejected by the renderer that reads
them (:class:`ray_marching_tpu_torch.render.fast.FastRenderer`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ray_marching_tpu_torch.camera import CameraConfig


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
