"""Pinhole camera: ray-grid construction and world-space posing (counterpart
of ``ray_marching_tpu/camera.py``).

The sensor plane sits at z = 0 with the focus at ``(0, 0, -focal_length)``;
pixel centres follow the ``align_corners=False`` convention and ray
directions are ``normalize(position - focus)``. The grid is computed in numpy
in ``grid_dtype`` (float32 reproduces the reference's f32 grid; float64 gives
exact pixel centres), as the JAX package computes it, then cast to the render
dtype and moved to the device. Posing rotates positions and directions by the
camera quaternion, translates the positions and reports the camera's
rotation matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ray_marching_tpu_torch import quat
from ray_marching_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class CameraConfig:
    num_cameras: int = 1
    px_width: int = 800
    px_height: int = 800
    focal_length: float = 17e-3
    sensor_width: float = 17e-3
    sensor_height: float = 17e-3

    @staticmethod
    def from_pixel_pitch(px_width: int, px_height: int,
                         px_size: float = 3.45e-6,
                         num_cameras: int = 1) -> "CameraConfig":
        """Focal length = sensor height (vertical field of view ≈ 53.13°),
        sensor sized by the pixel pitch."""
        return CameraConfig(
            num_cameras=num_cameras,
            px_width=px_width,
            px_height=px_height,
            focal_length=px_size * px_height,
            sensor_width=px_size * px_width,
            sensor_height=px_size * px_height,
        )


def _pixel_center_grid(cfg: CameraConfig, grid_dtype
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Sensor-plane pixel positions and unit ray directions, shape (H, W, 3),
    as numpy arrays in ``grid_dtype``."""
    w, h = cfg.px_width, cfg.px_height
    xs = (2.0 * np.arange(w, dtype=grid_dtype) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h, dtype=grid_dtype) + 1.0) / h - 1.0
    px = np.asarray(cfg.sensor_width / 2.0, dtype=grid_dtype) * xs
    py = np.asarray(-cfg.sensor_height / 2.0, dtype=grid_dtype) * ys
    positions = np.zeros((h, w, 3), dtype=grid_dtype)
    positions[:, :, 0] = px[None, :]
    positions[:, :, 1] = py[:, None]
    focus = np.asarray([0.0, 0.0, -cfg.focal_length], dtype=grid_dtype)
    rel = positions - focus
    directions = rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    return positions, directions


class Camera:
    """Holds the ray-grid constants on ``device`` (the card unless the
    caller asks for the CPU; :func:`utils.resolve_device` raises without
    one); :meth:`pose` is the pure forward map."""

    def __init__(self, cfg: CameraConfig, dtype=torch.float32,
                 grid_dtype=np.float32, device="cuda"):
        device = resolve_device(device)
        self.cfg = cfg
        positions, directions = _pixel_center_grid(cfg, grid_dtype)
        n = cfg.num_cameras
        self.ray_positions = torch.as_tensor(
            positions, dtype=dtype, device=device).expand(
                (n,) + positions.shape)
        self.ray_directions = torch.as_tensor(
            directions, dtype=dtype, device=device).expand(
                (n,) + directions.shape)

    def pose(self, orientation, translation):
        """World-space rays for the camera poses ``orientation`` (N, 4, unit
        quaternions) and ``translation`` (N, 3).

        Returns ``(pixel_positions, pixel_frames, ray_positions,
        ray_directions)`` with positions and directions of shape
        (N, H, W, 3) and frames of shape (N, 3, 3); ``pixel_positions`` and
        ``ray_positions`` are the same tensor."""
        q = orientation[:, None, None, :]
        ray_positions = (quat.rotation(self.ray_positions, q)
                         + translation[:, None, None, :])
        ray_directions = quat.rotation(self.ray_directions, q)
        pixel_frames = quat.to_so3(orientation)
        return ray_positions, pixel_frames, ray_positions, ray_directions
