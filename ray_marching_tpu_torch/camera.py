"""Pinhole camera constants (counterpart of ``ray_marching_tpu/camera.py``).

The sensor plane sits at z = 0 with the focus at ``(0, 0, -focal_length)``;
pixel centres follow the ``align_corners=False`` convention and ray
directions are ``normalize(position - focus)``. The grid is computed in numpy
in ``grid_dtype`` (float32 reproduces the reference's f32 grid; float64 gives
exact pixel centres) and cast to the render dtype by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class CameraConfig:
    num_cameras: int = 1
    px_width: int = 800
    px_height: int = 800
    focal_length: float = 17e-3
    sensor_width: float = 17e-3
    sensor_height: float = 17e-3


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
