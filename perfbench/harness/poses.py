"""Camera poses on a circle about the vertical axis, the traffic's one
source of variety between seeds.

A pose at yaw ``a`` sits at ``(D sin a, h, D cos a)`` and looks at the
scene's vertical axis: its quaternion is a turn of ``pi + a`` about y, so at
``a = 0`` it is the bench pose ``q = (0, 0, 1, 0)``, ``t = (0, h, D)``.
Every pose is at the same distance, and at tau = 0 every ray takes every
step, so each seed asks for the same work in another order of views.

The served mix turns the viewer's camera in place instead
(:func:`viewer_turn`)."""

from __future__ import annotations

import math

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one seed (any integer; large ones are fine)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def orbit_pose(yaw, distance: float, height: float):
    """``(q, t)`` as float32 numpy arrays: (4,) and (3,) for one yaw, (n, 4)
    and (n, 3) for an array of n."""
    yaw = np.asarray(yaw, np.float64)
    half = 0.5 * (math.pi + yaw)
    zero = np.zeros_like(yaw)
    q = np.stack([np.cos(half), zero, np.sin(half), zero], -1)
    t = np.stack([distance * np.sin(yaw), zero + height,
                  distance * np.cos(yaw)], -1)
    return q.astype(np.float32), t.astype(np.float32)


def start_yaw(seed: int) -> float:
    return float(rng(seed).uniform(0.0, 2.0 * math.pi))


def views(seed: int, pose_cfg: dict, n: int, spacing: float):
    """The fit's ``n`` views, ``spacing`` radians apart from the seed's
    start yaw."""
    a0 = start_yaw(seed)
    return [orbit_pose(a0 + i * spacing, pose_cfg["distance"],
                       pose_cfg["height"]) for i in range(n)]



def viewer_turn(seed: int, pose_cfg: dict, mix: dict, frames):
    """The viewer's camera under the scripted turn, worked out in float64:
    it starts at the seed's pose on the circle, and before each frame the
    mouse's ``yaw_per_frame`` times ``rotation_sensitivity`` is lifted to
    the unit quaternion ``(sqrt(1 - v^2), 0, v, 0)`` and multiplied on the
    right, a turn by ``2·asin(v)`` about the camera's own vertical axis.
    ``(q, t)``: (n, 4) and (n, 3) float64 arrays for the frame indices
    ``frames`` (frame ``k`` has had ``k + 1`` turns)."""
    a0 = start_yaw(seed)
    step = math.asin(mix["yaw_per_frame"] * mix["rotation_sensitivity"])
    k = np.asarray(frames, np.float64) + 1.0
    half = 0.5 * (math.pi + a0) + k * step
    zero = np.zeros_like(half)
    q = np.stack([np.cos(half), zero, np.sin(half), zero], -1)
    t = np.tile([pose_cfg["distance"] * math.sin(a0), pose_cfg["height"],
                 pose_cfg["distance"] * math.cos(a0)], (len(k), 1))
    return q, t
