"""The traffic generator's pieces: orbit poses and the judged frames."""

import math

import numpy as np
import pytest

from perfbench.harness import poses
from perfbench.harness.serve import Reservoir


def test_bench_pose_at_yaw_zero():
    q, t = poses.orbit_pose(0.0, 2.5, 0.2)
    np.testing.assert_allclose(q, [0.0, 0.0, 1.0, 0.0], atol=1e-7)
    np.testing.assert_allclose(t, [0.0, 0.2, 2.5], atol=1e-7)


def test_orbit_poses_vectorized_and_on_the_circle():
    yaws = 0.3 + 0.02 * np.arange(-2, 50)
    q, t = poses.orbit_pose(yaws, 2.2, 0.2)
    assert q.shape == (52, 4) and t.shape == (52, 3)
    for i in (0, 7, 51):
        qi, ti = poses.orbit_pose(float(yaws[i]), 2.2, 0.2)
        np.testing.assert_array_equal(q[i], qi)
        np.testing.assert_array_equal(t[i], ti)
    np.testing.assert_allclose(np.hypot(t[:, 0], t[:, 2]), 2.2, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, rtol=1e-6)


def test_viewer_turn_is_the_viewers_own_integration():
    """The reference's float64 camera against the program's pose step,
    applied frame by frame in float32 as the viewer applies it."""
    import torch

    from ray_marching_tpu_torch.control import (
        CameraState,
        ControlConfig,
        InputSnapshot,
        apply_input,
    )

    mix = {"yaw_per_frame": 0.02, "rotation_sensitivity": 0.25}
    pose_cfg = {"distance": 2.2, "height": 0.2}
    seed = 2**31 + 9
    q0, t0 = poses.orbit_pose(poses.start_yaw(seed), 2.2, 0.2)
    cam = CameraState(position=torch.tensor(t0[None]),
                      orientation=torch.tensor(q0[None]))
    snap = InputSnapshot(mouse_ndc=(mix["yaw_per_frame"], 0.0))
    control = ControlConfig(rotation_sensitivity=mix["rotation_sensitivity"])
    frames = [0, 1, 99, 399]
    q, t = poses.viewer_turn(seed, pose_cfg, mix, frames)
    got = {}
    for k in range(400):
        cam = apply_input(cam, snap, control)
        got[k] = cam
    for i, k in enumerate(frames):
        np.testing.assert_allclose(got[k].orientation[0].double(), q[i],
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(got[k].position[0].double(), t[i],
                                   rtol=0, atol=1e-6)
    # a turn of 2 asin(0.005) a frame about the camera's vertical axis
    assert q[3][0] ** 2 + q[3][2] ** 2 == pytest.approx(1.0)
    assert 2 * (np.arctan2(q[1][2], q[1][0]) - np.arctan2(q[0][2], q[0][0])) \
        == pytest.approx(2 * math.asin(0.005))


def test_views_same_work_other_order():
    a = poses.views(2**31 + 1, {"distance": 2.5, "height": 0.2}, 4,
                    math.pi / 2)
    b = poses.views(2**40 + 3, {"distance": 2.5, "height": 0.2}, 4,
                    math.pi / 2)
    assert len(a) == len(b) == 4
    assert not np.allclose(a[0][1], b[0][1])


def _judged(seed, n, k):
    r = Reservoir(seed, k)
    for i in range(n):
        r.add(i, np.full((1, 2, 2, 3), i % 256, np.uint8))
    return [i for i, _ in r.frames()]


def test_reservoir_keeps_k_with_the_last_and_repeats_per_seed():
    got = _judged(2**31 + 7, 500, 8)
    assert len(got) == 8 and got[-1] == 499 and len(set(got)) == 8
    assert got == _judged(2**31 + 7, 500, 8)
    assert got != _judged(2**31 + 8, 500, 8)
    assert _judged(1, 3, 8) == [0, 1, 2]


def test_reservoir_draws_uniformly():
    counts = np.zeros(20)
    for seed in range(2000):
        for i in _judged(seed, 21, 5)[:-1]:
            counts[i] += 1
    assert counts.sum() == 2000 * 4
    mean = counts.mean()
    assert 0.8 * mean < counts.min() <= counts.max() < 1.2 * mean
