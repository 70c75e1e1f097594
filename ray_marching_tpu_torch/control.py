"""Camera control: Lie-algebra input integration as pure state transitions
(counterpart of ``ray_marching_tpu/control.py``).

An input backend (interactive or scripted) produces :class:`InputSnapshot`s;
:func:`apply_input` folds a snapshot into :class:`CameraState`:

* mouse NDC offset → rotation Lie-algebra components (dy, dx, 0) over the
  (YZ, ZX, XY) bivector basis;
* pressed keys sum their bound translation (XYZ) and rotation (YZ, ZX, XY)
  generators;
* ``position += R(q)·(Δt · trans_sens)`` (camera-frame translation),
  ``q ← normalize(q ⊗ to_versor(Δr · rot_sens))``;
* scroll cycles the shader mode; i/o change the degree, m/n the marching
  steps, p saves a frame, q quits.

Key bindings: w/s = ±Z, d/a = ±X, e/x = ±Y, r = +0.5·XY roll
(:data:`DEFAULT_KEY_BINDINGS`; ``data/key_bindings.csv`` holds the same in
the reference's CSV format, which :func:`load_key_bindings` reads).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field, replace
from typing import Dict, FrozenSet, Tuple

import torch

from ray_marching_tpu_torch import quat

# key -> ((X, Y, Z), (YZ, ZX, XY)) generator components.
Binding = Tuple[Tuple[float, float, float], Tuple[float, float, float]]

DEFAULT_KEY_BINDINGS: Dict[str, Binding] = {
    "d": ((1.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
    "a": ((-1.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
    "e": ((0.0, 1.0, 0.0), (0.0, 0.0, 0.0)),
    "x": ((0.0, -1.0, 0.0), (0.0, 0.0, 0.0)),
    "w": ((0.0, 0.0, 1.0), (0.0, 0.0, 0.0)),
    "s": ((0.0, 0.0, -1.0), (0.0, 0.0, 0.0)),
    "r": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.5)),
}


def load_key_bindings(path) -> Dict[str, Binding]:
    """Load a reference-format key_bindings.csv (columns: key, X, Y, Z, YZ,
    ZX, XY)."""
    out: Dict[str, Binding] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out[row["key"]] = (
                (float(row["X"]), float(row["Y"]), float(row["Z"])),
                (float(row["YZ"]), float(row["ZX"]), float(row["XY"])),
            )
    return out


@dataclass(frozen=True)
class ControlConfig:
    translation_sensitivity: float = 0.1
    rotation_sensitivity: float = 0.25
    bindings: Dict[str, Binding] = field(
        default_factory=lambda: dict(DEFAULT_KEY_BINDINGS))


@dataclass(frozen=True)
class CameraState:
    """Camera pose: (N, 3) position, (N, 4) unit quaternion (tensors on the
    renderer's device; never changed in place)."""

    position: torch.Tensor
    orientation: torch.Tensor

    @staticmethod
    def initial(position=(0.0, 0.0, 1.0), orientation=(1.0, 0.0, 0.0, 0.0),
                num_cameras: int = 1, dtype=torch.float32,
                device="cuda") -> "CameraState":
        def tiled(v):
            return torch.tensor([v], dtype=dtype, device=device).repeat(
                num_cameras, 1)

        return CameraState(position=tiled(position),
                           orientation=tiled(orientation))


@dataclass(frozen=True)
class InputSnapshot:
    """One frame of input, produced by a single writer."""

    mouse_ndc: Tuple[float, float] = (0.0, 0.0)
    pressed: FrozenSet[str] = frozenset()
    scroll: int = 0
    quit: bool = False
    save_frame: bool = False


@dataclass(frozen=True)
class SessionState:
    """Non-pose interactive state: shader mode, degree, marching steps."""

    mode: int = 0
    degree: int = 2
    marching_steps: int = 32
    running: bool = True
    save_frame: bool = False

    def step(self, snap: InputSnapshot) -> "SessionState":
        # Degree and steps are clamped at 1, as the JAX package clamps them.
        degree = max(
            1, self.degree + ("i" in snap.pressed) - ("o" in snap.pressed))
        steps = max(1, self.marching_steps + ("m" in snap.pressed)
                    - ("n" in snap.pressed))
        return replace(self, mode=self.mode + snap.scroll, degree=degree,
                       marching_steps=steps,
                       running=self.running and not snap.quit,
                       save_frame=snap.save_frame)


def input_components(snap: InputSnapshot, cfg: ControlConfig):
    """Fold a snapshot into (translation, rotation) Lie-algebra components:
    the mouse's (dx, dy) as (dy, dx, 0) on the (YZ, ZX, XY) basis, plus the
    pressed keys' bound generators."""
    dx, dy = snap.mouse_ndc
    rot = [dy, dx, 0.0]
    trans = [0.0, 0.0, 0.0]
    for key in snap.pressed:
        if key in cfg.bindings:
            t, r = cfg.bindings[key]
            trans = [a + b for a, b in zip(trans, t)]
            rot = [a + b for a, b in zip(rot, r)]
    return tuple(trans), tuple(rot)


def _integrate(position, orientation, translation_input, rotation_input):
    """The device part of one pose step, in the JAX package's operation
    order."""
    new_position = quat.rotation(
        translation_input.expand(position.shape), orientation) + position
    new_orientation = quat.normalize(quat.multiply(
        orientation,
        quat.to_versor(rotation_input).expand(orientation.shape)))
    return new_position, new_orientation


def _like(values, ref):
    """``values`` as a (1, k) tensor of ``ref``'s dtype on its device. To a
    card the copy goes from pinned memory without waiting: a plain copy
    from the host would wait for every frame queued on the stream, and the
    viewer's pipeline (viewer.run_viewer) relies on it not waiting."""
    host = torch.tensor([values], dtype=ref.dtype)
    if ref.device.type == "cpu":
        return host
    return host.pin_memory().to(ref.device, non_blocking=True)


def apply_input(state: CameraState, snap: InputSnapshot,
                cfg: ControlConfig = ControlConfig()) -> CameraState:
    """One pose-integration step."""
    trans, rot = input_components(snap, cfg)
    pos = state.position
    s_t, s_r = cfg.translation_sensitivity, cfg.rotation_sensitivity
    translation_input = _like([v * s_t for v in trans], pos)
    rotation_input = _like([v * s_r for v in rot], pos)
    position, orientation = _integrate(pos, state.orientation,
                                       translation_input, rotation_input)
    return CameraState(position=position, orientation=orientation)
