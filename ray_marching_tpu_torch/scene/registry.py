"""Named scene registry (counterpart of ``ray_marching_tpu/scene/registry.py``):
the same scene names and the same trees."""

from __future__ import annotations

import math
from typing import Callable, Dict

from ray_marching_tpu_torch.scene.graph import (
    Affine,
    Box,
    Line,
    Node,
    Onion,
    SmoothUnion,
    Sphere,
    Torus,
    Union,
)

_REGISTRY: Dict[str, Callable[[], Node]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def make_scene(name: str) -> Node:
    """Build a registered scene by name."""
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scene {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return fn()


def available_scenes():
    return sorted(_REGISTRY)


@register("test_scene")
def make_test_scene() -> Node:
    """Smooth union exercising every composition mechanism."""
    return SmoothUnion(
        children=(
            Affine(
                child=Onion(child=Box(halfsides=(0.1, 0.2, 0.05)), radius=0.1),
                orientation=(0.9014, 0.25, 0.25, 0.25),
                translation=(0.0, 0.25, 0.25),
            ),
            Affine(
                child=Sphere(radius=0.5),
                orientation=(1.0, 0.0, 0.0, 0.0),
                translation=(0.0, 0.0, 1.0),
            ),
            Line(start=(-1.0, 1.0, 2.0), end=(1.0, 1.0, 0.0), radius=0.1),
            Affine(
                child=Torus(radius1=0.5, radius2=0.1),
                orientation=(0.0, math.sqrt(0.5), math.sqrt(0.5), 0.0),
                translation=(0.0, 0.5, 1.0),
            ),
        ),
        blend_k=22.0,
    )


@register("test_scene2")
def make_test_scene2() -> Node:
    """Room shell (onioned box) around a hard union of sphere/torus/capsule."""
    return Union(
        children=(
            Onion(child=Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
            Union(
                children=(
                    Sphere(radius=0.5),
                    Torus(radius1=1.0, radius2=0.25),
                    Line(start=(1.0, 0.0, 0.0), end=(-1.0, 0.0, 0.0), radius=0.1),
                )
            ),
        )
    )


@register("single_sphere")
def make_single_sphere() -> Node:
    """A lone sphere."""
    return Sphere(radius=0.5)


@register("neural_demo")
def make_neural_demo() -> Node:
    """A neural SDF blob beside analytic shapes inside the room shell."""
    from ray_marching_tpu_torch.scene.neural import NeuralSDF

    return Union(
        children=(
            Onion(child=Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
            Affine(
                child=NeuralSDF(hidden=(16, 16), seed=7, scale=0.6, w0=6.0),
                orientation=(1.0, 0.0, 0.0, 0.0),
                translation=(-0.8, 0.0, 0.0),
            ),
            Affine(
                child=Torus(radius1=0.7, radius2=0.2),
                orientation=(math.sqrt(0.5), math.sqrt(0.5), 0.0, 0.0),
                translation=(0.9, 0.0, 0.3),
            ),
        )
    )


@register("mandelbulb")
def make_mandelbulb() -> Node:
    """A power-8 Mandelbulb inside the room shell (scene/fractals.py),
    marched by the same kernels as the analytic scenes; the room ends every
    ray, so miss pixels stay finite."""
    from ray_marching_tpu_torch.scene.fractals import Mandelbulb

    return Union(
        children=(
            Onion(child=Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
            Affine(
                child=Mandelbulb(power=8, iterations=10, scale=1.0),
                orientation=(0.9239, 0.0, 0.3827, 0.0),  # ~45 deg about y
                translation=(0.0, 0.0, 0.0),
            ),
        )
    )


@register("composite")
def make_composite() -> Node:
    """Smooth union of sphere+torus+box under rotations."""
    return SmoothUnion(
        children=(
            Affine(
                child=Box(halfsides=(0.3, 0.2, 0.25)),
                orientation=(0.9014, 0.25, 0.25, 0.25),
                translation=(0.6, 0.0, 0.5),
            ),
            Sphere(radius=0.4),
            Affine(
                child=Torus(radius1=0.6, radius2=0.15),
                orientation=(math.sqrt(0.5), math.sqrt(0.5), 0.0, 0.0),
                translation=(-0.5, 0.2, 0.6),
            ),
        ),
        blend_k=16.0,
    )
