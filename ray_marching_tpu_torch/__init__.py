"""PyTorch/CUDA port of the differentiable sphere-tracing renderer.

A second package beside the JAX one (``ray_marching_tpu``), which stays the
reference. Plain tensor code is PyTorch; the fused march + normals kernel,
its backward and the march kernel are CUDA C++ written for Hopper
(``ops/csrc/render_fwd.cu``, ``render_bwd.cu``, ``march.cu``), built with
nvcc at first use and bound with ctypes
(:mod:`ray_marching_tpu_torch.ops.render_kernel`,
:mod:`ray_marching_tpu_torch.ops.backward_kernel`,
:mod:`ray_marching_tpu_torch.ops.march_kernel`). :class:`Renderer` is the
modular pipeline, :class:`FastRenderer` the plane-native one and
:class:`TiledRenderer` frames and gradients in strips of rows over it.

Entry points take ``device=`` and default to ``"cuda"``; they never fall back
to the CPU by themselves. Pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels (the tests do).
"""

from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig, Renderer
from ray_marching_tpu_torch.render.tiled import TiledRenderer
from ray_marching_tpu_torch.scene import registry

__all__ = ["FastRenderer", "RenderConfig", "Renderer", "TiledRenderer",
           "registry"]
