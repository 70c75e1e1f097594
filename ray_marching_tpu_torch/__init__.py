"""PyTorch/CUDA port of the differentiable sphere-tracing renderer.

A second package beside the JAX one (``ray_marching_tpu``), which stays the
reference. Plain tensor code is PyTorch; the fused march + normals kernel
and its backward are CUDA C++ written for Hopper (``ops/csrc/render_fwd.cu``,
``ops/csrc/render_bwd.cu``), built with nvcc at first use and bound with
ctypes (:mod:`ray_marching_tpu_torch.ops.render_kernel`,
:mod:`ray_marching_tpu_torch.ops.backward_kernel`).

Entry points take ``device=`` and default to ``"cuda"``; they never fall back
to the CPU by themselves. Pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels (the tests do).
"""

from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import registry

__all__ = ["FastRenderer", "RenderConfig", "registry"]
