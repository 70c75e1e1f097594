"""Image output and checkpoints."""

from ray_marching_tpu_torch.io.checkpoint import load_pytree, save_pytree
from ray_marching_tpu_torch.io.image import encode_png, write_png

__all__ = ["encode_png", "load_pytree", "save_pytree", "write_png"]
