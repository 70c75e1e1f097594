"""Image output."""

from ray_marching_tpu_torch.io.image import encode_png, write_png

__all__ = ["encode_png", "write_png"]
