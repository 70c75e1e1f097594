"""Inverse rendering."""

from ray_marching_tpu_torch.optim.inverse import InverseConfig, optimize

__all__ = ["InverseConfig", "optimize"]
