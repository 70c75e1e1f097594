"""Several devices: one process per device in a ``torch.distributed``
process group (counterpart of ``ray_marching_tpu/parallel``).

The scaling axis is rays: the ray grid is sharded over a mesh of ranks
while the scene parameters are replicated. The march is free of
communication per ray; the only coupling across shards in the forward pass
is the whole-image min/max of the distance, proximity and laplacian
shaders, and in the backward pass the sum of the replicated parameters'
gradients, both explicit collectives on the mesh's process groups.
"""

from ray_marching_tpu_torch.parallel.sharding import (
    make_mesh,
    make_train_step,
    shard_render,
)

__all__ = ["make_mesh", "shard_render", "make_train_step"]
