"""Data parallelism on torch.distributed (port of texpose_tpu/parallel)."""

from .mesh import (make_mesh, replicate, shard_leading_axis,
                   dp_constrain_batch, render_full_nerf_st_sharded,
                   render_full_nerf_sharded, masked_ray_indices_sharded,
                   render_masked_nerf_st_sharded)
