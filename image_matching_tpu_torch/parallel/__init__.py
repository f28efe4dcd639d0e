"""Parallelism of the port over `torch.distributed`: the multi-process
runtime (`distributed.py`), the mesh and the data axis's collectives
(`mesh.py`), the collectives on any axis (`collectives.py`), tensor-parallel
SuperGlue (`sharding.py`), ring attention (`ring_attention.py`), the
row-sharded Sinkhorn (`sharded_sinkhorn.py`), context-parallel SuperGlue
(`context_parallel.py`) and pipeline-parallel SuperGlue (`pipeline.py`).
The sharded pose-graph and bundle-adjustment solvers are in `slam/`."""
from image_matching_tpu_torch.parallel.distributed import initialize_multihost, is_primary
from image_matching_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    all_sum,
    global_count,
    make_data_mesh,
    make_mesh,
    replicate,
    shard_batch,
    sync_gradients,
    use_mesh,
)
from image_matching_tpu_torch.parallel.pipeline import make_pipelined_superglue, stack_gnn_params
from image_matching_tpu_torch.parallel.sharding import apply_param_sharding, superglue_param_sharding

__all__ = ["initialize_multihost", "is_primary", "Axis", "Mesh", "all_sum", "global_count", "make_data_mesh",
           "make_mesh", "replicate", "shard_batch", "sync_gradients", "use_mesh", "make_pipelined_superglue",
           "stack_gnn_params", "superglue_param_sharding", "apply_param_sharding"]
