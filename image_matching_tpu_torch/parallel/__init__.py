"""Data parallelism of the port over `torch.distributed` (`mesh.py`,
`distributed.py`); the JAX package's tensor, pipeline and context
parallelism are not ported."""
from image_matching_tpu_torch.parallel.distributed import initialize_multihost, is_primary
from image_matching_tpu_torch.parallel.mesh import (
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

__all__ = ["initialize_multihost", "is_primary", "Mesh", "all_sum", "global_count", "make_data_mesh", "make_mesh",
           "replicate", "shard_batch", "sync_gradients", "use_mesh"]
