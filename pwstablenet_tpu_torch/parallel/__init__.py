from pwstablenet_tpu_torch.parallel.mesh import (  # noqa: F401
    GradSync,
    Mesh,
    all_gather_rows,
    data_parallel_step,
    make_mesh,
    make_mesh_for_batch,
    replicate_tree,
    shard_batch,
    sync_batch_norm,
)
from pwstablenet_tpu_torch.parallel.multihost import (  # noqa: F401
    maybe_initialize_distributed,
    process_info,
)
from pwstablenet_tpu_torch.parallel.spatial import (  # noqa: F401
    spatial_sharded_warp,
)
