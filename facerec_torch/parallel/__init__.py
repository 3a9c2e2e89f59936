"""Process mesh and collectives (counterpart of ``facerec_tpu/parallel/``):
``torch.distributed`` data parallelism over the ``data`` axis and the
serve step's gallery rows over the ``model`` axis."""

from facerec_torch.parallel.collectives import (
    all_gather, axis_index, global_topk_merge, pmean, ppermute_ring, psum, reduce_scatter,
)
from facerec_torch.parallel.mesh import (
    batch_sharding, build_mesh, default_mesh, gallery_sharding, pad_to_multiple,
    replicated, shard_batch, shard_params,
)

__all__ = [
    "all_gather", "axis_index", "global_topk_merge", "pmean", "ppermute_ring",
    "psum", "reduce_scatter", "batch_sharding", "build_mesh", "default_mesh",
    "gallery_sharding", "pad_to_multiple", "replicated", "shard_batch", "shard_params",
]
