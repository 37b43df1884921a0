"""The parallel layer: a ``('dcn', 'ici')`` mesh of ``torch.distributed``
ranks, row-sharded tables with the all-to-all exchange, item-sharded
top-k, and the launchers.  Port of ``ncf_tpu/parallel/``; the modules say
how SPMD ranks stand in for one controller over a device mesh."""

from ncf_tpu_torch.parallel.embedding_sharding import (ShardedEmbedding,
                                                       exchange_lookup)
from ncf_tpu_torch.parallel.sharded_topk import (
    ShardedPreparedItems, ShardedPreparedItemsInt8, shard_items,
    shard_prepare_items, shard_prepare_items_int8,
    sharded_topk_scores, sharded_topk_scores_prepared)
from ncf_tpu_torch.parallel.multihost import (
    initialize_distributed,
    is_primary,
    local_batch_slice,
    mesh_shape_for_hosts,
    sync_hosts,
)
from ncf_tpu_torch.parallel.mesh import (
    DCN_AXIS,
    ICI_AXIS,
    Mesh,
    batch_sharding,
    gather_pytree,
    make_mesh,
    pad_rows,
    param_shardings,
    param_spec,
    replicated,
    shard_pytree,
    state_shardings,
    state_spec,
)

__all__ = [
    "ShardedEmbedding",
    "exchange_lookup",
    "initialize_distributed",
    "is_primary",
    "local_batch_slice",
    "mesh_shape_for_hosts",
    "sync_hosts",
    "DCN_AXIS",
    "ICI_AXIS",
    "Mesh",
    "make_mesh",
    "param_shardings",
    "param_spec",
    "state_shardings",
    "state_spec",
    "batch_sharding",
    "replicated",
    "shard_pytree",
    "gather_pytree",
    "pad_rows",
    "ShardedPreparedItems",
    "ShardedPreparedItemsInt8",
    "shard_items",
    "shard_prepare_items",
    "shard_prepare_items_int8",
    "sharded_topk_scores",
    "sharded_topk_scores_prepared",
]
