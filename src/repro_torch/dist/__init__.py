"""Distribution layer: mesh registry, partition-spec vocabulary and the
sharded kernels, on ``torch.distributed``.

``repro_torch.dist.mesh`` owns the current-mesh registry and the process
groups of a mesh; ``repro_torch.dist.sharding`` defines the partition-spec
contract for every workload family (LM params/caches, recsys embedding
tables, MPE packed serving tables) and the in-model helpers
(``maybe_shard``/``shard_batch_dim``), identities in eager SPMD;
``repro_torch.dist.shard`` runs the hand-written kernels and the train
step on the mesh, each wrapper a local body between collectives whose
placements derive from the same contract.
"""
from repro_torch.dist.mesh import (current_mesh, host_mesh, make_device_mesh,
                                   parse_mesh_flag, use_mesh)
from repro_torch.dist.shard import (sharded_embedding_bag,
                                    sharded_flash_attention,
                                    sharded_mixed_expectation,
                                    sharded_packed_lookup,
                                    sharded_tiered_hot_lookup,
                                    sharded_value_and_grad)
from repro_torch.dist.sharding import (cell_shardings, current_dp_axes,
                                       dp_axes, lm_batch_pspecs,
                                       lm_cache_pspecs, lm_kv_cache_pspecs,
                                       lm_param_pspecs, maybe_shard,
                                       packed_serve_pspecs,
                                       packed_table_pspecs,
                                       recsys_table_pspecs, replicate_like,
                                       shard_batch_dim, tiered_hot_pspecs,
                                       tree_named_shardings)

__all__ = [
    "use_mesh", "current_mesh", "make_device_mesh", "host_mesh",
    "parse_mesh_flag",
    "dp_axes", "current_dp_axes", "maybe_shard", "shard_batch_dim",
    "tree_named_shardings", "replicate_like", "cell_shardings",
    "lm_batch_pspecs", "lm_cache_pspecs", "lm_kv_cache_pspecs",
    "lm_param_pspecs", "recsys_table_pspecs", "packed_table_pspecs",
    "packed_serve_pspecs", "tiered_hot_pspecs",
    "sharded_packed_lookup", "sharded_tiered_hot_lookup",
    "sharded_embedding_bag", "sharded_flash_attention",
    "sharded_mixed_expectation", "sharded_value_and_grad",
]
