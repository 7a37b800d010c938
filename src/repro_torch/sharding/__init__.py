"""repro_torch.sharding — the logical-axis partition rules and their
lowering onto a ``DeviceMesh`` as DTensor placements (``MeshContext``),
the differentiable collectives of the mesh path's local regions, and the
serve plane's tensor parallelism on ``torch.distributed`` (``KVShardCtx``,
``serve_tp_context``); mirrors ``src/repro/sharding``."""
from .rules import (LOGICAL_RULES, KVShardCtx, MeshContext, PartitionSpec,
                    all_max, copy_to_group, local_context, rank_dir,
                    reduce_from_group, serve_tp_context)

__all__ = ["LOGICAL_RULES", "KVShardCtx", "MeshContext", "PartitionSpec",
           "all_max", "copy_to_group", "local_context", "rank_dir",
           "reduce_from_group", "serve_tp_context"]
