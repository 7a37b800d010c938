"""repro_torch.sharding — the logical-axis partition rules
(``MeshContext``'s, over a mesh's axis sizes) and the serve plane's tensor
parallelism on ``torch.distributed`` (``KVShardCtx``,
``serve_tp_context``); mirrors ``src/repro/sharding``."""
from .rules import (LOGICAL_RULES, KVShardCtx, MeshContext, PartitionSpec,
                    local_context, rank_dir, serve_tp_context)

__all__ = ["LOGICAL_RULES", "KVShardCtx", "MeshContext", "PartitionSpec",
           "local_context", "rank_dir", "serve_tp_context"]
