"""repro_torch.core — own copy of the pure-Python substrate of
``repro.core`` that ``serve.PrefixStore`` needs: the lineage DAG and its
incremental counters, the eviction index, the policies and the metrics."""
from .dag import BlockId, BlockMeta, DagState, JobDAG, TaskId, TaskSpec, fresh_id
from .eviction_index import EvictionIndex
from .metrics import CacheMetrics, MessageStats
from .policies import (LERC, LFU, LRC, LRU, MRU, FIFO, Belady, Policy,
                       Sticky, POLICIES, make_policy)

__all__ = [
    "BlockId", "BlockMeta", "DagState", "JobDAG", "TaskId", "TaskSpec",
    "fresh_id", "EvictionIndex", "CacheMetrics", "MessageStats", "LERC",
    "LFU", "LRC", "LRU", "MRU", "FIFO", "Belady", "Policy", "Sticky",
    "POLICIES", "make_policy",
]
