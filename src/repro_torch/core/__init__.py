"""repro_torch.core — own copy of ``repro.core``, the paper's contribution:
DAG-aware, peer-coordinated cache management (LERC) with
effective-cache-hit-ratio accounting. Every module here is a verbatim copy
of its original."""
from .dag import BlockId, BlockMeta, DagState, JobDAG, TaskId, TaskSpec, fresh_id
from .block_store import CacheManager, DiskTier, MemoryTier
from .eviction_index import EvictionIndex
from .coordination import (MessageBus, PeerTracker, PeerTrackerMaster,
                           build_cluster)
from .metrics import CacheMetrics, MessageStats
from .policies import (LERC, LFU, LRC, LRU, MRU, FIFO, Belady, Policy,
                       Sticky, POLICIES, make_policy)

__all__ = [
    "BlockId", "BlockMeta", "DagState", "JobDAG", "TaskId", "TaskSpec",
    "fresh_id", "CacheManager", "DiskTier", "MemoryTier", "EvictionIndex",
    "MessageBus",
    "PeerTracker", "PeerTrackerMaster", "build_cluster", "CacheMetrics",
    "MessageStats", "LERC", "LFU", "LRC", "LRU", "MRU", "FIFO", "Belady",
    "Policy", "Sticky", "POLICIES", "make_policy",
]
