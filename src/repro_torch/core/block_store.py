"""Mirrors ``src/repro/core/block_store.py`` verbatim (own copy).

Per-worker two-tier block store (memory cache + disk) and the
policy-driven cache manager.

The manager is the single mutation point for cache state: every insert /
access / evict flows through it so that (a) the ``DagState`` counters stay
exact, (b) metrics observe every access, and (c) the coordination layer
sees every completeness transition.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .dag import BlockId, DagState, JobDAG, TaskId
from .eviction_index import EvictionIndex
from .metrics import CacheMetrics
from .policies import Policy


@dataclass
class MemoryTier:
    capacity: int
    used: int = 0
    blocks: Dict[BlockId, int] = field(default_factory=dict)  # id -> bytes

    def __contains__(self, block: BlockId) -> bool:
        return block in self.blocks

    def put(self, block: BlockId, size: int) -> None:
        assert block not in self.blocks
        self.blocks[block] = size
        self.used += size

    def drop(self, block: BlockId) -> int:
        size = self.blocks.pop(block)
        self.used -= size
        return size

    @property
    def free(self) -> int:
        return self.capacity - self.used


@dataclass
class DiskTier:
    """Unbounded spill tier. In the simulator this is bandwidth-modelled; in
    ``repro.data`` it is a real directory of .npy files."""

    blocks: Dict[BlockId, int] = field(default_factory=dict)

    def __contains__(self, block: BlockId) -> bool:
        return block in self.blocks

    def put(self, block: BlockId, size: int) -> None:
        self.blocks[block] = size

    def drop(self, block: BlockId) -> None:
        self.blocks.pop(block, None)


class CacheManager:
    """Policy-pluggable cache manager for one logical cache.

    ``on_evict`` / ``on_load`` hooks let the embedding system (simulator,
    data pipeline, coordination protocol) observe transitions. ``pinned``
    blocks (inputs of currently-running tasks) are never evicted — matching
    Spark's unroll/pin semantics.
    """

    def __init__(self, capacity: int, policy: Policy, state: DagState,
                 metrics: Optional[CacheMetrics] = None,
                 on_evict: Optional[Callable[[BlockId, List[TaskId]], None]] = None,
                 on_load: Optional[Callable[[BlockId], None]] = None) -> None:
        self.mem = MemoryTier(capacity)
        self.disk = DiskTier()
        self.policy = policy
        self.state = state
        # incremental victim queue over this cache's in-memory blocks;
        # key invalidations flow in from the policy and the DagState
        self.index = EvictionIndex(policy, state)
        self.metrics = metrics or CacheMetrics()
        self.on_evict = on_evict
        self.on_load = on_load
        self.pinned: set = set()

    # ------------------------------------------------------------------ util
    def sizes(self) -> Dict[BlockId, int]:
        return self.mem.blocks

    def in_memory(self, block: BlockId) -> bool:
        return block in self.mem

    def pin(self, *blocks: BlockId) -> None:
        self.pinned.update(blocks)

    def unpin(self, *blocks: BlockId) -> None:
        self.pinned.difference_update(blocks)

    # ------------------------------------------------------------- mutations
    def _evict_for(self, needed: int) -> List[BlockId]:
        """Free at least ``needed`` bytes; returns victims in order."""
        if needed <= self.mem.free:
            return []
        victims = self.policy.choose_victims(
            list(self.mem.blocks), needed - self.mem.free,
            self.mem.blocks, self.state, pinned=self.pinned,
            index=self.index)
        for v in victims:
            self.evict(v)
        return victims

    def evict(self, block: BlockId) -> None:
        size = self.mem.drop(block)
        self.disk.put(block, size)
        self.index.discard(block)
        self.policy.on_remove(block)
        flipped_groups = self.state.on_evicted(block)
        self.metrics.evictions += 1
        if self.on_evict is not None:
            self.on_evict(block, flipped_groups)

    def insert(self, block: BlockId, size: int,
               materialized_now: bool = True) -> List[BlockId]:
        """Insert a newly materialized (or externally produced) block.

        Returns the victims evicted to make room. If the block is larger
        than the whole cache it goes straight to disk (Spark: unroll
        failure → disk store).
        """
        if block in self.mem:
            return []
        if size > self.mem.capacity:
            self.disk.put(block, size)
            if materialized_now:
                self.state.on_materialized(block, into_cache=False)
            return []
        victims = self._evict_for(size)
        self.mem.put(block, size)
        self.disk.drop(block)
        self.policy.on_insert(block)
        if materialized_now:
            self.state.on_materialized(block, into_cache=True)
        else:
            self.state.on_loaded(block)
        # index last: the key is computed against fully-updated counters
        self.index.add(block)
        return victims

    def load_from_disk(self, block: BlockId) -> List[BlockId]:
        """Promote a spilled block back into memory (after a miss)."""
        assert block in self.disk
        size = self.disk.blocks[block]
        victims = self.insert(block, size, materialized_now=False)
        if self.on_load is not None:
            self.on_load(block)
        return victims

    # ------------------------------------------------------------ task-level
    def access_task_inputs(self, task: TaskId) -> Dict[BlockId, bool]:
        """Record the cache accesses a task makes when it starts.

        Effectiveness is judged *at access time* against the whole peer
        group (paper Def. 1): a hit on ``b`` is effective iff every
        materialized peer of the task is in memory.

        Returns {block: was_hit}.
        """
        spec = self.state.dag.tasks[task]
        materialized_peers = [b for b in spec.inputs if b in self.state.materialized]
        all_peers_cached = all(b in self.mem for b in materialized_peers)
        # ineffective-hit attribution: where the first blocking peer sits
        # (on disk a load would complete the group; absent it must be
        # recomputed — "evicted" vs "never_cached" is not distinguishable
        # from MemoryTier/DiskTier membership alone, so absent blocks that
        # were never spilled attribute to the recompute bucket)
        cause = None
        if not all_peers_cached:
            blocker = next(b for b in materialized_peers if b not in self.mem)
            cause = "disk" if blocker in self.disk else "never_cached"
        hits: Dict[BlockId, bool] = {}
        for b in materialized_peers:
            hit = b in self.mem
            hits[b] = hit
            self.policy.on_access(b)
            self.metrics.record_access(hit=hit,
                                       effective=hit and all_peers_cached,
                                       cause=cause)
        return hits
