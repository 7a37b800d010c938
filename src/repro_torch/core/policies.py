"""Mirrors ``src/repro/core/policies.py`` verbatim (own copy).

Cache replacement policies.

Recency/frequency policies (LRU, LFU, MRU, FIFO, LRFU) are DAG-oblivious;
LRC is DAG-aware (paper [10]); LERC (this paper) is DAG- and peer-aware;
Sticky is the paper's strawman (§III-A); Belady is the clairvoyant lower
bound used by the simulator for headroom analysis.

A policy ranks the *eviction preference* of in-memory blocks. The cache
manager asks for victims until enough bytes are free. All policies are
deterministic given their tiebreaks (insertion counter); LRC optionally
breaks ties uniformly at random, matching the paper's §II-C analysis of
wrong-block probability.
"""
from __future__ import annotations

import random
from abc import ABC, abstractmethod
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from .dag import BlockId, DagState


class Policy(ABC):
    """Ranks in-memory blocks for eviction. Lower key = evicted first.

    The coordination plane reads two protocol-level traits: ``uses_dag``
    (the policy's key reads lineage reference counts, so workers need the
    peer-information profile broadcast) and ``uses_completeness`` (the key
    reads peer-group completeness labels, so workers additionally run the
    paper's eviction report/broadcast protocol). DAG-oblivious policies
    ship neither — that difference is the measured LERC overhead.
    """

    name: str = "abstract"
    uses_dag: bool = False
    uses_completeness: bool = False

    def __init__(self) -> None:
        self._clock = 0
        self._last_access: Dict[BlockId, int] = {}
        self._freq: Dict[BlockId, int] = {}
        self._inserted_at: Dict[BlockId, int] = {}
        self._indexes: List = []      # EvictionIndexes fed by this policy

    # ----------------------------------------------------------------- index
    def attach_index(self, index) -> None:
        self._indexes.append(index)

    def _touch(self, block: BlockId) -> None:
        """This policy's own key inputs for ``block`` changed."""
        for index in self._indexes:
            index.invalidate(block)

    # ------------------------------------------------------------- lifecycle
    def on_insert(self, block: BlockId) -> None:
        self._clock += 1
        self._inserted_at[block] = self._clock
        self._last_access[block] = self._clock
        self._freq[block] = self._freq.get(block, 0)
        self._touch(block)

    def on_access(self, block: BlockId) -> None:
        self._clock += 1
        self._last_access[block] = self._clock
        self._freq[block] = self._freq.get(block, 0) + 1
        self._touch(block)

    def on_remove(self, block: BlockId) -> None:
        self._inserted_at.pop(block, None)

    # ------------------------------------------------------------------ rank
    @abstractmethod
    def eviction_key(self, block: BlockId, state: DagState):
        """Sort key: blocks with the smallest key are evicted first."""

    def choose_victims(self, candidates: Iterable[BlockId], needed: int,
                       sizes: Dict[BlockId, int], state: DagState,
                       pinned: Optional[set] = None,
                       index=None) -> List[BlockId]:
        """Victims covering ``needed`` bytes, best-first.

        With an ``EvictionIndex`` this is O(victims · log n); the sorted
        full scan remains as the index-less fallback (and as the oracle the
        property tests compare against).
        """
        if index is not None:
            return index.choose_victims(needed, sizes, pinned)
        pinned = pinned or set()
        ranked = sorted((b for b in candidates if b not in pinned),
                        key=lambda b: self.eviction_key(b, state))
        victims, freed = [], 0
        for b in ranked:
            if freed >= needed:
                break
            victims.append(b)
            freed += sizes[b]
        return victims


class LRU(Policy):
    name = "lru"

    def eviction_key(self, block: BlockId, state: DagState):
        return self._last_access.get(block, 0)


class MRU(Policy):
    name = "mru"

    def eviction_key(self, block: BlockId, state: DagState):
        return -self._last_access.get(block, 0)


class FIFO(Policy):
    name = "fifo"

    def eviction_key(self, block: BlockId, state: DagState):
        return self._inserted_at.get(block, 0)


class LFU(Policy):
    name = "lfu"

    def eviction_key(self, block: BlockId, state: DagState):
        return (self._freq.get(block, 0), self._last_access.get(block, 0))


class LRC(Policy):
    """Least Reference Count (paper [10]): evict the block with the fewest
    unmaterialized dependents. Ties: random (paper §II-C) or LRU."""

    name = "lrc"
    uses_dag = True

    def __init__(self, tiebreak: str = "lru", seed: int = 0) -> None:
        super().__init__()
        assert tiebreak in ("lru", "random")
        self.tiebreak = tiebreak
        self._rng = random.Random(seed)

    def eviction_key(self, block: BlockId, state: DagState):
        rc = state.ref_count.get(block, 0)
        if self.tiebreak == "random":
            return (rc, self._rng.random())
        return (rc, self._last_access.get(block, 0))


class LERC(Policy):
    """Least Effective Reference Count (THE paper's policy, §III-B).

    Evict the in-memory block with the smallest effective reference count —
    the number of unmaterialized dependents whose peer groups are entirely
    cached. Ties are broken by plain reference count (a block that speeds up
    nothing *now* may still be one peer-load away from usefulness), then by
    recency (LRU).
    """

    name = "lerc"
    uses_dag = True
    uses_completeness = True

    def eviction_key(self, block: BlockId, state: DagState):
        return (state.eff_ref_count.get(block, 0),
                state.ref_count.get(block, 0),
                self._last_access.get(block, 0))


class Sticky(Policy):
    """The paper's naive strawman (§III-A): peer groups stick together — if
    any peer of a group is uncached, the remaining members are eviction
    candidates of the lowest class, *regardless* of their other references.
    Inefficient when a block is shared across tasks (the paper's argument
    for LERC); kept as a baseline.
    """

    name = "sticky"
    uses_dag = True
    uses_completeness = True

    def eviction_key(self, block: BlockId, state: DagState):
        dag = state.dag
        in_broken_group = any(
            state.task_live(t) and not state.group_complete(t)
            for t in dag.consumers.get(block, []))
        live_refs = state.ref_count.get(block, 0)
        # broken-group members first; then fewest refs; then LRU
        return (0 if in_broken_group else 1, live_refs,
                self._last_access.get(block, 0))


class Belady(Policy):
    """Clairvoyant MIN/OPT: evict the block whose next access is farthest in
    the future. Requires the future access trace (the simulator provides
    it); blocks with no future access are evicted first.
    """

    name = "belady"

    def __init__(self) -> None:
        super().__init__()
        self._future: Dict[BlockId, Deque[int]] = {}
        self._cursor = 0

    def set_trace(self, trace: List[BlockId]) -> None:
        stale = set(self._future)        # keys from any previous trace
        self._future = {}
        for i, b in enumerate(trace):
            self._future.setdefault(b, deque()).append(i)
        self._cursor = 0
        for b in stale | set(self._future):
            self._touch(b)

    def advance(self, block: BlockId) -> None:
        """Consume one access of ``block`` from the trace."""
        self._cursor += 1
        accesses = self._future.get(block)
        if accesses:
            accesses.popleft()
            self._touch(block)

    def eviction_key(self, block: BlockId, state: DagState):
        accesses = self._future.get(block, [])
        nxt = accesses[0] if accesses else float("inf")
        return -nxt if nxt != float("inf") else float("-inf")


POLICIES = {
    "lru": LRU,
    "mru": MRU,
    "fifo": FIFO,
    "lfu": LFU,
    "lrc": LRC,
    "lerc": LERC,
    "sticky": Sticky,
    "belady": Belady,
}


def make_policy(name: str, **kwargs) -> Policy:
    try:
        return POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
