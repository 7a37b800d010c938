"""Mirrors ``src/repro/core/eviction_index.py`` verbatim (own copy).

Incremental eviction index: a lazy min-heap over policy eviction keys.

The seed implementation re-sorted every in-memory block on each eviction
batch (core) or re-scanned every pending request chain per victim (serve).
This index makes victim selection O(log n) amortized:

* membership mirrors the set of evictable blocks (one index per cache);
* each member has one valid heap entry ``(eviction_key, seq, block)``,
  identified by its globally-unique ``seq``;
* when a block's key *may* have changed, the entry is invalidated by
  pushing a fresh entry (new seq) — superseded entries are skipped (and
  discounted) on pop;
* key-change notifications come from two producers: the owning ``Policy``
  (recency/frequency updates via ``on_insert``/``on_access``) and the
  shared ``DagState`` (reference-count and group-completeness flips,
  which it already computes in O(degree) per event).

Victim selection is therefore a sequence of heap pops against *current*
counters: popping k victims is equivalent to taking the first k blocks of
a full sort under the same keys (keys are not mutated during a batch), and
when the caller applies state updates between pops (the serve path), each
pop reflects every earlier eviction — identical to the brute-force
per-victim re-scan it replaces.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .dag import BlockId, DagState

# compact the heap when stale entries outnumber live ones by this margin
_COMPACT_SLACK = 64


class EvictionIndex:
    """Lazy min-heap keyed by ``policy.eviction_key`` with
    invalidate-on-update semantics."""

    def __init__(self, policy, state: DagState) -> None:
        self.policy = policy
        self.state = state
        self._heap: List[Tuple] = []     # (key, seq, block)
        # membership: block -> seq of its single valid heap entry. The seq
        # is globally unique, so an entry left behind by a discard can
        # never be mistaken for a later re-add's entry.
        self._entry: Dict[BlockId, int] = {}
        self._seq = itertools.count()
        self._stale = 0
        policy.attach_index(self)
        state.add_key_listener(self._on_keys_changed)

    # ------------------------------------------------------------ membership
    def __contains__(self, block: BlockId) -> bool:
        return block in self._entry

    def __len__(self) -> int:
        return len(self._entry)

    def add(self, block: BlockId) -> None:
        """Start tracking ``block`` (idempotent: re-adding invalidates)."""
        if block in self._entry:
            self._stale += 1
        seq = next(self._seq)
        self._entry[block] = seq
        heapq.heappush(self._heap,
                       (self.policy.eviction_key(block, self.state),
                        seq, block))
        self._maybe_compact()

    def discard(self, block: BlockId) -> None:
        """Stop tracking ``block`` (its heap entries become stale)."""
        if self._entry.pop(block, None) is not None:
            self._stale += 1
            self._maybe_compact()

    def invalidate(self, block: BlockId) -> None:
        """Note that ``block``'s eviction key may have changed."""
        if block in self._entry:
            self.add(block)

    # ---------------------------------------------------------- notifications
    def _on_keys_changed(self, blocks: Optional[Iterable[BlockId]]) -> None:
        """DagState listener; ``None`` means "everything changed"."""
        if blocks is None:
            self.rebuild()
        else:
            for b in blocks:
                self.invalidate(b)

    def rebuild(self) -> None:
        """Recompute every member's key (after ``DagState.rebuild``)."""
        members = list(self._entry)
        self._heap = []
        self._entry = {}
        self._stale = 0
        for b in members:
            seq = next(self._seq)
            self._entry[b] = seq
            self._heap.append((self.policy.eviction_key(b, self.state),
                               seq, b))
        heapq.heapify(self._heap)

    def _maybe_compact(self) -> None:
        if self._stale > len(self._entry) + _COMPACT_SLACK:
            self.rebuild()

    # ----------------------------------------------------------------- query
    def pop_min(self, exclude: Optional[Set[BlockId]] = None
                ) -> Optional[BlockId]:
        """Remove and return the member with the smallest current key, or
        None if every member is excluded. Excluded members stay tracked."""
        exclude = exclude or ()
        stash: List[Tuple] = []
        victim: Optional[BlockId] = None
        while self._heap:
            entry = heapq.heappop(self._heap)
            key, seq, block = entry
            if self._entry.get(block) != seq:
                self._stale -= 1
                continue
            if block in exclude:
                stash.append(entry)
                continue
            del self._entry[block]
            victim = block
            break
        # excluded entries were still valid (nothing mutated keys between
        # pop and re-push): restore them verbatim, no recomputation
        for entry in stash:
            heapq.heappush(self._heap, entry)
        return victim

    def choose_victims(self, needed: int, sizes: Dict[BlockId, int],
                       pinned: Optional[Set[BlockId]] = None
                       ) -> List[BlockId]:
        """Pop victims until ``needed`` bytes are covered (or the index is
        exhausted). Victims leave the index; the caller evicts them."""
        pinned = pinned or set()
        victims: List[BlockId] = []
        freed = 0
        while freed < needed:
            b = self.pop_min(exclude=pinned)
            if b is None:
                break
            victims.append(b)
            freed += sizes[b]
        return victims
