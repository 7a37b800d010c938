"""Mirrors ``src/repro/serve/reference.py`` verbatim (own copy).

Brute-force reference PrefixStore — the retained oracle.

This keeps the seed implementation's *algorithm*: on **every** eviction it
re-walks the whole radix tree for resident nodes and re-derives reference
/ effective-reference counts from **all** pending request chains, then
min-scans for the victim — O(requests × depth + resident) per victim. The
counter *semantics* are the unified chain→peer-group adapter's (depth-
weighted, see below), not the seed's chain-count form, so that the oracle
and the incremental ``PrefixStore`` rank identically by construction.
``tests/test_prefix_oracle.py`` proves both make *identical* eviction
decisions, and ``benchmarks/eviction_scaling.py`` measures the asymptotic
gap between recompute-per-victim and the incremental index.

The counters use the chain→peer-group adapter semantics (one peer group
per pending-chain prefix), computed from scratch:

* ``rc[b]``  = Σ over pending chains containing b at position j of
  (chain length − j)   — one reference per prefix at or below b;
* ``erc[b]`` = the same sum restricted to prefixes that are fully
  resident.

Clock discipline mirrors ``core.policies.Policy`` exactly (one tick per
per-block insert/access, in chain order), so tiebreaks are identical.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

from ..core import CacheMetrics
from .prefix_store import Node, TokenBlock, blocking_cause


class ReferencePrefixStore:
    """Same external behavior as ``PrefixStore`` (for lru/lrc/lerc), via
    full recomputation per victim instead of the incremental index."""

    def __init__(self, capacity_bytes: int, policy: str = "lerc",
                 block_tokens: int = 16) -> None:
        assert policy in ("lru", "lrc", "lerc"), \
            "the brute-force oracle covers the seed's three policies"
        self.capacity = capacity_bytes
        self.policy_name = policy
        self.block_tokens = block_tokens
        self.root = Node(key=(), parent=None, resident=True)
        self.used = 0
        self._uids = itertools.count(1)
        self._req_ids = itertools.count(1)
        self._clock = 0
        self._last_access: Dict[str, int] = {}
        self._pending: Dict[int, List[Node]] = {}
        self.metrics_obj = CacheMetrics()
        self.eviction_log: List[str] = []

    # ------------------------------------------------------------ structure
    def _blocks(self, tokens: Sequence[int]) -> List[TokenBlock]:
        bt = self.block_tokens
        return [tuple(tokens[i:i + bt])
                for i in range(0, len(tokens) - len(tokens) % bt, bt)]

    def _walk(self, tokens: Sequence[int], create: bool = False
              ) -> List[Node]:
        chain: List[Node] = []
        node = self.root
        for key in self._blocks(tokens):
            child = node.children.get(key)
            if child is None:
                if not create:
                    break
                child = Node(key=key, parent=node, uid=next(self._uids))
                node.children[key] = child
            chain.append(child)
            node = child
        return chain

    # ------------------------------------------------------------- requests
    def register_request(self, tokens: Sequence[int]) -> int:
        rid = next(self._req_ids)
        self._pending[rid] = self._walk(tokens, create=True)
        return rid

    def complete_request(self, rid: int) -> None:
        chain = self._pending.pop(rid, None)
        if chain:
            self._prune_chain(chain)

    def _prune_chain(self, chain: List[Node]) -> None:
        """Skeleton GC, brute-force form: a node is referenced iff it
        appears in ANY pending chain (rc > 0 in the incremental store ⟺
        membership here, since every position at or below contributes).
        Must prune exactly the nodes ``PrefixStore`` prunes so that uid
        assignment — and hence eviction logs — stay comparable."""
        referenced = {n.block_id for c in self._pending.values() for n in c}
        for node in reversed(chain):
            if (node.resident or node.children
                    or node.block_id in referenced):
                break
            node.parent.children.pop(node.key, None)
            self._last_access.pop(node.block_id, None)
            node.parent = None

    # ---------------------------------------------------------------- reads
    def lookup(self, tokens: Sequence[int]) -> List[Node]:
        chain = self._walk(tokens)
        usable: List[Node] = []
        touched: List[Node] = []
        broken = False
        cause = None          # first gap's whereabouts, as in PrefixStore
        for node in chain:
            hit = node.resident
            if not hit:
                broken = True
                if cause is None:
                    cause = blocking_cause(node)
            self.metrics_obj.record_access(hit=hit,
                                           effective=hit and not broken,
                                           cause=cause)
            if hit:
                if not broken:
                    usable.append(node)
                touched.append(node)
        for node in reversed(touched):            # leaf first, root last
            self._clock += 1
            self._last_access[node.block_id] = self._clock
        return usable

    # --------------------------------------------------------------- writes
    def insert(self, tokens: Sequence[int],
               payloads: Union[List[Any], Callable[[int, Node], Any]],
               nbytes_per_block: int) -> None:
        chain = self._walk(tokens, create=True)
        exclude = {n.block_id for n in chain}
        fresh: List[Node] = []
        if not callable(payloads):
            chain = chain[:len(payloads)]
        for i, node in enumerate(chain):
            if node.resident:
                continue
            self._make_room(nbytes_per_block, exclude=exclude)
            node.payload = (payloads(i, node) if callable(payloads)
                            else payloads[i])
            node.nbytes = nbytes_per_block
            node.resident = True
            node.ever_resident = True
            self.used += nbytes_per_block
            fresh.append(node)
        for node in reversed(fresh):              # leaf first, root last
            self._clock += 1
            self._last_access[node.block_id] = self._clock

    # -------------------------------------------------------------- counts
    def _ref_counts(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """From-scratch (rc, erc) over every pending chain — the seed's
        per-eviction recomputation."""
        rc: Dict[str, int] = {}
        erc: Dict[str, int] = {}
        for chain in self._pending.values():
            k = len(chain)
            # last position whose whole prefix is resident (-1 if none)
            last_complete = -1
            for i, node in enumerate(chain):
                if not node.resident:
                    break
                last_complete = i
            for j, node in enumerate(chain):
                b = node.block_id
                rc[b] = rc.get(b, 0) + (k - j)
                if j <= last_complete:
                    erc[b] = erc.get(b, 0) + (last_complete - j + 1)
        return rc, erc

    def _resident_nodes(self) -> List[Node]:
        out: List[Node] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and n.resident:
                out.append(n)
        return out

    def _make_room(self, needed: int, exclude: set) -> None:
        while self.used + needed > self.capacity:
            victims = [n for n in self._resident_nodes()
                       if n.block_id not in exclude]
            if not victims:
                return
            rc, erc = self._ref_counts()
            la = self._last_access
            if self.policy_name == "lru":
                key = lambda n: la.get(n.block_id, 0)
            elif self.policy_name == "lrc":
                key = lambda n: (rc.get(n.block_id, 0),
                                 la.get(n.block_id, 0))
            else:  # lerc
                key = lambda n: (erc.get(n.block_id, 0),
                                 rc.get(n.block_id, 0),
                                 la.get(n.block_id, 0))
            self._evict(min(victims, key=key))

    def _evict(self, node: Node) -> None:
        node.resident = False
        node.payload = None
        self.used -= node.nbytes
        node.nbytes = 0
        self.metrics_obj.evictions += 1
        self.eviction_log.append(node.block_id)

    # -------------------------------------------------------------- metrics
    @property
    def evictions(self) -> int:
        return self.metrics_obj.evictions

    def metrics(self) -> Dict[str, float]:
        self.metrics_obj.check_attribution()
        return {**self.metrics_obj.as_dict(), "used_bytes": self.used}
