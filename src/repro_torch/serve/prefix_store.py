"""Mirrors ``src/repro/serve/prefix_store.py`` verbatim (own copy).

Radix prefix cache with DAG-aware eviction — the paper's idea, 8 years
later, running on the paper's own machinery.

A served request hits the KV prefix cache only if **every** block along
its prefix chain is resident: a resident block whose ancestor was evicted
is useless (prefill must restart at the first gap). That is precisely the
paper's all-or-nothing property with peer groups generalized to *chains*,
and this store is now a thin client of the same incremental substrate the
batch layer uses (``core.DagState`` + ``core.EvictionIndex``), instead of
re-deriving reference counts from scratch on every eviction.

The chain→peer-group adapter: a pending request r with chain n1→…→nk
contributes one *task* per chain position i, whose peer group is the
ancestor set {n1…ni} and whose (virtual) output is never materialized
while r is pending. Under the paper's Definitions this yields, per the
shared incremental counters:

* ``ref_count[b]``     = Σ over pending chains of the positions at or
  below b — a *depth-weighted* reference count (an ancestor is worth at
  least as much as any of its descendants);
* ``eff_ref_count[b]`` = the same sum restricted to positions whose whole
  prefix is resident (Def. 2, chain form).

The old "deepest-first on ties" rule survives in two parts: while a chain
is referenced, depth-weighting orders it automatically (a leaf's (erc, rc)
is ≤ its parent's on the same chain); once a chain has no pending
references, the leaf→root clock stamping in ``lookup``/``insert`` makes
recency ties evict leaves before ancestors. Either way, evicting a victim
never orphans resident descendants.

Every ``core`` policy (lru/mru/fifo/lfu/lrc/lerc/sticky/belady) is
available via ``make_policy``; metrics are ``core.metrics.CacheMetrics``.
Victim selection is O(log n) heap pops against incrementally-maintained
counters; the retained brute-force oracle lives in ``serve.reference`` and
the equivalence tests prove identical eviction decisions.

Payloads are opaque to the store. The pooled engine stores *indices into a
device-resident KV block pool* (``serve.kv_pool``) so eviction is O(1)
index-freeing with zero copies; the legacy host-payload engine stores
per-block KV arrays. ``insert`` optionally takes a payload *factory*
(called only for blocks that actually become resident, after room has
been made), and ``evict_payload`` lets the pool reclaim a victim's block
index the moment it is evicted.

Skeleton GC: ``complete_request`` prunes chain nodes that are neither
resident nor referenced by any pending request, removing their DAG blocks
and counter entries — under sustained traffic the radix tree tracks the
live working set instead of growing with request history.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from ..core import (BlockMeta, CacheMetrics, DagState, EvictionIndex,
                    JobDAG, Policy, TaskSpec, make_policy)
from ..obs.trace import TID_STORE as _TID_STORE

TokenBlock = Tuple[int, ...]


@dataclass
class Node:
    key: TokenBlock                      # the tokens of this block
    parent: Optional["Node"]
    payload: Any = None                  # per-layer KV arrays (host)
    nbytes: int = 0
    resident: bool = False               # in the FAST tier (device pool)
    # slow-tier payloads (serve.TieredKVStore: a HostBlockPool row / a
    # DiskBlockPool row). Always None in a plain single-tier store; a node
    # holds at most one tier.
    host_payload: Any = None
    disk_payload: Any = None
    # has this node EVER held a fast-tier payload? Distinguishes an
    # "evicted" gap (the policy killed it) from a "never_cached" one
    # (cold chain) when attributing ineffective hits.
    ever_resident: bool = False
    children: Dict[TokenBlock, "Node"] = field(default_factory=dict)
    uid: int = 0

    @property
    def block_id(self) -> str:
        return f"n{self.uid}"


def blocking_cause(node: Node) -> str:
    """Where a non-tier-0 chain node currently sits — the attribution
    bucket charged to every ineffective hit it blocks (the first such
    node on a chain is the one the whole suffix waits on)."""
    if node.host_payload is not None:
        return "host"
    if node.disk_payload is not None:
        return "disk"
    return "evicted" if node.ever_resident else "never_cached"


class PrefixStore:
    def __init__(self, capacity_bytes: int,
                 policy: Union[str, Policy] = "lerc",
                 block_tokens: int = 16) -> None:
        self.capacity = capacity_bytes
        self.block_tokens = block_tokens
        # called with a victim's payload on eviction (pool index reclaim)
        self.evict_payload: Optional[Callable[[Any], None]] = None
        # coordination-plane hooks (serve.ShardedFrontend): every store
        # event a peer replica must see, fired inline so the cross-shard
        # event order is exactly the local one.
        #   on_evict(block_id, flipped_groups)  — after each eviction
        #   on_status(event, ident)             — "loaded" / "task_removed"
        #                                         / "forget_block"
        self.on_evict: Optional[Callable[[str, List[str]], None]] = None
        self.on_status: Optional[Callable[[str, str], None]] = None
        # obs: an attached ``repro.obs.TraceRecorder`` (None = every
        # instrumentation site is one predicate — bit-identical behavior)
        self.trace = None
        self.trace_pid = 0
        self.root = Node(key=(), parent=None, resident=True)
        self.used = 0
        self._uids = itertools.count(1)
        self._req_ids = itertools.count(1)
        # the shared substrate: chain nodes are blocks, pending-request
        # prefixes are peer groups, counters update in O(degree) per event
        self.dag = JobDAG()
        self.state = DagState(self.dag)
        self.policy = policy if isinstance(policy, Policy) \
            else make_policy(policy)
        self.index = EvictionIndex(self.policy, self.state)
        self.metrics_obj = CacheMetrics()
        self._nodes: Dict[str, Node] = {}          # block id -> node
        # outstanding (queued/admitted-not-yet-prefilled) request chains
        self._pending: Dict[int, List[Node]] = {}
        self._req_tasks: Dict[int, List[str]] = {}  # rid -> task ids
        self.eviction_log: List[str] = []           # block ids, in order

    # ------------------------------------------------------------ structure
    def _blocks(self, tokens: Sequence[int]) -> List[TokenBlock]:
        bt = self.block_tokens
        return [tuple(tokens[i:i + bt])
                for i in range(0, len(tokens) - len(tokens) % bt, bt)]

    def _walk(self, tokens: Sequence[int], create: bool = False
              ) -> List[Node]:
        """Nodes along the chain for ``tokens`` (existing, or created
        skeleton nodes when ``create``)."""
        chain: List[Node] = []
        node = self.root
        for key in self._blocks(tokens):
            child = node.children.get(key)
            if child is None:
                if not create:
                    break
                child = Node(key=key, parent=node, uid=next(self._uids))
                node.children[key] = child
                # a chain node is always "materialized" (recomputable by
                # prefill); it is cached only while resident
                self.dag.add_block(BlockMeta(id=child.block_id, size=0,
                                             dataset="kv", index=child.uid))
                self.state.on_materialized(child.block_id, into_cache=False)
                self._nodes[child.block_id] = child
            chain.append(child)
            node = child
        return chain

    # ------------------------------------------------------------- requests
    def register_request(self, tokens: Sequence[int]) -> int:
        """Announce a request (queued). Each prefix of its chain becomes a
        live peer group until ``complete_request``. Returns a request id."""
        rid = next(self._req_ids)
        chain = self._walk(tokens, create=True)
        self._pending[rid] = chain
        tids: List[str] = []
        job = f"req{rid}"
        for i in range(len(chain)):
            tid = f"{job}.{i}"
            out = f"out:{tid}"
            self.dag.add_block(BlockMeta(id=out, size=0, dataset="req",
                                         index=i))
            self.dag.add_task(TaskSpec(
                id=tid, inputs=tuple(n.block_id for n in chain[:i + 1]),
                output=out, job=job))
            self.state.on_task_added(tid)
            tids.append(tid)
        self._req_tasks[rid] = tids
        return rid

    def request_profile(self, rid: int) -> Tuple[List[Node], List[TaskSpec]]:
        """The peer-information profile of a registered request: its chain
        nodes and the per-position peer-group tasks. This is what the
        coordination plane broadcasts when the store is one shard of a
        ``serve.ShardedFrontend``."""
        chain = self._pending[rid]
        tasks = [self.dag.tasks[tid] for tid in self._req_tasks[rid]]
        return chain, tasks

    def complete_request(self, rid: int) -> None:
        """Retire a request: its chain's references leave the counters, its
        peer-group tasks are garbage-collected from the DAG, and chain
        nodes left with no residency and no references are pruned."""
        for tid in self._req_tasks.pop(rid, []):
            self.state.on_task_removed(tid)
            self.dag.remove_task(tid, remove_output=True)
            if self.on_status is not None:
                self.on_status("task_removed", tid)
        chain = self._pending.pop(rid, None)
        if chain:
            self._prune_chain(chain)

    def _prune_chain(self, chain: List[Node]) -> None:
        """Leaf→root GC of a retired chain: a node is garbage iff it is
        non-resident, childless, and carries no pending references
        (``ref_count == 0``). Depth-weighted counts are non-increasing with
        depth and a kept child keeps its parent, so the first kept node
        ends the walk."""
        for node in reversed(chain):
            if not self._is_garbage(node):
                break
            self._forget_node(node)

    def _is_garbage(self, node: Node) -> bool:
        """A skeleton node with nothing keeping it alive: not resident in
        any tier, childless, and free of pending references."""
        return (not node.resident and node.host_payload is None
                and node.disk_payload is None
                and not node.children
                and self.state.ref_count.get(node.block_id, 0) == 0)

    def _forget_node(self, node: Node) -> None:
        """Drop one garbage skeleton node (non-resident, childless,
        unreferenced): unlink it, erase its DAG block + counters, and
        announce the GC on the status channel."""
        node.parent.children.pop(node.key, None)
        self._nodes.pop(node.block_id, None)
        self.index.discard(node.block_id)
        self.state.forget_block(node.block_id)
        self.dag.remove_block(node.block_id)
        node.parent = None
        if self.on_status is not None:
            self.on_status("forget_block", node.block_id)

    # ---------------------------------------------------------------- reads
    def lookup(self, tokens: Sequence[int]) -> List[Node]:
        """Longest fully-resident chain from the root (the usable prefix).
        Records per-block hit/effective-hit metrics along the way.

        Policy clocks are stamped leaf→root, so within one lookup an
        ancestor is always *more* recent than its descendants: recency
        ties evict leaves before ancestors (the seed's deepest-first rule,
        now expressed through the shared policy clocks — evicting a leaf
        never orphans resident descendants)."""
        chain = self._walk(tokens)
        usable: List[Node] = []
        touched: List[Node] = []
        broken = False
        cause = None          # first gap's location: the blocking block
        blocking = [] if self.trace is not None else None
        ineff: Dict[str, int] = {}
        for node in chain:
            hit = node.resident
            if not hit:
                broken = True
                if cause is None:
                    cause = blocking_cause(node)
                if blocking is not None:
                    blocking.append((node.uid, blocking_cause(node)))
            self.metrics_obj.record_access(hit=hit,
                                           effective=hit and not broken,
                                           cause=cause)
            if hit:
                if not broken:
                    usable.append(node)
                else:
                    ineff[cause] = ineff.get(cause, 0) + 1
                touched.append(node)
        for node in reversed(touched):            # leaf first, root last
            self.policy.on_access(node.block_id)
        if self.trace is not None:
            self.trace.instant(
                "store.lookup", "store", self.trace_pid, _TID_STORE,
                args={"blocks": len(chain), "usable": len(usable),
                      "broken": broken, "blocking": blocking,
                      "ineffective": ineff})
        return usable

    # --------------------------------------------------------------- writes
    def insert(self, tokens: Sequence[int],
               payloads: Union[List[Any], Callable[[int, Node], Any]],
               nbytes_per_block: int) -> None:
        """Store KV payloads for the chain of ``tokens`` (post-prefill).
        ``payloads`` is either one payload per chain position, or a factory
        ``(position, node) -> payload`` invoked only for blocks that become
        resident — *after* room has been made, so a pool-backed factory
        allocates from indices the evictions just freed.
        Recency/insertion clocks are stamped leaf→root (see ``lookup``)."""
        chain = self._walk(tokens, create=True)
        exclude = {n.block_id for n in chain}
        fresh: List[Node] = []
        if not callable(payloads):
            chain = chain[:len(payloads)]
        for i, node in enumerate(chain):
            if node.resident:
                continue
            self._pre_insert(node)
            self._make_room(nbytes_per_block, exclude=exclude)
            node.payload = (payloads(i, node) if callable(payloads)
                            else payloads[i])
            node.nbytes = nbytes_per_block
            node.resident = True
            node.ever_resident = True
            self.used += nbytes_per_block
            self.state.on_loaded(node.block_id)   # flips prefixes complete
            self.index.add(node.block_id)
            fresh.append(node)
            if self.on_status is not None:
                self.on_status("loaded", node.block_id)
        for node in reversed(fresh):              # leaf first, root last
            self.policy.on_insert(node.block_id)
        if self.trace is not None and fresh:
            self.trace.instant(
                "store.insert", "store", self.trace_pid, _TID_STORE,
                args={"blocks": [n.uid for n in fresh],
                      "nbytes_per_block": nbytes_per_block})

    def _pre_insert(self, node: Node) -> None:
        """Hook: ``node`` (non-resident) is about to be (re)inserted.
        Tiered stores release a superseded slow-tier copy here."""

    # ------------------------------------------------------------- eviction
    def _make_room(self, needed: int, exclude: set) -> None:
        """Pop victims off the index until ``needed`` bytes fit. Each pop
        is O(log n); the state update after each eviction re-keys exactly
        the blocks whose prefixes it broke, so the next pop already sees
        the flip (the per-victim semantics of the paper's protocol)."""
        while self.used + needed > self.capacity:
            victim = self.index.pop_min(exclude=exclude)
            if victim is None:
                return
            self._evict(self._nodes[victim])

    def _evict(self, node: Node) -> None:
        if self.trace is not None:
            # the policy's eviction key at decision time, before the state
            # update invalidates it
            self.trace.instant(
                "store.evict", "store", self.trace_pid, _TID_STORE,
                args={"uid": node.uid, "block": node.block_id, "tier": 0,
                      "key": str(self.policy.eviction_key(node.block_id,
                                                          self.state))})
        node.resident = False
        if self.evict_payload is not None and node.payload is not None:
            self.evict_payload(node.payload)
        node.payload = None
        self.used -= node.nbytes
        node.nbytes = 0
        self.metrics_obj.evictions += 1
        self.eviction_log.append(node.block_id)
        self.index.discard(node.block_id)     # no-op when popped off
        self.policy.on_remove(node.block_id)
        # complete -> incomplete flips of every pending prefix through this
        # node propagate incrementally (the paper's broadcast moment)
        flipped = self.state.on_evicted(node.block_id)
        if self.on_evict is not None:
            self.on_evict(node.block_id, flipped)

    # -------------------------------------------------------------- metrics
    @property
    def evictions(self) -> int:
        return self.metrics_obj.evictions

    def metrics(self) -> Dict[str, float]:
        self.metrics_obj.check_attribution()
        return {**self.metrics_obj.as_dict(), "used_bytes": self.used}
