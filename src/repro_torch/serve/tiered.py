"""Mirrors ``src/repro/serve/tiered.py`` verbatim (own copy).

Tiered KV store: LERC-aware demotion down a compressed storage ladder.

``core`` honors the paper's all-or-nothing property with a two-tier
MemoryTier/DiskTier store: eviction moves a block to the slow tier, and a
task only speeds up when *every* peer sits in the fast tier. This module
gives the serving data plane the same shape, now three rungs deep. Tier 0
is the device-resident ``KVBlockPool``; tier 1 is a preallocated
``HostBlockPool``; tier 2 (PR 8) is a file-backed ``DiskBlockPool``.
Under device pressure a prefix-cache block *demotes* — one jitted
device→host row copy — instead of dying; under host pressure it demotes
*again* to disk; and a later lookup that walks over demoted blocks
promotes the usable chain back to the device pool, paying a copy (and a
dequantize) instead of a prefill recompute.

**Demotion transcodes** (PR 8): with ``kv_quant`` set, the device→host
copy quantizes rows on device (``repro.quant`` per-layer-per-block
scales) so the host budget holds ~``itemsize``-ratio more blocks — the
paper's lever is complete chains per byte, and narrowing the dtype is the
cheapest way to buy more of them. The host→disk hop can narrow again
(``disk_quant``); promotion dequantizes inside the device scatter jit.
With ``kv_quant`` "none" every path is the lossless copy it was in PR 4,
bit-identical to the pre-PR engine.

Placement policy is the paper's machinery three times over:

* **Demotion victims** are chosen by the store's existing
  ``Policy``/``EvictionIndex`` over the shared ``DagState`` counters — so
  LERC demotes members of broken peer groups (ERC 0) first and keeps
  complete chains wholly on-device. An *effective* hit remains
  tier-0-only: a partially demoted chain is "incomplete" in the paper's
  sense and pays the max-over-blocks promotion copy before it is usable —
  the all-or-nothing bottleneck, now one tier down.
* **Host-tier eviction** runs a second policy-driven ``EvictionIndex``
  over the same counters; its victims demote to disk when a disk tier is
  configured, and die otherwise. A demoted block is never in
  ``DagState.cached``, so every peer group through it is incomplete and a
  completeness-aware key degrades gracefully to (reference count,
  recency) — retention follows who still *references* a chain.
* **Disk-tier eviction** is a THIRD index over the very same counters:
  the final death, back to recomputable-by-prefill. The ladder orders
  blocks by restore cost (table write ≪ host copy ≪ disk page-in ≪
  recompute), and each rung's policy independently keeps the chains
  cheapest to complete at that rung.

Tier-0 state transitions (demotion = eviction from the fast tier) keep
the exact event stream the single-tier store emits: same
``eviction_log``, same ``DagState.on_evicted`` completeness flips, same
``on_evict``/``on_status`` coordination hooks — so a sharded frontend
with tiered shards stays replica-coherent with no protocol changes, and
with the host tier disabled this class is op-for-op a ``PrefixStore``.
Tier 1→2 movement touches no ``DagState`` (the block already left
``cached``), so the slow rungs stay invisible to the coordination plane.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from .. import quant as quantlib
from ..core import EvictionIndex, Policy, make_policy
from ..quant import QuantSpec
from ..obs.trace import TID_STORE as _TID_STORE
from .disk_pool import DiskBlockPool
from .host_pool import HostBlockPool
from .kv_pool import KVBlockPool
from .prefix_store import Node, PrefixStore, blocking_cause


class TieredKVStore(PrefixStore):
    """Three-tier prefix store: device pool (tier 0) + host pool (tier 1)
    + optional disk pool (tier 2), with optional transcoding demotion.

    Construct like a ``PrefixStore`` plus per-tier byte budgets and quant
    formats; the engine attaches the actual pools (it owns the cache
    template) via ``attach_pools``, building them from this store's
    ``quant``/``disk_quant``/``disk_capacity``/``disk_dir`` settings.
    With ``host_capacity_bytes == 0`` (or no pools attached) every code
    path delegates to the base class, bit-identical to a single-tier
    store; with ``kv_quant="none"`` and no disk tier it is bit-identical
    to the PR 4 two-tier store.
    """

    def __init__(self, capacity_bytes: int,
                 policy: Union[str, Policy] = "lerc",
                 block_tokens: int = 16, *,
                 host_capacity_bytes: int = 0,
                 host_policy: Union[str, Policy, None] = None,
                 kv_quant: Union[str, QuantSpec, None] = None,
                 disk_capacity_bytes: int = 0,
                 disk_policy: Union[str, Policy, None] = None,
                 disk_quant: Union[str, QuantSpec, None] = None,
                 disk_dir: Optional[str] = None) -> None:
        super().__init__(capacity_bytes, policy, block_tokens=block_tokens)
        self.host_capacity = host_capacity_bytes
        self.host_used = 0
        if host_policy is None:
            host_policy = make_policy(self.policy.name)
        elif isinstance(host_policy, str):
            host_policy = make_policy(host_policy)
        self.host_policy = host_policy
        self.host_index = EvictionIndex(self.host_policy, self.state)
        # transcode formats: ``quant`` narrows the device→host hop;
        # ``disk_quant`` the host→disk hop (None = inherit the host format,
        # so a lossless host tier gets a lossless disk tier by default)
        self.quant = quantlib.get_spec(kv_quant)
        self.disk_quant = (self.quant if disk_quant is None
                           else quantlib.get_spec(disk_quant))
        self.disk_capacity = disk_capacity_bytes
        self.disk_used = 0
        self.disk_dir = disk_dir
        if disk_policy is None:
            disk_policy = make_policy(self.policy.name)
        elif isinstance(disk_policy, str):
            disk_policy = make_policy(disk_policy)
        self.disk_policy = disk_policy
        self.disk_index = EvictionIndex(self.disk_policy, self.state)
        self.device_pool: Optional[KVBlockPool] = None
        self.host_pool: Optional[HostBlockPool] = None
        self.disk_pool: Optional[DiskBlockPool] = None
        self.host_eviction_log: List[str] = []
        self.disk_eviction_log: List[str] = []
        # demotions batched per ``_make_room`` call: (device row, host row).
        # Victim selection interleaves with per-victim state updates, but
        # the byte movement happens in ONE jitted gather (+ on-device
        # quantize) + device_get at the end of the batch, before any freed
        # device row can be reused.
        self._pending_demotions: List[Tuple[int, int]] = []
        # ---- fault injection + graceful degradation ----
        # repro.faults.FaultInjector shared with the whole run (None =
        # healthy). Must be attached BEFORE attach_pools so the disk pool
        # inherits it.
        self.faults = None
        self.disk_quarantined = False
        # consecutive disk I/O errors; only a successful disk READ resets
        # it — writes landing doesn't prove the bytes come back, so a disk
        # that accepts demotions but fails every promote still quarantines
        self._disk_errors = 0
        # virtual-clock stall accrued by slow promotions this step; the
        # engine drains it into ``now`` after the step's compute charge
        self.pending_stall = 0.0

    # --------------------------------------------------------------- wiring
    def attach_pools(self, device_pool: KVBlockPool,
                     host_pool: HostBlockPool,
                     disk_pool: Optional[DiskBlockPool] = None) -> None:
        self.device_pool = device_pool
        self.host_pool = host_pool
        self.disk_pool = disk_pool
        if disk_pool is not None:
            disk_pool.faults = self.faults
        # fallback/final device evictions still free pool rows directly
        self.evict_payload = device_pool.free

    @property
    def tiered(self) -> bool:
        return (self.host_capacity > 0 and self.host_pool is not None
                and self.host_pool.num_blocks > 0)

    @property
    def disk_tiered(self) -> bool:
        return (self.disk_capacity > 0 and self.disk_pool is not None
                and self.disk_pool.num_blocks > 0
                and not self.disk_quarantined)

    def _host_nbytes(self, node: Node) -> int:
        """Bytes one block charges against the host budget. Quantized
        tiers price the transcoded row (the capacity-per-byte win);
        lossless tiers keep pricing the device byte size — bit-identical
        accounting to the pre-quant store."""
        if self.quant is None:
            return node.nbytes
        return self.host_pool.block_nbytes

    def _trace_move(self, name: str, node: Node, *, src: str,
                    dst: Optional[str], policy: Policy,
                    quant: bool = False) -> None:
        """One tier-transition instant, stamped with the deciding
        policy's eviction key AT decision time (why this victim)."""
        if self.trace is None:
            return
        self.trace.instant(name, "store", self.trace_pid, _TID_STORE, args={
            "uid": node.uid, "block": node.block_id, "src": src, "dst": dst,
            "quant": quant,
            "key": str(policy.eviction_key(node.block_id, self.state))})

    # ---------------------------------------------------------------- reads
    def lookup(self, tokens: Sequence[int]) -> List[Node]:
        """Longest chain resident in *any* tier from the root; demoted
        blocks on it are promoted back to the device pool before the chain
        is returned, so callers always receive tier-0 payloads.

        Metrics follow the paper's definitions down the ladder: a hit is
        presence in any tier (``tier1_hits``/``tier2_hits`` count the
        slow-tier slices), but a hit is *effective* only when every block
        up to it sits in tier 0 — a partially demoted chain pays the
        promotion copy."""
        if not self.tiered:
            return super().lookup(tokens)
        chain = self._walk(tokens)
        usable: List[Node] = []
        touched_t0: List[Node] = []
        touched_t1: List[Node] = []
        touched_t2: List[Node] = []
        broken = False
        all_t0 = True
        cause = None        # first non-tier-0 node: the chain's blocker
        blocking = [] if self.trace is not None else None
        ineff: Dict[str, int] = {}
        for node in chain:
            in_t0 = node.resident
            in_t1 = node.host_payload is not None
            in_t2 = node.disk_payload is not None
            hit = in_t0 or in_t1 or in_t2
            if not hit:
                broken = True
            if not in_t0:
                all_t0 = False
                if cause is None:
                    cause = blocking_cause(node)
                if blocking is not None:
                    blocking.append((node.uid, blocking_cause(node)))
            effective = hit and not broken and all_t0
            self.metrics_obj.record_access(
                hit=hit, effective=effective,
                tier=1 if in_t1 else (2 if in_t2 else 0), cause=cause)
            if hit and not effective:
                ineff[cause] = ineff.get(cause, 0) + 1
            if hit and not broken:
                usable.append(node)
            if in_t0:
                touched_t0.append(node)
            elif in_t1:
                touched_t1.append(node)
            else:
                touched_t2.append(node)
        for node in reversed(touched_t2):         # leaf first, root last
            self.disk_policy.on_access(node.block_id)
        for node in reversed(touched_t1):
            self.host_policy.on_access(node.block_id)
        for node in reversed(touched_t0):
            self.policy.on_access(node.block_id)
        if self.trace is not None:
            self.trace.instant(
                "store.lookup", "store", self.trace_pid, _TID_STORE,
                args={"blocks": len(chain), "usable": len(usable),
                      "broken": broken, "blocking": blocking,
                      "ineffective": ineff})
        demoted = [n for n in usable if not n.resident]
        if demoted:
            failed = self._promote(demoted,
                                   exclude={n.block_id for n in chain})
            if failed:
                # a promotion timed out or its disk read died: the chain is
                # only usable up to the first unpromoted block — everything
                # past it falls back to prefill recompute (degraded mode)
                for i, n in enumerate(usable):
                    if n.block_id in failed:
                        usable = usable[:i]
                        break
        return usable

    # --------------------------------------------------------------- writes
    def _pre_insert(self, node: Node) -> None:
        if node.host_payload is not None:
            # the chain broke upstream of this block, so the engine
            # recomputed it; the fresh KV supersedes the slow-tier copy
            self._release_host(node)
        if node.disk_payload is not None:
            self._release_disk(node)

    # ----------------------------------------------------- tier-0 pressure
    def _make_room(self, needed: int, exclude: set) -> None:
        super()._make_room(needed, exclude)
        self._flush_demotions()

    def _evict(self, node: Node) -> None:
        """Tier-0 eviction under tiering is a *demotion*: identical
        store-visible event stream (eviction log, counter flips,
        coordination hooks), but the payload moves to the host pool —
        quantized when the store transcodes — instead of dying. When the
        host tier cannot hold the block it skips straight to the disk
        rung; a true eviction only when every lower tier is out of
        room."""
        if not self.tiered:
            return super()._evict(node)
        hbytes = self._host_nbytes(node)
        self._make_host_room(hbytes)
        if (self.host_used + hbytes > self.host_capacity
                or not self.host_pool.free_list):
            if self._demote_past_host(node):
                return
            return super()._evict(node)
        self._trace_move("store.demote", node, src="device", dst="host",
                         policy=self.policy, quant=self.quant is not None)
        host_idx = self.host_pool.alloc()
        self._pending_demotions.append((node.payload, host_idx))
        node.host_payload = host_idx
        node.payload = None
        node.resident = False
        self.used -= node.nbytes
        self.host_used += hbytes
        self.metrics_obj.evictions += 1
        self.metrics_obj.demotions += 1
        self.eviction_log.append(node.block_id)
        self.index.discard(node.block_id)
        self.policy.on_remove(node.block_id)
        # complete -> incomplete flips propagate exactly as for a real
        # eviction: the block left the fast tier (the paper's broadcast
        # moment); replicas track tier-0 residency only
        flipped = self.state.on_evicted(node.block_id)
        # enter the slow tier's victim queue, keyed on post-flip counters
        self.host_policy.on_insert(node.block_id)
        self.host_index.add(node.block_id)
        if self.on_evict is not None:
            self.on_evict(node.block_id, flipped)

    def _demote_past_host(self, node: Node) -> bool:
        """Device victim straight to the disk rung, skipping a host tier
        with no free row — which happens whenever every host row belongs
        to blocks an in-flight promotion is about to vacate. Emits the
        exact tier-0 eviction event stream of a host demotion; only the
        landing tier differs."""
        if not self.disk_tiered:
            return False
        dbytes = self.disk_pool.block_nbytes
        self._make_disk_room(dbytes)
        if (self.disk_used + dbytes > self.disk_capacity
                or not self.disk_pool.free_list):
            return False
        self._trace_move("store.demote", node, src="device", dst="disk",
                         policy=self.policy,
                         quant=self.disk_quant is not None)
        out = self.device_pool.read_rows([node.payload], quant=self.quant)
        blocks, scales = out if self.quant is not None else (out, None)
        blocks, scales = quantlib.transcode_tree_np(
            blocks, scales, self.quant, self.disk_quant)
        disk_idx = self.disk_pool.alloc()
        try:
            self.disk_pool.write_rows([disk_idx], blocks, scales)
        except OSError:
            self.disk_pool.free(disk_idx)
            self._note_disk_io_error("demote_write")
            return False
        if self.disk_quant is not None:
            self.metrics_obj.quantized_demotions += 1
        self.device_pool.free(node.payload)
        node.disk_payload = disk_idx
        node.payload = None
        node.resident = False
        self.used -= node.nbytes
        self.disk_used += dbytes
        self.metrics_obj.evictions += 1
        self.metrics_obj.demotions += 1
        self.metrics_obj.disk_demotions += 1
        self.eviction_log.append(node.block_id)
        self.index.discard(node.block_id)
        self.policy.on_remove(node.block_id)
        flipped = self.state.on_evicted(node.block_id)
        self.disk_policy.on_insert(node.block_id)
        self.disk_index.add(node.block_id)
        if self.on_evict is not None:
            self.on_evict(node.block_id, flipped)
        return True

    def _flush_demotions(self) -> None:
        if not self._pending_demotions:
            return
        dev = [d for d, _ in self._pending_demotions]
        host = [h for _, h in self._pending_demotions]
        self._pending_demotions = []
        if self.quant is None:
            self.host_pool.write_rows(host, self.device_pool.read_rows(dev))
        else:
            blocks, scales = self.device_pool.read_rows(dev,
                                                        quant=self.quant)
            self.host_pool.write_rows(host, blocks, scales)
            self.metrics_obj.quantized_demotions += len(dev)
        for d in dev:
            self.device_pool.free(d)

    # ----------------------------------------------------- tier-1 pressure
    def _make_host_room(self, needed: int) -> None:
        while self.host_used + needed > self.host_capacity:
            victim = self.host_index.pop_min()
            if victim is None:
                return
            self._evict_host(self._nodes[victim])

    def _release_host(self, node: Node) -> None:
        """Free a node's host row (no eviction event). Cancels an unflushed
        demotion of the same row: the device→host copy never happens and
        the device row is freed directly."""
        hp = node.host_payload
        for i, (dev, host) in enumerate(self._pending_demotions):
            if host == hp:
                del self._pending_demotions[i]
                self.device_pool.free(dev)
                break
        self.host_pool.free(hp)
        node.host_payload = None
        self.host_used -= self._host_nbytes(node)
        self.host_index.discard(node.block_id)
        self.host_policy.on_remove(node.block_id)

    def _evict_host(self, node: Node) -> None:
        """Host-tier eviction: demote once more to the disk rung when one
        is configured and has (or can make) room; otherwise the block
        leaves the system entirely (back to recomputable-by-prefill).
        Either way no ``DagState`` transition — a demoted block was
        already out of ``cached`` — so no counter or label changes, and
        nothing to coordinate."""
        if self._demote_to_disk(node):
            return
        self._trace_move("store.evict", node, src="host", dst=None,
                         policy=self.host_policy)
        self._release_host(node)
        node.nbytes = 0
        self.metrics_obj.host_evictions += 1
        self.host_eviction_log.append(node.block_id)
        self._gc_upward(node)

    def _gc_upward(self, node: Node) -> None:
        """Skeleton GC after a final eviction: unlike ``complete_request``
        pruning there is no chain list in hand, so walk parent links while
        nodes are garbage (non-resident in every tier, childless,
        unreferenced)."""
        while (node is not None and node.parent is not None
               and self._is_garbage(node)):
            parent = node.parent
            self._forget_node(node)
            node = parent

    # ----------------------------------------------------- tier-2 pressure
    def _demote_to_disk(self, node: Node) -> bool:
        """Move a host-tier victim's row to the disk pool, transcoding if
        the disk format differs. Returns False (caller finishes the kill)
        when no disk tier is configured or it cannot make room."""
        if not self.disk_tiered:
            return False
        dbytes = self.disk_pool.block_nbytes
        self._make_disk_room(dbytes)
        if (self.disk_used + dbytes > self.disk_capacity
                or not self.disk_pool.free_list):
            return False
        self._trace_move(
            "store.demote", node, src="host", dst="disk",
            policy=self.host_policy,
            quant=self.disk_quant is not None and self.disk_quant != self.quant)
        # the victim's host row may still be an unflushed pending demotion
        # (selected by _make_host_room inside the same _make_room batch) —
        # its bytes must land in host memory before we can read them
        if any(h == node.host_payload for _, h in self._pending_demotions):
            self._flush_demotions()
        out = self.host_pool.read_rows([node.host_payload])
        blocks, scales = out if self.quant is not None else (out, None)
        blocks, scales = quantlib.transcode_tree_np(
            blocks, scales, self.quant, self.disk_quant)
        disk_idx = self.disk_pool.alloc()
        try:
            self.disk_pool.write_rows([disk_idx], blocks, scales)
        except OSError:
            self.disk_pool.free(disk_idx)
            self._note_disk_io_error("demote_write")
            return False
        if self.disk_quant is not None and self.disk_quant != self.quant:
            self.metrics_obj.quantized_demotions += 1
        self._release_host(node)
        node.disk_payload = disk_idx
        self.disk_used += dbytes
        self.metrics_obj.disk_demotions += 1
        self.disk_policy.on_insert(node.block_id)
        self.disk_index.add(node.block_id)
        return True

    def _make_disk_room(self, needed: int) -> None:
        while self.disk_used + needed > self.disk_capacity:
            victim = self.disk_index.pop_min()
            if victim is None:
                return
            self._evict_disk(self._nodes[victim])

    def _release_disk(self, node: Node) -> None:
        """Free a node's disk row (no eviction event)."""
        self.disk_pool.free(node.disk_payload)
        node.disk_payload = None
        self.disk_used -= self.disk_pool.block_nbytes
        self.disk_index.discard(node.block_id)
        self.disk_policy.on_remove(node.block_id)

    def _evict_disk(self, node: Node) -> None:
        """The ladder's last rung: the block dies for real."""
        self._trace_move("store.evict", node, src="disk", dst=None,
                         policy=self.disk_policy)
        self._release_disk(node)
        node.nbytes = 0
        self.metrics_obj.disk_evictions += 1
        self.disk_eviction_log.append(node.block_id)
        self._gc_upward(node)

    # ------------------------------------------------------------ promotion
    def _promote(self, nodes: List[Node], exclude: Set[str]) -> Set[str]:
        """Bring demoted blocks back on-device: make tier-0 room (which may
        demote colder blocks — the whole looked-up chain is excluded), then
        ONE host→device transfer + scatter per source tier for the batch
        (``promotion_dispatches``), dequantizing on device when the source
        tier is transcoded. Disk rows promote straight to the device pool —
        their bytes stream through host RAM, not through host-pool rows, so
        a promotion never needs host-tier room. Mirrors
        ``CacheManager.load_from_disk``: the blocks re-enter the fast tier
        as loads, flipping their peer groups complete again.

        Returns the block ids that did NOT promote: a stalled promotion
        past the plan's timeout abandons the whole batch *before* any
        mutation (the blocks simply stay demoted — recomputable), and a
        disk-tier read error kills the affected blocks (their bytes are
        unreachable). The caller truncates the usable chain accordingly."""
        if self.faults is not None:
            stall = self.faults.promotion_stall()
            if stall > 0.0:
                if stall > self.faults.plan.promotion_timeout:
                    # abandon before touching indexes or payloads: the
                    # chain stays demoted and the engine recomputes — a
                    # stalled disk can never wedge the step
                    self.metrics_obj.promotion_timeouts += 1
                    if self.trace is not None:
                        self.trace.instant(
                            "fault.promotion_timeout", "store",
                            self.trace_pid, _TID_STORE,
                            args={"blocks": len(nodes), "stall": stall})
                    return {n.block_id for n in nodes}
                self.pending_stall += stall
                self.metrics_obj.promotion_stalls += 1
                if self.trace is not None:
                    self.trace.instant(
                        "fault.promotion_stall", "store", self.trace_pid,
                        _TID_STORE,
                        args={"blocks": len(nodes), "stall": stall})
        for node in nodes:
            self.host_index.discard(node.block_id)
            self.disk_index.discard(node.block_id)
        self._make_room(sum(n.nbytes for n in nodes), exclude=exclude)
        dev_rows = [self.device_pool.alloc() for _ in nodes]
        failed: Set[str] = set()
        for pool, spec, srcs in (
                (self.host_pool, self.quant,
                 [(n, d) for n, d in zip(nodes, dev_rows)
                  if n.host_payload is not None]),
                (self.disk_pool, self.disk_quant,
                 [(n, d) for n, d in zip(nodes, dev_rows)
                  if n.disk_payload is not None])):
            if not srcs:
                continue
            src_rows = [n.host_payload if pool is self.host_pool
                        else n.disk_payload for n, _ in srcs]
            dst_rows = [d for _, d in srcs]
            try:
                out = pool.read_rows(src_rows)
            except OSError:
                # the disk tier lost these bytes: free the reserved device
                # rows, kill the blocks (no copy survives anywhere), and
                # let quarantine accounting decide the tier's fate
                for n, d in srcs:
                    failed.add(n.block_id)
                    self.device_pool.free(d)
                    self._release_disk(n)
                    n.nbytes = 0
                    self.metrics_obj.disk_evictions += 1
                    self.disk_eviction_log.append(n.block_id)
                self._note_disk_io_error("promote_read")
                continue
            if pool is self.disk_pool:
                self._disk_errors = 0
            if spec is None:
                self.device_pool.write_rows(dst_rows, out)
            else:
                blocks, scales = out
                self.device_pool.write_rows(dst_rows, blocks, scales)
                self.metrics_obj.dequantized_promotions += len(src_rows)
            self.metrics_obj.promotion_dispatches += 1
        for node, dev in zip(nodes, dev_rows):
            if node.block_id in failed:
                self._gc_upward(node)
                continue
            if self.trace is not None:
                self._trace_move(
                    "store.promote", node,
                    src="host" if node.host_payload is not None else "disk",
                    dst="device",
                    policy=(self.host_policy if node.host_payload is not None
                            else self.disk_policy))
            if node.host_payload is not None:
                self.host_pool.free(node.host_payload)
                node.host_payload = None
                self.host_used -= self._host_nbytes(node)
                self.host_policy.on_remove(node.block_id)
            else:
                self.disk_pool.free(node.disk_payload)
                node.disk_payload = None
                self.disk_used -= self.disk_pool.block_nbytes
                self.disk_policy.on_remove(node.block_id)
                self.metrics_obj.disk_promotions += 1
            node.payload = dev
            node.resident = True
            self.used += node.nbytes
            self.metrics_obj.promotions += 1
            self.state.on_loaded(node.block_id)   # flips groups complete
            self.index.add(node.block_id)
            if self.on_status is not None:
                self.on_status("loaded", node.block_id)
        for node in reversed(nodes):              # leaf first, root last
            if node.block_id not in failed:
                self.policy.on_insert(node.block_id)
        return failed

    # --------------------------------------------- disk-fault bookkeeping
    def _note_disk_io_error(self, site: str) -> None:
        """One disk I/O error happened (injected or real): count it and
        quarantine the tier after ``quarantine_after`` consecutive
        failures."""
        self.metrics_obj.disk_io_errors += 1
        self._disk_errors += 1
        if self.faults is not None:
            self.faults.count("fault.disk_io")
        if self.trace is not None:
            self.trace.instant(
                "fault.disk_io", "store", self.trace_pid, _TID_STORE,
                args={"site": site, "consecutive": self._disk_errors})
        threshold = (self.faults.plan.quarantine_after
                     if self.faults is not None else 3)
        if not self.disk_quarantined and self._disk_errors >= threshold:
            self._quarantine_disk()

    def _quarantine_disk(self) -> None:
        """Take a failing disk tier out of rotation: every disk-resident
        block dies (its bytes are untrustworthy), future demotions skip
        the rung (``disk_tiered`` goes False), and the store degrades to
        the PR 5 two-tier semantics — eviction + prefill recompute — with
        zero exceptions escaping to the engine."""
        if self.disk_quarantined:
            return
        self.disk_quarantined = True
        self.metrics_obj.disk_quarantines += 1
        victims = sorted((n for n in self._nodes.values()
                          if n.disk_payload is not None),
                         key=lambda n: n.uid)
        if self.trace is not None:
            self.trace.instant(
                "fault.disk_quarantine", "store", self.trace_pid,
                _TID_STORE, args={"blocks_lost": len(victims),
                                  "errors": self._disk_errors})
        for node in victims:
            self._release_disk(node)
            node.nbytes = 0
            self.metrics_obj.disk_evictions += 1
            self.disk_eviction_log.append(node.block_id)
            self._gc_upward(node)

    # -------------------------------------------------------------- lifetime
    def close(self) -> None:
        """Deterministic teardown of file-backed resources (the disk
        pool's memmap row files)."""
        if self.disk_pool is not None:
            self.disk_pool.close()

    # -------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, float]:
        m = super().metrics()
        m["host_used_bytes"] = self.host_used
        m["host_capacity_bytes"] = self.host_capacity
        if self.disk_tiered or self.disk_capacity > 0:
            m["disk_used_bytes"] = self.disk_used
            m["disk_capacity_bytes"] = self.disk_capacity
        return m
