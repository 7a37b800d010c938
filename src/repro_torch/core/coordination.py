"""Mirrors ``src/repro/core/coordination.py`` verbatim (own copy).

Distributed coordination of effective reference counts (paper §III-C).

This module is the system's ONE coordination plane: both the cluster
simulator (``sim.ClusterSim``, one ``PeerTracker`` + ``CacheManager`` per
worker) and the sharded serving tier (``serve.ShardedFrontend``, one
``PeerTracker`` per cache shard) run their cross-worker state through it.

Architecture mirrors the paper's Spark implementation:

* ``PeerTrackerMaster`` (driver): holds the authoritative composed
  ``JobDAG``/``DagState``, broadcasts the *peer-information profile* —
  incrementally, only each job's new blocks and tasks — and relays both
  channels below.
* ``PeerTracker`` (one per worker/shard): owns a full ``JobDAG`` +
  ``DagState`` replica updated *only* through bus messages (plus the local
  events of its co-located cache manager), so tests can diff it against a
  centrally-fed oracle.

Two message channels, accounted separately:

* **LERC channel** (the paper's overhead claim): ``peer_profile``
  broadcasts at job submission, and ``evict_report`` (worker → master) +
  ``evict_bcast`` (master → workers) when a *local* eviction breaks at
  least one **complete** peer group. Evictions of blocks whose groups are
  all already incomplete are silent on this channel. Counted in
  ``MessageStats.{peer_profile_broadcasts,eviction_reports,
  eviction_broadcasts,lerc_bytes}``.
* **Legacy status channel** (exists regardless of LERC — Spark's
  ``BlockManagerMaster`` block-status updates): every local block/task
  event is reported worker → master (``status_report``), folded into the
  master's authoritative state, and relayed to all workers (``status``) so
  replicas stay coherent even across silent evictions. Counted only in
  ``point_to_point``/``payload_bytes``, so the LERC-specific overhead is
  measurable on its own.

The paper's communication-overhead claim, implemented and property-tested
here: **between two completeness transitions of a peer group, at most one
eviction broadcast is triggered for that group** — once a group flips to
incomplete, further evictions of its members cost no LERC messages (until
a reload makes it complete again).
"""
from __future__ import annotations

import heapq
import itertools
import pickle
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs.trace import TID_BUS as _TID_BUS
from .dag import BlockId, DagState, JobDAG, TaskId
from .metrics import MessageStats

# message kinds that belong to the LERC-specific channel (vs legacy status)
LERC_KINDS = frozenset({"peer_profile", "evict_report", "evict_bcast"})

# anti-entropy kinds ride a reliable RPC channel (they ARE the recovery
# mechanism): fault injection never drops, delays or duplicates them
RESYNC_KINDS = frozenset({"resync_request", "resync"})


def payload_nbytes(payload: tuple) -> int:
    """Serialized wire size of a message payload. The in-process bus never
    actually serializes; pickle gives an honest, deterministic estimate of
    what an RPC transport would put on the wire."""
    return len(pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))


def _shape_key(payload) -> Optional[tuple]:
    """Cache key under which two payloads are guaranteed to pickle to the
    SAME number of bytes — or None when we can't guarantee it (then the
    caller pickles for real). Covers the hot wire shapes: flat tuples of
    ≤4 primitives, which is every status/eviction message on the bus.

    The guarantees lean on pickle's fixed-width opcodes at
    ``HIGHEST_PROTOCOL``: a str costs opcode + length prefix + its UTF-8
    bytes (prefix width switches on the *byte* length, so key on that);
    an int costs a fixed frame by magnitude class (BININT1 < 256,
    BININT2 < 65536, BININT within int32 — wider ints bail); bool/None
    are single opcodes keyed by value; a float is a fixed 9-byte
    BINFLOAT. One trap: pickle memoizes by object *identity*, so a
    repeated string object would shrink to a back-reference — bail on
    identity-duplicate strings."""
    if type(payload) is not tuple or len(payload) > 4:
        return None
    key: list = [len(payload)]
    str_ids: set = set()
    for v in payload:
        t = type(v)
        if t is str:
            if id(v) in str_ids:
                return None
            str_ids.add(id(v))
            key.append(("s", len(v.encode("utf-8"))))
        elif t is bool or v is None:
            key.append(("c", v))
        elif t is int:
            if 0 <= v < 256:
                key.append(("i", 1))
            elif 0 <= v < 65536:
                key.append(("i", 2))
            elif -2 ** 31 <= v < 2 ** 31:
                key.append(("i", 4))
            else:
                return None
        elif t is float:
            key.append(("f",))
        else:
            return None
    return tuple(key)


@dataclass
class Message:
    kind: str        # "peer_profile" | "status_report" | "status"
    #                  | "evict_report" | "evict_bcast"
    payload: tuple
    src: str
    dst: str
    nbytes: Optional[int] = None   # filled by the bus (or precomputed once
    #                                per broadcast) at send time


class MessageBus:
    """Synchronous in-process bus with per-message accounting. A real
    deployment would replace this with RPC endpoints; the protocol logic
    above it is identical. ``record_log`` keeps the full message log for
    tests; long-running embedders (the simulator, the serve frontend) turn
    it off so memory stays bounded.

    ``stats_level`` gates how much accounting each send pays:

    * ``"full"`` (default) — message counts AND serialized payload bytes.
      Sizing pickles the payload, but repeated wire shapes (flat tuples of
      ≤4 primitives — every status/eviction message) hit a shape-keyed
      size cache, so the steady state is a dict lookup, not a pickle. The
      cache is exact: ``tests/test_obs.py`` asserts byte counters are
      unchanged vs. sizing every payload from scratch.
    * ``"counts"`` — skip payload sizing entirely; the byte counters stay
      zero, the count counters are identical to ``"full"``.
    """

    def __init__(self, record_log: bool = True,
                 stats_level: str = "full") -> None:
        if stats_level not in ("full", "counts"):
            raise ValueError(f"stats_level must be full|counts, "
                             f"got {stats_level!r}")
        self.stats = MessageStats()
        self.record_log = record_log
        self.stats_level = stats_level
        self.log: List[Message] = []
        self._endpoints: Dict[str, Callable[[Message], None]] = {}
        self._size_cache: Dict[tuple, int] = {}
        # obs: an attached ``repro.obs.TraceRecorder`` (None = off)
        self.trace = None
        self.trace_pid = 0
        # fault injection (repro.faults.FaultInjector, None = healthy bus).
        # ``now`` is the embedder's virtual clock, advanced via
        # ``flush_delayed``; delayed messages deliver when it passes their
        # due time, in (due, send-order) order — i.e. possibly reordered
        # relative to healthy traffic.
        self.faults = None
        self.now = 0.0
        self._delayed: List[Tuple[float, int, Message]] = []
        self._dseq = itertools.count()

    def register(self, name: str, handler: Callable[[Message], None]) -> None:
        self._endpoints[name] = handler

    def payload_nbytes(self, payload: tuple) -> int:
        """Wire size of ``payload`` under this bus's stats level: 0 at
        ``"counts"``; at ``"full"`` the exact pickled size, via the shape
        cache when the payload's shape guarantees a fixed size."""
        if self.stats_level == "counts":
            return 0
        key = _shape_key(payload)
        if key is None:
            return payload_nbytes(payload)
        n = self._size_cache.get(key)
        if n is None:
            n = payload_nbytes(payload)
            self._size_cache[key] = n
        return n

    def send(self, msg: Message) -> None:
        if msg.nbytes is None:
            msg.nbytes = self.payload_nbytes(msg.payload)
        if self.record_log:
            self.log.append(msg)
        self.stats.point_to_point += 1
        self.stats.payload_bytes += msg.nbytes
        if msg.kind in LERC_KINDS:
            self.stats.lerc_bytes += msg.nbytes
        if self.trace is not None:
            self.trace.instant(
                "bus." + msg.kind, "bus", self.trace_pid, _TID_BUS,
                args={"src": msg.src, "dst": msg.dst, "bytes": msg.nbytes})
        if self.faults is not None and msg.kind not in RESYNC_KINDS:
            act = self.faults.bus_action(msg.kind)
            if act is not None:
                if act[0] == "drop":
                    self.stats.dropped += 1
                    self.faults.count("fault.bus_drop")
                    if self.trace is not None:
                        self.trace.instant(
                            "fault.bus_drop", "bus", self.trace_pid,
                            _TID_BUS, args={"kind": msg.kind,
                                            "dst": msg.dst})
                    return
                if act[0] == "delay":
                    self.stats.delayed += 1
                    self.faults.count("fault.bus_delay")
                    heapq.heappush(self._delayed,
                                   (self.now + act[1], next(self._dseq),
                                    msg))
                    return
                # duplicate: the message arrives twice (handlers are
                # idempotent by protocol design — this proves it)
                self.stats.duplicated += 1
                self.faults.count("fault.bus_dup")
                self._endpoints[msg.dst](msg)
        self._endpoints[msg.dst](msg)

    def flush_delayed(self, now: float) -> int:
        """Advance the bus clock and deliver every delayed message now due,
        in (due time, send order). Returns the number delivered."""
        self.now = max(self.now, now)
        n = 0
        while self._delayed and self._delayed[0][0] <= self.now:
            _, _, msg = heapq.heappop(self._delayed)
            self._endpoints[msg.dst](msg)
            n += 1
        return n


def apply_status(state: DagState, event: str, ident,
                 eviction_log: Optional[List[BlockId]] = None) -> None:
    """Fold one legacy-channel status event into ``state``. Handlers are
    idempotent, so the worker that originated an event (and already applied
    it locally) can safely receive the relayed broadcast."""
    if event == "materialized":
        state.on_materialized(ident, into_cache=True)
    elif event == "materialized_disk":
        state.on_materialized(ident, into_cache=False)
    elif event == "loaded":
        state.on_loaded(ident)
    elif event == "evicted":
        if eviction_log is not None and ident in state.cached:
            eviction_log.append(ident)
        state.on_evicted(ident)
    elif event == "lost":
        # crash loss: no disk copy survives, so the producer must re-run
        # (lineage recompute). Relayed like a silent eviction so every
        # replica resurrects the same references.
        if eviction_log is not None and ident in state.cached:
            eviction_log.append(ident)
        state.on_lost(ident)
    elif event == "task_done":
        state.on_task_done(ident)
    elif event == "task_removed":
        # serve: a request chain's references left the system; mirror the
        # store's retirement (settle counters, drop the task + its virtual
        # output) so replicas track the live working set, not history
        if ident in state.dag.tasks:
            state.on_task_removed(ident)
            state.dag.remove_task(ident, remove_output=True)
    elif event == "forget_block":
        # serve: radix-skeleton GC of an unreferenced, non-resident node.
        # DAG-less replicas (the policy ships no peer profile) still drop
        # the block from their residency sets so those stay bounded.
        state.forget_block(ident)
        # tolerate replicas that are mid-divergence (dropped/duplicated
        # status traffic, crash purges): only detach the skeleton node if
        # it is genuinely unreferenced here too
        if (ident in state.dag.blocks
                and not state.dag.consumers.get(ident)
                and ident not in state.dag.producer):
            state.dag.remove_block(ident)
    else:
        raise ValueError(f"unknown status event {event!r}")


class PeerTracker:
    """Worker-side tracker: a full replica of the composed DAG, the
    peer-group completeness labels and the ERC counts.

    The replica (``self.dag`` + ``self.state``) exists from construction,
    so a co-located ``CacheManager``/``EvictionIndex`` can be built over it
    before any job arrives; peer profiles then extend it incrementally
    (``add_block``/``add_task`` + ``on_task_added`` — no rebuilds).
    """

    def __init__(self, worker_id: int, bus: MessageBus) -> None:
        self.worker_id = worker_id
        self.name = f"worker:{worker_id}"
        self.bus = bus
        self.dag = JobDAG()
        self.state = DagState(self.dag)
        # evictions applied to this replica *via bus messages*, in order
        # (local evictions applied directly to a shared state by the
        # co-located manager are deduplicated by residency). Follows the
        # bus's record_log flag: long-running embedders that bound the
        # message log also bound this, test clusters keep both.
        self.record_eviction_log = bus.record_log
        self.eviction_log: List[BlockId] = []
        bus.register(self.name, self.handle)

    # --------------------------------------------------------------- handler
    def handle(self, msg: Message) -> None:
        if msg.kind == "peer_profile":
            blocks, tasks = msg.payload
            for b in blocks:
                if b.id not in self.dag.blocks:
                    self.dag.add_block(b)
            for t in tasks:
                if t.id not in self.dag.tasks:
                    self.dag.add_task(t)
                    self.state.on_task_added(t.id)
        elif msg.kind == "status":
            event, ident = msg.payload
            try:
                apply_status(self.state, event, ident,
                             eviction_log=(self.eviction_log
                                           if self.record_eviction_log
                                           else None))
            except KeyError:
                if self.bus.faults is None:
                    raise
                # a lossy bus already skipped earlier updates, so later
                # ones can hit state they assume present; the replica is
                # diverged either way and anti-entropy resync is the
                # repair path — folding must not kill the worker
                self.bus.stats.diverged_applies += 1
        elif msg.kind == "evict_bcast":
            (block,) = msg.payload
            if self.record_eviction_log and block in self.state.cached:
                self.eviction_log.append(block)
            try:
                self.state.on_evicted(block)
            except KeyError:
                if self.bus.faults is None:
                    raise
                self.bus.stats.diverged_applies += 1
        elif msg.kind == "resync":
            self._install_snapshot(msg.payload)

    # ------------------------------------------------------------ anti-entropy
    def request_resync(self, include_dag: bool = True) -> None:
        """Ask the master for an authoritative snapshot (anti-entropy):
        used to seed a freshly rebuilt replica after a crash, or to
        reconverge one that drifted behind dropped status traffic.
        ``include_dag=False`` skips DAG structure (replicas on a cluster
        that ships no peer profiles deliberately stay DAG-less)."""
        self.bus.send(Message("resync_request",
                              (self.worker_id, include_dag),
                              src=self.name, dst="master"))

    def _install_snapshot(self, snap: tuple) -> None:
        """Replace this replica's view with the master's. The DagState
        object is mutated IN PLACE (co-located cache managers and eviction
        indexes hold references to it), then ``rebuild()`` re-derives every
        counter so listeners resort their keys."""
        blocks, tasks, materialized, cached, done = snap
        if blocks is not None:
            want_b = {b.id for b in blocks}
            want_t = {t.id for t in tasks}
            for tid in [t for t in self.dag.tasks if t not in want_t]:
                self.dag.remove_task(tid)
            for bid in [b for b in self.dag.blocks if b not in want_b]:
                if (not self.dag.consumers.get(bid)
                        and bid not in self.dag.producer):
                    self.dag.remove_block(bid)
            for b in blocks:
                if b.id not in self.dag.blocks:
                    self.dag.add_block(b)
            for t in tasks:
                if t.id not in self.dag.tasks:
                    self.dag.add_task(t)
        self.state.materialized = set(materialized)
        self.state.cached = set(cached)
        self.state.done_tasks = set(done)
        self.state.rebuild()

    # ----------------------------------------------------------- local event
    def local_eviction(self, block: BlockId) -> bool:
        """A local eviction not yet applied to the replica: apply it, then
        run the full protocol — the paper's reporting rule on the LERC
        channel plus the legacy status update (so the master and every
        peer replica learn of silent evictions too). Returns True iff a
        report (and hence a broadcast) was triggered."""
        if self.record_eviction_log and block in self.state.cached:
            self.eviction_log.append(block)
        flipped = self.state.on_evicted(block)
        reported = self.report_eviction(block, flipped)
        self.report_status("evicted", block)
        return reported

    def report_eviction(self, block: BlockId,
                        flipped_groups: Sequence[TaskId]) -> bool:
        """Paper §III-C worker-side rule, for callers whose cache manager
        already applied the eviction to the local state: report to the
        master iff the eviction broke at least one complete peer group
        (``flipped_groups`` is ``DagState.on_evicted``'s return value).
        Evictions out of already-incomplete groups are silent."""
        if not flipped_groups:
            return False
        self.bus.stats.eviction_reports += 1
        self.bus.send(Message("evict_report", (block,),
                              src=self.name, dst="master"))
        return True

    def report_status(self, event: str, ident) -> None:
        """Legacy BlockManagerMaster channel: one point-to-point message to
        the master, which folds it into the authoritative state and relays
        it to every worker."""
        self.bus.send(Message("status_report", (event, ident),
                              src=self.name, dst="master"))


class PeerTrackerMaster:
    """Driver-side: authoritative composed DAG + state, peer-profile
    broadcasts, eviction-report relay, and the legacy status relay."""

    def __init__(self, bus: MessageBus, n_workers: int) -> None:
        self.bus = bus
        self.n_workers = n_workers
        self.dag = JobDAG()
        self.state = DagState(self.dag)
        bus.register("master", self.handle)

    # ------------------------------------------------------------ job submit
    def submit_job(self, job_dag: JobDAG, broadcast: bool = True
                   ) -> Tuple[List, List]:
        """Merge the job's DAG into the composed multi-job DAG — applied
        incrementally to the authoritative state — and broadcast the *new*
        blocks and tasks as the peer-information profile (paper: via
        BlockManagerMasterEndpoint). ``broadcast=False`` skips the LERC
        profile (a cluster running a DAG-oblivious policy ships no peer
        information). Returns (new_blocks, new_tasks)."""
        new_blocks = [b for b in job_dag.blocks.values()
                      if b.id not in self.dag.blocks]
        new_tasks = [t for t in job_dag.tasks.values()
                     if t.id not in self.dag.tasks]
        for b in new_blocks:
            self.dag.add_block(b)
        for t in new_tasks:
            self.dag.add_task(t)
            self.state.on_task_added(t.id)
        if broadcast:
            self.bus.stats.peer_profile_broadcasts += 1
            self._broadcast("peer_profile",
                            (tuple(new_blocks), tuple(new_tasks)))
        return new_blocks, new_tasks

    # ----------------------------------------------------------------- relay
    def handle(self, msg: Message) -> None:
        if msg.kind == "evict_report":
            (block,) = msg.payload
            self.bus.stats.eviction_broadcasts += 1
            self._broadcast("evict_bcast", (block,))
        elif msg.kind == "status_report":
            event, ident = msg.payload
            apply_status(self.state, event, ident)
            self._broadcast("status", (event, ident))
        elif msg.kind == "resync_request":
            worker, include_dag = msg.payload
            self.bus.stats.resyncs += 1
            self.bus.send(Message("resync", self._snapshot(include_dag),
                                  src="master", dst=f"worker:{worker}"))

    def _snapshot(self, include_dag: bool = True) -> tuple:
        """Authoritative state snapshot for the anti-entropy ``resync``
        reply: (blocks, tasks, materialized, cached, done_tasks) — the
        first two None when the requester keeps a DAG-less replica."""
        dag = (tuple(self.dag.blocks.values()) if include_dag else None,
               tuple(self.dag.tasks.values()) if include_dag else None)
        return (*dag,
                tuple(sorted(self.state.materialized)),
                tuple(sorted(self.state.cached)),
                tuple(sorted(self.state.done_tasks)))

    def status_update(self, event: str, block_or_task) -> None:
        """Driver-originated status (legacy channel): fold into the
        authoritative state and broadcast to all workers."""
        apply_status(self.state, event, block_or_task)
        self._broadcast("status", (event, block_or_task))

    def _broadcast(self, kind: str, payload: tuple) -> None:
        nbytes = self.bus.payload_nbytes(payload)
        for w in range(self.n_workers):
            self.bus.send(Message(kind, payload, src="master",
                                  dst=f"worker:{w}", nbytes=nbytes))


def build_cluster(n_workers: int, record_log: bool = True,
                  stats_level: str = "full"
                  ) -> Tuple[PeerTrackerMaster, List[PeerTracker], MessageBus]:
    bus = MessageBus(record_log=record_log, stats_level=stats_level)
    workers = [PeerTracker(w, bus) for w in range(n_workers)]
    master = PeerTrackerMaster(bus, n_workers)
    return master, workers, bus
