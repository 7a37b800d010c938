"""Sharded multi-engine serve tier on the coordination plane; mirrors
``src/repro/serve/sharded.py``.

``ShardedFrontend`` hash-routes request prefixes across K independent
``ServeEngine`` shards — each with its own ``PrefixStore`` + ``KVBlockPool``
— and registers every shard as a worker on one ``core.MessageBus``:

* **Routing** is by the request's first token block (``route_prefix``): a
  deterministic digest, stable across process restarts, so a prefix family
  always lands on the same shard (affinity) and its KV chain is reused
  there. Prompts shorter than one block route on the whole prompt.
* **Coordination**: each request's chain is announced to the
  ``PeerTrackerMaster`` as a peer-information profile (chain nodes are
  blocks, per-position prefixes are peer groups — namespaced ``s{k}:`` per
  shard so one global DAG spans all shards); every store event (resident,
  evicted, request retired, skeleton GC) flows over the bus, and evictions
  that break a complete peer group run the paper's report/broadcast
  protocol. The protocol *level* follows the store policy exactly as in
  ``sim.ClusterSim``: a DAG-oblivious tier ships no peer profiles and a
  completeness-oblivious one no eviction reports — replicas then track
  residency only, via the legacy status channel. Every shard therefore
  holds a live ERC replica of the WHOLE
  tier: a chain resident across shards is just a peer group whose members
  carry different namespaces, and cross-shard evictions keep all replicas
  coherent (``verify_replicas`` proves it against each shard's own store
  state).

Generation is exact under sharding: greedy decoding with KV-exact prefix
restore means K-shard output is token-identical to the single engine
(``tests/test_torch_sharded.py`` holds shards ∈ {1,2,4} to each other and
to the reference's frontend).

The port's frontend differs from the reference's in four ways only: it
takes ``device`` (None: the card, as ``engine.resolve_device`` decides)
and ``cuda_graphs`` and hands both to every engine, the crash rebuild's
included; it moves ``params`` onto that device once, so every shard and
every rebuild serves from the same tensors (K shards hold one copy of the
weights, not K); and under tensor parallelism (``tp > 1``, one process a
rank, each running this frontend) each rank's disk tiers take a
``rank{r}`` subdirectory of a shard's.
"""
from __future__ import annotations

import hashlib
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core import (BlockMeta, CacheMetrics, JobDAG, MessageBus, PeerTracker,
                    PeerTrackerMaster, TaskSpec)
from ..faults import FaultInjector, FaultPlan
from ..obs.trace import TID_BUS as _TID_BUS, TID_ENGINE as _TID_ENGINE
from ..models.common import tree_map
from ..sharding import rank_dir
from .engine import Request, ServeEngine, resolve_device
from .prefix_store import PrefixStore
from .scheduler import Scheduler, StepCostModel
from .tiered import TieredKVStore


def route_prefix(tokens: Sequence[int], n_shards: int,
                 block_tokens: int) -> int:
    """Stable shard for a request: digest of its first token block.

    Uses blake2b (unsalted, unlike Python's ``hash``) so the mapping is
    identical across processes and restarts — the property that makes a
    warm shard's prefix cache survive a frontend restart.
    """
    head = tuple(int(t) for t in tokens[:block_tokens])
    digest = hashlib.blake2b(repr(head).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") % n_shards


class ShardedFrontend:
    """K ``ServeEngine`` shards behind one prefix-affinity router, all
    registered as workers of one coordination plane."""

    def __init__(self, cfg, params, n_shards: int = 2, *,
                 max_slots: int = 4, max_seq: int = 256,
                 capacity_bytes: int = 1 << 62, policy: str = "lerc",
                 block_tokens: int = 16, eos_id: int = -1,
                 prefill_chunk: int = 8,
                 pool_blocks: Optional[int] = None,
                 host_capacity_bytes: int = 0,
                 kv_quant: Optional[str] = None,
                 disk_capacity_bytes: int = 0,
                 disk_dir: Optional[str] = None,
                 paged: bool = False,
                 record_eviction_log: bool = False,
                 scheduler: Union[str, Scheduler, None] = None,
                 max_queue: Optional[int] = None,
                 clock: Optional[StepCostModel] = None,
                 eos_interval: int = 8, tp: int = 1,
                 stats_level: str = "full",
                 faults: Union[FaultPlan, FaultInjector, None] = None,
                 device: Union[str, torch.device, None] = None,
                 cuda_graphs: Optional[bool] = None) -> None:
        assert n_shards >= 1
        self.device = resolve_device(device)
        self.n_shards = n_shards
        self.block_tokens = block_tokens
        if isinstance(faults, FaultPlan):
            faults = faults.injector()
        self.faults: Optional[FaultInjector] = faults
        self.failover_retries = 0
        self.shard_crashes_fired = 0
        self._recorder = None
        self._retired_rings = []        # device steps of replaced engines
        self.bus = MessageBus(record_log=False, stats_level=stats_level)
        self.bus.faults = faults
        self.trackers = [PeerTracker(k, self.bus) for k in range(n_shards)]
        for tr in self.trackers:
            # per-replica eviction logs are test/debug instrumentation;
            # a long-lived frontend keeps them off so memory stays bounded
            tr.record_eviction_log = record_eviction_log
        self.master = PeerTrackerMaster(self.bus, n_shards)
        self.shards: List[ServeEngine] = []
        self._distribute_profiles = True
        self._coordinated = True
        # everything a crash rebuild needs to reconstruct a shard's store
        # and engine from scratch (the replacement runs the same config)
        self._store_args = dict(
            capacity_bytes=capacity_bytes, policy=policy,
            block_tokens=block_tokens,
            host_capacity_bytes=host_capacity_bytes, kv_quant=kv_quant,
            disk_capacity_bytes=disk_capacity_bytes, disk_dir=disk_dir)
        self._engine_args = dict(
            max_slots=max_slots, max_seq=max_seq, eos_id=eos_id,
            prefill_chunk=prefill_chunk, pool_blocks=pool_blocks,
            paged=paged, scheduler=scheduler, max_queue=max_queue,
            clock=clock, eos_interval=eos_interval, tp=tp,
            device=self.device, cuda_graphs=cuda_graphs)
        # one copy of the weights on the device, shared by every shard
        # and every crash rebuild (each engine's own move is then a no-op)
        self._cfg = cfg
        self._params = tree_map(lambda t: t.to(self.device), params)
        for k in range(n_shards):
            store = self._build_store(k)
            if k == 0:
                # protocol level is a tier-wide deployment choice derived
                # from the store policy, exactly as in sim.ClusterSim: a
                # DAG-oblivious shard ships no peer profiles and only a
                # completeness-aware one runs the report/bcast protocol
                self._distribute_profiles = store.policy.uses_dag
                self._coordinated = store.policy.uses_completeness
            self._wire(k, store)
            # shards (cache partitioning) and tp (tensor parallelism of
            # each shard's pool) compose: every engine, and every crash
            # rebuild, shares this process's group, so K shards × tp
            # ranks all hold 1/tp of each pool
            self.shards.append(self._build_engine(store))

    def _build_store(self, k: int) -> PrefixStore:
        a = self._store_args
        if a["host_capacity_bytes"] > 0:
            store: PrefixStore = TieredKVStore(
                a["capacity_bytes"], a["policy"],
                block_tokens=a["block_tokens"],
                host_capacity_bytes=a["host_capacity_bytes"],
                kv_quant=a["kv_quant"],
                disk_capacity_bytes=a["disk_capacity_bytes"],
                # each shard's memmap files live in their own subdir
                # (under TP, each rank's in its own below that)
                disk_dir=rank_dir(os.path.join(a["disk_dir"], f"shard{k}")
                                  if a["disk_dir"] else None,
                                  self._engine_args["tp"]))
            # attach BEFORE the engine builds the pools, so the disk pool
            # inherits the injector
            store.faults = self.faults
        else:
            store = PrefixStore(a["capacity_bytes"], a["policy"],
                                block_tokens=a["block_tokens"])
        return store

    def _build_engine(self, store: PrefixStore) -> ServeEngine:
        return ServeEngine(self._cfg, self._params, store=store,
                           **self._engine_args)

    # ------------------------------------------------------------------ obs
    def attach_trace(self, recorder) -> None:
        """Wire one ``TraceRecorder`` through the whole tier: each shard's
        engine becomes a pid of its own (``shard{k}``), and the
        coordination bus a final pid with its messages on the bus lane."""
        self._recorder = recorder
        for k, eng in enumerate(self.shards):
            eng.attach_trace(recorder, pid=k, name=f"shard{k}")
        recorder.label(self.n_shards, "bus", tid=_TID_BUS)
        self.bus.trace = recorder
        self.bus.trace_pid = self.n_shards

    def flush_trace(self) -> int:
        """``ServeEngine.flush_trace`` on every shard's engine, those a
        crash replaced included; returns the spans written."""
        rings = self._retired_rings + [e.device_steps for e in self.shards]
        self._retired_rings = []
        return sum(r.flush() for r in rings if r is not None)

    # ---------------------------------------------------------- coordination
    def _ns(self, shard: int, ident: str) -> str:
        """Namespace a shard-local block/task id into the global DAG."""
        return f"s{shard}:{ident}"

    def _wire(self, shard: int, store: PrefixStore) -> None:
        tracker = self.trackers[shard]

        def on_evict(block_id: str, flipped: List[str]) -> None:
            # paper §III-C: report iff a complete peer group broke (the
            # master broadcasts, updating every shard's labels); the
            # eviction itself always rides the legacy status channel.
            # Only a completeness-aware policy deploys the LERC protocol.
            if self._coordinated:
                tracker.report_eviction(self._ns(shard, block_id),
                                        [self._ns(shard, t) for t in flipped])
            tracker.report_status("evicted", self._ns(shard, block_id))

        def on_status(event: str, ident: str) -> None:
            tracker.report_status(event, self._ns(shard, ident))

        store.on_evict = on_evict
        store.on_status = on_status

    def _announce(self, shard: int, store: PrefixStore, rid: int) -> None:
        """Broadcast a registered request's peer profile: its (namespaced)
        chain blocks + per-position peer-group tasks. The master dedupes
        against the composed DAG, so shared prefixes are announced once;
        newly created skeleton nodes are then reported materialized-on-disk
        (recomputable by prefill, not resident) over the status channel."""
        chain, tasks = store.request_profile(rid)
        if not self._distribute_profiles:
            # DAG-oblivious tier: no peer profile ships (replicas keep no
            # DAG view), but the legacy status channel still announces the
            # chain's skeleton blocks so residency replicas stay coherent.
            # Dedup against the shard's OWN replica — bus-delivered state
            # only, so this path survives a real-RPC bus.
            replica = self.trackers[shard].state
            for node in chain:
                bid = self._ns(shard, node.block_id)
                if bid not in replica.materialized:
                    self.trackers[shard].report_status(
                        "materialized_disk", bid)
            return
        job = JobDAG()
        for node in chain:
            job.add_block(BlockMeta(id=self._ns(shard, node.block_id),
                                    size=0, dataset=f"s{shard}:kv",
                                    index=node.uid))
        for i, t in enumerate(tasks):
            job.add_block(BlockMeta(id=self._ns(shard, t.output), size=0,
                                    dataset=f"s{shard}:req", index=i))
            job.add_task(TaskSpec(
                id=self._ns(shard, t.id),
                inputs=tuple(self._ns(shard, b) for b in t.inputs),
                output=self._ns(shard, t.output),
                job=self._ns(shard, t.job)))
        new_blocks, _ = self.master.submit_job(job)
        chain_ids = {self._ns(shard, n.block_id) for n in chain}
        for b in new_blocks:
            if b.id in chain_ids:
                self.trackers[shard].report_status("materialized_disk", b.id)

    # --------------------------------------------------------------- serving
    def shard_of(self, prompt: Sequence[int]) -> int:
        return route_prefix(prompt, self.n_shards, self.block_tokens)

    def submit(self, prompt: Sequence[int], max_new: int = 16, *,
               deadline: Optional[float] = None,
               arrival: Optional[float] = None) -> Tuple[int, Request]:
        k = self.shard_of(prompt)
        eng = self.shards[k]
        req = eng.submit(prompt, max_new=max_new,
                         deadline=deadline, arrival=arrival)
        self._announce(k, eng.store, req.prefix_rid)
        return k, req

    def cancel(self, req: Request) -> bool:
        """Cancel a request on whichever shard owns it (same prefix-affinity
        routing as submit)."""
        return self.shards[self.shard_of(req.prompt)].cancel(req)

    def step(self) -> List[Request]:
        if self.faults is not None:
            self._check_faults()
        finished: List[Request] = []
        for eng in self.shards:
            if eng.queue or any(s is not None for s in eng.slots):
                finished.extend(eng.step())
        return finished

    def run(self, max_steps: int = 100_000) -> None:
        """Round-robin the shards until every queue and slot drains."""
        for _ in range(max_steps):
            if not any(e.queue or any(s is not None for s in e.slots)
                       for e in self.shards):
                return
            self.step()

    # -------------------------------------------------------- fault handling
    def _check_faults(self) -> None:
        """Fire every scheduled shard crash whose shard clock has been
        reached (once each), then deliver any fault-delayed bus messages
        now due on the tier's most advanced clock."""
        fi = self.faults
        for i, (t, k) in enumerate(fi.plan.shard_crashes):
            if (0 <= k < self.n_shards and self.shards[k].now >= t
                    and fi.claim(("shard", i))):
                self._crash_shard(k)
        if self.bus._delayed:
            self.bus.flush_delayed(max(e.now for e in self.shards))

    def _crash_shard(self, k: int) -> None:
        """Kill shard ``k`` and fail over: its device/host/disk KV state is
        gone, so (1) its whole DAG namespace is purged from the
        coordination plane (the master relays, so every surviving replica
        converges), (2) a replacement engine + store + ``PeerTracker``
        replica is built on the same bus endpoint and seeded via the
        anti-entropy ``resync`` protocol, and (3) every in-flight request
        is re-registered and requeued on the fresh shard with capped
        exponential backoff — deadlines unchanged, so the lost work counts
        against goodput exactly as a client would experience it."""
        fi = self.faults
        fi.count("fault.shard_crash")
        self.shard_crashes_fired += 1
        old = self.shards[k]
        store = old.store
        if old.trace is not None:
            old.trace.vt = old.now
            old.trace.instant(
                "fault.shard_crash", "engine", k, _TID_ENGINE,
                args={"shard": k,
                      "in_flight": sum(s is not None for s in old.slots),
                      "queued": len(old.queue)})
        inflight = sorted(
            (r for r in list(old.slots) + list(old.queue)
             if r is not None and not r.done),
            key=lambda r: r.rid)
        # ---- purge the namespace from the global coordination state.
        # Driver-originated status updates relay to every replica, so the
        # surviving shards and the master converge on "shard k holds
        # nothing" before the replacement announces anything.
        if self._distribute_profiles:
            for rid in sorted(store._req_tasks):
                for tid in store._req_tasks[rid]:
                    ns = self._ns(k, tid)
                    if ns in self.master.dag.tasks:
                        self.master.status_update("task_removed", ns)
        for node in sorted(store._nodes.values(), key=lambda n: n.uid):
            bid = self._ns(k, node.block_id)
            if bid in self.master.state.cached:
                self.master.status_update("evicted", bid)
            self.master.status_update("forget_block", bid)
        old.close()
        # ---- replacement replica on the same bus endpoint (re-register
        # swaps the handler) + fresh store/engine with the old clock and a
        # request-id counter past the old one (rids stay unique per pid)
        tracker = PeerTracker(k, self.bus)
        tracker.record_eviction_log = self.trackers[k].record_eviction_log
        self.trackers[k] = tracker
        new_store = self._build_store(k)
        self._wire(k, new_store)
        eng = self._build_engine(new_store)
        eng.now = old.now
        eng._rid = itertools.count(next(old._rid))
        if self._recorder is not None:
            eng.attach_trace(self._recorder, pid=k, name=f"shard{k}")
            # the crashed engine's device steps are flushed with the rest
            self._retired_rings.append(old.device_steps)
        self.shards[k] = eng
        tracker.request_resync(include_dag=self._distribute_profiles)
        fi.count("recover.resync")
        if eng.trace is not None:
            eng.trace.instant(
                "recover.resync", "engine", k, _TID_ENGINE,
                args={"shard": k, "include_dag": self._distribute_profiles})
        # ---- requeue in-flight work, REUSING the Request objects (the
        # caller holds references): generation restarts from scratch on
        # the rebuilt shard after a capped exponential backoff
        for r in inflight:
            r.slot = -1
            r.pos = 0
            r.generated = []
            r.n_generated = 0
            r._lazy_out = []
            r.prefill_skipped = 0
            r.first_token_at = None
            r.retries += 1
            r.not_before = eng.now + fi.plan.backoff(r.retries)
            r.prefix_rid = eng.store.register_request(r.prompt)
            eng.queue.append(r)
            self._announce(k, eng.store, r.prefix_rid)
            self.failover_retries += 1
            fi.count("recover.requeue")
            if eng.trace is not None:
                eng.trace.instant(
                    "recover.requeue", "engine", k, _TID_ENGINE,
                    args={"rid": r.rid, "retries": r.retries,
                          "not_before": r.not_before})

    def resync_replicas(self) -> None:
        """Anti-entropy sweep: every tracker pulls the master's snapshot.
        Reconverges replicas that drifted behind dropped status traffic
        (crash rebuilds resync automatically)."""
        for tr in self.trackers:
            tr.request_resync(include_dag=self._distribute_profiles)

    def close(self) -> None:
        """Deterministic teardown of every shard's file-backed resources."""
        for eng in self.shards:
            eng.close()

    # ------------------------------------------------------------ invariants
    def verify_replicas(self) -> None:
        """Every tracker's replica must agree with every shard's own store
        state (the authority for its namespace): residency, reference
        counts, effective reference counts. Proves the bus carried the
        whole truth — the sharded tier's analogue of the sim's
        ``ClusterSim.verify_replicas``."""
        for k, eng in enumerate(self.shards):
            st = eng.store.state
            resident = {self._ns(k, b) for b in st.cached}
            pfx = f"s{k}:"
            for tr in self.trackers + [self.master]:
                rs = tr.state
                assert {b for b in rs.cached
                        if b.startswith(pfx)} == resident, \
                    f"{getattr(tr, 'name', 'master')}: shard {k} residency"
                if not self._distribute_profiles:
                    continue   # no peer profile -> replica has no DAG view
                for bid in eng.store._nodes:
                    nb = self._ns(k, bid)
                    assert rs.ref_count.get(nb, 0) == \
                        st.ref_count.get(bid, 0), f"ref[{nb}]"
                    assert rs.eff_ref_count.get(nb, 0) == \
                        st.eff_ref_count.get(bid, 0), f"eff[{nb}]"

    # -------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, float]:
        cache = CacheMetrics()
        for eng in self.shards:
            cache = cache.merge(eng.store.metrics_obj)
        cache.check_attribution()
        out = cache.as_dict()
        out["used_bytes"] = sum(e.store.used for e in self.shards)
        out["host_used_bytes"] = sum(getattr(e.store, "host_used", 0)
                                     for e in self.shards)
        # tier utilization, aggregated across shards (high-water sums are
        # an upper bound on simultaneous use but exact per shard)
        for key, get in (("pool_blocks", lambda e: e.pool.num_blocks),
                         ("pool_blocks_in_use",
                          lambda e: e.pool.blocks_in_use),
                         ("pool_high_water", lambda e: e.pool.high_water)):
            out[key] = sum(get(e) for e in self.shards)
        host_pools = [e.store.host_pool for e in self.shards
                      if getattr(e.store, "host_pool", None) is not None]
        if host_pools:
            out["host_blocks"] = sum(p.num_blocks for p in host_pools)
            out["host_blocks_in_use"] = sum(p.blocks_in_use
                                            for p in host_pools)
            out["host_high_water"] = sum(p.high_water for p in host_pools)
        disk_pools = [e.store.disk_pool for e in self.shards
                      if getattr(e.store, "disk_pool", None) is not None]
        if disk_pools:
            out["disk_used_bytes"] = sum(getattr(e.store, "disk_used", 0)
                                         for e in self.shards)
            out["disk_blocks"] = sum(p.num_blocks for p in disk_pools)
            out["disk_blocks_in_use"] = sum(p.blocks_in_use
                                            for p in disk_pools)
            out["disk_high_water"] = sum(p.high_water for p in disk_pools)
        for field in ("steps", "prefill_tokens", "prefill_tokens_skipped",
                      "decoded_tokens", "rejected", "cancellations"):
            out[field if field != "steps" else "engine_steps"] = \
                sum(getattr(e, field) for e in self.shards)
        out["prefill_saved_frac"] = (
            out["prefill_tokens_skipped"]
            / max(out["prefill_tokens"] + out["prefill_tokens_skipped"], 1))
        out["n_shards"] = self.n_shards
        out["shard_crashes"] = self.shard_crashes_fired
        out["failover_retries"] = self.failover_retries
        for key, val in self.bus.stats.as_dict().items():
            out[f"msg_{key}"] = val
        return out
