"""Mirrors ``src/repro/sim/cluster.py`` verbatim (own copy).

Discrete-event cluster simulator for cache-policy evaluation.

Models the paper's EC2 deployment (§IV): ``n_workers`` machines, each with a
bounded RDD cache, a disk tier, a fixed number of task slots, and
disk/memory/network bandwidths. Jobs are ``JobDAG``s; the scheduler is
locality-aware and round-robins across tenants (FIFO within a job).

Task duration = scheduling overhead + max-over-inputs(fetch time) + compute:
the *max* is the paper's all-or-nothing bottleneck — one cold peer hides
every warm one.

The simulator drives the same ``CacheManager``/``DagState``/policy code that
the real data pipeline uses; only time is simulated. Victim selection runs
on each manager's ``EvictionIndex`` (O(log n) pops) over that worker's OWN
``DagState`` replica, held by its ``PeerTracker``: every piece of
cross-worker state — peer profiles at job submission, materialize/load
status, eviction broadcasts — flows through the shared ``MessageBus``, so
``SimResult.messages`` is exactly what the coordination protocol actually
sent (no hand-maintained counters anywhere in this module). Replicas are
verified bit-identical to the driver's authoritative state (and to a
from-scratch oracle) at the end of every ``run``.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import (Belady, CacheManager, CacheMetrics, DagState, JobDAG,
                    MessageBus, MessageStats, PeerTracker, PeerTrackerMaster,
                    TaskSpec, make_policy)
from ..faults import FaultInjector, FaultPlan
from ..obs.trace import TID_BUS as _TID_BUS


@dataclass
class HardwareModel:
    """Per-worker hardware. Defaults calibrated to the paper's m4.large
    fleet (2 vCPU / 8 GB, EBS magnetic, direct I/O): see
    benchmarks/fig5_makespan.py for the calibration note."""

    cache_bytes: int = 5_300 * 2 ** 20 // 10      # per-worker share, set by runner
    disk_bw: float = 50e6                         # B/s  (direct I/O, no page cache)
    mem_bw: float = 10e9                          # B/s
    net_bw: float = 56e6                          # B/s  (m4.large "moderate")
    slots: int = 2                                # task slots (2 vCPUs)
    task_overhead: float = 0.08                   # s, Spark launch+sched delay
    compute_bw: float = 200e6                     # B/s processed by task code
    disk_queue: bool = False                      # True: serialize the volume;
                                                  # False: parallel streams at
                                                  # per-stream disk_bw (EBS-like)
    msg_latency: float = 0.0                      # s per bus hop: the driver
                                                  # learns of a task's finish
                                                  # one status-report hop after
                                                  # it happens, so dependents
                                                  # launch that much later.
                                                  # 0 = instantaneous bus
                                                  # (bit-identical to pre-PR-4
                                                  # results)


@dataclass
class SimResult:
    makespan: float
    metrics: CacheMetrics
    messages: MessageStats
    per_job_finish: Dict[str, float] = field(default_factory=dict)
    task_runtimes: Dict[str, float] = field(default_factory=dict)

    def as_dict(self):
        return {
            "makespan": self.makespan,
            **self.metrics.as_dict(),
            "messages": self.messages.as_dict(),
        }


class ClusterSim:
    def __init__(self, n_workers: int, hw: HardwareModel, policy: str = "lerc",
                 policy_kwargs: Optional[dict] = None,
                 cache_outputs: bool = True,
                 trace=None, stats_level: str = "full",
                 faults=None) -> None:
        self.n_workers = n_workers
        self.hw = hw
        # deterministic fault injection (repro.faults): worker crashes fire
        # as simulator events at their plan times; bus faults ride the
        # shared MessageBus. None = healthy cluster, bit-identical to a sim
        # built without the parameter.
        if isinstance(faults, FaultPlan):
            faults = faults.injector()
        self.faults: Optional[FaultInjector] = faults
        self._faulted = False                     # any crash fired yet?
        self.worker_crashes_fired = 0
        # obs: an attached TraceRecorder (None = zero-overhead off). Tasks
        # are retrospective X events on the VIRTUAL clock — pid 0 with one
        # lane per worker; the bus is pid 1.
        self.trace = trace
        # the coordination plane: driver-side master (authoritative DAG +
        # state) and one worker-side tracker per machine, each holding its
        # own DagState replica fed only by bus messages
        self.bus = MessageBus(record_log=False, stats_level=stats_level)
        self.bus.faults = self.faults
        if trace is not None:
            trace.label(0, "sim")
            for w in range(n_workers):
                trace.label(0, "sim", tid=w, tname=f"worker{w}")
            trace.label(1, "bus", tid=_TID_BUS)
            self.bus.trace = trace
            self.bus.trace_pid = 1
        self.trackers = [PeerTracker(w, self.bus) for w in range(n_workers)]
        self.master = PeerTrackerMaster(self.bus, n_workers)
        self.dag = self.master.dag        # driver's view (scheduling)
        self.state = self.master.state
        self.metrics = CacheMetrics()
        self.cache_outputs = cache_outputs
        self.policy_name = policy
        self._policies = []
        self.managers: List[CacheManager] = []
        for w in range(n_workers):
            pol = make_policy(policy, **(policy_kwargs or {}))
            self._policies.append(pol)
            self.managers.append(CacheManager(
                capacity=hw.cache_bytes, policy=pol,
                state=self.trackers[w].state, metrics=self.metrics,
                on_evict=self._make_evict_hook(w)))
        # protocol level is a cluster-wide deployment choice derived from
        # the policy: DAG-oblivious policies ship no peer profiles, and
        # only completeness-aware ones run the eviction report protocol
        self._distribute_profiles = self._policies[0].uses_dag
        self._coordinated = self._policies[0].uses_completeness
        self.home: Dict[str, int] = {}            # block -> worker
        self._outputs_not_cached: set = set()
        self._done: set = set()                   # executed tasks, across runs
        # per-worker disk is a serialized resource (the m4.large EBS volume):
        # concurrent readers queue behind each other
        self._disk_free = [0.0] * n_workers

    @property
    def messages(self) -> MessageStats:
        """All message accounting comes from actual bus traffic."""
        return self.bus.stats

    # ------------------------------------------------------------- protocol
    def _make_evict_hook(self, worker: int):
        """The worker's cache manager applied an eviction to this worker's
        replica; run the protocol: report to the master iff the eviction
        broke a complete peer group (master then broadcasts, keeping every
        other replica's labels current), and always ship the legacy
        block-status update."""
        def hook(block: str, flipped_groups: List[str]) -> None:
            tracker = self.trackers[worker]
            if self._coordinated:
                tracker.report_eviction(block, flipped_groups)
            tracker.report_status("evicted", block)
        return hook

    # ------------------------------------------------------------ job intake
    def submit(self, job: JobDAG, output_not_cached: Sequence[str] = ()) -> None:
        for b in job.blocks.values():
            if b.id not in self.dag.blocks:
                self.home[b.id] = (b.preferred_worker
                                   if b.preferred_worker is not None
                                   else len(self.home) % self.n_workers)
        self._outputs_not_cached.update(output_not_cached)
        # merge into the authoritative DAG (incremental task arrival — no
        # rebuild) and broadcast the delta as the peer profile
        self.master.submit_job(job, broadcast=self._distribute_profiles)

    # ---------------------------------------------------------------- timing
    def _disk_io(self, worker: int, nbytes: int, clock: float) -> float:
        """Seconds until a disk transfer of ``nbytes`` started at ``clock``
        completes, serializing behind in-flight transfers on that worker's
        volume (direct I/O: no page cache, §IV)."""
        if not self.hw.disk_queue:
            return nbytes / self.hw.disk_bw
        start = max(self._disk_free[worker], clock)
        self._disk_free[worker] = start + nbytes / self.hw.disk_bw
        return self._disk_free[worker] - clock

    def _fetch_time(self, block: str, on_worker: int, clock: float
                    ) -> Tuple[float, bool]:
        """(seconds, was_cache_hit) to fetch a materialized block."""
        size = self.dag.blocks[block].size
        h = self.home[block]
        mgr = self.managers[h]
        if mgr.in_memory(block):
            t = size / self.hw.mem_bw
            if h != on_worker:
                t += size / self.hw.net_bw
            self.metrics.mem_bytes_read += size
            return t, True
        # on disk at its home worker
        t = self._disk_io(h, size, clock)
        if h != on_worker:
            t += size / self.hw.net_bw
        self.metrics.disk_bytes_read += size
        return t, False

    def _source_read_time(self, block: str, worker: int, clock: float) -> float:
        """Initial materialization from stable storage (not a cache access)."""
        return self._disk_io(worker, self.dag.blocks[block].size, clock)

    # -------------------------------------------------------------- schedule
    def _unmet(self, task: TaskSpec) -> int:
        """Inputs not yet materialized. Raw source blocks (no producer) live
        on stable storage and are always available."""
        return sum(1 for b in task.inputs
                   if b in self.dag.producer and b not in self.state.materialized)

    def _pick_worker(self, task: TaskSpec, free_slots: List[int]) -> int:
        """Locality: the eligible worker holding the most input bytes."""
        eligible = [w for w in range(self.n_workers) if free_slots[w] > 0]
        if not eligible:
            raise RuntimeError("no free slot")

        def local_bytes(w: int) -> int:
            return sum(self.dag.blocks[b].size for b in task.inputs
                       if self.home.get(b) == w)

        return max(eligible, key=lambda w: (local_bytes(w), -w))

    def run(self, belady_trace: Optional[List[str]] = None,
            stages: Optional[set] = None) -> SimResult:
        """Run all currently-runnable tasks to completion.

        ``stages``: if given, only tasks whose ``stage`` is in the set are
        executed this call — used to separate the (unmeasured) ingest phase
        from the measured compute phase, as in the paper's §IV setup where
        the input files are partitioned and stored before the zip jobs are
        timed. The cache policy sees the *full* DAG throughout (reference
        counts are known from job submission, as in Spark's lazy plan).
        Each call measures its own makespan from t=0.
        """
        if belady_trace is not None:
            for pol in self._policies:
                if isinstance(pol, Belady):
                    pol.set_trace(list(belady_trace))
        clock = 0.0
        self._disk_free = [0.0] * self.n_workers
        free_slots = [self.hw.slots] * self.n_workers
        done: set = self._done
        # (t, seq, kind, task, worker): "finish" = a task completes on a
        # worker; "ready" = the driver *learns* a task became runnable
        # (its last producer's status report arrived, hw.msg_latency later)
        events: List[Tuple[float, int, str, str, int]] = []
        seq = itertools.count()
        per_job_finish: Dict[str, float] = {}
        task_runtimes: Dict[str, float] = {}
        # makespan is charged by task completions only: a crash event (or a
        # delayed bus flush) after the last finish must not extend it
        makespan = 0.0
        # tid -> (worker, finish-event seq): tasks currently executing. A
        # crash aborts the victims by seq, so their already-queued finish
        # events become stale no-ops — the recompute run pushes fresh ones.
        inflight: Dict[str, Tuple[int, int]] = {}
        aborted: set = set()
        if self.faults is not None:
            for i, (t, w) in enumerate(self.faults.plan.worker_crashes):
                if (0 <= int(w) < self.n_workers
                        and self.faults.claim(("worker", i))):
                    heapq.heappush(events, (float(t), next(seq),
                                            "crash", "", int(w)))

        def runnable(t: TaskSpec) -> bool:
            return (t.id not in done
                    and (stages is None or t.stage in stages))

        # incremental readiness: unmet-producer counts per task
        unmet: Dict[str, int] = {t.id: self._unmet(t)
                                 for t in self.dag.tasks.values()
                                 if runnable(t)}
        ready_by_job: Dict[str, List[TaskSpec]] = {}
        for t in sorted(self.dag.tasks.values(), key=lambda t: t.id):
            if runnable(t) and unmet[t.id] == 0:
                ready_by_job.setdefault(t.job, []).append(t)
        # multi-tenant fairness: round-robin across jobs
        job_order = sorted(self.dag.jobs)
        rr = itertools.cycle(job_order)

        def try_schedule() -> None:
            while any(free_slots) and any(ready_by_job.values()):
                job = next(rr)
                if not ready_by_job.get(job):
                    continue
                task = ready_by_job[job].pop(0)
                worker = self._pick_worker(task, free_slots)
                free_slots[worker] -= 1
                dur = self._task_duration(task, worker, clock)
                task_runtimes[task.id] = dur
                if self.trace is not None:
                    # sim time is in seconds; the recorder's virtual clock
                    # is milliseconds (1 vt unit -> 1ms on export)
                    self.trace.complete(
                        task.id, "task", 0, worker,
                        vt=clock * 1e3, dur=dur * 1e3,
                        args={"job": task.job, "worker": worker})
                eseq = next(seq)
                inflight[task.id] = (worker, eseq)
                heapq.heappush(events, (clock + dur, eseq, "finish",
                                        task.id, worker))

        try_schedule()
        while events:
            clock, eseq, kind, tid, worker = heapq.heappop(events)
            if self.bus.faults is not None and self.bus._delayed:
                self.bus.flush_delayed(clock)
            if kind == "ready":
                # the completion status report reached the driver: the
                # dependent task is now visible to the scheduler
                t = self.dag.tasks[tid]
                if self._faulted and (
                        tid in done or tid in inflight
                        or unmet.get(tid, 1) != 0
                        or any(x.id == tid
                               for x in ready_by_job.get(t.job, ()))):
                    # stale: a crash-time readiness rebuild already re-listed
                    # (or re-ran) this task before its report arrived
                    continue
                ready_by_job.setdefault(t.job, []).append(t)
                try_schedule()
                continue
            if kind == "crash":
                self._handle_crash(worker, clock, done, free_slots, inflight,
                                   aborted, unmet, ready_by_job,
                                   task_runtimes, runnable)
                try_schedule()
                continue
            if eseq in aborted:
                # finish event of a task killed by a crash mid-flight: the
                # worker restarted, the slot accounting was reset there
                aborted.discard(eseq)
                continue
            task = self.dag.tasks[tid]
            done.add(tid)
            inflight.pop(tid, None)
            makespan = clock
            free_slots[worker] += 1
            # materialize output at this worker: the owning manager applies
            # the local event to its replica, then the worker reports it
            # over the legacy status channel (master folds it into the
            # authoritative state and relays to every other replica)
            out = task.output
            self.home.setdefault(out, worker)
            home = self.home[out]
            mgr = self.managers[home]
            if self.cache_outputs and out not in self._outputs_not_cached:
                mgr.insert(out, self.dag.blocks[out].size)
                self.trackers[home].report_status(
                    "materialized" if mgr.in_memory(out)
                    else "materialized_disk", out)
            else:
                mgr.disk.put(out, self.dag.blocks[out].size)
                mgr.state.on_materialized(out, into_cache=False)
                self.trackers[home].report_status("materialized_disk", out)
            per_job_finish[task.job] = clock
            for cons in self.dag.consumers.get(out, []):
                if cons not in unmet:
                    continue
                unmet[cons] -= 1
                if unmet[cons] == 0:
                    if self.hw.msg_latency > 0:
                        # the scheduler only sees the completion once the
                        # worker's status report has crossed the bus
                        heapq.heappush(events,
                                       (clock + self.hw.msg_latency,
                                        next(seq), "ready", cons, -1))
                    else:
                        ready_by_job.setdefault(
                            self.dag.tasks[cons].job, []) \
                            .append(self.dag.tasks[cons])
            try_schedule()

        if self.bus.faults is not None:
            # deliver any still-delayed traffic, then reconverge replicas
            # that sit behind dropped status messages before the coherence
            # check — anti-entropy is the documented repair path for drops
            self.bus.flush_delayed(float("inf"))
            if self.bus.stats.dropped:
                self.resync_replicas()
        self.verify_replicas()
        self.metrics.check_attribution()
        return SimResult(makespan=makespan, metrics=self.metrics,
                         messages=self.messages, per_job_finish=per_job_finish,
                         task_runtimes=task_runtimes)

    # --------------------------------------------------------------- faults
    def _handle_crash(self, worker: int, clock: float, done: set,
                      free_slots: List[int], inflight, aborted: set,
                      unmet, ready_by_job, task_runtimes, runnable) -> None:
        """A worker crashed (and immediately restarts empty, Spark's
        executor-loss model): its running tasks die, every block it cached
        — memory and local disk — is gone, and the driver relays the loss
        over the status channel so all replicas resurrect the producers'
        references (``DagState.on_lost``). Dependent recompute is then just
        ordinary scheduling over the repaired readiness view, charged to
        the makespan like any other work."""
        self._faulted = True
        self.worker_crashes_fired += 1
        if self.faults is not None:
            self.faults.count("fault.worker_crash")
        if self.trace is not None:
            self.trace.instant("fault.worker_crash", "fault", 0, worker,
                               vt=clock * 1e3)
        # running tasks on the victim die: their queued finish events are
        # stale; drop them by event seq (a recompute may re-run the same
        # task id, whose fresh finish event must NOT be discarded)
        for t_id, (w, eseq) in list(inflight.items()):
            if w == worker:
                aborted.add(eseq)
                del inflight[t_id]
                task_runtimes.pop(t_id, None)
        # both tiers of the victim's block store are lost
        mgr = self.managers[worker]
        lost = sorted(set(mgr.mem.blocks) | set(mgr.disk.blocks))
        for b in lost:
            if b in mgr.mem:
                mgr.mem.drop(b)
            mgr.disk.drop(b)
            mgr.index.discard(b)
            mgr.policy.on_remove(b)
        free_slots[worker] = self.hw.slots      # restarted executor
        # driver-detected loss, relayed like a silent eviction: every
        # replica (including the restarted worker's) folds on_lost —
        # un-materialize, resurrect the producer's reference counts
        resurrected = []
        for b in lost:
            self.master.status_update("lost", b)
            self.home.pop(b, None)
            p = self.dag.producer.get(b)
            if p is not None and p in done:
                done.discard(p)
                resurrected.append(p)
        if self.faults is not None:
            self.faults.count("recover.lost_blocks", len(lost))
            self.faults.count("recover.recompute", len(resurrected))
        if self.trace is not None:
            self.trace.instant("recover.lineage", "fault", 0, worker,
                               vt=clock * 1e3,
                               args={"lost_blocks": len(lost),
                                     "recompute_tasks": len(resurrected)})
        # rebuild the scheduler's readiness view from the repaired state:
        # aborted + resurrected tasks become pending again, everything
        # in-flight elsewhere stays where it is (in place — these dicts
        # are closed over by the run() loop)
        unmet.clear()
        for t in self.dag.tasks.values():
            if runnable(t) and t.id not in inflight:
                unmet[t.id] = self._unmet(t)
        for lst in ready_by_job.values():
            lst.clear()
        for t in sorted(self.dag.tasks.values(), key=lambda t: t.id):
            if runnable(t) and t.id not in inflight and unmet[t.id] == 0:
                ready_by_job.setdefault(t.job, []).append(t)

    def resync_replicas(self) -> None:
        """Anti-entropy: every tracker pulls the master's authoritative
        snapshot (reliable RPC, exempt from injection). Used after runs
        whose status traffic was lossy."""
        for tr in self.trackers:
            tr.request_resync(include_dag=self._distribute_profiles)

    # ------------------------------------------------------------ invariants
    def verify_replicas(self) -> None:
        """Every worker replica must agree with the driver's authoritative
        state, and the driver's incremental counters with a from-scratch
        rebuild (the paper's Definitions computed directly). Cheap —
        O(blocks + tasks) — and run at the end of every ``run`` so the
        whole sim test suite doubles as a coherence proof."""
        ms = self.master.state
        oracle = DagState(self.master.dag,
                          materialized=set(ms.materialized),
                          cached=set(ms.cached),
                          done_tasks=set(ms.done_tasks))
        blocks = self.master.dag.blocks
        assert all(ms.ref_count.get(b, 0) == oracle.ref_count.get(b, 0)
                   for b in blocks), "driver ref counts diverge from oracle"
        assert all(ms.eff_ref_count.get(b, 0) == oracle.eff_ref_count.get(b, 0)
                   for b in blocks), "driver eff counts diverge from oracle"
        for tr in self.trackers:
            st = tr.state
            assert st.cached == ms.cached, f"{tr.name}: cached set diverged"
            assert st.materialized == ms.materialized, \
                f"{tr.name}: materialized set diverged"
            if not self._distribute_profiles:
                continue      # no peer profile -> replica has no DAG view
            assert st.done_tasks == ms.done_tasks, \
                f"{tr.name}: done tasks diverged"
            assert all(st.ref_count.get(b, 0) == ms.ref_count.get(b, 0)
                       for b in blocks), f"{tr.name}: ref counts diverged"
            assert all(st.eff_ref_count.get(b, 0) == ms.eff_ref_count.get(b, 0)
                       for b in blocks), f"{tr.name}: eff counts diverged"

    # ----------------------------------------------------------- task timing
    def _task_duration(self, task: TaskSpec, worker: int, clock: float) -> float:
        hw = self.hw
        dur = hw.task_overhead + task.compute_cost
        cacheable_inputs = [b for b in task.inputs if b in self.dag.producer]
        if not cacheable_inputs:
            # pure source/load task: reads external storage via the disk
            dur += sum(self._source_read_time(b, worker, clock)
                       for b in task.inputs)
            dur += sum(self.dag.blocks[b].size
                       for b in task.inputs) / hw.compute_bw
            return dur
        # Def. 1 effectiveness, judged before any access mutates state
        all_cached = all(self.managers[self.home[b]].in_memory(b)
                         for b in cacheable_inputs)
        # ineffective-hit attribution: the first blocking peer's location
        # (a disk-resident blocker makes the group one load from complete;
        # an absent one costs a recompute)
        cause = None
        if not all_cached:
            blocker = next(b for b in cacheable_inputs
                           if not self.managers[self.home[b]].in_memory(b))
            cause = ("disk"
                     if blocker in self.managers[self.home[blocker]].disk
                     else "never_cached")
        fetch = 0.0
        for b in cacheable_inputs:
            t, hit = self._fetch_time(b, worker, clock)
            fetch = max(fetch, t)          # parallel fetch: slowest peer wins
            self.metrics.record_access(hit=hit, effective=hit and all_cached,
                                       cause=cause)
            self._policies[self.home[b]].on_access(b)
            pol = self._policies[self.home[b]]
            if isinstance(pol, Belady):
                pol.advance(b)
        dur += fetch
        compute_bytes = sum(self.dag.blocks[b].size for b in task.inputs)
        dur += compute_bytes / hw.compute_bw
        # writing the output: cached outputs are lazily spilled (no cost
        # here); uncached outputs are written through to disk
        if task.output in self._outputs_not_cached or not self.cache_outputs:
            dur += self._disk_io(worker, self.dag.blocks[task.output].size,
                                 clock + dur)
        return dur
