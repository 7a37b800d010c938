"""Mirrors ``src/repro/core/dag.py`` verbatim (own copy).

Lineage DAG for data-parallel jobs.

This is the paper's substrate: jobs are DAGs whose nodes are *blocks*
(partitions of datasets, Spark's "RDD blocks") and whose hyper-edges are
*tasks*. A task reads a set of input blocks — its *peer group* — and
materializes one output block. The all-or-nothing property (paper §II-C)
lives on peer groups: a task is sped up iff every materialized input is
cached.

Terminology is kept deliberately close to the paper:

* reference count (LRC, paper [10]): for a block ``b``, the number of
  *unmaterialized* blocks whose producing task reads ``b``.
* effective reference (paper Def. 2): a reference by task ``t`` is
  effective iff all of ``t``'s *materialized* input blocks are cached.
* peer group (paper §I): the input-block set of a task.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BlockId = str
TaskId = str
JobId = str

_uid = itertools.count()


def fresh_id(prefix: str) -> str:
    return f"{prefix}_{next(_uid)}"


@dataclass(frozen=True)
class BlockMeta:
    """A partition of a dataset."""

    id: BlockId
    size: int                      # bytes
    dataset: str                   # logical dataset ("RDD") this block belongs to
    index: int                     # partition index within the dataset
    preferred_worker: Optional[int] = None  # data-locality hint


@dataclass(frozen=True)
class TaskSpec:
    """A compute task: reads ``inputs`` (its peer group), writes ``output``."""

    id: TaskId
    inputs: Tuple[BlockId, ...]
    output: BlockId
    job: JobId
    stage: int = 0
    compute_cost: float = 0.0      # abstract compute seconds (simulator)

    @property
    def peer_group(self) -> Tuple[BlockId, ...]:
        return self.inputs


class JobDAG:
    """A DAG of blocks and tasks; supports incremental multi-job composition.

    The driver-side view: built once per job submission from the pipeline
    lineage (Spark: ``DAGScheduler``), then handed to the cache manager /
    ``PeerTrackerMaster``.
    """

    def __init__(self) -> None:
        self.blocks: Dict[BlockId, BlockMeta] = {}
        self.tasks: Dict[TaskId, TaskSpec] = {}
        # block -> tasks that read it. Insertion-ordered dict used as an
        # ordered set: iteration matches the old list semantics, but
        # retirement (serve traffic: one per completed request chain
        # position) is O(1) instead of O(consumers).
        self.consumers: Dict[BlockId, Dict[TaskId, None]] = {}
        # block -> task that produces it (None for source blocks)
        self.producer: Dict[BlockId, TaskId] = {}
        self.jobs: Dict[JobId, Dict[TaskId, None]] = {}

    # ------------------------------------------------------------------ build
    def add_block(self, block: BlockMeta) -> BlockMeta:
        if block.id in self.blocks:
            raise ValueError(f"duplicate block {block.id}")
        self.blocks[block.id] = block
        self.consumers.setdefault(block.id, {})
        return block

    def add_source(self, dataset: str, index: int, size: int,
                   preferred_worker: Optional[int] = None) -> BlockMeta:
        return self.add_block(
            BlockMeta(id=f"{dataset}[{index}]", size=size, dataset=dataset,
                      index=index, preferred_worker=preferred_worker))

    def add_task(self, task: TaskSpec) -> TaskSpec:
        if task.id in self.tasks:
            raise ValueError(f"duplicate task {task.id}")
        for b in task.inputs:
            if b not in self.blocks:
                raise ValueError(f"task {task.id} reads unknown block {b}")
        if task.output not in self.blocks:
            raise ValueError(f"task {task.id} writes unknown block {task.output}")
        if task.output in self.producer:
            raise ValueError(f"block {task.output} already has a producer")
        self.tasks[task.id] = task
        self.producer[task.output] = task.id
        for b in task.inputs:
            self.consumers[b][task.id] = None
        self.jobs.setdefault(task.job, {})[task.id] = None
        return task

    def remove_task(self, tid: TaskId, remove_output: bool = False) -> TaskSpec:
        """Retire a task from the DAG (serve: a request chain's reference
        left the system). The caller is responsible for having settled the
        task's counter contributions first (``DagState.on_task_removed``)."""
        task = self.tasks.pop(tid)
        for b in task.inputs:
            consumers = self.consumers.get(b)
            if consumers is not None:
                consumers.pop(tid, None)
        self.producer.pop(task.output, None)
        job_tasks = self.jobs.get(task.job)
        if job_tasks is not None:
            job_tasks.pop(tid, None)
            if not job_tasks:
                del self.jobs[task.job]
        if remove_output:
            self.remove_block(task.output)
        return task

    def remove_block(self, block: BlockId) -> None:
        """Drop a block with no remaining producer or consumers."""
        if self.consumers.get(block):
            raise ValueError(f"block {block} still has consumers")
        if block in self.producer:
            raise ValueError(f"block {block} still has a producer")
        self.blocks.pop(block, None)
        self.consumers.pop(block, None)

    # ------------------------------------------------------------------ query
    def source_blocks(self) -> List[BlockId]:
        return [b for b in self.blocks if b not in self.producer]

    def peer_groups(self) -> Dict[TaskId, Tuple[BlockId, ...]]:
        return {t.id: t.inputs for t in self.tasks.values()}

    def topological_tasks(self) -> List[TaskSpec]:
        """Kahn's algorithm over the task graph (stable order)."""
        indeg: Dict[TaskId, int] = {}
        for t in self.tasks.values():
            indeg[t.id] = sum(1 for b in t.inputs if b in self.producer)
        ready = [tid for tid, d in sorted(indeg.items()) if d == 0]
        out: List[TaskSpec] = []
        ready_i = 0
        while ready_i < len(ready):
            tid = ready[ready_i]
            ready_i += 1
            task = self.tasks[tid]
            out.append(task)
            for consumer in self.consumers.get(task.output, []):
                indeg[consumer] -= 1
                if indeg[consumer] == 0:
                    ready.append(consumer)
        if len(out) != len(self.tasks):
            raise ValueError("cycle in task DAG")
        return out

    def validate(self) -> None:
        self.topological_tasks()  # raises on cycles


# --------------------------------------------------------------------------
# Mutable DAG state: which blocks exist where.  Shared by the cache manager,
# the policies and the coordination layer.
# --------------------------------------------------------------------------
@dataclass
class DagState:
    """Runtime state of a (multi-)job DAG.

    Maintains, incrementally and in O(degree) per event:

    * ``ref_count[b]``     — the LRC reference count (paper [10]).
    * ``eff_ref_count[b]`` — the LERC effective reference count (Def. 2).
    * per-task ``missing[t]`` — # of materialized-but-uncached inputs; a
      peer group is *complete* iff ``missing == 0`` (paper §III-C labels).
    """

    dag: JobDAG
    materialized: set = field(default_factory=set)   # computed at least once
    cached: set = field(default_factory=set)         # currently in memory
    ref_count: Dict[BlockId, int] = field(default_factory=dict)
    eff_ref_count: Dict[BlockId, int] = field(default_factory=dict)
    missing: Dict[TaskId, int] = field(default_factory=dict)
    done_tasks: set = field(default_factory=set)
    # eviction-key listeners (EvictionIndex instances): called with the
    # blocks whose ref/eff counters just changed, or None for "everything"
    key_listeners: List = field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        self.rebuild()

    # ------------------------------------------------------------- listeners
    def add_key_listener(self, fn) -> None:
        self.key_listeners.append(fn)

    def _notify(self, blocks: Optional[Iterable[BlockId]]) -> None:
        for fn in self.key_listeners:
            fn(blocks)

    # ---------------------------------------------------------------- derive
    def task_live(self, tid: TaskId) -> bool:
        """A task still *references* its inputs while its output is
        unmaterialized (paper: reference count counts unmaterialized
        dependents)."""
        return tid not in self.done_tasks

    def group_complete(self, tid: TaskId) -> bool:
        return self.missing.get(tid, 0) == 0

    def rebuild(self) -> None:
        """Recompute all counters from scratch (oracle; also used by property
        tests to cross-check the incremental updates)."""
        self.ref_count = {b: 0 for b in self.dag.blocks}
        self.eff_ref_count = {b: 0 for b in self.dag.blocks}
        self.missing = {}
        for t in self.dag.tasks.values():
            self.missing[t.id] = sum(
                1 for b in t.inputs
                if b in self.materialized and b not in self.cached)
        for t in self.dag.tasks.values():
            if not self.task_live(t.id):
                continue
            effective = self.group_complete(t.id)
            for b in t.inputs:
                self.ref_count[b] += 1
                if effective:
                    self.eff_ref_count[b] += 1
        self._notify(None)

    # ---------------------------------------------------------------- events
    def _set_group_effective(self, tid: TaskId, effective: bool) -> None:
        delta = 1 if effective else -1
        inputs = self.dag.tasks[tid].inputs
        for b in inputs:
            self.eff_ref_count[b] += delta
        self._notify(inputs)

    def on_materialized(self, block: BlockId, into_cache: bool = True) -> None:
        """A block was computed (or re-computed). New materialized blocks
        enter the cache unless ``into_cache`` is False (direct-to-disk)."""
        first = block not in self.materialized
        self.materialized.add(block)
        if into_cache:
            if block not in self.cached:
                self.cached.add(block)
                if not first:
                    # was materialized-on-disk: groups lose a missing member
                    self._dec_missing(block)
        else:
            if first:
                # materialized straight to disk: it is "missing" for peers
                self._inc_missing(block, newly_materialized=True)
        if first and into_cache:
            pass  # newly materialized & cached: missing counts unaffected

        producer = self.dag.producer.get(block)
        if producer is not None and producer not in self.done_tasks:
            self.on_task_done(producer)

    def _inc_missing(self, block: BlockId, newly_materialized: bool = False) -> None:
        for tid in self.dag.consumers.get(block, []):
            if not self.task_live(tid):
                continue
            was_complete = self.group_complete(tid)
            self.missing[tid] = self.missing.get(tid, 0) + 1
            if was_complete:
                self._set_group_effective(tid, False)

    def _dec_missing(self, block: BlockId) -> None:
        for tid in self.dag.consumers.get(block, []):
            if not self.task_live(tid):
                continue
            self.missing[tid] = self.missing.get(tid, 0) - 1
            if self.group_complete(tid):
                self._set_group_effective(tid, True)

    def on_evicted(self, block: BlockId) -> List[TaskId]:
        """Block dropped from memory (still materialized, on disk).

        Returns the peer groups that were *complete* before this eviction —
        exactly the set for which the paper's protocol must broadcast.
        """
        if block not in self.cached:
            return []
        self.cached.discard(block)
        flipped = [tid for tid in self.dag.consumers.get(block, [])
                   if self.task_live(tid) and self.group_complete(tid)]
        self._inc_missing(block)
        return flipped

    def on_loaded(self, block: BlockId) -> None:
        """Materialized block fetched back from disk into memory."""
        if block in self.cached or block not in self.materialized:
            return
        self.cached.add(block)
        self._dec_missing(block)

    def on_task_done(self, tid: TaskId) -> None:
        """Task finished: its output is materialized, so its references to
        its inputs are no longer counted (they are no longer references by
        an unmaterialized block)."""
        if tid in self.done_tasks:
            return
        effective = self.group_complete(tid)
        self.done_tasks.add(tid)
        inputs = self.dag.tasks[tid].inputs
        for b in inputs:
            self.ref_count[b] -= 1
            if effective:
                self.eff_ref_count[b] -= 1
        self._notify(inputs)

    def on_task_undone(self, tid: TaskId) -> None:
        """Inverse of ``on_task_done``: the task's output was *lost* (a
        crashed worker took it), so the task must re-run and its references
        to its inputs are live again. ``missing`` is recomputed from the
        sets — it was not maintained while the task sat in
        ``done_tasks``."""
        if tid not in self.done_tasks:
            return
        self.done_tasks.discard(tid)
        inputs = self.dag.tasks[tid].inputs
        self.missing[tid] = sum(
            1 for b in inputs
            if b in self.materialized and b not in self.cached)
        effective = self.missing[tid] == 0
        for b in inputs:
            self.ref_count[b] += 1
            if effective:
                self.eff_ref_count[b] += 1
        self._notify(inputs)

    def on_lost(self, block: BlockId) -> None:
        """Crash loss: the block left memory AND its materialization is
        gone — unlike ``on_evicted`` there is no disk copy to reload, so
        the producing task must re-run (lineage recompute). Consumers stop
        counting it as a *missing* member (an unmaterialized input is
        absent, not missing), and a done producer is resurrected."""
        self.on_evicted(block)
        if block not in self.materialized:
            return
        self.materialized.discard(block)
        # after the eviction above the block was materialized-but-uncached,
        # i.e. "missing" in every live consumer group; unmaterializing it
        # removes it from that count
        self._dec_missing(block)
        producer = self.dag.producer.get(block)
        if producer is not None and producer in self.done_tasks:
            self.on_task_undone(producer)

    def on_task_added(self, tid: TaskId) -> None:
        """Incremental counterpart of ``rebuild`` for one new task: charge
        its references (serve: a request chain arrived). O(group size)."""
        t = self.dag.tasks[tid]
        self.missing[tid] = sum(
            1 for b in t.inputs
            if b in self.materialized and b not in self.cached)
        effective = self.missing[tid] == 0
        for b in t.inputs:
            self.ref_count[b] = self.ref_count.get(b, 0) + 1
            if effective:
                self.eff_ref_count[b] = self.eff_ref_count.get(b, 0) + 1
            else:
                self.eff_ref_count.setdefault(b, 0)
        self._notify(t.inputs)

    def on_task_removed(self, tid: TaskId) -> None:
        """Retire a task entirely (serve: request finished or cancelled):
        settle its counter contributions and forget its bookkeeping. The
        caller may then drop it from the DAG (``JobDAG.remove_task``)."""
        self.on_task_done(tid)
        self.done_tasks.discard(tid)
        self.missing.pop(tid, None)

    def on_removed(self, block: BlockId) -> None:
        """Block deleted entirely (unpersisted): treated as eviction."""
        self.on_evicted(block)
        self.materialized.discard(block)

    def forget_block(self, block: BlockId) -> None:
        """Drop every trace of a block that no live task references (serve:
        radix-skeleton GC). The caller guarantees ``ref_count`` is zero, so
        no counters or group labels change — this only bounds the dicts."""
        self.cached.discard(block)
        self.materialized.discard(block)
        self.ref_count.pop(block, None)
        self.eff_ref_count.pop(block, None)
