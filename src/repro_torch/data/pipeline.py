"""Mirrors ``src/repro/data/pipeline.py`` verbatim (own copy).

Lineage-DAG data pipeline with a LERC-managed block cache.

This is the paper's mechanism embedded in a *real* input pipeline: every
transform declares its lineage, multi-input transforms (``zip_``,
``coalesce``) create peer groups, and the executor runs tasks against a
``CacheManager`` whose eviction policy is pluggable (LRU/LRC/LERC/...).
Evicted blocks spill to disk (real ``.npy`` I/O); a cache miss re-reads
them — so the effective-cache-hit ratio measured here maps directly onto
bytes NOT re-read from disk, the paper's Fig. 3 mechanism.

On a TPU training cluster there is one executor per host feeding that
host's device slice; ``repro.data.loader`` adds sharding/prefetch/resume.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import (BlockMeta, CacheManager, CacheMetrics, DagState, JobDAG,
                    TaskSpec, make_policy)


@dataclass(frozen=True)
class DataRef:
    """A logical dataset inside a pipeline: ``n_blocks`` partitions."""

    dataset: str
    n_blocks: int

    def block_id(self, i: int) -> str:
        return f"{self.dataset}[{i}]"


class Pipeline:
    """Builds the lineage DAG. Transforms are lazy; ``Executor`` runs them."""

    def __init__(self, name: str = "pipe") -> None:
        self.name = name
        self.dag = JobDAG()
        self._sources: Dict[str, List[np.ndarray]] = {}
        self._fns: Dict[str, Callable[..., np.ndarray]] = {}
        self._counter = 0

    def _fresh(self, kind: str) -> str:
        self._counter += 1
        return f"{self.name}.{kind}{self._counter}"

    # ------------------------------------------------------------- builders
    def source(self, arrays: Sequence[np.ndarray],
               name: Optional[str] = None) -> DataRef:
        """Materialized source partitions (rows of a dataset)."""
        ds = name or self._fresh("src")
        ref = DataRef(ds, len(arrays))
        self._sources[ds] = list(arrays)
        for i, a in enumerate(arrays):
            self.dag.add_block(BlockMeta(ref.block_id(i), a.nbytes, ds, i))
        return ref

    def map(self, ref: DataRef, fn: Callable[[np.ndarray], np.ndarray],
            name: Optional[str] = None,
            out_bytes_factor: float = 1.0) -> DataRef:
        ds = name or self._fresh("map")
        out = DataRef(ds, ref.n_blocks)
        for i in range(ref.n_blocks):
            src = self.dag.blocks[ref.block_id(i)]
            self.dag.add_block(BlockMeta(
                out.block_id(i), max(1, int(src.size * out_bytes_factor)),
                ds, i))
            tid = f"{ds}.t[{i}]"
            self.dag.add_task(TaskSpec(tid, (ref.block_id(i),),
                                       out.block_id(i), job=self.name))
            self._fns[tid] = fn
        return out

    def zip_(self, refs: Sequence[DataRef],
             fn: Callable[..., np.ndarray],
             name: Optional[str] = None) -> DataRef:
        """Multi-input transform: block i of every ref forms a PEER GROUP
        (the paper's all-or-nothing unit)."""
        n = refs[0].n_blocks
        assert all(r.n_blocks == n for r in refs)
        ds = name or self._fresh("zip")
        out = DataRef(ds, n)
        for i in range(n):
            size = sum(self.dag.blocks[r.block_id(i)].size for r in refs)
            self.dag.add_block(BlockMeta(out.block_id(i), size, ds, i))
            tid = f"{ds}.t[{i}]"
            self.dag.add_task(TaskSpec(
                tid, tuple(r.block_id(i) for r in refs), out.block_id(i),
                job=self.name))
            self._fns[tid] = fn
        return out

    def coalesce(self, ref: DataRef, factor: int,
                 fn: Optional[Callable[..., np.ndarray]] = None,
                 name: Optional[str] = None) -> DataRef:
        """Merge ``factor`` consecutive blocks into one (peer group of
        ``factor``)."""
        assert ref.n_blocks % factor == 0
        ds = name or self._fresh("coalesce")
        out = DataRef(ds, ref.n_blocks // factor)
        fn = fn or (lambda *xs: np.concatenate(xs))
        for i in range(out.n_blocks):
            inputs = tuple(ref.block_id(i * factor + j)
                           for j in range(factor))
            size = sum(self.dag.blocks[b].size for b in inputs)
            self.dag.add_block(BlockMeta(out.block_id(i), size, ds, i))
            tid = f"{ds}.t[{i}]"
            self.dag.add_task(TaskSpec(tid, inputs, out.block_id(i),
                                       job=self.name))
            self._fns[tid] = fn
        return out


@dataclass
class ExecStats:
    disk_reads: int = 0
    disk_read_bytes: int = 0
    disk_writes: int = 0
    recomputes: int = 0
    tasks_run: int = 0
    io_seconds: float = 0.0


class Executor:
    """Runs pipeline tasks against a policy-managed two-tier block store.

    * in-memory tier: ``{block_id: np.ndarray}`` bounded by ``cache_bytes``
      and managed by the chosen eviction policy,
    * disk tier: ``spill_dir/<block>.npy`` — written on first eviction,
      re-read (with real file I/O) on a subsequent miss.
    """

    def __init__(self, pipe: Pipeline, cache_bytes: int,
                 policy: str = "lerc", spill_dir: Optional[str] = None,
                 policy_kwargs: Optional[dict] = None) -> None:
        self.pipe = pipe
        self.state = DagState(pipe.dag)
        self.metrics = CacheMetrics()
        self.policy = make_policy(policy, **(policy_kwargs or {}))
        self.mgr = CacheManager(cache_bytes, self.policy, self.state,
                                metrics=self.metrics,
                                on_evict=self._spill)
        self.spill_dir = spill_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), f"repro_spill_{id(self)}")
        os.makedirs(self.spill_dir, exist_ok=True)
        self._mem: Dict[str, np.ndarray] = {}
        self.stats = ExecStats()

    # --------------------------------------------------------------- tiers
    def _path(self, block: str) -> str:
        safe = block.replace("/", "_").replace("[", "_").replace("]", "")
        return os.path.join(self.spill_dir, f"{safe}.npy")

    def _spill(self, block: str, flipped_groups) -> None:
        arr = self._mem.pop(block, None)
        if arr is None:
            return
        path = self._path(block)
        if not os.path.exists(path):
            t0 = time.perf_counter()
            np.save(path, arr)
            self.stats.io_seconds += time.perf_counter() - t0
            self.stats.disk_writes += 1

    def _fetch(self, block: str) -> np.ndarray:
        """Block value, loading from disk / recomputing lineage on miss."""
        if block in self._mem:
            return self._mem[block]
        path = self._path(block)
        if os.path.exists(path):
            t0 = time.perf_counter()
            arr = np.load(path)
            self.stats.io_seconds += time.perf_counter() - t0
            self.stats.disk_reads += 1
            self.stats.disk_read_bytes += arr.nbytes
            self.mgr.load_from_disk(block)
            self._mem[block] = arr
            return arr
        # source block never materialized: read from the pipeline source
        meta = self.pipe.dag.blocks[block]
        if meta.dataset in self.pipe._sources:
            arr = self.pipe._sources[meta.dataset][meta.index]
            return arr  # stable storage: not cache-managed
        # lineage recompute (lost intermediate — e.g. spill file removed)
        self.stats.recomputes += 1
        producer = self.pipe.dag.producer[block]
        return self._run_task(producer)

    # --------------------------------------------------------------- tasks
    def _run_task(self, tid: str) -> np.ndarray:
        spec = self.pipe.dag.tasks[tid]
        self.mgr.pin(*spec.inputs)
        try:
            self.mgr.access_task_inputs(tid)       # hit/effective metrics
            args = [self._fetch(b) for b in spec.inputs]
        finally:
            self.mgr.unpin(*spec.inputs)
        out = self.pipe._fns[tid](*args)
        self.stats.tasks_run += 1
        self._insert(spec.output, out)
        self.state.on_task_done(tid)
        return out

    def _insert(self, block: str, arr: np.ndarray) -> None:
        self._mem[block] = arr
        victims = self.mgr.insert(block, arr.nbytes)
        # (victims already spilled via the on_evict hook)

    # ----------------------------------------------------------------- api
    def load_sources(self, ref: DataRef) -> None:
        """Materialize source partitions into the cache (ingest stage)."""
        for i in range(ref.n_blocks):
            b = ref.block_id(i)
            if b not in self._mem and not self.mgr.in_memory(b):
                arr = self.pipe._sources[ref.dataset][i]
                self._insert(b, arr)
                self.state.on_materialized(b, into_cache=True)

    def materialize(self, ref: DataRef) -> List[np.ndarray]:
        """Run every task needed to produce ``ref``, in topological order."""
        needed = {ref.block_id(i) for i in range(ref.n_blocks)}
        for task in self.pipe.dag.topological_tasks():
            if task.id in self.state.done_tasks:
                continue
            self._run_task(task.id)
        return [self._fetch(b) for b in sorted(
            needed, key=lambda b: self.pipe.dag.blocks[b].index)]

    def get(self, ref: DataRef, i: int) -> np.ndarray:
        b = ref.block_id(i)
        producer = self.pipe.dag.producer.get(b)
        if producer is not None and producer not in self.state.done_tasks:
            return self._run_task(producer)
        return self._fetch(b)
