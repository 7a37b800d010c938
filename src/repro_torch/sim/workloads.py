"""Mirrors ``src/repro/sim/workloads.py`` verbatim (own copy).

Workload generators mirroring the paper's experiments (§II-C, §IV).

* ``zip_job``: two files, each partitioned into ``n_blocks`` blocks; the
  zip stage pairs block k of file A with block k of file B (paper Fig. 2).
* ``multi_tenant_zip``: 10 tenants × zip jobs over distinct files — the
  §IV EC2 experiment (2 × 400 MB per job, 100 blocks per file).
* ``load_then_zip`` builds the two-stage DAG: a *load* stage materializes
  each source partition from stable storage (populating the cache), then
  the zip stage consumes the pairs.
Arrival-process generators (PR 6) live here too: timed request arrivals
for the serve front door — Poisson (the open-loop baseline), bursty
(on/off, Markov-modulated) and diurnal (sinusoidal rate, thinned) — all
seeded and deterministic, consumed by ``serve.play_trace`` and
``benchmarks/serve_latency.py``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core import BlockMeta, JobDAG, TaskSpec


def zip_job(job_id: str, n_blocks: int, block_size: int,
            n_workers: int = 20, align_homes: bool = True,
            compute_cost: float = 0.0) -> Tuple[JobDAG, List[str]]:
    """Two-stage job: load A[k], B[k] from stable storage, then zip pairwise.

    Returns (dag, zip_output_ids). Source partitions A*[k]/B*[k] are raw
    external data (not cache-managed); the *load* outputs (the RDD blocks)
    are what the cache manages — exactly Spark's scan-then-persist shape.
    """
    dag = JobDAG()
    zip_outputs: List[str] = []
    for fname in ("A", "B"):
        for k in range(n_blocks):
            home = k % n_workers if align_homes else None
            # raw partition on stable storage
            dag.add_block(BlockMeta(f"{job_id}.{fname}raw[{k}]", block_size,
                                    f"{job_id}.{fname}raw", k, home))
            # materialized (cacheable) RDD block
            dag.add_block(BlockMeta(f"{job_id}.{fname}[{k}]", block_size,
                                    f"{job_id}.{fname}", k, home))
    # load stage: file A first, then file B (paper: files partitioned in
    # order; under LRU the later B-blocks push out the A-blocks)
    for fname in ("A", "B"):
        for k in range(n_blocks):
            dag.add_task(TaskSpec(
                id=f"{job_id}.load{fname}[{k:04d}]",
                inputs=(f"{job_id}.{fname}raw[{k}]",),
                output=f"{job_id}.{fname}[{k}]",
                job=job_id, stage=0))
    # zip stage
    for k in range(n_blocks):
        out = f"{job_id}.Z[{k}]"
        dag.add_block(BlockMeta(out, 2 * block_size, f"{job_id}.Z", k,
                                k % n_workers if align_homes else None))
        dag.add_task(TaskSpec(
            id=f"{job_id}.zip[{k:04d}]",
            inputs=(f"{job_id}.A[{k}]", f"{job_id}.B[{k}]"),
            output=out, job=job_id, stage=1))
        zip_outputs.append(out)
    return dag, zip_outputs


def multi_tenant_zip(n_jobs: int = 10, n_blocks: int = 100,
                     file_mb: int = 400, n_workers: int = 20
                     ) -> List[Tuple[JobDAG, List[str]]]:
    """The paper's §IV workload: 10 tenants, 2 × 400 MB files each,
    100 blocks per file → 8 GB of cacheable input blocks in total."""
    block_size = file_mb * 2 ** 20 // n_blocks
    return [zip_job(f"job{j}", n_blocks, block_size, n_workers)
            for j in range(n_jobs)]


def zip_access_trace(n_jobs: int, n_blocks: int) -> List[str]:
    """Approximate future block-access order for the Belady oracle:
    round-robin over jobs, zip tasks in partition order."""
    trace: List[str] = []
    for k in range(n_blocks):
        for j in range(n_jobs):
            trace.append(f"job{j}.A[{k}]")
            trace.append(f"job{j}.B[{k}]")
    return trace


def coalesce_job(job_id: str, n_groups: int, group_size: int,
                 block_size: int, n_workers: int = 20
                 ) -> Tuple[JobDAG, List[str]]:
    """k-ary peer groups (Spark coalesce/join with ``group_size`` inputs):
    the all-or-nothing property sharpens as k grows — the probability that
    a peer-oblivious policy keeps ALL k inputs resident falls
    geometrically, so LERC's advantage should WIDEN with k (paper §II-C
    names join/coalesce alongside zip; this workload measures the claim)."""
    dag = JobDAG()
    outputs: List[str] = []
    for g in range(n_groups):
        for j in range(group_size):
            home = (g * group_size + j) % n_workers
            dag.add_block(BlockMeta(f"{job_id}.raw[{g}.{j}]", block_size,
                                    f"{job_id}.raw{g}", j, home))
            dag.add_block(BlockMeta(f"{job_id}.in[{g}.{j}]", block_size,
                                    f"{job_id}.in{g}", j, home))
    # load order is FILE-major (input j of every group together), matching
    # Spark scanning k input RDDs one file at a time — the interleaving
    # that defeats recency (the paper's Fig. 1 mechanism, generalized)
    for j in range(group_size):
        for g in range(n_groups):
            dag.add_task(TaskSpec(
                id=f"{job_id}.load[{j:02d}.{g:03d}]",
                inputs=(f"{job_id}.raw[{g}.{j}]",),
                output=f"{job_id}.in[{g}.{j}]", job=job_id, stage=0))
    for g in range(n_groups):
        out = f"{job_id}.C[{g}]"
        dag.add_block(BlockMeta(out, group_size * block_size,
                                f"{job_id}.C", g, g % n_workers))
        dag.add_task(TaskSpec(
            id=f"{job_id}.coalesce[{g:03d}]",
            inputs=tuple(f"{job_id}.in[{g}.{j}]"
                         for j in range(group_size)),
            output=out, job=job_id, stage=1))
        outputs.append(out)
    return dag, outputs


# ---------------------------------------------------------------------------
# Arrival processes (PR 6): timed request arrivals for the serve front door
# ---------------------------------------------------------------------------


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> List[float]:
    """``n`` arrival times of a homogeneous Poisson process with ``rate``
    arrivals per unit of virtual time (exponential i.i.d. gaps)."""
    assert rate > 0
    rng = np.random.default_rng(seed)
    return list(np.cumsum(rng.exponential(1.0 / rate, size=n)))


def bursty_arrivals(n: int, rate: float, seed: int = 0, *,
                    burst_factor: float = 8.0, p_burst: float = 0.15,
                    mean_burst: int = 8) -> List[float]:
    """On/off (Markov-modulated) Poisson arrivals: the process alternates
    between a quiet phase at ``rate`` and bursts of ~``mean_burst``
    requests arriving ``burst_factor``× faster — the flash-crowd shape
    that separates deadline-aware scheduling from FCFS hardest."""
    assert rate > 0
    rng = np.random.default_rng(seed)
    t, out, left = 0.0, [], 0           # left = arrivals left in the burst
    while len(out) < n:
        if left == 0 and rng.random() < p_burst:
            left = 1 + rng.geometric(1.0 / mean_burst)
        r = rate * burst_factor if left > 0 else rate
        left = max(left - 1, 0)
        t += rng.exponential(1.0 / r)
        out.append(t)
    return out


def diurnal_arrivals(n: int, rate: float, seed: int = 0, *,
                     period: float = 200.0, depth: float = 0.8
                     ) -> List[float]:
    """Non-homogeneous Poisson arrivals with a sinusoidal rate
    ``rate * (1 + depth * sin(2πt/period))`` — the day/night load swing —
    generated by thinning against the peak rate."""
    assert rate > 0 and 0 <= depth <= 1
    rng = np.random.default_rng(seed)
    peak = rate * (1 + depth)
    t, out = 0.0, []
    while len(out) < n:
        t += rng.exponential(1.0 / peak)
        lam = rate * (1 + depth * np.sin(2 * np.pi * t / period))
        if rng.random() < lam / peak:
            out.append(t)
    return out
