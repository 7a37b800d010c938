"""Mirrors ``src/repro/serve/scheduler.py`` verbatim (own copy).

Deadline-aware step scheduling for the serve front door (PR 6).

The engine's step loop asks a ``Scheduler`` two questions:

* **admission** — when a slot frees, *which* queued request takes it
  (``admit_idx``): FIFO for the baseline schedulers, earliest-deadline-
  first for the budgeted one;
* **prefill planning** — how many prompt tokens each prefilling slot may
  feed *this step* (``plan_prefill``). Decode slots are always packed
  first by the engine (one token each, pipelined feeds); the scheduler
  only divides the step's *prefill* work.

Three policies:

* ``fcfs`` — every prefilling slot feeds its full chunk every step. This
  is exactly the pre-scheduler engine behavior (and is the default), so a
  scheduled engine degrades bit-identically to the old ``run()`` loop —
  ``tests/test_engine_equivalence.py`` proves it.
* ``decode-first`` — prefill runs only on steps with no decode work:
  TPOT is never taxed by prefill, TTFT starves behind long decodes. One
  extreme of the tradeoff the budgeted scheduler navigates.
* ``budgeted`` — each step spends at most ``prefill_budget`` prompt
  tokens, allocated earliest-deadline-first across prefilling slots
  (ties: arrival order). A long prefill is *preempted* — fed zero tokens
  — whenever more urgent prompts exhaust the budget, so a new arrival's
  TTFT and the decode slots' TPOT are both bounded by
  ``base + per_token * (budget + decode_slots)`` per step instead of
  ``per_token * (slots * chunk)``.

Because greedy decoding with KV-exact prefix restore makes a request's
tokens independent of *when* its chunks are scheduled, all three policies
produce token-identical generations — scheduling moves latency, never
text. Eviction logs may legitimately differ (store ops reorder).

Time is **virtual**: the engine advances its clock by ``StepCostModel``
per step (affine in the tokens dispatched), so scheduled runs, TTFT/TPOT
percentiles, and goodput are deterministic under a seeded arrival trace —
on CI CPU as on a TPU pod. ``play_trace`` is the front-door event loop
that drives an engine (or a ``ShardedFrontend``, per-shard queues) from a
timed arrival trace with admission control and backpressure.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs.trace import TID_SCHED as _TID_SCHED


def _trace_retry(eng, tries: int, wait: float) -> None:
    """Mark a QueueFull-bounced arrival's re-offer on the trace, so
    ``trace_report`` can split retried bounces from final rejections
    (the engine's own ``rejected`` instant fires for both)."""
    rec = getattr(eng, "trace", None)
    if rec is not None:
        rec.instant("sched.retry", "sched", eng._trace_pid, _TID_SCHED,
                    args={"tries": tries, "wait": wait})


class QueueFull(RuntimeError):
    """Backpressure: the engine's admission queue is at ``max_queue``.

    Carries actionable hints for the client: ``depth`` (how deep the
    queue it bounced off is) and ``retry_after`` (the engine's
    ``StepCostModel`` estimate of virtual-clock time until a slot —
    and hence a queue position — frees)."""

    def __init__(self, msg: str = "", depth: Optional[int] = None,
                 retry_after: Optional[float] = None) -> None:
        super().__init__(msg)
        self.depth = depth
        self.retry_after = retry_after


@dataclass(frozen=True)
class StepCostModel:
    """Virtual wall-clock of one engine step: fixed dispatch/host overhead
    (``base``), per-token MLP/projection FLOPs (``per_token``), and — when
    ``per_attn`` is nonzero — the attention term, linear in KV *pairs*
    read this step (Σ over slots of tokens_fed × context_length). The
    attention term is what makes a long prompt's late prefill chunks
    disproportionately expensive, and therefore what a deadline-aware
    scheduler can keep off the steps interactive requests share (the
    stall-free-batching observation). Units are abstract milliseconds;
    the *ratios* between schedulers, not the absolute numbers, are the
    measurement."""
    base: float = 0.25
    per_token: float = 0.05
    per_attn: float = 0.0

    def __call__(self, prefill_tokens: int, decode_tokens: int,
                 attn_pairs: int = 0) -> float:
        return (self.base
                + self.per_token * (prefill_tokens + decode_tokens)
                + self.per_attn * attn_pairs)


def _deadline_key(r):
    """EDF order: requests with deadlines first (earliest first), then
    arrival order; rid breaks exact ties deterministically."""
    return (r.deadline is None,
            r.deadline if r.deadline is not None else 0.0,
            r.arrival, r.rid)


class Scheduler:
    """Base policy = FCFS admission + full-chunk prefill for everyone."""

    name = "fcfs"

    def admit_idx(self, queue: Sequence) -> int:
        """Index into ``queue`` of the request that takes the free slot."""
        return 0

    def plan_prefill(self, prefilling: List, chunk: int, n_decode: int
                     ) -> Dict[int, int]:
        """slot -> prompt tokens to feed this step (omitted slots idle).
        ``prefilling`` holds the active prefill-phase requests in slot
        order; the engine has already packed ``n_decode`` decode slots
        (one token each) into the same dispatch."""
        return {r.slot: min(chunk, len(r.prompt) - r.pos)
                for r in prefilling}


class FCFSScheduler(Scheduler):
    pass


class DecodeFirstScheduler(Scheduler):
    """Strict decode priority: prefill only on steps with no decode
    work — TPOT is never taxed by prefill, TTFT starves behind decodes."""

    name = "decode-first"

    def plan_prefill(self, prefilling, chunk, n_decode):
        if n_decode > 0:
            return {}
        return super().plan_prefill(prefilling, chunk, n_decode)


class BudgetedScheduler(Scheduler):
    """Deadline-aware prefill budgeting: decode packs first, then up to
    ``prefill_budget`` prompt tokens are spent earliest-deadline-first
    across prefilling slots; slots past the budget are preempted (fed 0).
    ``prefill_budget=None`` removes the cap (degrades to FCFS planning);
    ``prefill_budget=0`` degrades to strict decode-first.

    When the engine's ``StepCostModel`` has a nonzero attention term, a
    chunk is charged its *cost-equivalent* tokens — ``n`` tokens at
    context position ``p`` cost like ``n * (1 + (per_attn/per_token) *
    (p+n))`` flat ones — so the late, expensive chunks of a long prompt
    automatically shrink to fit the budget. That bounds every step at
    ``~base + per_token*(budget + decodes)`` regardless of how deep into
    a long context a slot is, which is the whole point: TPOT and new
    arrivals' TTFT never inherit a long prefill's attention bill. (The
    engine wires its own clock in when the scheduler doesn't carry one.)"""

    name = "budgeted"

    def __init__(self, prefill_budget: Optional[int] = None,
                 clock: Optional[StepCostModel] = None) -> None:
        self.prefill_budget = prefill_budget
        self.clock = clock

    def admit_idx(self, queue):
        best, best_key = 0, None
        for i, r in enumerate(queue):
            k = _deadline_key(r)
            if best_key is None or k < best_key:
                best, best_key = i, k
        return best

    def _eff_tokens(self, n: int, pos: int) -> int:
        """Cost-equivalent flat tokens of an ``n``-token chunk whose
        context ends at ``pos + n``."""
        c = self.clock
        if n <= 0 or c is None or not c.per_attn or not c.per_token:
            return n
        return n + int(round(c.per_attn * n * (pos + n) / c.per_token))

    def plan_prefill(self, prefilling, chunk, n_decode):
        if self.prefill_budget is None:
            return super().plan_prefill(prefilling, chunk, n_decode)
        left = self.prefill_budget
        plan: Dict[int, int] = {}
        for r in sorted(prefilling, key=_deadline_key):
            if left <= 0:
                break
            n = min(chunk, len(r.prompt) - r.pos)
            while n > 0 and self._eff_tokens(n, r.pos) > left:
                n -= 1
            if n > 0:
                plan[r.slot] = n
                left -= self._eff_tokens(n, r.pos)
        return plan


_SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "decode-first": DecodeFirstScheduler,
    "budgeted": BudgetedScheduler,
}


def make_scheduler(name: str, *, prefill_budget: Optional[int] = None
                   ) -> Scheduler:
    if name not in _SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}; "
                         f"have {sorted(_SCHEDULERS)}")
    if name == "budgeted":
        return BudgetedScheduler(prefill_budget)
    return _SCHEDULERS[name]()


# ---------------------------------------------------------------------------
# Front-door event loop: timed arrivals -> submit/step/backpressure
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TracedRequest:
    """One arrival of a timed trace. ``deadline`` is the *relative* TTFT
    SLO (first token due by ``t + deadline`` on the virtual clock);
    ``None`` means best-effort."""
    t: float
    prompt: Sequence[int]
    max_new: int = 16
    deadline: Optional[float] = None


@dataclass
class TraceReport:
    requests: List = field(default_factory=list)   # admitted Requests
    rejected: int = 0                              # shed by backpressure
    retried: int = 0                               # rejected, then re-offered

    def merge(self, other: "TraceReport") -> "TraceReport":
        return TraceReport(self.requests + other.requests,
                           self.rejected + other.rejected,
                           self.retried + other.retried)


def _engine_idle(eng) -> bool:
    return not eng.queue and all(s is None for s in eng.slots)


def _play_engine(front, eng, trace: List[TracedRequest],
                 max_steps: int, retry_rejected: int = 0) -> TraceReport:
    """Drive one engine from a time-sorted trace: submit every arrival the
    virtual clock has reached (rejections count, not raise), advance the
    clock over idle gaps, step while there is work. ``front`` is what
    ``submit`` is called on (the engine itself, or a ShardedFrontend that
    routes + announces and lands the request on ``eng``).

    ``retry_rejected`` > 0 re-offers each ``QueueFull``-bounced arrival up
    to that many times, waiting out the rejection's ``retry_after`` hint;
    retries keep the original arrival time, so the wait shows up in TTFT
    and counts against goodput."""
    report = TraceReport()
    pending = [(tr.t, i, 0, tr) for i, tr in enumerate(trace)]
    heapq.heapify(pending)
    seq = itertools.count(len(trace))
    for _ in range(max_steps):
        while pending and pending[0][0] <= eng.now:
            _, _, tries, tr = heapq.heappop(pending)
            abs_deadline = None if tr.deadline is None else tr.t + tr.deadline
            try:
                req = front.submit(tr.prompt, max_new=tr.max_new,
                                   deadline=abs_deadline, arrival=tr.t)
            except QueueFull as e:
                if tries < retry_rejected:
                    wait = e.retry_after if e.retry_after else 1.0
                    heapq.heappush(pending, (eng.now + wait, next(seq),
                                             tries + 1, tr))
                    report.retried += 1
                    _trace_retry(eng, tries + 1, wait)
                else:
                    report.rejected += 1
                continue
            if isinstance(req, tuple):          # ShardedFrontend returns
                req = req[1]                    # (shard, Request)
            report.requests.append(req)
        if _engine_idle(eng):
            if not pending:
                return report
            eng.now = max(eng.now, pending[0][0])  # jump the idle gap
            continue
        eng.step()
    raise RuntimeError(f"trace not drained in {max_steps} steps")


def _play_frontend(front, trace: List[TracedRequest], max_steps: int,
                   retry_rejected: int = 0) -> TraceReport:
    """Interleaved front-door loop for a fault-injected ``ShardedFrontend``:
    all shards step round-robin through ``front.step()`` (where crash
    detection and failover live), and each arrival is submitted once its
    own shard's clock reaches it. The per-shard sequential replay in
    ``play_trace`` cannot drive crash recovery — a crashed shard's
    requeued requests must interleave with the other shards' progress."""
    report = TraceReport()
    pending = [(tr.t, i, 0, tr) for i, tr in enumerate(trace)]
    heapq.heapify(pending)
    seq = itertools.count(len(trace))
    for _ in range(max_steps):
        while pending:
            t, _, tries, tr = pending[0]
            eng = front.shards[front.shard_of(tr.prompt)]
            if t > eng.now:
                break
            heapq.heappop(pending)
            abs_deadline = None if tr.deadline is None else tr.t + tr.deadline
            try:
                _, req = front.submit(tr.prompt, max_new=tr.max_new,
                                      deadline=abs_deadline, arrival=tr.t)
            except QueueFull as e:
                if tries < retry_rejected:
                    wait = e.retry_after if e.retry_after else 1.0
                    heapq.heappush(pending, (eng.now + wait, next(seq),
                                             tries + 1, tr))
                    report.retried += 1
                    _trace_retry(eng, tries + 1, wait)
                else:
                    report.rejected += 1
                continue
            report.requests.append(req)
        if not any(e.queue or any(s is not None for s in e.slots)
                   for e in front.shards):
            if not pending:
                return report
            t = pending[0][0]
            for e in front.shards:
                e.now = max(e.now, t)           # jump the idle gap
            continue
        front.step()
    raise RuntimeError(f"trace not drained in {max_steps} steps")


def play_trace(engine, trace: Sequence[TracedRequest], *,
               max_steps: int = 1_000_000,
               retry_rejected: int = 0) -> TraceReport:
    """Run a timed arrival trace through a ``ServeEngine`` or a
    ``ShardedFrontend``. Shards are independent servers with independent
    virtual clocks, so a frontend trace is split by the (unchanged)
    prefix-affinity router and each shard replays its own arrivals —
    per-shard queues, per-shard backpressure. A fault-injected frontend
    instead runs the interleaved loop (shard crashes re-route work across
    shards mid-trace, so the shards cannot replay independently)."""
    trace = sorted(trace, key=lambda r: r.t)
    if hasattr(engine, "shards"):               # ShardedFrontend
        faults = getattr(engine, "faults", None)
        if faults is not None and not faults.plan.empty:
            # an empty plan injects nothing, so the (bit-identical)
            # per-shard replay below serves it too
            return _play_frontend(engine, trace, max_steps, retry_rejected)
        per_shard: Dict[int, List[TracedRequest]] = {}
        for tr in trace:
            per_shard.setdefault(engine.shard_of(tr.prompt), []).append(tr)
        report = TraceReport()
        for k, shard_trace in sorted(per_shard.items()):
            report = report.merge(
                _play_engine(engine, engine.shards[k], shard_trace,
                             max_steps, retry_rejected))
        return report
    return _play_engine(engine, engine, trace, max_steps, retry_rejected)


# ---------------------------------------------------------------------------
# Latency accounting
# ---------------------------------------------------------------------------


def _pct(xs: List[float], q: float) -> float:
    # empty sample -> 0.0, not NaN: a trace where nothing finished must
    # still produce a numeric (JSON-safe, comparable) report
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def latency_stats(report: TraceReport) -> Dict[str, float]:
    """TTFT/TPOT percentiles and goodput-under-deadline for a finished
    trace. TTFT = first decode token computed minus arrival; TPOT = mean
    inter-token time over a request's decode phase. Goodput counts a
    request iff it was admitted, not cancelled, and its first token
    landed by its deadline (no-deadline requests count when they
    complete); rejected arrivals count against the denominator. NaN-free
    by construction: an empty or zero-offered trace reports zeros."""
    ttft = [r.first_token_at - r.arrival for r in report.requests
            if r.first_token_at is not None]
    tpot = [(r.finished_at - r.first_token_at) / (len(r.generated) - 1)
            for r in report.requests
            if r.finished_at is not None and r.first_token_at is not None
            and len(r.generated) > 1]
    met = 0
    for r in report.requests:
        if r.cancelled or r.first_token_at is None:
            continue
        if r.deadline is None:
            met += r.finished_at is not None
        else:
            met += r.first_token_at <= r.deadline
    offered = len(report.requests) + report.rejected
    out = {"n_offered": offered, "n_rejected": report.rejected,
           "n_retried": getattr(report, "retried", 0),
           "goodput": round(float(met) / max(offered, 1), 4)}
    for name, xs in (("ttft", ttft), ("tpot", tpot)):
        for q in (50, 95, 99):
            out[f"{name}_p{q}"] = round(_pct(xs, q), 4)
    return out
