"""Continuous-batching serve engine over a device-resident KV block pool,
with a LERC prefix cache underneath; mirrors ``src/repro/serve/engine.py``
on both of its data planes.

* **Chunked prefill** — each engine step feeds up to ``prefill_chunk``
  prompt tokens per slot through one batched decode step; prefill-chunk
  slots and decode slots share the dispatch. On the paged plane the step
  runs on packed token rows (``step_graph.pack_feed``,
  ``models.lm_packed_step``): a decoding slot's one token and each
  prefilling slot's chunk, one after another, padded only to a bucket of
  rows (B up to B tokens, else the next multiple of the chunk), so a
  decoding slot costs one row whether or not another slot prefills. On
  the gather plane the step is a (B, S) grid, every slot's feed
  right-padded to the widest and masked.
* **Zero-copy paged attention** (``paged=True``) — the ``KVBlockPool`` is
  the ONLY KV storage. Each slot owns a *block table* (host-side list of
  pool rows); a prefix hit appends the store's rows to the table (zero
  copies), new tokens are written by the model straight into the slot's
  tail pool rows (in place), attention streams from the rows the table
  names (the CUDA paged-attention kernel on the card, its plain version on
  the CPU), and publish is an ownership transfer of the already-written
  rows to the store. Rows are refcounted: evicting a block another slot
  still reads defers the reclaim to that slot's completion.
* **Gather plane** (``paged=False``, the default) — per-slot contiguous
  caches, written in place; a hit is a gather pool→slot, publish a scatter
  slot→pool, and every one-token attention runs the CUDA flash-decoding
  kernel on the card (its plain version on the CPU). The only plane for
  patterns with rolling-window (L) layers, whose KV layout is not
  absolute-position: those run the store's lookups and evictions but
  recompute their prefill instead of restoring it.
* **Pipelined host readback** — the argmax token of step N is routed into
  step N+1's feed *on device*, so the engine only waits on a device→host
  copy when a request finishes (or every ``eos_interval`` steps when EOS
  detection is on).
* **The step as one captured program** (``step_graph.StepProgram``, the
  counterpart of the reference's jitted ``_step_fn``) — on the card each
  step signature, (T, S, NW) on the paged plane (packed rows, K1's tile
  width, table width) and S on the gather plane, runs eagerly when first
  seen, is captured into a CUDA graph (the
  kernels launched inside it) when seen again, and replays from then on
  (``cuda_graphs``); on the CPU the same program runs eagerly.

* **The compressed tier ladder** (``store=TieredKVStore(...)``) — the
  engine builds the store's host pool (page-locked when the device pool is
  on CUDA) and, when budgeted, its disk pool, and attaches them: device-
  pressure victims demote to host memory (transcoded to int8/fp8 with
  ``kv_quant``), host-pressure victims to the disk tier, and a lookup that
  walks over demoted blocks promotes the chain back into the device pool
  in place, so the captured steps stay valid. ``close()`` tears the disk
  tier's files down.

* **Tensor parallelism** (``tp > 1`` or ``kv_shard``, a
  ``sharding.KVShardCtx``; paged plane only) — one process per rank, each
  running this engine on replicated weights: a rank's pool (and its host
  and disk tiers) holds its ``KV/tp`` heads of every leaf, its attention
  runs on its head slice and all-gathers the outputs over heads before
  ``wo``, and every host-side decision (admission, block tables, the
  store's evictions, demotions and promotions) is the same on every rank,
  since the store prices global bytes and quantized tiers scale each
  block by its amax over the group. The tokens are those of tp=1. Each
  rank's disk tier needs a directory of its own, which whoever builds the
  store chooses (``launch/serve.py`` and ``ShardedFrontend`` add a
  ``rank{r}`` subdirectory).

Store-visible behaviour (the sequence of ``register_request`` / ``lookup``
/ ``insert`` / ``complete_request`` calls and so every eviction, demotion
and promotion decision) is the reference engine's, op for op:
``tests/test_torch_engine.py`` and ``tests/test_torch_tiered.py`` hold the
two to identical tokens, eviction logs and metrics.

``step_hlo`` is refused with ``NotImplementedError``: the port's step has
no HLO; on the card it is a captured CUDA graph.
"""
from __future__ import annotations

import itertools
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.api import decode_cache_shapes, init_decode_cache
from ..models.common import ModelConfig, tree_map, tree_paths
from ..obs.device import DEVICE_LANE, TID_DEVICE as _TID_DEVICE, DeviceSteps
from ..obs.trace import (TID_ENGINE as _TID_ENGINE, TID_REQ as _TID_REQ,
                         TID_SCHED as _TID_SCHED, TID_STORE as _TID_STORE)
from ..sharding import KVShardCtx, serve_tp_context
from .disk_pool import DiskBlockPool
from .host_pool import HostBlockPool
from .kv_pool import KVBlockPool, chain_block_nbytes
from .prefix_store import PrefixStore
from .scheduler import QueueFull, Scheduler, StepCostModel, make_scheduler
from .step_graph import DenseFeed, StepProgram, pack_feed
from .tiered import TieredKVStore

# pool rows a default-constructed engine starts with when the store's byte
# budget is effectively unbounded (the pool doubles on demand)
_DEFAULT_POOL_BLOCKS = 256


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Asking for CUDA where there is none raises; nothing falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless asked "
            "for the CPU (pass device='cpu', or --device cpu)")
    return dev


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    prefix_rid: int = -1            # id inside the PrefixStore
    slot: int = -1
    pos: int = 0                    # next position to fill
    generated: List[int] = field(default_factory=list)
    n_generated: int = 0            # tokens emitted (generated may lag:
                                    # pipelined readback materializes lazily)
    prefill_skipped: int = 0
    done: bool = False
    cancelled: bool = False
    # front-door timing, on the engine's virtual clock (scheduler SLOs)
    arrival: float = 0.0
    deadline: Optional[float] = None    # absolute TTFT deadline, or None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # failover re-admission (repro_torch.faults): how many times a crash
    # has requeued this request, and the backoff gate before it may
    # re-admit
    retries: int = 0
    not_before: float = 0.0
    # un-synced per-step token vectors (pipelined readback)
    _lazy_out: List = field(default_factory=list, repr=False)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_seq: int = 256, store: Optional[PrefixStore] = None,
                 eos_id: int = -1, prefill_chunk: int = 8,
                 pool_blocks: Optional[int] = None,
                 paged: bool = False,
                 scheduler: Union[str, Scheduler, None] = None,
                 max_queue: Optional[int] = None,
                 clock: Optional[StepCostModel] = None,
                 eos_interval: int = 8, tp: int = 1,
                 kv_shard: Optional[KVShardCtx] = None,
                 device: Union[str, torch.device, None] = None,
                 cuda_graphs: Optional[bool] = None) -> None:
        """``cuda_graphs``: run each step as a captured CUDA graph (None:
        on the card yes, on the CPU no, as ``decode_kernel="auto"``
        chooses; True on the CPU raises). ``tp > 1`` without ``kv_shard``
        takes this process's rank in the initialized group
        (``serve_tp_context``)."""
        self.device = resolve_device(device)
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, got "
                             f"{self.device}: the CPU runs the step eagerly")
        # KV leaves as meta tensors: shapes and dtypes, no memory
        template = tree_map(
            lambda s: torch.empty(s, dtype=cfg.dtype, device="meta"),
            decode_cache_shapes(cfg, 1, 8))
        for path, _ in tree_paths(template):
            assert path[-1] in ("k", "v"), (
                "ServeEngine supports uniform-KV patterns; got leaf "
                f"{'/'.join(path)}")
        absolute_kv = set(cfg.layer_pattern) <= {"G", "M"}
        if prefill_chunk > 1 and not absolute_kv:
            warnings.warn(
                "chunked prefill needs absolute-position KV caches; "
                f"pattern {cfg.layer_pattern!r} has rolling/recurrent "
                "layers — clamping prefill_chunk to 1", stacklevel=2)
            prefill_chunk = 1
        if paged and not absolute_kv:
            warnings.warn(
                "paged attention needs absolute-position KV caches; "
                f"pattern {cfg.layer_pattern!r} has rolling/recurrent "
                "layers — falling back to the gather engine", stacklevel=2)
            paged = False
        # rolling-window (L) KV keeps only the last `window` tokens, so a
        # chain block cannot be restored into it: such patterns run the
        # full store machinery (lookups, evictions) but pay prefill
        # recompute instead of a restore
        self.restore_prefix = absolute_kv
        # ----- serve tensor parallelism: shard the paged KV pool (and the
        # attention reading it) over the ranks of a group, one process
        # each. Params and per-step host arrays are replicated; block
        # tables, refcounts, and the whole store stay rank-invariant — a
        # pool row index means the same block on every rank.
        if kv_shard is None and tp > 1:
            kv_shard = serve_tp_context(tp, self.device)
        if kv_shard is not None:
            if not paged:
                raise ValueError(
                    "tensor parallelism shards the paged data plane; "
                    f"pattern {cfg.layer_pattern!r} (or --no-paged-"
                    "attention) runs the gather engine, which is tp=1 only")
            kv_shard.validate(cfg)
        self.kv_shard = kv_shard
        self.tp = kv_shard.tp if kv_shard is not None else 1
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.B = max_slots
        self.max_seq = max_seq
        self.store = store or PrefixStore(capacity_bytes=1 << 62,
                                          policy="lerc")
        self.eos_id = eos_id
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.paged = bool(paged)

        # ----- pool: sized so the store's byte budget, not the pool, is
        # always the binding constraint; on the paged plane it also
        # carries each slot's private tail rows
        bt = self.store.block_tokens
        self.table_width = -(-max_seq // bt)
        blk_bytes = chain_block_nbytes(template, bt)
        if pool_blocks is None:
            by_capacity = -(-self.store.capacity // max(blk_bytes, 1))
            pool_blocks = int(min(by_capacity, _DEFAULT_POOL_BLOCKS))
            if self.paged:
                pool_blocks += self.B * self.table_width + 1
        self.pool = KVBlockPool(template, bt, pool_blocks, self.device,
                                shard_ctx=self.kv_shard)
        if self.paged:
            self.cache = None
            # every padding row's token (and, on the dense grid, every
            # right-padded one) is written into this reserved row, so real
            # rows only ever see real writes
            self._junk_row = self.pool.alloc()
            assert self._junk_row == 0
            self._tables: List[List[int]] = [[] for _ in range(self.B)]
            # tables only change on admission/completion, not per decode
            # step — the step keeps the device copy, re-uploaded only when
            # dirty; the host keeps its last (B, NW) array for the packed
            # rows' pool writes
            self._tables_dirty = True
            self._tables_np: Optional[np.ndarray] = None
        else:
            self.cache = init_decode_cache(cfg, self.B, max_seq,
                                           device=self.device)
        if isinstance(self.store, TieredKVStore):
            # tier 1: host-side pool sized to the store's host byte budget
            # (0 rows when the tier is disabled — the store then behaves
            # op-for-op like a plain PrefixStore), page-locked on the
            # card. With a quant format the pool stores transcoded rows,
            # so the same budget holds ~itemsize-ratio more blocks. Tier
            # 2, when budgeted, is a memmap pool mirroring the host layout.
            # Under TP both hold this rank's head slice, and a quantize
            # takes each block's amax over the group.
            if self.kv_shard is not None:
                self.store.quant = self.kv_shard.bind(self.store.quant)
                self.store.disk_quant = self.kv_shard.bind(
                    self.store.disk_quant)
            host_pool = HostBlockPool.for_device_pool(
                template, self.pool, self.store.host_capacity,
                quant=self.store.quant,
                pin_memory=self.device.type == "cuda")
            disk_pool = None
            if self.store.disk_capacity > 0:
                disk_pool = DiskBlockPool.for_device_pool(
                    template, self.pool, self.store.disk_capacity,
                    quant=self.store.disk_quant,
                    directory=self.store.disk_dir)
            self.store.attach_pools(self.pool, host_pool, disk_pool)
        else:
            self.store.evict_payload = self.pool.free

        self.step_program = StepProgram(
            cfg, self.params, slots=self.B, paged=self.paged, eos_id=eos_id,
            device=self.device,
            capture=(self.device.type == "cuda" if cuda_graphs is None
                     else cuda_graphs), kv_shard=self.kv_shard)
        self._rid = itertools.count(1)
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * self.B
        # ----- front door: step scheduling, admission control, and a
        # deterministic virtual clock for SLO accounting. The default FCFS
        # scheduler reproduces the plain step loop exactly.
        self.scheduler = (make_scheduler(scheduler)
                          if isinstance(scheduler, str)
                          else scheduler or Scheduler())
        self.max_queue = max_queue
        self.clock = clock or StepCostModel()
        if getattr(self.scheduler, "clock", False) is None:
            # cost-aware schedulers price chunks on the engine's own clock
            self.scheduler.clock = self.clock
        self.now = 0.0
        self.eos_interval = max(int(eos_interval), 1)
        self._fresh_slots: set = set()  # admitted since the last dispatch
        self.steps = 0
        self.decoded_tokens = 0
        self.prefill_tokens = 0
        self.prefill_tokens_skipped = 0
        self.transfer_dispatches = 0    # gather/scatter/copy-on-write
        self.readback_syncs = 0         # device→host blocking reads
        self.rejected = 0               # backpressure sheds
        self.cancellations = 0
        # obs: an attached ``repro_torch.obs.TraceRecorder`` (None = every
        # instrumentation site is one predicate) and the ring of device
        # step events that goes with it
        self.trace = None
        self._trace_pid = 0
        self.device_steps: Optional[DeviceSteps] = None

    # ------------------------------------------------------------------ obs
    def attach_trace(self, recorder, pid: int = 0,
                     name: str = "engine") -> None:
        """Wire a ``TraceRecorder`` through every layer of this engine:
        step phases + scheduler decisions + request lifecycle (this
        class), and store events (the prefix store). The port adds spans
        of its own, under categories the reference does not emit: the
        engine's calls into the store (``store.call``), how the step
        program ran each step (``program``) and, once ``flush_trace()``
        has run, each step's time on the device (``device``, from a ring
        of event pairs made here; this synchronizes once)."""
        self.trace = recorder
        self._trace_pid = pid
        for tid in (_TID_ENGINE, _TID_SCHED, _TID_STORE, _TID_REQ):
            recorder.label(pid, name, tid=tid)
        recorder.label(pid, name, tid=_TID_DEVICE, tname=DEVICE_LANE)
        self.store.trace = recorder
        self.store.trace_pid = pid
        self.step_program.trace = recorder
        self.step_program.trace_pid = pid
        self.device_steps = DeviceSteps(recorder, self.device, pid)
        recorder.vt = self.now

    def flush_trace(self) -> int:
        """Write the device times of the steps dispatched since the last
        flush to the recorder as ``step.device`` spans; synchronizes, so
        call it outside any timed region. Returns the spans written."""
        if self.device_steps is None:
            return 0
        return self.device_steps.flush()

    def _store_span(self, name: str, req: "Request"):
        """An open span around one of the engine's calls into the store
        (tracing on only)."""
        return self.trace.span(name, "store.call", self._trace_pid,
                               _TID_STORE, args={"rid": req.rid}).begin()

    def _aid(self, req: "Request") -> str:
        """Async-track id for a request: pid-qualified."""
        return f"{self._trace_pid}:{req.rid}"

    def _trace_req_end(self, r: "Request") -> None:
        """Close a request's lifecycle track with everything
        ``latency_stats`` needs."""
        if self.trace is None:
            return
        self.trace.end_async(
            "req", self._aid(r), "request", self._trace_pid, _TID_REQ,
            args={"rid": r.rid, "arrival": r.arrival, "deadline": r.deadline,
                  "first_token_at": r.first_token_at,
                  "finished_at": r.finished_at,
                  "n_generated": len(r.generated),
                  "cancelled": r.cancelled,
                  "prefill_skipped": r.prefill_skipped})

    # ------------------------------------------------------------- requests
    def submit(self, prompt: Sequence[int], max_new: int = 16, *,
               deadline: Optional[float] = None,
               arrival: Optional[float] = None) -> Request:
        """Enqueue a request. ``deadline`` is an *absolute* TTFT deadline
        on the engine's virtual clock (None = best-effort); ``arrival``
        backdates the request. Raises ``QueueFull`` when admission control
        is on and the queue is at ``max_queue``."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.rejected += 1
            retry_after = self.retry_after()
            if self.trace is not None:
                self.trace.instant(
                    "rejected", "request", self._trace_pid, _TID_REQ,
                    args={"queued": len(self.queue),
                          "retry_after": retry_after})
            raise QueueFull(f"queue at max_queue={self.max_queue}",
                            depth=len(self.queue), retry_after=retry_after)
        req = Request(next(self._rid), list(prompt), max_new,
                      arrival=self.now if arrival is None else arrival,
                      deadline=deadline)
        if self.trace is None:
            req.prefix_rid = self.store.register_request(prompt)
        else:
            span = self._store_span("register", req)
            req.prefix_rid = self.store.register_request(prompt)
            span.end()
        self.queue.append(req)
        if self.trace is not None:
            self.trace.begin_async(
                "req", self._aid(req), "request", self._trace_pid, _TID_REQ,
                args={"rid": req.rid, "prompt_tokens": len(req.prompt),
                      "max_new": req.max_new, "deadline": req.deadline},
                vt=req.arrival)
        return req

    def retry_after(self) -> float:
        """Backpressure hint stamped on ``QueueFull``: the nearest-to-done
        active request's remaining steps priced by the engine's
        ``StepCostModel``."""
        active = [r for r in self.slots if r is not None]
        per_step = float(self.clock(0, max(len(active), 1), 0))
        if not active:
            return per_step
        steps_left = min(
            -(-max(len(r.prompt) - r.pos, 0) // self.prefill_chunk)
            + max(r.max_new - r.n_generated, 0)
            for r in active)
        return max(steps_left, 1) * per_step

    def cancel(self, req: Request) -> bool:
        """Cancel a request at any point in its lifetime — queued,
        prefilling, or mid-decode. Frees the slot and its block-table rows
        *immediately*; the store's pending-chain references retire. Tokens
        already computed remain readable on the returned request. Call
        between steps."""
        if req.done:
            return False
        req.done = True
        req.cancelled = True
        self.cancellations += 1
        if req.slot >= 0 and self.slots[req.slot] is req:
            self._release_slot(req)
        else:
            try:
                self.queue.remove(req)
            except ValueError:
                pass
        self._retire(req)
        self._drain(req)
        req.finished_at = self.now
        self._trace_req_end(req)
        return True

    def drain(self, req: Request) -> List[int]:
        """Streaming read: materialize every token computed so far (one
        blocking device→host copy) and return the visible generation.
        With EOS detection on, tokens past the first EOS are not shown."""
        self._drain(req)
        gen = req.generated
        if self.eos_id >= 0 and self.eos_id in gen:
            gen = gen[:gen.index(self.eos_id) + 1]
        return list(gen)

    # -------------------------------------------------------- cache plumbing
    def _block_nbytes(self) -> int:
        return self.pool.block_nbytes

    def _publish(self, req: Request) -> None:
        """Prefill complete: publish the prompt's KV chain into the store.

        Paged: the chain's blocks already live in pool rows the slot's
        block table names — the payload factory hands the store a shared
        reference to each fresh block's row. Zero copies.

        Gather: the store makes room first (freeing pool indices), then the
        factory allocates one pool row per fresh block and a single scatter
        captures exactly those blocks from the slot's contiguous cache."""
        span = (None if self.trace is None
                else self._store_span("publish", req))
        if self.paged:
            table = self._tables[req.slot]
            self.store.insert(req.prompt,
                              lambda i, _node: self.pool.share(table[i]),
                              self.pool.block_nbytes)
            if span is not None:
                span.end()
            return
        fresh: List[Tuple[int, int]] = []       # (chain position, pool row)

        def alloc(i, _node):
            idx = self.pool.alloc()
            fresh.append((i, idx))
            return idx

        self.store.insert(req.prompt, alloc, self.pool.block_nbytes)
        if span is not None:
            span.end()
        if fresh:
            self.pool.scatter_from(self.cache, req.slot,
                                   [i for i, _ in fresh],
                                   [idx for _, idx in fresh])
            self.transfer_dispatches += 1

    # ---------------------------------------------------------------- admit
    def _admit(self) -> None:
        bt = self.store.block_tokens
        for i in range(self.B):
            if self.slots[i] is not None or not self.queue:
                continue
            queued = len(self.queue)
            if any(r.not_before > self.now for r in self.queue):
                # failover re-admissions wait out their backoff; everyone
                # else competes normally. This branch is unreachable
                # without a crash (not_before defaults to 0.0).
                eligible = [r for r in self.queue
                            if r.not_before <= self.now]
                if not eligible:
                    break
                pick = self.scheduler.admit_idx(eligible)
                req = eligible[pick]
                self.queue.remove(req)
            else:
                pick = self.scheduler.admit_idx(self.queue)
                if pick == 0:
                    req = self.queue.popleft()
                else:
                    req = self.queue[pick]
                    del self.queue[pick]
            self._fresh_slots.add(i)
            if self.trace is None:
                usable = self.store.lookup(req.prompt)
            else:
                span = self._store_span("lookup", req)
                usable = self.store.lookup(req.prompt)
                span.end(args={"blocks": len(usable)})
            if not self.restore_prefix:
                usable = []             # hit metrics recorded; no restore
            restored = len(usable) * bt
            # the last prompt token is always recomputed: its logits seed
            # generation and were never cached
            restored = min(restored, len(req.prompt) - 1)
            if self.paged:
                # prefix hit = a host-side block-table write: the slot
                # reads the store's rows in place (refcounted shares)
                table = [self.pool.share(n.payload) for n in usable]
                if table and restored < len(table) * bt:
                    # fully-resident chain: the final block must absorb
                    # the recomputed last prompt token — copy-on-write so
                    # the store's row stays pristine
                    priv = self.pool.alloc()
                    self.pool.copy_row(table[-1], priv)
                    self.pool.free(table[-1])
                    table[-1] = priv
                    self.transfer_dispatches += 1
                # private tail rows for the rest of the prompt + decode
                horizon = min(len(req.prompt) + req.max_new, self.max_seq)
                while len(table) * bt < horizon:
                    table.append(self.pool.alloc())
                self._tables[i] = table
                self._tables_dirty = True
            elif usable:
                # gather pool→slot: the whole resident chain lands in one
                # transfer
                self.pool.gather_into(self.cache, i,
                                      [n.payload for n in usable])
                self.transfer_dispatches += 1
            req.slot = i
            req.pos = restored
            req.prefill_skipped = restored
            self.prefill_tokens_skipped += restored
            self.slots[i] = req
            if self.trace is not None:
                self.trace.instant(
                    "sched.admit", "sched", self._trace_pid, _TID_SCHED,
                    args={"rid": req.rid, "slot": i, "pick": pick,
                          "queued": queued, "restored_tokens": restored})
                self.trace.async_instant(
                    "req", self._aid(req), "request", self._trace_pid,
                    _TID_REQ, args={"event": "admitted", "slot": i,
                                    "restored_tokens": restored})

    # ----------------------------------------------------------------- step
    def step(self) -> List[Request]:
        """One engine iteration. Decode slots pack first (one pipelined
        token each); the scheduler then divides this step's prefill work —
        up to ``prefill_chunk`` tokens per prefilling slot under FCFS, a
        deadline-ordered token budget under the budgeted scheduler — all in
        a single batched dispatch. Returns requests that finished."""
        trace = self.trace
        if trace is None:
            return self._step_inner(None)
        trace.vt = self.now
        with trace.span("step", "engine", self._trace_pid, _TID_ENGINE,
                        args={"n": self.steps}):
            return self._step_inner(trace)

    def _step_inner(self, trace) -> List[Request]:
        pid = self._trace_pid
        if trace is None:
            self._admit()
        else:
            with trace.span("admit", "engine", pid, _TID_ENGINE):
                self._admit()
        active = [r for r in self.slots if r is not None]
        if not active:
            if self.queue and all(r.not_before > self.now
                                  for r in self.queue):
                # everything queued is backing off: jump the virtual clock
                # to the earliest re-admission so the loop can't spin
                self.now = min(r.not_before for r in self.queue)
            return []
        decoding = [r for r in active if r.pos >= len(r.prompt)]
        prefilling = [r for r in active if r.pos < len(r.prompt)]
        plan = self.scheduler.plan_prefill(prefilling, self.prefill_chunk,
                                           len(decoding))
        plan = {s: n for s, n in plan.items() if n > 0}
        if not decoding and not plan and prefilling:
            # never stall a step that has only prefill work: feed the
            # scheduler's most urgent slot its chunk
            r = prefilling[0]
            plan = {r.slot: min(self.prefill_chunk,
                                len(r.prompt) - r.pos)}
        if trace is not None:
            trace.instant(
                "sched.plan", "sched", pid, _TID_SCHED,
                args={"plan": {str(s): n for s, n in plan.items()},
                      "preempted": [r.rid for r in prefilling
                                    if r.slot not in plan],
                      "decoding": len(decoding)})
        dispatch = (trace.span("dispatch", "engine", pid,
                               _TID_ENGINE).begin()
                    if trace is not None else None)
        feeds: Dict[int, List[int]] = {}
        for r in decoding:
            # the feed is the previous step's argmax for this slot —
            # routed on device, never synced to host
            feeds[r.slot] = [0]
            self.decoded_tokens += 1
        for r in prefilling:
            n = plan.get(r.slot, 0)
            if n:                      # preempted slots idle this step
                feeds[r.slot] = r.prompt[r.pos:r.pos + n]
                self.prefill_tokens += n
        fed = [r for r in active if r.slot in feeds]
        # the fed slots in slot order: slot, position, tokens fed, route
        # the last argmax in (decoding), output counts as generated
        slot = np.array([r.slot for r in fed], np.int32)
        pos = np.array([r.pos for r in fed], np.int32)
        n = np.array([len(feeds[r.slot]) for r in fed], np.int32)
        route = np.array([r.pos >= len(r.prompt) for r in fed], bool)
        emit = pos + n >= np.array([len(r.prompt) for r in fed])
        reset = np.zeros((self.B,), bool)
        reset[list(self._fresh_slots)] = True
        self._fresh_slots.clear()
        S = int(n.max())
        if self.paged and self._tables_dirty:
            # attention costs scale with the widest ACTIVE table, not
            # max_seq. Bucketed to multiples of 4 so the table widths the
            # kernel sees stay few.
            nw = max((len(t) for t in self._tables), default=1)
            nw = min(self.table_width, max(-(-max(nw, 1) // 4) * 4, 4))
            tables = np.zeros((self.B, nw), np.int32)
            for r in active:
                tab = self._tables[r.slot]
                tables[r.slot, :len(tab)] = tab
            self._tables_np = tables
            self._tables_dirty = False
        else:
            tables = None
        if self.paged:
            feed = pack_feed(
                self.B, self.prefill_chunk, self.store.block_tokens,
                self._tables_np, slot, pos, n, route, emit, reset,
                np.fromiter(itertools.chain.from_iterable(
                    feeds[r.slot] for r in fed), np.int32, int(n.sum())))
        else:
            tokens = np.zeros((self.B, S), np.int32)
            for r in fed:
                f = feeds[r.slot]
                tokens[r.slot, :len(f)] = f
            # meta rows: pos / lens / use_prev / emits-generated /
            # reset-done
            meta = np.zeros((5, self.B), np.int32)
            meta[:4, slot] = pos, n, route, emit
            meta[4] = reset
            feed = DenseFeed(tokens, meta)
        # one batched step on the device: the previous argmax routed into
        # the decode feeds, the KV written in place, the (B,) argmax left
        # on the device
        if trace is not None:
            self.device_steps.begin()
        out_tok = self.step_program(
            self.pool.buffers if self.paged else self.cache, feed, tables)
        if trace is not None:
            sig = self.step_program.key_args
            self.device_steps.end(self.steps, sig["S"], sig["NW"],
                                  self.step_program.mode, T=sig["T"])
        if dispatch is not None:
            dispatch.end(args={"S": S, "fed": len(fed),
                               "decoding": len(decoding)})
        self.steps += 1
        # prefill attention reads this step: a prompt chunk of ``lens``
        # tokens attends over a context ending at pos + lens
        attn_pairs = int((n * (pos + n) * ~route).sum())
        self.now += float(self.clock(int(n.sum()) - len(decoding),
                                     len(decoding), attn_pairs))
        stall = getattr(self.store, "pending_stall", 0.0)
        if stall:
            # slow promotions this step (injected disk stalls) charge the
            # virtual clock once, after the step's compute charge
            self.now += stall
            self.store.pending_stall = 0.0
        if trace is not None:
            trace.vt = self.now
            trace.counter("engine", pid, {
                "queue": len(self.queue),
                "active_slots": sum(s is not None for s in self.slots),
                "pool_blocks_in_use": self.pool.blocks_in_use,
                "store_used_bytes": self.store.used})

        finished: List[Request] = []
        for r in fed:
            r.pos += len(feeds[r.slot])
            in_decode = r.pos >= len(r.prompt)
            if in_decode:
                r.n_generated += 1
                r._lazy_out.append(out_tok)
                if r.n_generated == 1:
                    r.first_token_at = self.now
                    if trace is not None:
                        trace.async_instant(
                            "req", self._aid(r), "request", pid, _TID_REQ,
                            args={"event": "first_token"})
            if r.pos == len(r.prompt):
                self._publish(r)
            if in_decode and r.n_generated >= r.max_new:
                self._finish(r)
                finished.append(r)
        if self.eos_id >= 0 and decoding \
                and self.steps % self.eos_interval == 0:
            # device-side EOS detection: one (B,) bool copy per interval
            # instead of the whole token vector every step. A slot that hit
            # EOS between checks decoded a few garbage tokens past it —
            # _finish truncates them — in exchange for pipelined steps.
            if trace is None:
                done = self.step_program.done.cpu().numpy()
            else:
                with trace.span("eos_sync", "engine", pid, _TID_ENGINE):
                    done = self.step_program.done.cpu().numpy()
            self.readback_syncs += 1
            for r in decoding:
                if not r.done and done[r.slot]:
                    self._finish(r)
                    finished.append(r)
        return finished

    def _finish(self, r: Request) -> None:
        """Complete a request: drain pipelined tokens, truncate at the
        first EOS, retire the store chain, release the slot."""
        self._drain(r)
        if self.eos_id >= 0 and self.eos_id in r.generated:
            r.generated = r.generated[:r.generated.index(self.eos_id) + 1]
        r.n_generated = len(r.generated)
        r.done = True
        r.finished_at = self.now
        self._retire(r)
        self._release_slot(r)
        self._trace_req_end(r)

    def _retire(self, r: Request) -> None:
        """Retire a request's chain in the store (finish or cancel)."""
        if self.trace is None:
            self.store.complete_request(r.prefix_rid)
        else:
            span = self._store_span("retire", r)
            self.store.complete_request(r.prefix_rid)
            span.end()

    def _release_slot(self, r: Request) -> None:
        """Free a slot's engine-side resources *now* (finish or cancel):
        on the paged plane every block-table row drops the slot's
        reference — private tail rows return to the pool immediately,
        store-shared rows survive on the store's own reference."""
        if self.paged:
            for idx in self._tables[r.slot]:
                self.pool.free(idx)
            self._tables[r.slot] = []
            self._tables_dirty = True
        self.slots[r.slot] = None

    def _drain(self, r: Request) -> None:
        """Drain a request's pipelined token reads into ``generated`` (one
        blocking device→host copy for all of them)."""
        if r._lazy_out:
            if self.trace is None:
                vals = torch.stack(r._lazy_out).cpu().numpy()
            else:
                with self.trace.span("readback", "engine", self._trace_pid,
                                     _TID_ENGINE,
                                     args={"steps": len(r._lazy_out),
                                           "rid": r.rid}):
                    vals = torch.stack(r._lazy_out).cpu().numpy()
            r.generated.extend(int(v[r.slot]) for v in vals)
            r._lazy_out = []
            self.readback_syncs += 1

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                return
            self.step()

    def close(self) -> None:
        """Deterministic teardown of file-backed store resources (the
        disk tier's memmap row files). Idempotent; safe on stores with
        no disk tier."""
        close = getattr(self.store, "close", None)
        if close is not None:
            close()

    def step_hlo(self) -> str:
        raise NotImplementedError(
            "step_hlo exposes the reference's compiled XLA step; the port "
            "has no HLO: on the card its step is a captured CUDA graph "
            "(serve/step_graph.py), on the CPU it runs eagerly")

    # -------------------------------------------------------------- metrics
    def _cache_bytes(self) -> int:
        return 0 if self.cache is None else sum(
            t.numel() * t.element_size() for _, t in tree_paths(self.cache))

    def step_rows(self) -> Dict[str, int]:
        """The token rows the steps fed (``rows_real``) and the rows they
        computed (``rows_run``: the packed rows on the paged plane, B x S
        on the gather plane); their quotient is the share of computed rows
        that carried a token. Kept out of ``metrics()``, which holds the
        reference engine's keys."""
        return {"rows_real": self.step_program.rows_real,
                "rows_run": self.step_program.rows_run}

    def metrics(self) -> Dict[str, float]:
        m = dict(self.store.metrics())
        m.update({
            "engine_steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "decoded_tokens": self.decoded_tokens,
            "pool_blocks": self.pool.num_blocks,
            "pool_blocks_in_use": self.pool.blocks_in_use,
            "pool_high_water": self.pool.high_water,
            "kv_transfer_dispatches": self.transfer_dispatches,
            "readback_syncs": self.readback_syncs,
            "virtual_time": self.now,
            "rejected": self.rejected,
            "cancellations": self.cancellations,
            "host_syncs_avoided": max(self.steps - self.readback_syncs, 0),
            # per-device vs global KV bytes, split EXPLICITLY: once the
            # pool shards (tp>1) the two differ by a factor of tp, and
            # "device_kv_bytes" keeps meaning what it says — bytes ONE
            # device holds. (The gather cache only exists at tp=1.)
            "serve_tp": self.tp,
            "device_kv_bytes": self.pool.nbytes_per_device
            + self._cache_bytes(),
            "kv_bytes_global": self.pool.nbytes + self._cache_bytes(),
            "prefill_saved_frac": (
                self.prefill_tokens_skipped
                / max(self.prefill_tokens + self.prefill_tokens_skipped, 1)),
        })
        if isinstance(self.store, TieredKVStore) \
                and self.store.host_pool is not None:
            hp = self.store.host_pool
            m.update({
                "host_blocks": hp.num_blocks,
                "host_blocks_in_use": hp.blocks_in_use,
                "host_high_water": hp.high_water,
            })
            if self.store.quant is not None:
                # per-tier occupancy in BYTES + the transcode economics:
                # how many blocks one host byte buys vs the lossless tier
                m.update({
                    "kv_quant": self.store.quant.name,
                    "host_block_nbytes": hp.block_nbytes,
                    "host_bytes_in_use": hp.bytes_in_use,
                    "host_compression_ratio": (
                        self.pool.block_nbytes / max(hp.block_nbytes, 1)),
                })
            dp = self.store.disk_pool
            if dp is not None:
                m.update({
                    "disk_blocks": dp.num_blocks,
                    "disk_blocks_in_use": dp.blocks_in_use,
                    "disk_high_water": dp.high_water,
                    "disk_block_nbytes": dp.block_nbytes,
                    "disk_bytes_in_use": dp.bytes_in_use,
                })
        return m
