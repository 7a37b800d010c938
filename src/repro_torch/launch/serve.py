"""Serving entry point: continuous batching + LERC prefix cache; mirrors
``src/repro/launch/serve.py``: the paged and gather planes, the
compressed tier ladder (``--host-cache-kb``, ``--kv-quant``,
``--disk-cache-mb``), the timed front door (``--arrival``), the sharded
tier (``--shards``), tensor parallelism (``--tp``) and the fault plan.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --requests 16 --slots 8 --max-seq 640 --shared-prefix 512 \\
      --prefill-chunk 64 --block-tokens 16 --host-cache-kb 262144

The paged plane is the default for global-attention patterns and
``--no-paged-attention`` forces the gather plane; patterns with rolling-
window layers (gemma2's "LG") run the gather plane with ``--prefill-chunk``
clamped to 1. With ``--arrival`` requests arrive on a timed trace (Poisson
/ bursty / diurnal, seeded) with ``--deadline-ms`` TTFT deadlines and
``--max-queue`` admission control, and the report adds TTFT/TPOT
percentiles and goodput on the virtual clock. ``--shards K`` serves
through a ``ShardedFrontend`` of K engines on one coordination bus, the
store's byte budgets split across them, and proves the replicas coherent
after the run. ``--tp N`` shards every engine's paged KV pool (and the
attention reading it) over N ranks, one process each, which the launcher
starts itself (``launch/ranks.py``), or joins when ``RANK`` and
``WORLD_SIZE`` are set (``torchrun``): one card a rank on CUDA (N visible
cards needed), gloo on the CPU. Rank 0 prints the report; each rank's
disk tier takes a ``rank{r}`` subdirectory of ``--disk-dir``, and a rank
that fails makes the launcher exit non-zero. Runs on the GPU unless
``--device cpu`` asks for the CPU (where the attention kernels run their
plain versions); without a GPU the default raises. Weights are seeded
random (``--seed``), made by the port's own init, the same on every rank.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import time

import numpy as np
import torch

from .. import configs
from ..core import POLICIES
from ..faults import FaultPlan
from ..models import init_params, model_spec
from ..obs import TraceRecorder, jsonable
from ..serve import (BudgetedScheduler, PrefixStore, ServeEngine,
                     ShardedFrontend, TieredKVStore, TracedRequest,
                     latency_stats, play_trace)
from ..serve.engine import resolve_device
from ..sharding import rank_dir
from ..sim import bursty_arrivals, diurnal_arrivals, poisson_arrivals
from . import ranks

# seconds the launcher waits for its ranks, and a rank's collective for
# its peers
TP_DEADLINE = 3600.0
TP_GROUP_TIMEOUT = 300.0

_ARRIVALS = {"poisson": poisson_arrivals, "bursty": bursty_arrivals,
             "diurnal": diurnal_arrivals}


def serve_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    # belady needs a future-access trace the serve path cannot provide
    ap.add_argument("--policy", default="lerc",
                    choices=sorted(p for p in POLICIES if p != "belady"))
    ap.add_argument("--cache-kb", type=int, default=512)
    ap.add_argument("--block-tokens", type=int, default=8)
    ap.add_argument("--shared-prefix", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens per slot per engine step")
    ap.add_argument("--paged-attention", dest="paged", action="store_true",
                    default=None,
                    help="decode straight out of the KV pool via per-slot "
                         "block tables: hits are host-side table writes, "
                         "publish transfers row ownership, no per-slot "
                         "contiguous KV cache (default: on for uniform "
                         "global-attention patterns)")
    ap.add_argument("--no-paged-attention", dest="paged",
                    action="store_false",
                    help="force the gather/scatter data plane")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="device KV pool size in blocks "
                         "(default: sized to --cache-kb)")
    ap.add_argument("--host-cache-kb", type=int, default=0,
                    help="host-memory KV tier per engine: device-pressure "
                         "evictions demote blocks here (page-locked memory "
                         "on the GPU) and prefix hits promote them back "
                         "instead of recomputing (0 disables the tier; "
                         "split across --shards)")
    ap.add_argument("--kv-quant", default="none",
                    choices=["none", "int8", "fp8"],
                    help="transcode demoted KV blocks to this format "
                         "(per-layer-per-block f32 scales): the host/disk "
                         "byte budgets then hold ~2-4x more blocks; "
                         "promotion dequantizes on device. 'none' keeps "
                         "every path bit-identical to the lossless tier")
    ap.add_argument("--disk-cache-mb", type=int, default=0,
                    help="disk KV tier per engine (np.memmap row files): "
                         "host-tier evictions demote here instead of "
                         "dying, and lookups promote disk-resident chains "
                         "back to the device pool (0 disables; needs "
                         "--host-cache-kb > 0; split across --shards)")
    ap.add_argument("--disk-dir", default=None,
                    help="directory for the disk tier's memmap files "
                         "(default: a TemporaryDirectory per engine)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism: shard every KV pool leaf "
                         "(and the paged attention reading it) over N "
                         "ranks, one process each, started by the "
                         "launcher (one card a rank on CUDA, gloo on the "
                         "CPU); block tables and the whole store stay "
                         "rank-invariant. Paged plane only")
    ap.add_argument("--shards", type=int, default=1,
                    help="cache shards: >1 runs a ShardedFrontend of "
                         "independent engines on the coordination plane, "
                         "splitting --cache-kb across shards")
    ap.add_argument("--scheduler", default="fcfs",
                    choices=["fcfs", "decode-first", "budgeted"],
                    help="step scheduler: fcfs (full-chunk prefill for "
                         "every slot), decode-first (prefill only on "
                         "decode-idle steps), budgeted (earliest-deadline-"
                         "first prefill under --prefill-budget)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prompt tokens per step for the budgeted "
                         "scheduler (None = uncapped, 0 = decode-first)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request TTFT deadline on the virtual clock "
                         "(None = best-effort; goodput counts completions)")
    ap.add_argument("--arrival", default=None,
                    choices=sorted(_ARRIVALS),
                    help="drive requests through the timed front door "
                         "with this arrival process instead of the "
                         "batch submit-then-run loop")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean arrivals per virtual time unit")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-control queue bound (per shard); "
                         "arrivals past it are shed with QueueFull")
    ap.add_argument("--retry-rejected", type=int, default=0,
                    help="re-submit QueueFull-shed arrivals up to N times, "
                         "waiting the engine's advertised retry-after "
                         "between attempts (retries count against goodput)")
    ap.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="JSON repro_torch.faults.FaultPlan: seeded shard "
                         "crashes, bus drop/delay/dup, disk I/O errors, "
                         "slow promotions — the run then exercises "
                         "failover, quarantine and resync deterministically")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="override the fault plan's seed (same plan, "
                         "different draw sequence)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a Chrome/Perfetto trace of the whole run "
                         "and write trace-event JSON here")
    ap.add_argument("--trace-limit", type=int, default=200_000,
                    help="trace ring-buffer size in events (oldest drop)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the final metrics dict (plus the run args) "
                         "as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; 'cpu' "
                         "runs the plain attention)")
    args = ap.parse_args(argv)

    # flag cross-validation up front — a bad combination must die with an
    # actionable message before any model weights are initialised
    if args.disk_cache_mb > 0 and args.host_cache_kb <= 0:
        ap.error("--disk-cache-mb needs --host-cache-kb > 0: blocks demote "
                 "device -> host -> disk, so a disk tier without a host "
                 "tier is unreachable. Add --host-cache-kb.")
    if args.disk_dir is not None and args.disk_cache_mb <= 0:
        ap.error("--disk-dir has no effect without --disk-cache-mb > 0 "
                 "(there is no disk tier to place there)")
    if args.kv_quant != "none" and args.host_cache_kb <= 0:
        ap.error(f"--kv-quant {args.kv_quant} transcodes blocks demoted to "
                 "the host/disk tiers, which --host-cache-kb 0 disables. "
                 "Add --host-cache-kb or drop --kv-quant.")
    if args.prefill_budget is not None and args.scheduler != "budgeted":
        ap.error(f"--prefill-budget only applies to --scheduler budgeted "
                 f"(got --scheduler {args.scheduler})")
    if args.tp > 1 and args.paged is False:
        ap.error("--tp > 1 shards the paged KV pool; it cannot run on the "
                 "gather plane forced by --no-paged-attention")
    if args.fault_seed is not None and args.fault_plan is None:
        ap.error("--fault-seed overrides a plan's seed; pass --fault-plan")
    injector = None
    if args.fault_plan is not None:
        try:
            plan = FaultPlan.from_json(args.fault_plan)
        except (OSError, ValueError, TypeError) as e:
            ap.error(f"--fault-plan {args.fault_plan}: {e}")
        if args.fault_seed is not None:
            plan = dataclasses.replace(plan, seed=args.fault_seed)
        for _, k in plan.shard_crashes:
            if not 0 <= k < args.shards:
                ap.error(f"fault plan crashes shard {k} but --shards is "
                         f"{args.shards} (valid: 0..{args.shards - 1})")
        injector = plan.injector()

    device = resolve_device(args.device)
    if args.tp > 1 and "RANK" not in os.environ:
        if device.type == "cuda" and torch.cuda.device_count() < args.tp:
            ap.error(f"--tp {args.tp} needs {args.tp} visible cards, one a "
                     f"rank; {torch.cuda.device_count()} are visible")
        argv = sys.argv[1:] if argv is None else list(argv)
        return ranks.spawn(["-m", "repro_torch.launch.serve", *argv],
                           args.tp, timeout=TP_DEADLINE)
    if args.tp == 1:
        return _serve(args, device, injector)
    device = ranks.init_rank(device.type, TP_GROUP_TIMEOUT)
    try:
        if int(os.environ["RANK"]) == 0:
            return _serve(args, device, injector)
        # rank 0 reports and writes the files; the others run the same
        # engines silently
        args.trace = args.metrics_json = None
        with contextlib.redirect_stdout(io.StringIO()):
            return _serve(args, device, injector)
    finally:
        torch.distributed.destroy_process_group()


def _serve(args, device, injector) -> int:
    cfg = configs.get(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model_spec(cfg), gen, device, dtype=cfg.dtype)
    host_bytes = args.host_cache_kb * 1024
    disk_bytes = args.disk_cache_mb * 1024 * 1024
    absolute_kv = set(cfg.layer_pattern) <= {"G", "M"}
    if args.paged is None:
        # zero-copy paged attention is the default wherever the KV layout
        # supports it (absolute positions); the engine itself falls back
        # to the gather plane — with a warning — if asked for more
        args.paged = absolute_kv
    if args.prefill_chunk > 1 and not absolute_kv:
        print(f"warning: pattern {cfg.layer_pattern!r} has rolling/"
              "recurrent layers; clamping --prefill-chunk to 1",
              file=sys.stderr)
        args.prefill_chunk = 1
    # schedulers are stateless policy objects — one instance is safely
    # shared by every shard
    scheduler = (BudgetedScheduler(args.prefill_budget)
                 if args.scheduler == "budgeted" else args.scheduler)
    if args.shards > 1:
        eng = ShardedFrontend(
            cfg, params, args.shards, max_slots=args.slots,
            max_seq=args.max_seq,
            capacity_bytes=max(args.cache_kb * 1024 // args.shards, 1),
            policy=args.policy, block_tokens=args.block_tokens,
            prefill_chunk=args.prefill_chunk, pool_blocks=args.pool_blocks,
            host_capacity_bytes=host_bytes // args.shards,
            kv_quant=args.kv_quant,
            disk_capacity_bytes=disk_bytes // args.shards,
            disk_dir=args.disk_dir,
            paged=args.paged, scheduler=scheduler,
            max_queue=args.max_queue, tp=args.tp, faults=injector,
            device=device)
    else:
        if host_bytes > 0:
            store: PrefixStore = TieredKVStore(
                capacity_bytes=args.cache_kb * 1024, policy=args.policy,
                block_tokens=args.block_tokens,
                host_capacity_bytes=host_bytes, kv_quant=args.kv_quant,
                disk_capacity_bytes=disk_bytes,
                disk_dir=rank_dir(args.disk_dir, args.tp))
            # disk-error / slow-promotion injection: attach before the
            # engine wires the pools so the disk pool inherits the injector
            store.faults = injector
        else:
            store = PrefixStore(capacity_bytes=args.cache_kb * 1024,
                                policy=args.policy,
                                block_tokens=args.block_tokens)
        eng = ServeEngine(cfg, params, max_slots=args.slots,
                          max_seq=args.max_seq, store=store,
                          prefill_chunk=args.prefill_chunk,
                          pool_blocks=args.pool_blocks, paged=args.paged,
                          scheduler=scheduler, max_queue=args.max_queue,
                          tp=args.tp, device=device)

    recorder = None
    if args.trace is not None:
        recorder = TraceRecorder(limit=args.trace_limit)
        eng.attach_trace(recorder)

    if host_bytes > 0:
        # a host budget below one KV block (per shard) sizes the pool to
        # zero rows, silently disabling the tier — say so up front
        engines = eng.shards if args.shards > 1 else [eng]
        if any(getattr(e.store, "host_pool", None) is None
               or e.store.host_pool.num_blocks == 0 for e in engines):
            print(f"warning: --host-cache-kb {args.host_cache_kb} is below "
                  f"one KV block per {'shard' if args.shards > 1 else 'engine'}"
                  f" ({engines[0].pool.block_nbytes} B); host tier disabled",
                  file=sys.stderr)

    rng = np.random.default_rng(args.seed)
    n_families = max(args.requests // 4, 1)
    prefixes = [list(rng.integers(0, cfg.vocab, args.shared_prefix))
                for _ in range(n_families)]
    prompts = [prefixes[i % n_families]
               + list(rng.integers(0, cfg.vocab, 8))
               for i in range(args.requests)]
    t0 = time.time()
    report = None
    if args.arrival is not None:
        times = _ARRIVALS[args.arrival](args.requests, args.arrival_rate,
                                        args.seed)
        trace = [TracedRequest(t=t, prompt=p, max_new=args.max_new,
                               deadline=args.deadline_ms)
                 for t, p in zip(times, prompts)]
        report = play_trace(eng, trace, retry_rejected=args.retry_rejected)
    else:
        for p in prompts:
            eng.submit(p, max_new=args.max_new)
        eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if args.shards > 1:
        if injector is not None:
            # lossy status traffic leaves replicas behind by design; the
            # anti-entropy resync is the documented repair before verify
            eng.resync_replicas()
        eng.verify_replicas()       # smoke doubles as a coherence proof
    m = eng.metrics()
    if report is not None:
        m.update(latency_stats(report))
    if injector is not None:
        for name in sorted(injector.counters):
            m[name] = injector.counters[name]
    paged_on = (all(e.paged for e in eng.shards) if args.shards > 1
                else eng.paged)
    print(f"policy={args.policy}  shards={args.shards}  tp={args.tp}  "
          f"paged={'on' if paged_on else 'off'}  "
          f"scheduler={args.scheduler}"
          + (f"  arrival={args.arrival}@{args.arrival_rate}"
             if args.arrival else "")
          + f"  host_cache_kb={args.host_cache_kb}  "
          f"kv_quant={args.kv_quant}  disk_cache_mb={args.disk_cache_mb}  "
          f"device={device}  wall={time.time()-t0:.1f}s")
    for k, v in m.items():
        print(f"  {k:26s} {v:.3f}" if isinstance(v, float)
              else f"  {k:26s} {v}")
    if recorder is not None:
        eng.flush_trace()
        recorder.export(args.trace)
        print(f"trace: {args.trace}  events={len(recorder.events)}"
              f"  emitted={recorder.n_emitted}"
              f"  dropped={recorder.n_dropped}")
    if args.metrics_json is not None:
        with open(args.metrics_json, "w") as f:
            json.dump(jsonable({"args": vars(args), "metrics": m}),
                      f, indent=2)
        print(f"metrics: {args.metrics_json}")
    eng.close()       # deterministic disk-tier teardown (memmaps + files)
    return 0


if __name__ == "__main__":
    sys.exit(serve_main())
