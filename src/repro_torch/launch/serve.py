"""Serving entry point: continuous batching + LERC prefix cache; mirrors
``src/repro/launch/serve.py`` for the planes the port has (single shard,
single tier, tp=1, batch submit-then-run loop).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --requests 16 --slots 8 --max-seq 640 --shared-prefix 512 \\
      --prefill-chunk 64 --block-tokens 16

The paged plane is the default for global-attention patterns and
``--no-paged-attention`` forces the gather plane; patterns with rolling-
window layers (gemma2's "LG") run the gather plane with ``--prefill-chunk``
clamped to 1. Runs on the GPU unless ``--device cpu`` asks for the CPU
(where the attention kernels run their plain versions); without a GPU the
default raises. Weights are seeded random (``--seed``), made by the port's
own init.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import configs
from ..core import POLICIES
from ..models import init_params, model_spec
from ..obs import TraceRecorder, jsonable
from ..serve import BudgetedScheduler, PrefixStore, ServeEngine
from ..serve.engine import resolve_device


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
    ap.add_argument("--scheduler", default="fcfs",
                    choices=["fcfs", "decode-first", "budgeted"],
                    help="step scheduler: fcfs (full-chunk prefill for "
                         "every slot), decode-first (prefill only on "
                         "decode-idle steps), budgeted (earliest-deadline-"
                         "first prefill under --prefill-budget)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prompt tokens per step for the budgeted "
                         "scheduler (None = uncapped, 0 = decode-first)")
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
    if args.prefill_budget is not None and args.scheduler != "budgeted":
        ap.error(f"--prefill-budget only applies to --scheduler budgeted "
                 f"(got --scheduler {args.scheduler})")

    device = resolve_device(args.device)
    cfg = configs.get(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model_spec(cfg), gen, device, dtype=cfg.dtype)
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
    scheduler = (BudgetedScheduler(args.prefill_budget)
                 if args.scheduler == "budgeted" else args.scheduler)
    store = PrefixStore(capacity_bytes=args.cache_kb * 1024,
                        policy=args.policy, block_tokens=args.block_tokens)
    eng = ServeEngine(cfg, params, max_slots=args.slots,
                      max_seq=args.max_seq, store=store,
                      prefill_chunk=args.prefill_chunk,
                      pool_blocks=args.pool_blocks, paged=args.paged,
                      scheduler=scheduler, device=device)

    recorder = None
    if args.trace is not None:
        recorder = TraceRecorder(limit=args.trace_limit)
        eng.attach_trace(recorder)

    rng = np.random.default_rng(args.seed)
    n_families = max(args.requests // 4, 1)
    prefixes = [list(rng.integers(0, cfg.vocab, args.shared_prefix))
                for _ in range(n_families)]
    prompts = [prefixes[i % n_families]
               + list(rng.integers(0, cfg.vocab, 8))
               for i in range(args.requests)]
    t0 = time.time()
    for p in prompts:
        eng.submit(p, max_new=args.max_new)
    eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    m = eng.metrics()
    print(f"policy={args.policy}  shards=1  tp=1  "
          f"paged={'on' if eng.paged else 'off'}  "
          f"scheduler={args.scheduler}  device={device}  "
          f"wall={time.time()-t0:.1f}s")
    for k, v in m.items():
        print(f"  {k:26s} {v:.3f}" if isinstance(v, float)
              else f"  {k:26s} {v}")
    if recorder is not None:
        recorder.export(args.trace)
        print(f"trace: {args.trace}  events={len(recorder.events)}"
              f"  emitted={recorder.n_emitted}"
              f"  dropped={recorder.n_dropped}")
    if args.metrics_json is not None:
        with open(args.metrics_json, "w") as f:
            json.dump(jsonable({"args": vars(args), "metrics": m}),
                      f, indent=2)
        print(f"metrics: {args.metrics_json}")
    return 0


if __name__ == "__main__":
    sys.exit(serve_main())
