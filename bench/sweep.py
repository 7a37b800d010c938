#!/usr/bin/env python3
"""The sweeps that size a cell, each in one process:

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds 30 \\
        --rates 2.5,3,3.5,4
    python3 bench/sweep.py --workload <cell> --seed <n> --seconds 25 \\
        --slots 8,16,32,64

``--rates`` (an open-loop cell) warms the cell up once, then offers each
rate in turn, lowest first, without draining the engine between them:
``harness.LEAD_S`` seconds of the rate's own arrivals, then ``--seconds``
measured. It prints one JSON line a rate: requests due and finished,
output tokens/s, time to first token at p50 and p90, the queue of waiting
requests at each eighth of the window, and the slots fed a step. The knee
is the highest rate at which that queue does not grow across the window;
the cell runs at 0.8 of it.

``--slots`` (any cell) builds the engine anew at each slot count, over one
set of weights, warms it up on the cell's own traffic for ``--seconds``
and measures ``--seconds``: output tokens/s, steps, the share of steps
that carry prefill, and the peak of device memory at that count. The cell
takes the count that serves the most tokens a second.

Only ever run by hand, to set a mix's ``rate_per_s`` or a configuration's
``max_slots``.
"""
import sys
import time

import run as entry     # sets the cache directories and the import path


def _window(drv, traffic, slots, seconds, clock, harness):
    from bench.stats import percentile

    _, reqs, steps, before, after, _, _ = harness.measure(
        drv, traffic, slots, seconds, clock, False)
    T = seconds
    ttft = [(min(r.first.t, T) if r.first else T) - r.arrival for r in reqs]
    fed = [len(s.feeds) for s in steps]
    return {
        "due": len(reqs),
        "finished": sum(r.last is not None and r.last.t <= T for r in reqs),
        "output_tokens_per_s": sum(s.out_tokens for s in steps
                                   if s.t <= T) / T,
        "ttft_p50_ms": (percentile(ttft, 50) or 0.0) * 1e3,
        "ttft_p90_ms": (percentile(ttft, 90) or 0.0) * 1e3,
        "queue_by_eighth": [steps[min(len(steps) - 1,
                                      (k * len(steps)) // 8)].queued
                            for k in range(1, 9)] if steps else [],
        "slots_fed_mean": sum(fed) / max(len(fed), 1),
        "slots_fed_max": max(fed, default=0),
        "prefill_step_share": sum(any(b - a > 1 for a, b in s.feeds)
                                  for s in steps) / max(len(steps), 1),
        "steps": len(steps),
        "eager_steps": (after["engine_steps"] - before["engine_steps"]
                        - after["replays"] + before["replays"]),
    }


def main(argv) -> int:
    import argparse
    import gc
    import json

    import torch

    from bench import check, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--rates")
    what.add_argument("--slots")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    manifest = json.loads((entry.ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(manifest, args.workload)
    cfg = cell.config
    print(f"device: {harness.power_limit()}", file=sys.stderr)
    traffic = cell.make_traffic(args.seed)
    reference = check.load_reference(harness.BENCH, cfg["reference"])
    weights = reference.make_weights(cfg, args.seed, "cuda")
    dev = torch.device("cuda")
    clock = harness.EventClock(harness.EVENTS)
    head = {"workload": cell.name, "seed": args.seed}
    if args.rates:
        rates = [float(r) for r in args.rates.split(",")]
        slots = cfg["serve"]["max_slots"]
        drv = harness.Driver(harness.build_engine(cfg, weights, dev), clock)
        harness.warm_up(drv, traffic.with_rate(rates[0]), slots,
                        args.seconds)
        for k, rate in enumerate(rates, start=1):
            t = time.perf_counter()
            at = traffic.with_rate(rate, salt=k)
            if k > 1:       # the first rate's lead-in closed the warm-up
                harness.lead_in(drv, at.requests("warmup"), harness.LEAD_S)
            out = _window(drv, at, slots, args.seconds, clock, harness)
            print(json.dumps({**head, "rate_per_s": rate, **out,
                              "wall_s": time.perf_counter() - t}),
                  flush=True)
        return 0
    for slots in (int(s) for s in args.slots.split(",")):
        t = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        eng = harness.build_engine(cfg, weights, dev, slots=slots)
        drv = harness.Driver(eng, clock)
        harness.warm_up(drv, traffic, slots, args.seconds)
        out = _window(drv, traffic, slots, args.seconds, clock, harness)
        print(json.dumps({**head, "max_slots": slots, **out,
                          "memory_peak_bytes":
                              torch.cuda.max_memory_allocated(dev),
                          "wall_s": time.perf_counter() - t}), flush=True)
        del drv, eng
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
