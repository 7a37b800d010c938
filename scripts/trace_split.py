#!/usr/bin/env python3
"""Run one cell of the port's benchmark with the engine's trace attached,
write its device steps to the trace after the window (``flush_trace``), and
split what the benchmark's metrics see only from outside:

    python3 scripts/trace_split.py --workload <cell> --seed <n> \\
        --seconds <s> [--device cuda|cpu] [--json PATH]

from the root of a checkout. The cell's set-up, warm-up and window are the
benchmark's own (``bench/harness.py``: the same engine, traffic, clock and,
on the card, the profiler slice over the window's last seconds). Prints one
JSON object, and writes it to PATH too:

* ``metrics``: five readings of the engine's own spans over the window:
  ``store_host_ms_per_request`` (the host seconds of its ``register``,
  ``lookup``, ``publish`` and ``retire`` spans over the requests
  submitted), ``queue_wait_p90_ms`` (a request's ``admitted`` mark less its
  submit, p90), ``prefill_p90_ms`` (the ``step.device`` end of the step
  that gave the request its first token, less its ``admitted`` mark, p90),
  ``step_device_ms`` (the mean ``step.device`` span of the steps that
  replayed a graph) and ``host_wait_share`` (the share of the device's
  window, first step's begin to last step's end, that no ``step.device``
  span covers);
* ``ttft_split``: for the requests at the TTFT p90 (and, in PATH, for
  every request with a first token in the window), the harness's TTFT
  beside its parts: the arrival lag, the queue wait, the prefill and what
  is left (host time before this request's submit in the harness's loop,
  and after the first-token step's end until the harness's mark);
* ``device_window``: the window's steps, their device seconds and the host
  wait; the token rows its steps fed and computed, and the share that
  carried a token (``rows``); and its replayed steps' mean device ms,
  split by steps whose every fed slot fed one token and steps that carried
  a prefill chunk, with their counts by packed rows (``replays_by_kind``);
  and the host's time a step builds and uploads its feed outside the step
  program (``host_build``: each ``dispatch`` span less its ``program``
  span);
* ``host_waits``: that wait, each instant named by the innermost host span
  that covers it (seconds by name, and the longest waits);
* ``clock``: the largest gap between a step's ``step.device`` end and the
  harness's CUDA-event mark of the same step, and on the card how the
  profiler slice's records fall against the device spans;
* ``cost``: host microseconds of one device event pair and of one span;
* ``end_to_end``: the traced run's own end-to-end numbers (the benchmark
  reports them only untraced).

Nothing here is part of the benchmark: ``bench/`` and ``BENCHMARK.json``
are read, never changed.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

STORE_SPANS = ("register", "lookup", "publish", "retire")


# ------------------------------------------------------------ the readings
def _pct(xs: List[float], q: float) -> Optional[float]:
    from bench.stats import percentile
    return percentile(xs, q)


def store_host_s(events, w0: float, w1: float) -> Optional[float]:
    """Host seconds of the store-call spans that began in [w0, w1); None
    without any (an engine that does not emit them)."""
    spans = [e["dur_wall"] for e in events
             if e["ph"] == "X" and e["cat"] == "store.call"
             and e["name"] in STORE_SPANS and w0 <= e["wall"] < w1]
    return sum(spans) if spans else None


def request_marks(events, pid: int = 0) -> Dict[int, Dict[str, float]]:
    """{rid: {"submit", "admitted", "first_token": wall}} from the request
    track: its begin (at submit) and its ``admitted`` and
    ``first_token`` marks; a request re-admitted keeps its first."""
    out: Dict[int, Dict[str, float]] = {}
    prefix = f"{pid}:"
    for e in events:
        if e.get("cat") != "request" or e["ph"] not in ("b", "n") \
                or not e["id"].startswith(prefix):
            continue
        rid = int(e["id"][len(prefix):])
        key = "submit" if e["ph"] == "b" else (e["args"] or {}).get("event")
        if key in ("submit", "admitted", "first_token"):
            out.setdefault(rid, {}).setdefault(key, e["wall"])
    return out


def device_steps(events, pid: int = 0) -> Dict[int, Tuple[float, float,
                                                          str]]:
    """{step n: (begin, end, mode)} of the ``step.device`` spans."""
    return {e["args"]["n"]: (e["wall"], e["wall"] + e["dur_wall"],
                             e["args"]["mode"])
            for e in events if e["ph"] == "X" and e["cat"] == "device"
            and e["pid"] == pid}


def host_steps(events, pid: int = 0) -> List[Tuple[float, float, int]]:
    """(begin, end, n) of the engine's ``step`` spans, by begin."""
    return sorted((e["wall"], e["wall"] + e["dur_wall"], e["args"]["n"])
                  for e in events if e["ph"] == "X" and e["cat"] == "engine"
                  and e["name"] == "step" and e["pid"] == pid)


def step_at(steps: List[Tuple[float, float, int]],
            wall: float) -> Optional[int]:
    """The step whose host span holds ``wall``."""
    i = bisect.bisect_right(steps, (wall, float("inf"), 0)) - 1
    if i >= 0 and steps[i][0] <= wall <= steps[i][1]:
        return steps[i][2]
    return None


def queue_waits(marks, w0: float, w1: float) -> Dict[int, float]:
    """{rid: admitted - submit} for the requests submitted and admitted in
    [w0, w1)."""
    return {rid: m["admitted"] - m["submit"] for rid, m in marks.items()
            if "submit" in m and "admitted" in m
            and w0 <= m["submit"] and m["admitted"] < w1}


def prefills(marks, hsteps, dev, w0: float, w1: float) -> Dict[int, float]:
    """{rid: device end of the first-token step - admitted} for the
    requests admitted in [w0, w1) whose first-token step ended in it."""
    out = {}
    for rid, m in marks.items():
        if "admitted" not in m or "first_token" not in m \
                or not w0 <= m["admitted"] < w1:
            continue
        n = step_at(hsteps, m["first_token"])
        if n is None or n not in dev or dev[n][1] >= w1:
            continue
        out[rid] = dev[n][1] - m["admitted"]
    return out


def window_steps(dev, w0: float, w1: float):
    """The device steps that began and ended in [w0, w1), by begin."""
    return sorted(v for v in dev.values() if w0 <= v[0] and v[1] <= w1)


def step_device_mean_s(dev, w0: float, w1: float,
                       mode: str = "replay") -> Optional[float]:
    spans = [e - b for b, e, m in window_steps(dev, w0, w1) if m == mode]
    return sum(spans) / len(spans) if spans else None


def replay_ms_by_kind(events, w0: float, w1: float,
                      pid: int = 0) -> Dict[str, Dict]:
    """The window's replayed steps split by whether every fed slot fed one
    token (``decode_only``: the step's ``S`` is 1) or some slot fed a
    prefill chunk (``prefill``): their count and mean device ms, and
    their count by packed rows ``T`` (None where the engine's spans carry
    no T)."""
    out: Dict[str, Dict] = {}
    for kind in ("decode_only", "prefill"):
        spans = [e for e in events if e["ph"] == "X"
                 and e["cat"] == "device" and e["pid"] == pid
                 and e["args"]["mode"] == "replay"
                 and (e["args"]["S"] == 1) == (kind == "decode_only")
                 and w0 <= e["wall"] and e["wall"] + e["dur_wall"] <= w1]
        durs = [e["dur_wall"] for e in spans]
        by_t: Dict = {}
        for e in spans:
            t = e["args"].get("T")
            by_t[t] = by_t.get(t, 0) + 1
        out[kind] = {"steps": len(durs),
                     "mean_ms": sum(durs) / len(durs) * 1e3 if durs
                     else None,
                     "steps_by_T": dict(sorted(by_t.items(),
                                               key=lambda kv: str(kv[0])))}
    return out


def host_build_ms(events, w0: float, w1: float,
                  pid: int = 0) -> Optional[Dict[str, float]]:
    """The host's time a step spends building and uploading its feed
    outside the step program: each ``dispatch`` span of the window less
    the ``program`` span inside it (the step's device event pair
    included); mean and p90 in ms, None without the spans."""
    prog = sorted((e["wall"], e["dur_wall"]) for e in events
                  if e["ph"] == "X" and e["cat"] == "program"
                  and e["pid"] == pid)
    begins = [b for b, _ in prog]
    out = []
    for e in events:
        if e["ph"] != "X" or e["cat"] != "engine" \
                or e["name"] != "dispatch" or e["pid"] != pid \
                or not w0 <= e["wall"] < w1:
            continue
        i = bisect.bisect_left(begins, e["wall"])
        if i < len(prog) and prog[i][0] <= e["wall"] + e["dur_wall"]:
            out.append(e["dur_wall"] - prog[i][1])
    if not out:
        return None
    return {"steps": len(out), "mean_ms": sum(out) / len(out) * 1e3,
            "p90_ms": _pct(out, 90) * 1e3}


def row_share(before: Optional[Dict], after: Optional[Dict]) -> Dict:
    """The window's token rows fed and computed (``ServeEngine.step_rows``
    before and after it), and the share of computed rows that carried a
    token; None where the engine does not count them."""
    if before is None or after is None:
        return {"rows_real": None, "rows_run": None, "real_share": None}
    real = after["rows_real"] - before["rows_real"]
    run = after["rows_run"] - before["rows_run"]
    return {"rows_real": real, "rows_run": run,
            "real_share": real / run if run else None}


def union_s(spans) -> float:
    total, end = 0.0, float("-inf")
    for b, e in sorted((s[0], s[1]) for s in spans):
        if e <= end:
            continue
        total += e - max(b, end)
        end = e
    return total


def host_wait_share(dev, w0: float, w1: float) -> Optional[float]:
    """1 - the union of the window's step.device spans over the device's
    window, the first step's begin to the last step's end."""
    steps = window_steps(dev, w0, w1)
    if not steps:
        return None
    span = max(e for _, e, _ in steps) - steps[0][0]
    return 1.0 - union_s(steps) / span if span > 0 else None


def waits_by_span(events, w0: float, w1: float, pid: int = 0,
                  n: int = 10) -> Dict:
    """The device's waits between the window's steps (from one
    ``step.device`` span's end to the next one's begin), each instant named
    by the innermost host span that covers it, the shortest: seconds by
    name, and the ``n`` longest waits with their named pieces."""
    steps = window_steps(device_steps(events, pid), w0, w1)
    gaps = [(a[1], b[0]) for a, b in zip(steps, steps[1:]) if b[0] > a[1]]
    spans = sorted((e["wall"], e["wall"] + e["dur_wall"], e["name"])
                   for e in events if e["ph"] == "X" and e["pid"] == pid
                   and e["cat"] != "device")
    begins = [sp[0] for sp in spans]
    longest = max((sp[1] - sp[0] for sp in spans), default=0.0)
    total: Dict[str, float] = {}
    named = []
    for g0, g1 in gaps:
        lo = bisect.bisect_left(begins, g0 - longest)
        hi = bisect.bisect_left(begins, g1)
        over = [sp for sp in spans[lo:hi] if sp[1] > g0]
        cuts = sorted({g0, g1} | {t for sp in over for t in sp[:2]
                                  if g0 < t < g1})
        pieces: Dict[str, float] = {}
        for a, b in zip(cuts, cuts[1:]):
            cover = [sp for sp in over if sp[0] <= a and b <= sp[1]]
            name = (min(cover, key=lambda sp: sp[1] - sp[0])[2] if cover
                    else "outside any span")
            pieces[name] = pieces.get(name, 0.0) + (b - a)
        for name, t in pieces.items():
            total[name] = total.get(name, 0.0) + t
        named.append((g1 - g0, pieces))
    named.sort(key=lambda g: -g[0])
    return {"by_span_s": dict(sorted(total.items(), key=lambda kv: -kv[1])),
            "longest_ms": [[g * 1e3, {k: v * 1e3 for k, v in p.items()}]
                           for g, p in named[:n]]}


def readings(events, w0: float, w1: float, n_submitted: int) -> Dict:
    marks, dev = request_marks(events), device_steps(events)
    waits = queue_waits(marks, w0, w1)
    pre = prefills(marks, host_steps(events), dev, w0, w1)
    q, p = _pct(list(waits.values()), 90), _pct(list(pre.values()), 90)
    mean = step_device_mean_s(dev, w0, w1)
    store = store_host_s(events, w0, w1)
    return {
        "store_host_ms_per_request": (store * 1e3 / n_submitted
                                      if store is not None and n_submitted
                                      else None),
        "queue_wait_p90_ms": None if q is None else q * 1e3,
        "prefill_p90_ms": None if p is None else p * 1e3,
        "step_device_ms": None if mean is None else mean * 1e3,
        "host_wait_share": host_wait_share(dev, w0, w1),
    }


def ttft_split(run, events, offset: float, t0: float) -> List[Dict]:
    """Each request of the window with a first token in it: the harness's
    TTFT and, from the engine's spans, its arrival lag, queue wait,
    prefill and the rest, in ms. ``offset`` puts a recorder wall on the
    perf_counter clock, ``t0`` is the harness's window start on it."""
    marks, dev = request_marks(events), device_steps(events)
    hsteps = host_steps(events)
    out = []
    for r in run.requests:
        if r.req is None or r.first is None or r.first.t > run.window_s:
            continue
        m = marks.get(r.req.rid, {})
        if not {"submit", "admitted", "first_token"} <= set(m):
            continue
        n = step_at(hsteps, m["first_token"])
        if n not in dev:
            continue
        ttft = r.first.t - r.arrival
        lag = r.submit - r.arrival
        wait = m["admitted"] - m["submit"]
        prefill = dev[n][1] - m["admitted"]
        out.append({"rid": r.req.rid, "ttft_ms": ttft * 1e3,
                    "lag_ms": lag * 1e3, "queue_wait_ms": wait * 1e3,
                    "prefill_ms": prefill * 1e3,
                    "rest_ms": (ttft - lag - wait - prefill) * 1e3,
                    "submit_after_loop_ms":
                        (m["submit"] + offset - t0 - r.submit) * 1e3,
                    "mark_after_end_ms":
                        (r.first.t - (dev[n][1] + offset - t0)) * 1e3,
                    "prompt_tokens": r.prompt_len,
                    "restored_tokens": r.req.prefill_skipped})
    return out


# ------------------------------------------------------------------- a run
def cost_us(device, n: int = 2000) -> Dict[str, float]:
    """Host microseconds of one device event pair (begin and end) and of
    one span, begun and ended, on a recorder of their own."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.obs.device import DeviceSteps

    rec = TraceRecorder(limit=8 * n)
    ring = DeviceSteps(rec, device, capacity=n)

    def pairs() -> float:
        t = time.perf_counter()
        for k in range(n):
            ring.begin()
            ring.end(k, 1, 4, "replay")
        t = time.perf_counter() - t
        ring.flush()
        return t / n

    def spans() -> float:
        t = time.perf_counter()
        for k in range(n):
            rec.span("lookup", "store.call", 0, 2,
                     args={"rid": k}).begin().end()
        return (time.perf_counter() - t) / n

    pairs(), spans()                    # warm: the second pass is timed
    pair, span = pairs(), spans()
    return {"event_pair_us": pair * 1e6, "span_us": span * 1e6,
            "step_us": (pair + span) * 1e6,
            "request_us": 4 * span * 1e6}


def clock_check(run, events, offset, t0, n0, sl) -> Dict:
    """Where the harness's step marks and the profiler slice's records
    fall against the step.device spans, in ms."""
    dev = device_steps(events)
    diffs = [(t0 + s.t) - (offset + dev[n0 + k][1])
             for k, s in enumerate(run.steps) if n0 + k in dev]
    out = {"steps_matched": len(diffs),
           "mark_minus_end_ms_max": max(diffs) * 1e3 if diffs else None,
           "mark_minus_end_ms_min": min(diffs) * 1e3 if diffs else None}
    if sl is None:
        return out
    spans = sorted((offset + b, offset + e) for b, e, _ in dev.values()
                   if sl.t0 <= offset + b and offset + e <= sl.t1)
    recs = sorted((r.start, r.end) for r in sl.records
                  if sl.t0 <= r.start and r.end <= sl.t1)
    lead, tail, inside, busy = [], [], 0.0, 0.0
    for b, e in spans:
        i = bisect.bisect_left(recs, (b, float("-inf")))
        mine = [r for r in recs[i:] if r[0] < e]
        if mine:
            lead.append(mine[0][0] - b)
            tail.append(e - max(r[1] for r in mine))
    for s, e in recs:
        busy += e - s
        j = bisect.bisect_right(spans, (s, float("inf"))) - 1
        if j >= 0:
            inside += max(0.0, min(e, spans[j][1]) - s)
    out.update({
        "slice_steps": len(spans),
        "first_record_after_begin_ms": [min(lead) * 1e3,
                                        _pct(lead, 50) * 1e3,
                                        max(lead) * 1e3] if lead else None,
        "end_after_last_record_ms": [min(tail) * 1e3, _pct(tail, 50) * 1e3,
                                     max(tail) * 1e3] if tail else None,
        "record_time_inside_spans": inside / busy if busy else None})
    return out


def traced_window(cell, seed: int, seconds: float, device: str) -> Dict:
    import torch

    from bench import flops, harness
    from bench.devtrace import DeviceSlice
    from repro_torch.obs import TraceRecorder

    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = cell.config
    reference = harness.check.load_reference(harness.BENCH, cfg["reference"])
    slots = cfg["serve"]["max_slots"]
    traffic = cell.make_traffic(seed)
    weights = reference.make_weights(cfg, seed, device)
    eng = harness.build_engine(cfg, weights, device)
    clock = harness.EventClock(harness.EVENTS) if cuda \
        else harness.HostClock()
    drv = harness.Driver(eng, clock)
    harness.warm_up(drv, traffic, slots, seconds)
    # room for every event of the window: nothing may drop
    rec = TraceRecorder(limit=4_000_000)
    eng.attach_trace(rec)
    drv.recorder = rec
    if cuda:
        DeviceSlice.prime()
    step_rows = getattr(eng, "step_rows", lambda: None)
    rows0 = step_rows()
    wall0, reqs, steps, before, after, sl, sl_steps = harness.measure(
        drv, traffic, slots, seconds, clock, cuda)
    rows1 = step_rows()
    t_flush = time.perf_counter()
    written = eng.flush_trace()
    flush_s = time.perf_counter() - t_flush
    offset = time.perf_counter() - rec.wall()
    if sl is not None:
        sl.read()
    run = harness.Run(cell, seed, seconds, 0.0, reqs, drv.done, steps,
                      before, after, sl, sl_steps,
                      flops.peaks(harness.device_name(device)))
    events = list(rec.events)
    w0 = clock.t0 - offset
    w1 = w0 + seconds
    n_sub = sum(r.submit is not None for r in reqs)
    split = ttft_split(run, events, offset, clock.t0)
    ttfts = sorted(s["ttft_ms"] for s in split)
    p90 = _pct(ttfts, 90)
    tail = sorted(split, key=lambda s: abs(s["ttft_ms"] - p90))[:3] \
        if split else []
    dev = device_steps(events)
    ws = window_steps(dev, w0, w1)
    dev_s = sum(e - b for b, e, _ in ws)
    span = (ws[-1][1] - ws[0][0]) if ws else 0.0
    e2e = {}
    for m in cell.end_to_end:
        if m["name"] != "setup_s":
            e2e[m["name"]] = harness.load_reader(harness.BENCH,
                                                 m["name"])(run)
    return {
        "workload": cell.name, "seed": seed, "seconds": seconds,
        "device": harness.device_name(device),
        "metrics": readings(events, w0, w1, n_sub),
        "ttft_split": {"p90_ms": p90, "requests": len(split),
                       "nearest_p90": tail, "all": split},
        "device_window": {
            "steps": len(ws), "harness_steps": len(steps),
            "device_s": dev_s, "window_s": span,
            "host_wait_s": span - union_s(ws),
            "modes": {m: sum(x[2] == m for x in ws)
                      for m in ("eager", "capture", "replay")},
            "rows": row_share(rows0, rows1),
            "host_build": host_build_ms(events, w0, w1),
            "replays_by_kind": replay_ms_by_kind(events, w0, w1)},
        "host_waits": waits_by_span(events, w0, w1),
        "clock": clock_check(run, events, offset, clock.t0,
                             int(before["engine_steps"]), sl),
        "cost": cost_us(device),
        "end_to_end": e2e,
        "trace": {"events": len(events), "dropped": rec.n_dropped,
                  "device_spans": written,
                  "ring_dropped": eng.device_steps.dropped,
                  "flush_s": flush_s,
                  "signatures": len(eng.step_program.signatures),
                  "eager_steps": eng.step_program.eager_steps,
                  "captures": eng.step_program.captures,
                  "replays": eng.step_program.replays},
    }


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    from bench import harness
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(manifest, args.workload)
    out = traced_window(cell, args.seed, args.seconds, args.device)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out))
    # every request's split goes to the file only
    out["ttft_split"].pop("all")
    print(json.dumps(out), flush=True)
    return 0 if out["trace"]["dropped"] == 0 \
        and out["trace"]["ring_dropped"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
