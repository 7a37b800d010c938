"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the metrics and the check.

The system under test is ``repro_torch.serve.engine.ServeEngine`` on the
paged plane with its captured CUDA-graph steps, the FCFS scheduler and a
LERC ``PrefixStore``; the window feeds it through ``submit()`` and
``step()`` and reads nothing of it but its requests, its counters
(``metrics()``, the step program's ``replays``) and, in a traced run, its
spans and the names of the kernels it launches.

Times on the card come from CUDA events: one recorded right after a
synchronize at the window's start, one after each ``step()``, all read
after the window. A request's first token exists when the step that
computed it has finished on the device, so its time to first token runs
from its scheduled arrival to that event.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, flops, gen
from .devtrace import DeviceSlice, name_gaps

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SLICE_S = 3.0          # the traced slice: the window's last seconds
LEAD_S = 8.0           # open loop: the cell's own arrivals before the window
WARMUP_LIMIT_S = 300.0
EVENTS = 16384         # CUDA events made at set-up, one a window step


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class CellError(RuntimeError):
    """The run cannot measure this cell (nothing is printed as a result)."""


# ------------------------------------------------------------------ cells
@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    generator: type = gen.Traffic

    def make_traffic(self, seed: int) -> gen.Traffic:
        return self.generator(self.traffic, self.config["vocab_size"], seed)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


def _load(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + "".join(ch if ch.isalnum() else "_" for ch in path.stem),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve_cell(manifest: Dict, workload: str,
                 bench_dir: Path = BENCH) -> Cell:
    """A cell of the manifest with its configuration and traffic files
    read, and the metrics it reports: every end-to-end metric without a
    ``workloads`` key or listing it, and every per-layer metric listing it
    (or, without the key, moving an end-to-end metric it reports).

    A mix is ``traffic/<name>.json`` for the one generator
    (``gen.Traffic``). Where ``traffic/<name>.py`` exists, its ``Traffic``
    class (``gen.Traffic``'s interface) generates the mix instead, from
    its ``SPEC`` or, without one, from the JSON file."""
    w = _named(manifest["workloads"], workload, "workload")
    c = _named(manifest["configs"], w["config"], "configuration")
    config = json.loads((bench_dir.parent / c["file"]).read_text())
    mix = bench_dir / "traffic" / w["traffic"]
    generator, traffic = gen.Traffic, None
    if mix.with_suffix(".py").exists():
        mod = _load(mix.with_suffix(".py"), "bench_traffic_")
        generator, traffic = mod.Traffic, getattr(mod, "SPEC", None)
    if traffic is None:
        traffic = json.loads(mix.with_suffix(".json").read_text())
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer,
                generator)


def load_reader(bench_dir: Path, name: str):
    """``metrics/<name>.py``'s ``read``."""
    return _load(bench_dir / "metrics" / f"{name}.py", "bench_metric_").read


# ----------------------------------------------------------------- records
@dataclass
class StepRec:
    mark: object                 # a CUDA event, or a host time on the CPU
    feeds: List                  # (before, after) a fed slot
    out_tokens: int
    queued: int = 0              # requests waiting after the step
    t: Optional[float] = None    # completion, seconds from the window
                                 # start (None: a warm-up step)


@dataclass
class ReqRec:
    arrival: float               # scheduled, seconds from the window start
    submit: Optional[float]      # None: due, never submitted
    prompt_len: int
    max_new: int
    req: object = None           # the engine's Request
    first: Optional[StepRec] = None
    last: Optional[StepRec] = None
    n_out: int = 0


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    seed: int
    window_s: float
    setup_s: float
    requests: List[ReqRec]       # due in the window
    finished: List[ReqRec]       # finished in the window, whenever due
    steps: List[StepRec]         # dispatched in the window
    before: Dict                 # counters at the window's start
    after: Dict                  # and at its end
    slice: Optional[DeviceSlice] = None
    slice_steps: List[StepRec] = field(default_factory=list)
    peak: Optional[Dict] = None  # the card's published peaks

    def delta(self, key: str) -> float:
        return self.after[key] - self.before[key]


# ------------------------------------------------------------------ clocks
class EventClock:
    """Device completion times by CUDA events against a start event
    recorded right after a synchronize."""

    def __init__(self, n: int) -> None:
        self._free = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        self._ev0 = torch.cuda.Event(enable_timing=True)
        self.t0 = 0.0

    def start(self) -> None:
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self._ev0.record()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self):
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        return ev

    def finish(self, steps: List[StepRec]) -> None:
        torch.cuda.synchronize()
        for s in steps:
            s.t = self._ev0.elapsed_time(s.mark) / 1e3


class HostClock(EventClock):
    """The CPU's: the program runs synchronously, so the host clock after
    a step is its completion."""

    def __init__(self) -> None:
        self.t0 = 0.0

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def mark(self):
        return time.perf_counter()

    def finish(self, steps: List[StepRec]) -> None:
        for s in steps:
            s.t = s.mark - self.t0


# ------------------------------------------------------------------ engine
def block_nbytes(cfg: Dict, block_tokens: int) -> int:
    """Bytes of one chain block of bf16 K and V over all layers."""
    D = flops.head_dim(cfg)
    return (2 * cfg["num_hidden_layers"] * block_tokens
            * cfg["num_key_value_heads"] * D * flops.BF16_BYTES)


def build_engine(cfg: Dict, weights, device, slots: Optional[int] = None):
    """The configuration's engine; ``slots`` overrides its ``max_slots``
    (the slot sweep)."""
    from repro_torch.models.common import ModelConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prefix_store import PrefixStore

    s = dict(cfg["serve"])
    if slots is not None:
        s["max_slots"] = int(slots)
    bt = s["block_tokens"]
    nbytes = block_nbytes(cfg, bt)
    store = PrefixStore(capacity_bytes=cfg["store_blocks"] * nbytes,
                        policy=s["policy"], block_tokens=bt)
    width = -(-s["max_seq"] // bt)
    eng = ServeEngine(ModelConfig(**cfg["program"]), weights,
                      max_slots=s["max_slots"], max_seq=s["max_seq"],
                      store=store, eos_id=-1,
                      prefill_chunk=s["prefill_chunk"],
                      pool_blocks=cfg["store_blocks"]
                      + s["max_slots"] * width + 1,
                      paged=True, scheduler=s["scheduler"], device=device)
    if eng.pool.block_nbytes != nbytes:
        raise CellError(f"the pool's block holds {eng.pool.block_nbytes} B, "
                        f"the configuration's {nbytes} B")
    return eng


def counters(eng) -> Dict:
    m = eng.metrics()
    m["replays"] = eng.step_program.replays
    m["captures"] = eng.step_program.captures
    return m


class Driver:
    """Feeds the engine and keeps, step by step, what each step fed and
    which request got which token."""

    def __init__(self, eng, clock: EventClock) -> None:
        self.eng = eng
        self.clock = clock
        self.recorder = None     # a TraceRecorder in the traced run
        self.pos: Dict[int, int] = {}
        self.recs: Dict[int, ReqRec] = {}
        self.finished = 0
        self.marking = False     # warm-up steps take no event
        self.done: List[ReqRec] = []    # finished while marking

    def span(self, name: str):
        if self.recorder is None:
            return contextlib.nullcontext()
        return self.recorder.span(name, "bench")

    def submit(self, r: gen.Request, arrival: float,
               now: float) -> ReqRec:
        req = self.eng.submit(r.prompt, max_new=r.max_new)
        rec = ReqRec(arrival, now, len(r.prompt), r.max_new, req)
        self.recs[req.rid] = rec
        return rec

    def idle(self) -> bool:
        return not self.eng.queue and all(s is None for s in self.eng.slots)

    def step(self) -> Optional[StepRec]:
        eng = self.eng
        n = eng.steps
        finished = eng.step()
        if eng.steps == n:
            return None
        with self.span("bench.record"):
            rec = StepRec(self.clock.mark() if self.marking else None, [], 0)
            for r in [s for s in eng.slots if s is not None] + finished:
                before = self.pos.get(r.rid, r.prefill_skipped)
                if r.pos > before:
                    rec.feeds.append((before, r.pos))
                    if r.pos >= len(r.prompt):
                        rec.out_tokens += 1
                        rr = self.recs[r.rid]
                        rr.n_out += 1
                        if rr.first is None:
                            rr.first = rec
                self.pos[r.rid] = r.pos
            for r in finished:
                rr = self.recs.pop(r.rid)
                rr.last = rec
                del self.pos[r.rid]
                if self.marking:
                    self.done.append(rr)
            self.finished += len(finished)
            rec.queued = len(eng.queue)
        return rec


# ----------------------------------------------------------------- phases
def warm_up(drv: Driver, traffic: gen.Traffic, slots: int,
            window_s: float) -> None:
    """The cell's own traffic from the warm-up stream until the store has
    filled (it has evicted) and as many requests have finished as the
    window will serve (an open loop: its rate times the window; a backlog:
    the mix's ``warmup_per_slot`` a slot, a count and not a time, so that
    the window starts from the same point of the same work in every run),
    then, for an open loop, ``LEAD_S`` seconds of the cell's arrivals, so
    the window starts under the cell's load."""
    eng = drv.eng
    stream = traffic.requests("warmup")
    waiting = (2 if traffic.open_loop
               else traffic.waiting_per_slot * slots)
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed > WARMUP_LIMIT_S:
            raise CellError("warm-up did not fill the store in "
                            f"{WARMUP_LIMIT_S:.0f} s")
        full = eng.store.metrics_obj.evictions > 0
        if traffic.open_loop:
            served = drv.finished >= traffic.rate * window_s
        else:
            served = drv.finished >= traffic.warmup_per_slot * slots
        if full and served:
            break
        while len(eng.queue) < waiting:
            drv.submit(next(stream), 0.0, 0.0)
        drv.step()
    if traffic.open_loop:
        lead_in(drv, stream, LEAD_S)


def lead_in(drv: Driver, stream, seconds: float) -> None:
    """``seconds`` of an open loop's arrivals from ``stream``, on time,
    stepping the engine between them (nothing is recorded)."""
    start, origin = time.perf_counter(), None
    for r in stream:
        origin = r.arrival_s if origin is None else origin
        due = start + r.arrival_s - origin
        if due - start >= seconds:
            return
        while time.perf_counter() < due:
            if drv.idle():
                time.sleep(max(0.0, due - time.perf_counter()))
            else:
                drv.step()
        drv.submit(r, 0.0, 0.0)


def measure(drv: Driver, traffic: gen.Traffic, slots: int,
            window_s: float, clock: EventClock,
            traced: bool) -> tuple:
    """The window: its start on the wall clock, the requests due in it,
    the steps dispatched in it, the counters at its ends and, traced, the
    device slice and its steps."""
    eng = drv.eng
    stream = traffic.requests("window")
    pending = next(stream) if traffic.open_loop else None
    waiting = traffic.waiting_per_slot * slots
    reqs: List[ReqRec] = []
    steps: List[StepRec] = []
    sl: Optional[DeviceSlice] = None
    slice_at = max(window_s - SLICE_S, 0.0)
    i_slice = [0, 0]
    clock.start()
    wall0 = time.time()
    drv.marking = True
    before = counters(eng)
    while True:
        now = clock.now()
        if now >= window_s:
            break
        if traced and sl is None and now >= slice_at:
            sl = DeviceSlice()
            sl.start()
            i_slice[0] = len(steps)
            log(f"profiler started in {clock.now() - now:.3f} s")
        with drv.span("bench.submit"):
            if pending is not None:
                while pending.arrival_s <= now:
                    reqs.append(drv.submit(pending, pending.arrival_s, now))
                    pending = next(stream)
            else:
                while len(eng.queue) < waiting:
                    reqs.append(drv.submit(next(stream), now, now))
        if pending is not None and drv.idle():
            with drv.span("bench.wait"):
                time.sleep(max(0.0, min(pending.arrival_s, window_s)
                               - clock.now()))
            continue
        rec = drv.step()
        if rec is not None:
            steps.append(rec)
    after = counters(eng)
    drv.marking = False
    if sl is not None:
        sl.stop()
        i_slice[1] = len(steps)
    # due in the window but never submitted: counted at their age
    while pending is not None and pending.arrival_s < window_s:
        reqs.append(ReqRec(pending.arrival_s, None, len(pending.prompt),
                           pending.max_new))
        pending = next(stream)
    clock.finish(steps)
    return (wall0, reqs, steps, before, after, sl,
            steps[i_slice[0]:i_slice[1]])


# --------------------------------------------------------------------- run
def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"not read ({out.stderr.strip()[:200]})"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_process: float, bench_dir: Path = BENCH,
             control: bool = False) -> Dict:
    """One run. Returns the result line's object, with the check's
    numbers under ``check`` (last). ``control`` also reads the float8
    control (the control runs only; never in the benchmark's own)."""
    device = torch.device(device)
    cfg = cell.config
    reference = check.load_reference(bench_dir, cfg["reference"])
    slots = cfg["serve"]["max_slots"]
    traffic = cell.make_traffic(seed)
    t = time.perf_counter()
    weights = reference.make_weights(cfg, seed, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    log(f"weights {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    eng = build_engine(cfg, weights, device)
    log(f"engine {time.perf_counter() - t:.2f} s")
    clock = EventClock(EVENTS) if cuda else HostClock()
    recorder = None
    if trace:
        from repro_torch.obs.trace import TraceRecorder
        recorder = TraceRecorder()
    drv = Driver(eng, clock)
    t = time.perf_counter()
    warm_up(drv, traffic, slots, seconds)
    log(f"warm-up {time.perf_counter() - t:.2f} s: {drv.finished} finished, "
        f"{eng.steps} steps, {eng.step_program.captures} captures, "
        f"{eng.store.metrics_obj.evictions} evictions")
    if recorder is not None:
        eng.attach_trace(recorder)
        drv.recorder = recorder
    if trace and cuda:
        DeviceSlice.prime()
    wall0, reqs, steps, before, after, sl, sl_steps = measure(
        drv, traffic, slots, seconds, clock, trace and cuda)
    setup_s = wall0 - t_process
    peak_bytes = (torch.cuda.max_memory_allocated(device) if cuda else 0)
    fed = [len(s.feeds) for s in steps]
    log(f"window {seconds} s: {len(steps)} steps, {len(reqs)} requests due, "
        f"{after['captures'] - before['captures']} captures, "
        f"{after['replays'] - before['replays']} replays, queue "
        f"{[s.queued for s in steps[::max(len(steps) // 8, 1)]]}, slots fed "
        f"a step: mean {sum(fed) / max(len(fed), 1):.2f}, "
        f"max {max(fed, default=0)} of {slots}")
    run = Run(cell, seed, seconds, setup_s, reqs, drv.done, steps, before,
              after, sl, sl_steps, flops.peaks(device_name(device)))
    breakdown = None
    if sl is not None:
        sl.read()
        first = min((r.start for r in sl.records), default=sl.t0)
        last = max((r.end for r in sl.records), default=sl.t1)
        log(f"slice {sl.wall_s:.3f} s, {len(sl_steps)} steps, "
            f"{len(sl.records)} device records from "
            f"{(first - sl.t0) * 1e3:+.2f} ms to {(last - sl.t1) * 1e3:+.2f} ms "
            f"of its ends")
        spans = [(e["name"], recorder._t0 + e["wall"],
                  recorder._t0 + e["wall"] + e["dur_wall"])
                 for e in recorder.events if e["ph"] == "X"]
        breakdown = {
            "device_ops": sl.top_ops(),
            "idle_gaps": name_gaps(
                sl.gaps(), [s for s in spans if s[0] != "step"],
                [s for s in spans if s[0] == "step"])}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(bench_dir, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the check, once the program's state is freed
    served = [check.Served(r.req.prompt, list(r.req.generated),
                           r.req.prefill_skipped)
              for r in drv.done if len(r.req.generated) == r.max_new]
    spec = cfg["check"]
    n_due = len(reqs)
    sample = check.choose_sample(served, seed, spec["served_tokens"])
    del drv, eng, weights, steps, run, reqs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    weights = reference.make_weights(cfg, seed, device)
    t_check = time.perf_counter()
    judged = check.judge(reference, cfg, weights, sample, control=control)
    check_s = time.perf_counter() - t_check
    log(f"check {check_s:.2f} s over {len(sample)} requests, gaps "
        f"{[round(g, 4) for g in judged['program']]}")
    limit = float(spec["max_logit_gap"])
    gaps = judged["program"]
    failed = sum(g > limit for g in gaps)
    result = {
        "correct": bool(sample) and failed == 0,
        "attempted": n_due,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": device_name(device), "count": cell.chips,
                   "memory_peak_bytes": int(peak_bytes)},
    }
    if sl is not None:
        result["device"]["busy_s"] = sl.busy_s()
        result["device"]["window_s"] = sl.wall_s
        result["breakdown"] = breakdown
    result["check"] = {
        "max_logit_gap": {"value": max(gaps) if gaps else None,
                          "limit": limit},
        "requests_checked": len(sample),
        "restored_checked": sum(s.restored > 0 for s in sample),
        "tokens_checked": sum(len(s.tokens) for s in sample),
        "check_s": check_s,
    }
    if control:
        result["check"]["control_gap"] = max(judged["control"], default=None)
    return result


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark must not
    load, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
