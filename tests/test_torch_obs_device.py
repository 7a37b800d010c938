"""The port's own trace sites, on the CPU: the engine's spans at its calls
into the store (``store.call``), the step program's modes (``program``)
and the device step spans (``device``, ``repro_torch.obs.device``) that
``flush_trace()`` writes. Each store call gets exactly one span, each
dispatched step one ``step.device`` span in step order, the program's
modes add up to its calls, tracing changes no token, eviction log or
metric, and the ring drops only past its capacity. The card's case is
the last test (``cuda``), which also reads the device spans off CUDA
events."""
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.models import init_params, model_spec  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.obs.device import (PORT_CATEGORIES,  # noqa: E402
                                    TID_DEVICE, DeviceSteps)
from repro_torch.obs.trace import TID_ENGINE, TID_STORE  # noqa: E402
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402
from repro_torch.serve.sharded import ShardedFrontend  # noqa: E402
from repro_torch.serve.step_graph import StepProgram  # noqa: E402

BT = 8
PROMPT = 32
MAX_NEW = 4
STORE_CALLS = {"register": "register_request", "lookup": "lookup",
               "publish": "insert", "retire": "complete_request"}
# (arch, paged, prefill chunk): the paged plane, and the gather plane on
# rolling-window layers
PLANES = [("qwen2_7b", True, 8), ("gemma2_27b", False, 1)]


def _model(arch, device="cpu"):
    cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    params = init_params(model_spec(cfg),
                         torch.Generator(device=device).manual_seed(0),
                         device, dtype=torch.float32)
    return cfg, params


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch) for arch in ("qwen2_7b", "gemma2_27b")}


def workload(vocab, n_requests=8, n_families=3, seed=7):
    """Shared-prefix requests, repeats of the first and the last, and a
    ragged one (its last prefill chunk a one-off signature)."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, PROMPT - BT))
                for _ in range(n_families)]
    reqs = [prefixes[i % n_families] + list(rng.integers(0, vocab, BT))
            for i in range(n_requests)]
    return reqs + [list(reqs[0]), list(reqs[-1]), list(range(3, 40))]


def _engine(cfg, params, paged, chunk, device="cpu", **kw):
    """Two slots over a store of ten chain blocks, so it evicts."""
    probe = ServeEngine(cfg, params, max_slots=2, max_seq=64,
                        store=PrefixStore(1 << 30, "lerc", block_tokens=BT),
                        pool_blocks=1, prefill_chunk=chunk, paged=paged,
                        device=device)
    store = PrefixStore(probe._block_nbytes() * 10, "lerc", block_tokens=BT)
    return ServeEngine(cfg, params, max_slots=2, max_seq=64, store=store,
                       prefill_chunk=chunk, paged=paged, device=device, **kw)


def _fake_graphs(monkeypatch, eng):
    """The step program's graph bookkeeping on the CPU: a capture records
    the step and runs nothing, a replay runs it."""
    monkeypatch.setattr(StepProgram, "_record", lambda prog, fn: (
        SimpleNamespace(replay=fn), Counter(step=1)))
    eng.step_program.capture = True


def _count_store_calls(monkeypatch, store):
    calls = Counter()
    for name in STORE_CALLS.values():
        method = getattr(store, name)

        def counted(*a, _m=method, _n=name, **kw):
            calls[_n] += 1
            return _m(*a, **kw)
        monkeypatch.setattr(store, name, counted)
    return calls


def _drive(eng, cancel=False):
    reqs = [eng.submit(p, max_new=MAX_NEW) for p in workload(eng.cfg.vocab)]
    if cancel:
        for _ in range(4):
            eng.step()
        assert eng.cancel(reqs[-1]) and eng.cancel(reqs[1])
    eng.run()
    return ([r.generated for r in reqs], eng.store.eviction_log,
            eng.metrics())


def _spans(rec, cat, name=None):
    return [e for e in rec.events if e["ph"] == "X" and e["cat"] == cat
            and (name is None or e["name"] == name)]


@pytest.mark.parametrize("cancel", [False, True])
@pytest.mark.parametrize("arch,paged,chunk", PLANES)
def test_one_span_for_each_store_call(models, monkeypatch, arch, paged,
                                      chunk, cancel):
    cfg, params = models[arch]
    eng = _engine(cfg, params, paged, chunk)
    rec = TraceRecorder()
    eng.attach_trace(rec)
    calls = _count_store_calls(monkeypatch, eng.store)
    _drive(eng, cancel)
    spans = Counter(e["name"] for e in _spans(rec, "store.call"))
    assert set(spans) == set(STORE_CALLS)
    for span, call in STORE_CALLS.items():
        assert spans[span] == calls[call], (span, spans, calls)
    assert calls["register_request"] == len(workload(cfg.vocab))
    assert calls["complete_request"] == len(workload(cfg.vocab))
    for e in _spans(rec, "store.call"):
        assert e["tid"] == TID_STORE and e["dur_wall"] >= 0
        assert isinstance(e["args"]["rid"], int)
    lookups = _spans(rec, "store.call", "lookup")
    assert sum(e["args"]["blocks"] for e in lookups) > 0, "no prefix hit"


@pytest.mark.parametrize("arch,paged,chunk", PLANES)
def test_one_device_span_a_step_in_order(models, arch, paged, chunk):
    cfg, params = models[arch]
    eng = _engine(cfg, params, paged, chunk)
    rec = TraceRecorder()
    eng.attach_trace(rec, pid=3)
    _drive(eng)
    assert _spans(rec, "device") == []         # nothing before the flush
    assert eng.flush_trace() == eng.steps
    assert eng.flush_trace() == 0              # resolved once
    dev = _spans(rec, "device")
    assert [e["args"]["n"] for e in dev] == list(range(eng.steps))
    assert all(e["name"] == "step.device" and e["pid"] == 3
               and e["tid"] == TID_DEVICE for e in dev)
    for a, b in zip(dev, dev[1:]):
        assert a["wall"] + a["dur_wall"] <= b["wall"]
    # each inside its engine step, with the program's signature and mode
    steps = {e["args"]["n"]: e for e in _spans(rec, "engine")
             if e["name"] == "step"}
    prog = _spans(rec, "program")
    assert len(prog) == eng.steps
    for d, p in zip(dev, prog):
        s = steps[d["args"]["n"]]
        assert s["wall"] <= d["wall"] <= p["wall"]
        assert p["wall"] + p["dur_wall"] <= d["wall"] + d["dur_wall"] \
            <= s["wall"] + s["dur_wall"]
        assert d["args"]["mode"] == p["name"] == "eager"
        assert (d["args"]["T"], d["args"]["S"], d["args"]["NW"]) == \
            (p["args"]["T"], p["args"]["S"], p["args"]["NW"])
        assert (p["args"]["NW"] is not None) == paged
        assert (p["args"]["T"] is not None) == paged
    assert eng.device_steps.dropped == 0
    assert rec._meta[(3, TID_DEVICE)] == "device"
    # eagerly on the CPU, every call a first sighting or not
    assert eng.step_program.eager_steps == eng.steps
    assert eng.step_program.signatures == {
        (d["args"]["T"], d["args"]["S"], d["args"]["NW"]) if paged
        else (d["args"]["S"],) for d in dev}


@pytest.mark.parametrize("arch,paged,chunk", PLANES)
def test_captured_program_modes_add_up(models, monkeypatch, arch, paged,
                                       chunk):
    """A first sighting runs eagerly, the second is captured and replayed
    in the same call, later ones replay: eager_steps + replays == steps,
    and the spans say the same."""
    cfg, params = models[arch]
    eng = _engine(cfg, params, paged, chunk)
    _fake_graphs(monkeypatch, eng)
    rec = TraceRecorder()
    eng.attach_trace(rec)
    _drive(eng)
    eng.flush_trace()
    prog = eng.step_program
    assert prog.captures > 0 and prog.replays > prog.captures
    assert prog.eager_steps + prog.replays == eng.steps
    assert prog.eager_steps == len(prog.signatures)
    names = Counter(e["name"] for e in _spans(rec, "program"))
    assert names == Counter(eager=prog.eager_steps, capture=prog.captures,
                            replay=prog.replays)
    modes = Counter(e["args"]["mode"] for e in _spans(rec, "device"))
    assert modes == Counter(eager=prog.eager_steps, capture=prog.captures,
                            replay=prog.replays - prog.captures)
    # first sighting eager, second captured, later replayed
    seen = Counter()
    for e in _spans(rec, "device"):
        a = e["args"]
        key = (a["T"], a["S"], a["NW"])
        seen[key] += 1
        assert a["mode"] == {1: "eager", 2: "capture"}.get(seen[key],
                                                           "replay")


@pytest.mark.parametrize("arch,paged,chunk", PLANES)
def test_traced_engine_equals_untraced(models, monkeypatch, arch, paged,
                                       chunk):
    cfg, params = models[arch]
    plain = _engine(cfg, params, paged, chunk)
    want = _drive(plain, cancel=True)
    assert plain.device_steps is None and plain.step_program.trace is None
    assert plain.flush_trace() == 0
    eng = _engine(cfg, params, paged, chunk)
    rec = TraceRecorder()
    eng.attach_trace(rec)
    got = _drive(eng, cancel=True)
    eng.flush_trace()
    assert want[1], "the workload evicted nothing"
    assert got == want
    assert {e["cat"] for e in rec.events} >= set(PORT_CATEGORIES)
    assert rec.n_dropped == 0 and eng.device_steps.dropped == 0


def test_ring_keeps_the_newest_past_its_capacity():
    rec = TraceRecorder()
    ring = DeviceSteps(rec, torch.device("cpu"), pid=1, capacity=4)
    for n in range(10):
        ring.begin()
        ring.end(n, 8, None, "eager")
    assert ring.flush() == 4 and ring.dropped == 6
    assert [e["args"]["n"] for e in rec.events] == [6, 7, 8, 9]
    ring.begin()
    ring.end(10, 1, 4, "replay")
    assert ring.flush() == 1 and ring.dropped == 6
    assert rec.events[-1]["args"] == {"n": 10, "T": None, "S": 1,
                                      "NW": 4, "mode": "replay"}
    ring.begin()
    ring.end(11, 64, 8, "capture", T=128)
    assert ring.flush() == 1
    assert rec.events[-1]["args"] == {"n": 11, "T": 128, "S": 64,
                                      "NW": 8, "mode": "capture"}


def test_sharded_frontend_flushes_every_shard(models):
    cfg, params = models["qwen2_7b"]
    fe = ShardedFrontend(cfg, params, n_shards=2, capacity_bytes=1 << 30,
                         block_tokens=BT, max_slots=2, max_seq=64,
                         prefill_chunk=8, paged=True, device="cpu")
    rec = TraceRecorder()
    fe.attach_trace(rec)
    for p in workload(cfg.vocab):
        fe.submit(p, max_new=MAX_NEW)
    fe.run()
    steps = [e.steps for e in fe.shards]
    assert fe.flush_trace() == sum(steps)
    dev = _spans(rec, "device")
    assert Counter(e["pid"] for e in dev) == {k: n for k, n in
                                              enumerate(steps) if n}
    assert all(e["tid"] == TID_DEVICE for e in dev)
    assert {e["tid"] for e in _spans(rec, "program")} == {TID_ENGINE}


@pytest.mark.cuda
def test_device_spans_on_the_card(monkeypatch):
    """On the card: one span a step from CUDA events, in order and not
    overlapping, each inside its engine step's host span less the
    launch's lead (the device runs behind the host), modes adding up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    cfg, params = _model("qwen2_7b", dev)
    eng = _engine(cfg, params, True, 8, device=dev)
    rec = TraceRecorder()
    eng.attach_trace(rec)
    _drive(eng)
    assert eng.flush_trace() == eng.steps
    prog = eng.step_program
    assert prog.captures > 0
    assert prog.eager_steps + prog.replays == eng.steps
    spans = _spans(rec, "device")
    assert [e["args"]["n"] for e in spans] == list(range(eng.steps))
    host = {e["args"]["n"]: e for e in _spans(rec, "engine")
            if e["name"] == "step"}
    for a, b in zip(spans, spans[1:]):
        assert 0 < a["dur_wall"]
        assert a["wall"] + a["dur_wall"] <= b["wall"]
    # a step starts on the card after its host span began
    assert all(e["wall"] >= host[e["args"]["n"]]["wall"] for e in spans)
    assert eng.device_steps.dropped == 0
