"""``scripts/trace_split.py``: the readings it takes of the engine's own
spans, on events written by hand (and none where an engine emits no such
span), and a traced run of each benchmark cell at the CPU tests' size
(``bench/tests/conftest.py``'s ``tiny_cell``) that reports each of its
readings, with the TTFT split bounded by the harness's own TTFT."""
import importlib.util
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


split = _load(ROOT / "scripts" / "trace_split.py", "trace_split")
bench_conftest = _load(ROOT / "bench" / "tests" / "conftest.py",
                       "bench_tests_conftest")

RAG, BACKLOG = "qwen2-7b.rag-zipf", "qwen1.5-110b-s10.unique-backlog"


def X(name, cat, wall, dur, tid=0, **args):
    return {"ph": "X", "name": name, "cat": cat, "pid": 0, "tid": tid,
            "wall": wall, "vt": 0.0, "dur_wall": dur, "dur_vt": 0.0,
            "args": args or None}


def req(ph, rid, wall, event=None):
    return {"ph": ph, "name": "req", "cat": "request", "pid": 0, "tid": 3,
            "id": f"0:{rid}", "wall": wall, "vt": 0.0,
            "args": {"event": event} if event else {"rid": rid}}


def dev(n, wall, dur, mode, S=1, T=None):
    return X("step.device", "device", wall, dur, tid=5, n=n, T=T, S=S,
             NW=4, mode=mode)


# a window of [1, 2): request 1 submitted at 1.0, admitted in step 0 at
# 1.1, its first token in step 2 (ends on the card at 1.45); request 2
# submitted before the window; request 3 admitted after it
EVENTS = [
    X("register", "store.call", 0.5, 0.2),            # before the window
    X("register", "store.call", 1.0, 0.01),
    req("b", 1, 1.02),
    X("step", "engine", 1.05, 0.1, n=0),
    X("lookup", "store.call", 1.09, 0.004),
    req("n", 1, 1.1, "admitted"),
    dev(0, 1.1, 0.08, "eager"),
    X("step", "engine", 1.2, 0.1, n=1),
    dev(1, 1.2, 0.1, "capture"),
    X("step", "engine", 1.35, 0.09, n=2),
    dev(2, 1.4, 0.05, "replay"),
    req("n", 1, 1.44, "first_token"),
    X("publish", "store.call", 1.441, 0.003),
    X("retire", "store.call", 1.5, 0.002),
    X("dispatch", "engine", 1.5, 0.2),                # not a store call
    req("b", 2, 0.7),
    req("n", 2, 1.6, "admitted"),
    dev(3, 1.6, 0.1, "replay", S=64, T=128),
    dev(4, 1.9, 0.2, "replay"),                       # ends past the window
    req("b", 3, 1.95),
    req("n", 3, 2.1, "admitted"),
]


def test_readings_by_hand():
    w0, w1 = 1.0, 2.0
    assert split.store_host_s(EVENTS, w0, w1) == pytest.approx(
        0.01 + 0.004 + 0.003 + 0.002)
    marks = split.request_marks(EVENTS)
    assert marks[1] == {"submit": 1.02, "admitted": 1.1,
                        "first_token": 1.44}
    hsteps = split.host_steps(EVENTS)
    assert split.step_at(hsteps, 1.44) == 2
    assert split.step_at(hsteps, 1.32) is None
    # only request 1 was submitted and admitted in the window
    assert split.queue_waits(marks, w0, w1) == {1: pytest.approx(0.08)}
    d = split.device_steps(EVENTS)
    assert split.prefills(marks, hsteps, d, w0, w1) == {
        1: pytest.approx(1.45 - 1.1)}
    # replayed steps only (the capture and the step past the window left
    # out), and the device's window from 1.1 to 1.7
    assert split.step_device_mean_s(d, w0, w1) == pytest.approx(0.075)
    busy = 0.08 + 0.1 + 0.05 + 0.1
    assert split.host_wait_share(d, w0, w1) == pytest.approx(
        1 - busy / 0.6)
    r = split.readings(EVENTS, w0, w1, n_submitted=2)
    assert r["store_host_ms_per_request"] == pytest.approx(19 / 2)
    assert r["queue_wait_p90_ms"] == pytest.approx(80)
    assert r["prefill_p90_ms"] == pytest.approx(350)
    assert r["step_device_ms"] == pytest.approx(75)


def test_replays_split_by_kind_and_rows():
    """The window's replayed steps: step 2 fed one token a slot (S=1, no
    T), step 3 carried a chunk on 128 packed rows; step 4 ends past the
    window and the capture is not a replay. The rows' share reads the
    engine's counters, and nothing without them."""
    r = split.replay_ms_by_kind(EVENTS, 1.0, 2.0)
    assert r == {"decode_only": {"steps": 1, "mean_ms": pytest.approx(50),
                                 "steps_by_T": {None: 1}},
                 "prefill": {"steps": 1, "mean_ms": pytest.approx(100),
                             "steps_by_T": {128: 1}}}
    assert split.replay_ms_by_kind([], 0.0, 1.0)["prefill"] == {
        "steps": 0, "mean_ms": None, "steps_by_T": {}}
    assert split.row_share({"rows_real": 10, "rows_run": 40},
                           {"rows_real": 70, "rows_run": 160}) == {
        "rows_real": 60, "rows_run": 120, "real_share": 0.5}
    assert split.row_share(None, None)["real_share"] is None


def test_host_build_is_dispatch_less_its_program_span():
    """Two dispatches in the window, each holding a program span: 10 and
    30 ms outside it; one before the window is left out."""
    events = [X("dispatch", "engine", 0.5, 0.05),
              X("eager", "program", 0.51, 0.02),
              X("dispatch", "engine", 1.0, 0.05),
              X("replay", "program", 1.01, 0.04),
              X("dispatch", "engine", 1.5, 0.05),
              X("capture", "program", 1.52, 0.02)]
    r = split.host_build_ms(events, 1.0, 2.0)
    assert r["steps"] == 2
    assert r["mean_ms"] == pytest.approx(20)
    assert split.host_build_ms(events[:1], 0.0, 1.0) is None


def test_waits_are_named_by_the_innermost_span():
    """The device waits 1.18-1.2, 1.3-1.4 and 1.45-1.6 between the window's
    steps; inside the last, ``retire`` (1.5-1.502) is nested in
    ``dispatch`` (1.5-1.7) and names its own two milliseconds."""
    w = split.waits_by_span(EVENTS, 1.0, 2.0)
    assert w["by_span_s"] == {
        "outside any span": pytest.approx(0.02 + 0.05 + 0.05),
        "step": pytest.approx(0.05), "dispatch": pytest.approx(0.098),
        "retire": pytest.approx(0.002)}
    total, pieces = w["longest_ms"][0]
    assert total == pytest.approx(150)
    assert pieces == {"outside any span": pytest.approx(50),
                      "retire": pytest.approx(2),
                      "dispatch": pytest.approx(98)}


def test_union_counts_overlaps_once():
    assert split.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_an_engine_without_the_spans_reads_nothing():
    """The reference's events alone (no store.call, no device spans): every
    reading of the port's own spans is None, and none raises."""
    names = ["store_host_ms_per_request", "queue_wait_p90_ms",
             "prefill_p90_ms", "step_device_ms", "host_wait_share"]
    plain = [e for e in EVENTS if e["cat"] not in ("store.call", "device")]
    r = split.readings(plain, 1.0, 2.0, 2)
    # the request track is the reference's own: the queue wait reads
    assert r.pop("queue_wait_p90_ms") == pytest.approx(80)
    assert r == dict.fromkeys(set(names) - {"queue_wait_p90_ms"})
    assert split.readings([], 0.0, 1.0, 0) == dict.fromkeys(names)


def _captured_engines(monkeypatch):
    """The benchmark's engine with the step program's graph bookkeeping on
    the CPU: a capture records the step, a replay runs it."""
    from bench import harness
    from repro_torch.serve.step_graph import StepProgram

    monkeypatch.setattr(StepProgram, "_record", lambda prog, fn: (
        SimpleNamespace(replay=fn), Counter(step=1)))
    build = harness.build_engine

    def captured(*a, **kw):
        eng = build(*a, **kw)
        eng.step_program.capture = True
        return eng
    monkeypatch.setattr(harness, "build_engine", captured)


def _tiny(workload):
    """The CPU tests' cell, its prompts and outputs shortened further, so
    that requests due in a few seconds get their first tokens in them."""
    cell = bench_conftest.tiny_cell(workload)
    t = cell.traffic
    if t.get("documents"):
        t["documents"].update(tokens=[32, 48])
        t.update(question_tokens=[4, 8], output_tokens=[2, 4])
        t["arrival"]["rate_per_s"] = 3.0
    else:
        t.update(question_tokens=[16, 40], output_tokens=[2, 6])
    return cell


@pytest.mark.parametrize("workload", [RAG, BACKLOG])
def test_traced_tiny_cell_reports_its_readings(monkeypatch, workload):
    from bench import harness

    monkeypatch.setattr(harness, "LEAD_S", 1.0)
    _captured_engines(monkeypatch)
    out = split.traced_window(_tiny(workload), 2147483999, 4.0, "cpu")
    m = out["metrics"]
    assert out["trace"]["dropped"] == out["trace"]["ring_dropped"] == 0
    assert out["trace"]["eager_steps"] + out["trace"]["replays"] > 0
    if workload == RAG:
        for name in ("store_host_ms_per_request", "queue_wait_p90_ms",
                     "prefill_p90_ms"):
            assert m[name] is not None and m[name] >= 0, (name, m)
        # arrival lag + queue wait + prefill never exceeds the harness's
        # TTFT: the rest is the host's time before this request's submit
        # in the harness's loop and after its first-token step's end
        s = out["ttft_split"]
        assert s["requests"] > 0 and s["nearest_p90"]
        for r in s["all"]:
            assert r["rest_ms"] >= 0, r
            assert r["submit_after_loop_ms"] >= 0, r
            assert r["mark_after_end_ms"] >= 0, r
            assert r["rest_ms"] == pytest.approx(
                r["submit_after_loop_ms"] + r["mark_after_end_ms"],
                abs=1e-3)
    else:
        assert m["step_device_ms"] > 0
        assert 0 <= m["host_wait_share"] < 1
        w = out["device_window"]
        assert w["modes"]["replay"] > 0
        assert w["host_wait_s"] == pytest.approx(
            w["window_s"] - w["device_s"], abs=1e-6)
    rows = out["device_window"]["rows"]
    assert 0 < rows["rows_real"] <= rows["rows_run"]
    assert 0 < rows["real_share"] <= 1
    assert out["device_window"]["host_build"]["mean_ms"] > 0
    kinds = out["device_window"]["replays_by_kind"]
    assert sum(k["steps"] for k in kinds.values()) == \
        out["device_window"]["modes"]["replay"]
    # each harness step matched to its device span, the mark after its end
    c = out["clock"]
    assert c["steps_matched"] == out["device_window"]["harness_steps"]
    assert c["mark_minus_end_ms_min"] >= 0
    assert np.isfinite(out["cost"]["step_us"])
    assert sum(out["host_waits"]["by_span_s"].values()) == pytest.approx(
        out["device_window"]["host_wait_s"], abs=1e-6)
