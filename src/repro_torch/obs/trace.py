"""Mirrors ``src/repro/obs/trace.py`` verbatim (own copy).

Bounded ring-buffer trace recorder with Chrome/Perfetto export.

The serve/sim stack is instrumented at every layer — engine step phases,
scheduler decisions, per-request lifecycle, store events (evict / demote
/ promote with the policy's eviction key at decision time), coordination
bus messages — but ALL of it is off by default: instrumentation sites
are ``if trace is not None`` guards, so an engine without a recorder is
bit-identical to the pre-obs code (tested in
``tests/test_obs.py::test_tracing_off_bit_identity``).

Two clocks, stamped on every event:

* **virtual** — the embedder's deterministic clock (``ServeEngine.now``
  on the ``StepCostModel``, ``ClusterSim``'s event-loop clock). Units
  are the embedder's abstract milliseconds; reproducible on any host.
  Embedders keep ``recorder.vt`` current (or pass ``vt=`` explicitly for
  backdated events like arrivals).
* **wall** — ``time.perf_counter`` seconds since the recorder was built.
  What intra-step phase durations actually cost on this machine.

``export(timebase=...)`` picks which clock becomes the Chrome
trace-event ``ts``; the other is preserved per-event in ``args`` only
where the embedder put it there. The export is the standard JSON object
format (``{"traceEvents": [...]}``) with ``X`` (complete), ``i``
(instant), ``C`` (counter) and ``b``/``n``/``e`` (async lifecycle)
phases plus ``M`` process/thread-name metadata — loadable in
``ui.perfetto.dev`` / ``chrome://tracing`` as-is.

The buffer is a ``deque(maxlen=limit)``: under sustained traffic the
oldest events drop (``n_emitted`` still counts them) so memory stays
bounded; metadata labels live outside the ring and always export.
"""
from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import Any, Dict, Optional

# thread-id lanes used by the serve engine's instrumentation (one pid per
# engine/shard, one lane per subsystem)
TID_ENGINE = 0
TID_SCHED = 1
TID_STORE = 2
TID_REQ = 3
TID_BUS = 4

_LANE_NAMES = {TID_ENGINE: "engine", TID_SCHED: "scheduler",
               TID_STORE: "store", TID_REQ: "requests", TID_BUS: "bus"}


def jsonable(obj):
    """Recursively coerce an object into strict-JSON-safe values: tuples
    and sets become lists, numpy scalars their Python values, non-finite
    floats strings (strict JSON has no Infinity/NaN — Perfetto rejects
    them), and anything else its ``str``."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [jsonable(v) for v in obj]
    item = getattr(obj, "item", None)           # numpy scalars
    if callable(item):
        try:
            return jsonable(item())
        except Exception:
            pass
    return str(obj)


class Span:
    """One ``X`` (complete) event, timed on BOTH clocks between
    ``begin()`` and ``end()``. Usable as a context manager or via the
    explicit begin/end pair (the engine's step phases interleave with
    control flow that a ``with`` block cannot wrap)."""

    __slots__ = ("rec", "name", "cat", "pid", "tid", "args", "_w0", "_v0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 pid: int, tid: int, args: Optional[dict]) -> None:
        self.rec, self.name, self.cat = rec, name, cat
        self.pid, self.tid, self.args = pid, tid, args

    def begin(self) -> "Span":
        self._w0 = self.rec.wall()
        self._v0 = self.rec.vt
        return self

    def end(self, args: Optional[dict] = None) -> None:
        rec = self.rec
        if args:
            self.args = {**(self.args or {}), **args}
        rec._push({"ph": "X", "name": self.name, "cat": self.cat,
                   "pid": self.pid, "tid": self.tid,
                   "wall": self._w0, "vt": self._v0,
                   "dur_wall": rec.wall() - self._w0,
                   "dur_vt": rec.vt - self._v0, "args": self.args})

    def __enter__(self) -> "Span":
        return self.begin()

    def __exit__(self, *exc) -> None:
        self.end()


class TraceRecorder:
    """Bounded recorder for spans, instants, counter samples and async
    (request-lifecycle) events. One recorder serves a whole deployment:
    engines/shards stamp their own ``pid``, subsystems their ``tid``
    lane."""

    def __init__(self, limit: int = 200_000) -> None:
        self.limit = int(limit)
        self.events: deque = deque(maxlen=self.limit)
        self.n_emitted = 0            # includes events the ring dropped
        self.vt = 0.0                 # embedder-maintained virtual clock
        self._t0 = time.perf_counter()
        self._meta: Dict[tuple, str] = {}   # (pid,) / (pid, tid) -> name

    # ------------------------------------------------------------- plumbing
    def wall(self) -> float:
        return time.perf_counter() - self._t0

    def _push(self, ev: dict) -> None:
        self.n_emitted += 1
        self.events.append(ev)

    @property
    def n_dropped(self) -> int:
        return self.n_emitted - len(self.events)

    def label(self, pid: int, name: str, tid: Optional[int] = None,
              tname: Optional[str] = None) -> None:
        """Name a process (engine/shard/bus) and optionally one of its
        lanes. Labels are not ring-buffered — they always export."""
        self._meta[(pid,)] = name
        if tid is not None:
            self._meta[(pid, tid)] = tname or _LANE_NAMES.get(tid, str(tid))

    # --------------------------------------------------------------- events
    def span(self, name: str, cat: str, pid: int = 0, tid: int = 0,
             args: Optional[dict] = None) -> Span:
        return Span(self, name, cat, pid, tid, args)

    def instant(self, name: str, cat: str, pid: int = 0, tid: int = 0,
                args: Optional[dict] = None,
                vt: Optional[float] = None) -> None:
        self._push({"ph": "i", "name": name, "cat": cat, "pid": pid,
                    "tid": tid, "wall": self.wall(),
                    "vt": self.vt if vt is None else vt, "args": args})

    def counter(self, name: str, pid: int, values: Dict[str, float],
                vt: Optional[float] = None) -> None:
        """One ``C`` sample: every key in ``values`` becomes a counter
        track under ``name``."""
        self._push({"ph": "C", "name": name, "cat": "counter", "pid": pid,
                    "tid": 0, "wall": self.wall(),
                    "vt": self.vt if vt is None else vt, "args": values})

    def complete(self, name: str, cat: str, pid: int = 0, tid: int = 0, *,
                 vt: float, dur: float, args: Optional[dict] = None) -> None:
        """Retrospective ``X`` event on the VIRTUAL clock — for embedders
        (the cluster sim) that learn a span's duration when it is
        scheduled, not by bracketing real work."""
        self._push({"ph": "X", "name": name, "cat": cat, "pid": pid,
                    "tid": tid, "wall": self.wall(), "vt": vt,
                    "dur_wall": 0.0, "dur_vt": dur, "args": args})

    # async lifecycle (b/n/e share name+cat+id — Chrome's legacy async
    # events, which Perfetto renders as one track per id)
    def begin_async(self, name: str, aid, cat: str, pid: int = 0,
                    tid: int = 0, args: Optional[dict] = None,
                    vt: Optional[float] = None) -> None:
        self._async(name, aid, cat, pid, tid, "b", args, vt)

    def async_instant(self, name: str, aid, cat: str, pid: int = 0,
                      tid: int = 0, args: Optional[dict] = None,
                      vt: Optional[float] = None) -> None:
        self._async(name, aid, cat, pid, tid, "n", args, vt)

    def end_async(self, name: str, aid, cat: str, pid: int = 0,
                  tid: int = 0, args: Optional[dict] = None,
                  vt: Optional[float] = None) -> None:
        self._async(name, aid, cat, pid, tid, "e", args, vt)

    def _async(self, name, aid, cat, pid, tid, ph, args, vt) -> None:
        self._push({"ph": ph, "name": name, "cat": cat, "pid": pid,
                    "tid": tid, "id": str(aid), "wall": self.wall(),
                    "vt": self.vt if vt is None else vt, "args": args})

    # --------------------------------------------------------------- export
    def export(self, path: Optional[str] = None, timebase: str = "wall"
               ) -> Dict[str, Any]:
        """Chrome trace-event JSON. ``timebase`` picks the ``ts`` clock:
        ``"wall"`` (seconds -> us; real phase durations) or ``"virtual"``
        (the embedder's deterministic clock, 1 unit -> 1ms -> 1000 us).
        Returns the document; writes it to ``path`` when given."""
        if timebase not in ("wall", "virtual"):
            raise ValueError(f"timebase must be wall|virtual, "
                             f"got {timebase!r}")
        wall_ts = timebase == "wall"

        def ts(ev):
            return ev["wall"] * 1e6 if wall_ts else ev["vt"] * 1e3

        out = []
        for key, name in sorted(self._meta.items(), key=lambda kv: kv[0]):
            if len(key) == 1:
                out.append({"ph": "M", "name": "process_name", "pid": key[0],
                            "tid": 0, "ts": 0, "args": {"name": name}})
            else:
                out.append({"ph": "M", "name": "thread_name", "pid": key[0],
                            "tid": key[1], "ts": 0, "args": {"name": name}})
        for ev in self.events:
            e = {"ph": ev["ph"], "name": ev["name"], "cat": ev["cat"],
                 "pid": ev["pid"], "tid": ev["tid"], "ts": ts(ev)}
            if ev["ph"] == "X":
                e["dur"] = (ev["dur_wall"] * 1e6 if wall_ts
                            else ev["dur_vt"] * 1e3)
            if ev["ph"] == "i":
                e["s"] = "t"
            if "id" in ev:
                e["id"] = ev["id"]
            if ev.get("args") is not None:
                e["args"] = jsonable(ev["args"])
            out.append(e)
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": {"timebase": timebase,
                             "events_emitted": self.n_emitted,
                             "events_dropped": self.n_dropped}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
