"""A traced slice of the window: torch.profiler's CUDA activity over a few
seconds, read from its raw records.

The records are read straight from the profiler's results
(``kineto_results.events()``), never through ``key_averages()``, whose
parse of a full-depth model's trace takes minutes of host time. Device
records carry the profiler's clock (nanoseconds since the epoch); they are
put on the host's ``time.perf_counter`` clock, the clock of the engine's
spans, through one reading of both clocks right after the synchronize at
the slice's start.

``busy`` is the union of the device's records (kernels, copies, sets),
so overlapping kernels count once; ``gaps`` are the holes in that union.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

_PRIME_CYCLES = 2000           # torch.cuda._sleep: a spin of ~1 us


@dataclass
class Record:
    name: str
    start: float                 # seconds, host perf_counter clock
    end: float


@dataclass
class DeviceSlice:
    """Start with ``start()`` and end with ``stop()``, each of which
    synchronizes; then ``read()`` once."""
    t0: float = 0.0              # host perf_counter at the slice's start
    t1: float = 0.0
    records: List[Record] = field(default_factory=list)
    _prof: object = None
    _epoch0: int = 0

    @staticmethod
    def prime() -> None:
        """One empty profile, so that the profiler's first start (its
        tracing library's set-up, seconds long) is paid at set-up and not
        inside the window."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda._sleep(_PRIME_CYCLES)
            torch.cuda.synchronize()

    def start(self) -> None:
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._epoch0 = time.time_ns()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    def read(self) -> None:
        self.records = [
            Record(e.name(), self.t0 + (e.start_ns() - self._epoch0) / 1e9,
                   self.t0 + (e.start_ns() + e.duration_ns() - self._epoch0)
                   / 1e9)
            for e in self._prof.profiler.kineto_results.events()
            if e.device_type().name == "CUDA"]
        self._prof = None

    # ------------------------------------------------------------ readings
    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's records, clipped to the slice."""
        spans = sorted((max(r.start, self.t0), min(r.end, self.t1))
                       for r in self.records)
        out: List[List[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """Holes in the union, from the slice's start to its end."""
        out, t = [], self.t0
        for s, e in self.intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def time_by_name(self, *parts: str) -> float:
        """Device seconds of the records whose name holds any of
        ``parts``."""
        return sum(r.end - r.start for r in self.records
                   if any(p in r.name for p in parts))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for r in self.records:
            by[r.name] = by.get(r.name, 0.0) + (r.end - r.start)
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def name_gaps(gaps: List[Tuple[float, float]],
              leaves: List[Tuple[str, float, float]],
              outer: List[Tuple[str, float, float]], n: int = 10
              ) -> List[List]:
    """The ``n`` longest gaps, each named by what the host was doing: the
    innermost host span (``leaves``: (name, start, end) on the
    perf_counter clock) that overlaps the gap most, else the enclosing one
    (``outer``) that does, else "host: outside any span"."""
    def most(g0, g1, spans):
        best, name = 0.0, None
        for sname, s0, s1 in spans:
            ov = min(g1, s1) - max(g0, s0)
            if ov > best:
                best, name = ov, sname
        return name

    out: List[List] = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        name = (most(g0, g1, leaves) or most(g0, g1, outer)
                or "host: outside any span")
        out.append([name, g1 - g0])
    return out
