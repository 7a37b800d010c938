"""Device step spans: when the step each ``ServeEngine.step()`` dispatched
ran on the card, put on the trace recorder's wall clock.

``DeviceSteps`` is a ring of CUDA event pairs made when a recorder is
attached. The engine records a begin event just before a step's uploads
and an end event just after the step's program, on the current stream;
nothing waits on them while the engine runs. ``flush()`` synchronizes
once and turns each pair into an ``X`` span named ``step.device`` on the
engine's ``device`` lane (``TID_DEVICE``), timed as the anchor's wall
plus each event's elapsed time from the anchor, an event recorded right
after a synchronize at attach. Its args are the step index ``n``, the
step signature (``T``, ``S``, ``NW``: on the paged plane the packed rows,
K1's tile width and the table width; on the gather plane the grid's width
``S``, the other two None) and ``mode``, how the step program ran it:
``eager``, ``capture`` or ``replay``.

On the CPU the step runs synchronously, so a pair is the host's wall at
the step program's begin and end, and the same span comes out.

The ring holds ``capacity`` steps between flushes (by default more than
a benchmark window dispatches); past that the oldest pairs are
overwritten and counted in ``dropped``, as the recorder's own ring drops
its oldest events.
"""
from __future__ import annotations

from typing import List, Optional

import torch

# the port's own lane, beside obs.trace's engine/scheduler/store/requests/bus
TID_DEVICE = 5
DEVICE_LANE = "device"
# the categories of the spans only the port emits: the engine's calls into
# the store, the step program's modes, and the device steps; everything
# else the port's engine emits is the reference's trace, event for event
PORT_CATEGORIES = ("store.call", "program", "device")


class DeviceSteps:
    """A ring of ``capacity`` step event pairs on ``device`` for
    ``recorder``; ``pid`` is the engine's trace pid."""

    def __init__(self, recorder, device: torch.device, pid: int = 0,
                 capacity: int = 16384) -> None:
        self.rec = recorder
        self.pid = pid
        self.capacity = int(capacity)
        self.device = device
        self.cuda = device.type == "cuda"
        self.dropped = 0             # pairs overwritten before a flush
        self._next = 0               # pairs recorded so far
        self._flushed = 0            # pairs resolved (or dropped) so far
        self._args: List[Optional[dict]] = [None] * self.capacity
        self._vt: List[float] = [0.0] * self.capacity
        if self.cuda:
            # set-up: allocated now, so a step records into events it holds
            self._begin = [torch.cuda.Event(enable_timing=True)
                           for _ in range(self.capacity)]
            self._end = [torch.cuda.Event(enable_timing=True)
                         for _ in range(self.capacity)]
            self._anchor = torch.cuda.Event(enable_timing=True)
            # an event's CUDA handle is made at its first record: make them
            # all here, outside any timed region
            for ev in self._begin + self._end:
                ev.record()
            torch.cuda.synchronize(device)
            self._anchor.record()
        else:
            self._begin = [0.0] * self.capacity
            self._end = [0.0] * self.capacity
        self.anchor_wall = recorder.wall()

    def begin(self) -> None:
        i = self._next % self.capacity
        if self.cuda:
            self._begin[i].record()
        else:
            self._begin[i] = self.rec.wall()
        self._vt[i] = self.rec.vt

    def end(self, n: int, S: int, NW: Optional[int], mode: str,
            T: Optional[int] = None) -> None:
        i = self._next % self.capacity
        if self.cuda:
            self._end[i].record()
        else:
            self._end[i] = self.rec.wall()
        self._args[i] = {"n": n, "T": T, "S": S, "NW": NW, "mode": mode}
        self._next += 1
        if self._next - self._flushed > self.capacity:
            self._flushed += 1
            self.dropped += 1

    def flush(self) -> int:
        """Resolve every pair recorded since the last flush into a
        ``step.device`` span, oldest first (one synchronize on the card);
        returns how many were written."""
        if self._next == self._flushed:
            return 0
        if self.cuda:
            torch.cuda.synchronize(self.device)
        rec, n = self.rec, 0
        for k in range(self._flushed, self._next):
            i = k % self.capacity
            if self.cuda:
                w0 = self.anchor_wall + self._anchor.elapsed_time(
                    self._begin[i]) / 1e3
                w1 = self.anchor_wall + self._anchor.elapsed_time(
                    self._end[i]) / 1e3
            else:
                w0, w1 = self._begin[i], self._end[i]
            # obs.trace's ``X`` event, its wall times given rather than read
            rec._push({"ph": "X", "name": "step.device", "cat": "device",
                       "pid": self.pid, "tid": TID_DEVICE, "wall": w0,
                       "vt": self._vt[i], "dur_wall": w1 - w0, "dur_vt": 0.0,
                       "args": self._args[i]})
            n += 1
        self._flushed = self._next
        return n
