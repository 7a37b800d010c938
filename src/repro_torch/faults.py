"""Mirrors ``src/repro/faults.py`` verbatim (own copy).

Deterministic fault injection for the serve/sim/coordination planes.

LERC was built as a Spark memory manager, where executor loss, dropped
BlockManager messages and lineage recompute of lost blocks are the
operating baseline. This module makes failure a first-class, *seeded*
input to every layer of the reproduction: a ``FaultPlan`` schedules fault
events on the virtual clock (shard/worker crashes at time t) and draws
probabilistic ones (bus message drop/delay/duplication per channel,
disk-tier I/O errors, slow promotions) from one ``numpy`` generator, so a
faulted run is exactly reproducible — on CI CPU as on a TPU pod.

Consumers:

* ``serve.ShardedFrontend`` — shard crashes (failover: re-route, requeue
  in-flight requests with capped exponential backoff, rebuild the replica
  via the anti-entropy ``resync`` protocol);
* ``core.MessageBus`` — per-channel drop/delay/duplication of messages;
* ``serve.TieredKVStore`` / ``serve.DiskBlockPool`` — injected ``OSError``
  on disk-tier reads/writes (quarantine after ``quarantine_after``
  consecutive errors) and slow-promotion stalls with a timeout;
* ``sim.ClusterSim`` — worker crashes (cached blocks lost, lineage
  recompute charged to the makespan).

Determinism contract: the injector draws from its generator ONLY when a
matching fault is configured for that site — adding a fault on one
channel never perturbs the draws (and therefore the outcome) of another.
An **empty plan is bit-identical to no plan at all**: every hook in the
consumers is gated on a predicate that an empty plan never satisfies
(``tests/test_faults.py`` proves tokens, eviction logs and the full
metrics dict unchanged).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class BusFault:
    """Probabilistic fault on one bus channel (message ``kind``, or ``"*"``
    for every kind). Checks are ordered drop → duplicate → delay, each an
    independent draw."""

    channel: str = "*"
    drop_p: float = 0.0
    delay_p: float = 0.0
    delay: float = 0.5          # virtual-clock units a delayed message waits
    dup_p: float = 0.0


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic schedule of faults plus recovery tuning.

    ``shard_crashes`` / ``worker_crashes`` are ``(t, index)`` pairs on the
    consumer's virtual clock: the serve frontend kills shard ``index`` the
    first time that shard's clock reaches ``t``; the simulator loses
    worker ``index``'s cached blocks at simulated time ``t`` (the executor
    restarts with an empty cache — Spark's standard recovery).
    """

    seed: int = 0
    shard_crashes: Tuple[Tuple[float, int], ...] = ()
    worker_crashes: Tuple[Tuple[float, int], ...] = ()
    bus_faults: Tuple[BusFault, ...] = ()
    disk_read_error_p: float = 0.0
    disk_write_error_p: float = 0.0
    quarantine_after: int = 3       # consecutive disk I/O errors -> quarantine
    promotion_stall_p: float = 0.0
    promotion_stall: float = 0.0    # virtual-clock stall per slow promotion
    promotion_timeout: float = float("inf")   # stalls past this abandon the
    #                                           promotion (chain recomputes)
    retry_backoff: float = 0.5      # failover re-admission: base backoff
    retry_backoff_cap: float = 4.0  # ... and its exponential cap

    @property
    def empty(self) -> bool:
        """True iff this plan injects nothing (recovery tuning aside)."""
        return not (self.shard_crashes or self.worker_crashes
                    or self.bus_faults
                    or self.disk_read_error_p > 0.0
                    or self.disk_write_error_p > 0.0
                    or self.promotion_stall_p > 0.0)

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    def backoff(self, retries: int) -> float:
        """Capped exponential backoff before a failed-over request's
        re-admission (``retries`` >= 1)."""
        return min(self.retry_backoff * (2.0 ** (retries - 1)),
                   self.retry_backoff_cap)

    @classmethod
    def from_json(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown fault-plan keys {sorted(unknown)}; "
                             f"have {sorted(known)}")
        kw = dict(raw)
        for key in ("shard_crashes", "worker_crashes"):
            if key in kw:
                kw[key] = tuple((float(t), int(i)) for t, i in kw[key])
        if "bus_faults" in kw:
            kw["bus_faults"] = tuple(BusFault(**bf) for bf in kw["bus_faults"])
        if "promotion_timeout" in kw and kw["promotion_timeout"] is None:
            kw["promotion_timeout"] = float("inf")
        return cls(**kw)


class FaultInjector:
    """Runtime companion of a ``FaultPlan``: owns the seeded generator,
    the fired-event bookkeeping and the fault/recovery counters. One
    injector is shared by every layer of a run (bus, stores, frontend) so
    the draw sequence — and therefore the whole faulted execution — is a
    pure function of the plan."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.counters: Dict[str, int] = {}
        self._fired: set = set()
        self._bus_by_kind: Dict[str, Tuple[BusFault, ...]] = {}
        for bf in plan.bus_faults:
            self._bus_by_kind.setdefault(bf.channel, ())
            self._bus_by_kind[bf.channel] += (bf,)

    # --------------------------------------------------------------- common
    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def claim(self, key) -> bool:
        """Fire-once bookkeeping for scheduled events: True the first time
        ``key`` is claimed, False after."""
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    # ------------------------------------------------------------------ bus
    def bus_action(self, kind: str) -> Optional[tuple]:
        """Fault decision for one message of ``kind``: ``None`` (deliver),
        ``("drop",)``, ``("dup",)`` or ``("delay", t)``. Draws happen only
        for kinds a fault is configured on."""
        matching = self._bus_by_kind.get(kind, ())
        if kind != "*":
            matching += self._bus_by_kind.get("*", ())
        for bf in matching:
            if bf.drop_p > 0.0 and self.rng.random() < bf.drop_p:
                return ("drop",)
            if bf.dup_p > 0.0 and self.rng.random() < bf.dup_p:
                return ("dup",)
            if bf.delay_p > 0.0 and self.rng.random() < bf.delay_p:
                return ("delay", bf.delay)
        return None

    # ----------------------------------------------------------------- disk
    def disk_read_fails(self) -> bool:
        p = self.plan.disk_read_error_p
        return p > 0.0 and bool(self.rng.random() < p)

    def disk_write_fails(self) -> bool:
        p = self.plan.disk_write_error_p
        return p > 0.0 and bool(self.rng.random() < p)

    # ------------------------------------------------------------ promotion
    def promotion_stall(self) -> float:
        """Virtual-clock stall this promotion suffers (0.0 = healthy)."""
        p = self.plan.promotion_stall_p
        if p > 0.0 and self.rng.random() < p:
            return self.plan.promotion_stall
        return 0.0
