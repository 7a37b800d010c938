"""Mirrors ``src/repro/core/metrics.py`` verbatim (own copy).

Cache performance metrics.

The paper's point (§III-A, Figs. 6–7): the *effective* cache hit ratio —
hits whose whole peer group is resident — predicts job runtime; the plain
hit ratio does not.

``merge``/``as_dict`` are derived from ``dataclasses.fields`` so a
counter added by a future PR is aggregated and reported automatically —
the hand-maintained three-place copies these replaced silently dropped
any field someone forgot (``tests/test_obs.py`` round-trips every field
through both).

Effective-hit **attribution** (the obs PR): every ineffective hit
increments exactly one bucket of ``ineffective_by_cause`` — where the
first blocking peer block of its group/chain was sitting at access time:

* ``"host"`` / ``"disk"`` — demoted to a slower tier (a promotion copy,
  not a recompute, would complete the group);
* ``"evicted"`` — was resident once and died (the policy's fault);
* ``"never_cached"`` — never entered the cache at all (cold chain);
* ``"unattributed"`` — the caller recorded no cause.

Conservation holds structurally: ``sum(ineffective_by_cause.values())
== hits - effective_hits`` after any interleaving of ``record_access``
and ``merge`` (``check_attribution`` asserts it; the stores and the sim
call it on every metrics read).
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, Optional


def _merged(a, b):
    """Field-derived dataclass merge: numeric fields sum, dict-valued
    counter fields sum key-wise."""
    kw = {}
    for f in fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, dict):
            out = dict(va)
            for k, v in vb.items():
                out[k] = out.get(k, 0) + v
            kw[f.name] = out
        else:
            kw[f.name] = va + vb
    return type(a)(**kw)


def _field_dict(obj) -> Dict[str, object]:
    """Every dataclass field, in declaration order; dict-valued fields
    are copied so callers can't mutate the live counters."""
    return {f.name: (dict(v) if isinstance(v, dict) else v)
            for f in fields(obj)
            for v in (getattr(obj, f.name),)}


@dataclass
class CacheMetrics:
    accesses: int = 0
    hits: int = 0
    effective_hits: int = 0
    evictions: int = 0
    disk_bytes_read: int = 0
    mem_bytes_read: int = 0
    # ---- tiered stores (serve.TieredKVStore; core's mem/disk analogue) ----
    # ``hits`` counts presence in ANY tier; ``tier1_hits``/``tier2_hits``
    # are the slices served by the host/disk tiers (hits that pay a
    # promotion copy, not a recompute). Effective hits are tier-0-only by
    # Def. 1: the whole peer group must sit in the fast tier.
    tier1_hits: int = 0
    tier2_hits: int = 0
    demotions: int = 0        # fast tier -> host tier (block survives)
    promotions: int = 0       # slower tier -> fast tier (chain reused)
    host_evictions: int = 0   # out of the host tier, no disk tier to catch
    # ---- the disk rung (PR 8) ----
    disk_demotions: int = 0   # host tier -> disk tier (block survives again)
    disk_promotions: int = 0  # the slice of ``promotions`` sourced from disk
    disk_evictions: int = 0   # out of the disk tier (block finally dies)
    # ---- transcoding + dispatch economics ----
    quantized_demotions: int = 0     # demotions that narrowed the dtype
    dequantized_promotions: int = 0  # promotions that widened it back
    promotion_dispatches: int = 0    # batched transfers (1 per tier per
    #                                  promotion, however many blocks ride)
    # ---- fault injection + graceful degradation (robustness PR) ----
    disk_io_errors: int = 0          # injected/real OSErrors on the disk tier
    disk_quarantines: int = 0        # disk tiers taken out of rotation
    promotion_stalls: int = 0        # slow promotions charged to the clock
    promotion_timeouts: int = 0      # promotions abandoned past the budget
    # ---- effective-hit attribution (obs PR): ineffective hits bucketed
    # by where the first blocking peer block sat at access time ----
    ineffective_by_cause: Dict[str, int] = field(default_factory=dict)

    def record_access(self, hit: bool, effective: bool, tier: int = 0,
                      cause: Optional[str] = None) -> None:
        self.accesses += 1
        if hit:
            self.hits += 1
            if tier == 1:
                self.tier1_hits += 1
            elif tier == 2:
                self.tier2_hits += 1
        if effective:
            if not hit:
                raise ValueError("an effective hit must be a hit")
            if tier != 0:
                raise ValueError("an effective hit must be a fast-tier hit")
            self.effective_hits += 1
        elif hit:
            # every ineffective hit lands in exactly one bucket, so the
            # conservation invariant cannot drift no matter the caller
            c = cause or "unattributed"
            self.ineffective_by_cause[c] = \
                self.ineffective_by_cause.get(c, 0) + 1

    @property
    def hit_ratio(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    @property
    def effective_hit_ratio(self) -> float:
        return self.effective_hits / self.accesses if self.accesses else 0.0

    def check_attribution(self) -> None:
        got = sum(self.ineffective_by_cause.values())
        want = self.hits - self.effective_hits
        if got != want:
            raise AssertionError(
                f"ineffective-hit attribution leaked: "
                f"sum(causes)={got} != hits-effective={want} "
                f"({self.ineffective_by_cause})")

    def merge(self, other: "CacheMetrics") -> "CacheMetrics":
        return _merged(self, other)

    def as_dict(self) -> Dict[str, float]:
        return {**_field_dict(self),
                "hit_ratio": self.hit_ratio,
                "effective_hit_ratio": self.effective_hit_ratio}


@dataclass
class MessageStats:
    """Coordination-protocol traffic (paper §III-C).

    Counts are split into the LERC-specific channel (peer-profile
    broadcasts + eviction reports/broadcasts — the paper's overhead claim)
    and the legacy block-status channel that exists regardless of LERC
    (Spark's BlockManagerMaster updates). ``point_to_point`` counts every
    individual message on the wire across both channels; the byte counters
    measure serialized payload sizes so overhead is reportable in bytes as
    well as message counts (zeros on a bus running at stats level
    ``"counts"``, which skips payload sizing entirely).
    """

    peer_profile_broadcasts: int = 0      # job submit: peer info -> workers
    eviction_reports: int = 0             # worker -> master
    eviction_broadcasts: int = 0          # master -> all workers
    point_to_point: int = 0               # individual messages on the wire
    payload_bytes: int = 0                # serialized payload bytes, all msgs
    lerc_bytes: int = 0                   # ...restricted to the LERC channel
    # ---- fault injection + recovery (robustness PR) ----
    dropped: int = 0                      # messages lost to injected faults
    delayed: int = 0                      # ... delivered late
    duplicated: int = 0                   # ... delivered twice
    resyncs: int = 0                      # anti-entropy snapshots served
    diverged_applies: int = 0             # status folds skipped on replicas
    #                                       already diverged by lost traffic

    def merge(self, other: "MessageStats") -> "MessageStats":
        return _merged(self, other)

    def as_dict(self) -> Dict[str, int]:
        return _field_dict(self)
