"""Mirrors ``src/repro/launch/hlo_analysis.py`` verbatim (own copy).

Post-SPMD HLO analysis: collective wire bytes + cost/memory extraction.

Shapes in partitioned HLO are per-device shard shapes, so every byte count
below is per-device. Wire cost per collective (ring schedules, n = replica
group size):

* all-gather:          out − in        (bytes received per device)
* reduce-scatter:      in − out
* all-reduce:          2 · out · (n−1)/n   (reduce-scatter + all-gather)
* all-to-all:          out · (n−1)/n
* collective-permute:  out             (one hop)

``lax.scan`` bodies appear once in HLO regardless of trip count (XLA while
loops); the roofline extractor (benchmarks/roofline.py) recovers per-layer
costs by a two-point fit over reduced-depth compiles — this module only
reports what is literally in the artifact.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(([^)]*)\)(.*)$")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([0-9,]+)\}")
_GROUPS_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(text: str) -> int:
    """Sum byte sizes of every `dtype[dims]` occurrence in ``text``."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_V2_RE.search(line)
    if m:                                   # [n_groups,group_size]
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 2


@dataclass
class CollectiveStats:
    per_kind_bytes: Dict[str, float] = field(default_factory=dict)
    per_kind_count: Dict[str, int] = field(default_factory=dict)
    ops: List[Tuple[str, float, int]] = field(default_factory=list)

    @property
    def total_bytes(self) -> float:
        return sum(self.per_kind_bytes.values())

    def as_dict(self) -> Dict:
        return {"total_bytes": self.total_bytes,
                "per_kind_bytes": dict(self.per_kind_bytes),
                "per_kind_count": dict(self.per_kind_count)}


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Per-device wire bytes of every collective in partitioned HLO."""
    stats = CollectiveStats()
    seen_started: set = set()
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue  # async pair: count the -start only
        m = _OP_RE.match(line)
        if not m:
            continue
        out_shape, kind, operands, rest = m.groups()
        out_b = _shape_bytes(out_shape)
        in_b = _shape_bytes(operands)
        n = _group_size(line)
        if kind == "all-gather":
            wire = max(out_b - in_b, 0)
        elif kind == "reduce-scatter":
            wire = max(in_b - out_b, 0)
        elif kind == "all-reduce":
            wire = 2.0 * out_b * (n - 1) / max(n, 1)
        elif kind == "all-to-all":
            wire = out_b * (n - 1) / max(n, 1)
        else:                                # collective-permute
            wire = float(out_b)
        stats.per_kind_bytes[kind] = stats.per_kind_bytes.get(kind, 0.0) + wire
        stats.per_kind_count[kind] = stats.per_kind_count.get(kind, 0) + 1
        stats.ops.append((kind, wire, n))
    return stats


def cost_summary(compiled) -> Dict[str, float]:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return {"flops": float(ca.get("flops", 0.0)),
            "bytes_accessed": float(ca.get("bytes accessed", 0.0)),
            "transcendentals": float(ca.get("transcendentals", 0.0))}


def memory_summary(compiled) -> Dict[str, float]:
    ma = compiled.memory_analysis()
    return {
        "argument_bytes": float(ma.argument_size_in_bytes),
        "output_bytes": float(ma.output_size_in_bytes),
        "temp_bytes": float(ma.temp_size_in_bytes),
        "alias_bytes": float(ma.alias_size_in_bytes),
        "peak_bytes": float(ma.argument_size_in_bytes
                            + ma.output_size_in_bytes
                            + ma.temp_size_in_bytes
                            - ma.alias_size_in_bytes),
    }
