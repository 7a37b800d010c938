"""The work a serve step's inputs need: model FLOPs for ``mfu`` and K1's
bytes and FLOPs for its roofline share, from a configuration's published
sizes (``configs/<name>.json``, Hugging Face key names) and the step's
feeds.

A step's feeds are ``(before, after)`` pairs, one a slot that the step fed:
the slot's tokens at positions ``[before, after)`` went through the model
(a prefill chunk, or one decode token). Padding, inactive slots and
anything else the program computes beyond that are not counted, so these
are at or under what any implementation has to do, and a share of a peak
computed from them cannot pass 100% unless the time is short of the work.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Tuple

Feed = Tuple[int, int]
BF16_BYTES = 2


def head_dim(cfg: Dict) -> int:
    return int(cfg.get("head_dim") or cfg["hidden_size"]
               // cfg["num_attention_heads"])


def linear_params(cfg: Dict) -> int:
    """Weights of the non-embedding matrix products of all layers: Q, K,
    V and output projections, the SwiGLU gate, up and down projections.
    Biases and norm scales are not products and are left out."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    H, KV, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        head_dim(cfg)
    attn = d * H * D + 2 * d * KV * D + H * D * d
    mlp = 3 * d * f
    return cfg["num_hidden_layers"] * (attn + mlp)


def attention_pairs(feeds: Iterable[Feed]) -> int:
    """Visible (query, key) pairs: the token at position t sees t + 1
    keys."""
    return sum((a * (a + 1) - b * (b + 1)) // 2 for b, a in feeds)


def step_flops(cfg: Dict, feeds: Iterable[Feed]) -> float:
    """Model FLOPs a step's feeds need: 2 x linear weights a fed token,
    one unembedding a fed slot, and 4 x head_dim x heads a visible pair a
    layer (QK^T and PV)."""
    feeds = list(feeds)
    tokens = sum(a - b for b, a in feeds)
    return (2.0 * linear_params(cfg) * tokens
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * len(feeds)
            + 4.0 * head_dim(cfg) * cfg["num_attention_heads"]
            * attention_pairs(feeds) * cfg["num_hidden_layers"])


def k1_step_cost(cfg: Dict, feeds: Iterable[Feed],
                 dtype_bytes: int = BF16_BYTES) -> Tuple[float, float]:
    """(bytes, FLOPs) of a step's paged-attention calls, all layers. Each
    visible K and V row is read once per (row, KV head, layer); Q is read
    and O written once a fed token; FLOPs are the visible pairs' QK^T and
    PV products."""
    feeds = list(feeds)
    H, KV, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        head_dim(cfg)
    L = cfg["num_hidden_layers"]
    kv_rows = sum(a for _, a in feeds)
    tokens = sum(a - b for b, a in feeds)
    nbytes = L * dtype_bytes * (2 * kv_rows * KV * D + 2 * tokens * H * D)
    flops = 4.0 * D * H * attention_pairs(feeds) * L
    return float(nbytes), flops


def roofline_s(nbytes: float, flops: float, peak: Dict) -> float:
    """The least time the chip could take: the larger of the bytes at the
    memory bandwidth and the FLOPs at the bf16 rate."""
    return max(nbytes / peak["hbm_byte_per_s"],
               flops / peak["bf16_flop_per_s"])


def peaks(device_kind: str) -> Dict:
    """The published peaks of ``device_kind`` from ``peaks.json``; a card
    that is not in the table has no peak, and its shares are not
    reported."""
    table = json.loads(Path(__file__).with_name("peaks.json").read_text())
    return table.get(device_kind)
