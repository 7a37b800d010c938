"""The work a serve step's inputs need: the cache's bytes a token, model
FLOPs for ``mfu``, and the bytes and FLOPs of the attention kernels for
their roofline shares (K1 over a K/V cache, and a kernel over a latent
cache), from a configuration's published sizes (``configs/<name>.json``,
Hugging Face key names) and the step's feeds. The keys read say the
kind: ``kv_lora_rank`` a latent (MLA) cache, ``n_routed_experts`` expert
layers after the first ``first_k_dense_replace``; without them, dense
GQA.

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


def is_latent(cfg: Dict) -> bool:
    """Latent attention (MLA): keys and values are read from one
    compressed row a token, ``kv_lora_rank`` wide, beside a shared RoPE
    key ``qk_rope_head_dim`` wide."""
    return bool(cfg.get("kv_lora_rank"))


def attention_dims(cfg: Dict) -> Tuple[int, int]:
    """(d_qk, d_v): a head's query-key and value widths. MLA's query and
    key carry a non-rotary and a rotary part; GQA's are one head_dim."""
    if is_latent(cfg):
        return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                cfg["v_head_dim"])
    D = head_dim(cfg)
    return D, D


def cache_elements(cfg: Dict) -> int:
    """Cache elements a token holds in one layer: MLA's one latent row,
    from which keys and values are both read (``kv_lora_rank +
    qk_rope_head_dim``), or a K and a V row a KV head."""
    if is_latent(cfg):
        return cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    return 2 * cfg["num_key_value_heads"] * head_dim(cfg)


def attention_params(cfg: Dict) -> int:
    """Weights of one layer's attention projections. GQA: Q, K, V and O.
    MLA: Q (or ``q_a`` and ``q_b`` where ``q_lora_rank`` is set),
    ``kv_a`` into the latent row and the RoPE key, ``kv_b`` out of the
    latent row into each head's non-rotary key and value, and O."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    d_qk, d_v = attention_dims(cfg)
    if not is_latent(cfg):
        KV = cfg["num_key_value_heads"]
        return d * H * d_qk + 2 * d * KV * d_qk + H * d_v * d
    r, rq = cfg["kv_lora_rank"], cfg.get("q_lora_rank")
    q = d * rq + rq * H * d_qk if rq else d * H * d_qk
    kv_a = d * (r + cfg["qk_rope_head_dim"])
    kv_b = r * H * (cfg["qk_nope_head_dim"] + d_v)
    return q + kv_a + kv_b + H * d_v * d


def mlp_params(cfg: Dict, layer: int) -> int:
    """Weights of layer ``layer``'s SwiGLU products that one token passes
    through: a dense MLP at ``intermediate_size``, or, from layer
    ``first_k_dense_replace`` on where the configuration has routed
    experts, ``num_experts_per_tok`` routed and ``n_shared_experts``
    shared experts at ``moe_intermediate_size`` and the router."""
    d = cfg["hidden_size"]
    routed = cfg.get("n_routed_experts")
    if not routed or layer < cfg.get("first_k_dense_replace", 0):
        return 3 * d * cfg["intermediate_size"]
    experts = cfg["num_experts_per_tok"] + cfg.get("n_shared_experts", 0)
    return experts * 3 * d * cfg["moe_intermediate_size"] + d * routed


def linear_params(cfg: Dict) -> int:
    """Weights of the non-embedding matrix products that one token passes
    through, all layers: the attention projections and the MLP's (its
    active experts and router, in an expert layer). Biases and norm
    scales are not products and are left out."""
    L = cfg["num_hidden_layers"]
    return (L * attention_params(cfg)
            + sum(mlp_params(cfg, i) for i in range(L)))


def attention_pairs(feeds: Iterable[Feed]) -> int:
    """Visible (query, key) pairs: the token at position t sees t + 1
    keys."""
    return sum((a * (a + 1) - b * (b + 1)) // 2 for b, a in feeds)


def pair_flops(cfg: Dict) -> int:
    """FLOPs of one visible pair in one layer: QK^T over d_qk and PV over
    d_v in each head, 2 x H x (d_qk + d_v); 4 x head_dim x H where the two
    widths are one head_dim."""
    d_qk, d_v = attention_dims(cfg)
    return 2 * cfg["num_attention_heads"] * (d_qk + d_v)


def step_flops(cfg: Dict, feeds: Iterable[Feed]) -> float:
    """Model FLOPs a step's feeds need: 2 x linear weights a fed token,
    one unembedding a fed slot, and ``pair_flops`` a visible pair a
    layer."""
    feeds = list(feeds)
    tokens = sum(a - b for b, a in feeds)
    return (2.0 * linear_params(cfg) * tokens
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * len(feeds)
            + float(pair_flops(cfg) * attention_pairs(feeds)
                    * cfg["num_hidden_layers"]))


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


def latent_attention_cost(cfg: Dict, feeds: Iterable[Feed],
                          dtype_bytes: int = BF16_BYTES
                          ) -> Tuple[float, float]:
    """(bytes, FLOPs) of a step's attention over a latent (MLA) paged
    cache, all layers, for the roofline of a kernel that reads it.

    Bytes: each visible latent row (``cache_elements``) read once per row
    and layer; Q read and O written once a fed token, at the model's own
    widths (H x d_qk and H x d_v).
    FLOPs: the lesser of the two forms. Absorbed (``kv_b`` folded into
    the query and the output): 2 x H x (r + rope + r) a visible pair.
    Expanded (each visible latent row through ``kv_b`` into the heads'
    keys and values, then attention): 2 x r x H x (nope + v) a visible
    row and ``pair_flops`` a visible pair.
    So the count is at or under what the kernel must do, whichever form
    it takes. No metric reads it yet: the port has no kernel over a
    latent cache."""
    feeds = list(feeds)
    H, L = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    r, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    d_qk, d_v = attention_dims(cfg)
    rows = sum(a for _, a in feeds)
    tokens = sum(a - b for b, a in feeds)
    pairs = attention_pairs(feeds)
    nbytes = L * dtype_bytes * (rows * cache_elements(cfg)
                                + tokens * H * (d_qk + d_v))
    absorbed = 2 * H * (r + rope + r) * pairs
    expanded = (2 * r * H * (cfg["qk_nope_head_dim"] + d_v) * rows
                + pair_flops(cfg) * pairs)
    return float(nbytes), float(L * min(absorbed, expanded))


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
