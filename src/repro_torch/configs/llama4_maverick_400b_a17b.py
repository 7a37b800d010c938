"""llama4-maverick-400b-a17b — interleaved dense/MoE with top-1 routing +
shared expert [hf:meta-llama/Llama-4-Maverick]; mirrors
``src/repro/configs/llama4_maverick_400b_a17b.py``.
48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048;
128 experts top-1 + 1 shared expert on alternating layers ("GM" pattern);
dense layers use d_ff=16384. Text-only backbone.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="llama4_maverick_400b_a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=8192, vocab=202_048,
        layer_pattern="GM", dense_d_ff=16384,
        n_experts=128, top_k=1, n_shared_experts=1,
        act="swiglu", rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="llama4_maverick_400b_a17b_smoke", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=96, vocab=512,
        layer_pattern="GM", dense_d_ff=192,
        n_experts=8, top_k=1, n_shared_experts=1,
        act="swiglu",
    )
