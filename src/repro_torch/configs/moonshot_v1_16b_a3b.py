"""moonshot-v1-16b-a3b — Moonlight-style fine-grained MoE
[hf:moonshotai/Moonlight-16B-A3B]; mirrors
``src/repro/configs/moonshot_v1_16b_a3b.py``.
48L d_model=2048 16H (kv=16) d_ff=1408 (per expert) vocab=163840; 64
experts, top-6, +2 shared experts. All layers MoE.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="moonshot_v1_16b_a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab=163_840,
        layer_pattern="M", n_experts=64, top_k=6, n_shared_experts=2,
        act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="moonshot_v1_16b_a3b_smoke", family="moe",
        n_layers=3, d_model=48, n_heads=3, n_kv_heads=3, d_head=16,
        d_ff=32, vocab=512,
        layer_pattern="M", n_experts=8, top_k=2, n_shared_experts=1,
        act="swiglu",
    )
