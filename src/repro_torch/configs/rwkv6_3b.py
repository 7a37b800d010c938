"""rwkv6-3b — Finch: attention-free, data-dependent per-channel decay
[arXiv:2404.05892]; mirrors ``src/repro/configs/rwkv6_3b.py``.
32L d_model=2560 d_ff=8960 vocab=65536. Time-mix (chunked linear attention
with LoRA-modulated decay) + channel-mix with squared-ReLU; 16 heads x 160
head dim.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="rwkv6_3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=16, n_kv_heads=16, d_head=160,
        d_ff=8960, vocab=65_536,
        layer_pattern="W", act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="rwkv6_3b_smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=160, vocab=512,
        layer_pattern="W", act="gelu",
    )
