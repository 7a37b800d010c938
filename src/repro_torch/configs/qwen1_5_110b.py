"""qwen1.5-110b — dense GQA transformer with QKV bias
[hf:Qwen/Qwen1.5-110B]; mirrors ``src/repro/configs/qwen1_5_110b.py``.
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064. SwiGLU, untied
embeddings, rope theta 1e6.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="qwen1_5_110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=49152, vocab=152_064,
        qkv_bias=True, act="swiglu", tie_embeddings=False,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="qwen1_5_110b_smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=160, vocab=512,
        qkv_bias=True, act="swiglu", tie_embeddings=False,
    )
