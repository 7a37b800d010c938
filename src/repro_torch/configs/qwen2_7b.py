"""qwen2-7b — dense GQA with QKV bias [arXiv:2407.10671]; mirrors
``src/repro/configs/qwen2_7b.py``.
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. SwiGLU,
rope theta 1e6.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="qwen2_7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
        d_ff=18944, vocab=152_064,
        qkv_bias=True, act="swiglu", tie_embeddings=False,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="qwen2_7b_smoke", family="dense",
        n_layers=3, d_model=56, n_heads=7, n_kv_heads=1, d_head=8,
        d_ff=112, vocab=512,
        qkv_bias=True, act="swiglu", tie_embeddings=False,
    )
