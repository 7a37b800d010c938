"""codeqwen1.5-7b — qwen1.5 architecture sized for code
[hf:Qwen/CodeQwen1.5-7B]; mirrors ``src/repro/configs/codeqwen1_5_7b.py``.
32L d_model=4096 32H (kv=32: full MHA KV per the assignment) d_ff=13440
vocab=92416. QKV bias, SwiGLU, rope theta 1e6.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="codeqwen1_5_7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
        d_ff=13440, vocab=92_416,
        qkv_bias=True, act="swiglu", tie_embeddings=False,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="codeqwen1_5_7b_smoke", family="dense",
        n_layers=3, d_model=48, n_heads=3, n_kv_heads=3, d_head=16,
        d_ff=144, vocab=512,
        qkv_bias=True, act="swiglu", tie_embeddings=False,
    )
