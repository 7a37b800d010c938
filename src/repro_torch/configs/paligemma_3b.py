"""paligemma-3b — SigLIP vision encoder + gemma decoder [arXiv:2407.07726];
mirrors ``src/repro/configs/paligemma_3b.py``.
18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216. The SigLIP
frontend is a stub: callers pass 256 precomputed patch embeddings (dim
1152, SigLIP So400m output), projected and prepended as a bidirectional
prefix (PaliGemma's prefix-LM attention).
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="paligemma_3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
        d_ff=16384, vocab=257_216,
        act="geglu", embed_scale=True,
        frontend="patch_embed", frontend_len=256, frontend_dim=1152,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="paligemma_3b_smoke", family="vlm",
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, d_head=32,
        d_ff=128, vocab=512,
        act="geglu", embed_scale=True,
        frontend="patch_embed", frontend_len=8, frontend_dim=24,
    )
