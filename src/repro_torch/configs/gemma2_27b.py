"""gemma2-27b — local+global alternating attention with logit softcaps
[arXiv:2408.00118]; mirrors ``src/repro/configs/gemma2_27b.py``.
46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000. Window 4096 on
local layers; attn softcap 50, final softcap 30; sandwich (post) norms;
geglu; embed scaling; head_dim 128.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="gemma2_27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
        d_ff=36864, vocab=256_000,
        layer_pattern="LG", window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norms=True, act="geglu", embed_scale=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="gemma2_27b_smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512,
        layer_pattern="LG", window=8,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norms=True, act="geglu", embed_scale=True,
    )
