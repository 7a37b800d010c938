"""recurrentgemma-9b — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427]; mirrors ``src/repro/configs/recurrentgemma_9b.py``.
38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Pattern "RRL": two Griffin recurrent blocks then one local-attention block
(window 2048); 38 = 12*3 + "RR" tail. Gemma-style: geglu, embed scaling,
head_dim 256.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="recurrentgemma_9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
        d_ff=12288, vocab=256_000,
        layer_pattern="RRL", window=2048, rnn_width=4096, conv_width=4,
        act="geglu", embed_scale=True, rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="recurrentgemma_9b_smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, d_head=32,
        d_ff=128, vocab=512,
        layer_pattern="RRL", window=16, rnn_width=64, conv_width=4,
        act="geglu", embed_scale=True,
    )
