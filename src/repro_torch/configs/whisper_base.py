"""whisper-base — encoder-decoder ASR backbone [arXiv:2212.04356]; mirrors
``src/repro/configs/whisper_base.py``.
6L encoder + 6L decoder, d_model=512 8H (MHA kv=8) d_ff=2048 vocab=51865.
LayerNorm + GELU (original whisper), learned decoder positions. The conv
audio frontend is a stub: callers pass precomputed frame embeddings
(B, 1500, 512) — the output length of whisper's stride-2 conv stem on
30 s of audio. Whisper's realistic decoder length is 448.
"""
from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="whisper_base", family="encdec",
        n_layers=6, n_encoder_layers=6,
        d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
        d_ff=2048, vocab=51_865,
        norm="layernorm", act="gelu", tie_embeddings=True,
        frontend="audio_frames", frontend_len=1500,
        max_seq_len=32_768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="whisper_base_smoke", family="encdec",
        n_layers=2, n_encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=512,
        norm="layernorm", act="gelu", tie_embeddings=True,
        frontend="audio_frames", frontend_len=12,
        max_seq_len=128,
    )
