"""Whisper-tiny — encoder-decoder audio backbone [arXiv:2212.04356].

The conv/mel frontend is a STUB: ``input_specs()`` provides 1500 precomputed
frame embeddings (30 s at 50 Hz after the conv stride-2).  GELU MLP, full MHA
(n_kv_heads == n_heads), learned-position-free backbone (we use RoPE in this
framework's backbone; divergence noted in DESIGN.md — the backbone contract
is shapes + family, per the assignment).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, mlp_act="gelu",
    enc_layers=4, enc_seq=1500,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=256, mlp_act="gelu", enc_layers=2, enc_seq=64,
    )
