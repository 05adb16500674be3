"""Mamba2-130M — SSD state-space duality, attention-free [arXiv:2405.21060]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, ssm_state=128, ssm_expand=2, ssm_head=64,
    ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256, ssm_state=16, ssm_expand=2, ssm_head=32,
        ssm_conv=4, ssm_chunk=32,
    )
