"""Granite-8B (code) — llama-arch GQA [arXiv:2405.04324; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=256,
    )
