"""TinyLlama 1.1B — llama2-arch small [arXiv:2401.02385; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=256,
    )
