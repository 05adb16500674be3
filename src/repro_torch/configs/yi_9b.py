"""Yi-9B — llama-arch GQA [arXiv:2403.04652; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=256,
    )
