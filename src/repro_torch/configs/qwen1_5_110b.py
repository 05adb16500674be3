"""Qwen1.5-110B — dense GQA with QKV bias [hf:Qwen/Qwen1.5-110B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064, qkv_bias=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=384, vocab=256, qkv_bias=True,
    )
