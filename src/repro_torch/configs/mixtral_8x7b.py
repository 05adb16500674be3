"""Mixtral 8x7B — MoE 8 experts top-2, sliding-window attn [arXiv:2401.04088]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, n_experts=8, topk=2,
    sliding_window=4096, rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=256, n_experts=4, topk=2, sliding_window=64,
    )
