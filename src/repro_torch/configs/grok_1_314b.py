"""Grok-1 314B — MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, n_experts=8, topk=2, head_dim=128,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="grok-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=256, n_experts=4, topk=2,
    )
