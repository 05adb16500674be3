"""Hymba-1.5B — hybrid parallel attention + mamba heads [arXiv:2411.13676].

Each layer runs GQA attention and an SSM mixer in parallel on the same input
and averages the branch outputs after per-branch normalization.  Most layers
use sliding-window attention in the published model; we use a uniform 1024
window (global-attn exception layers and meta-tokens are noted as
simplifications in DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    ssm_state=16, ssm_expand=2, ssm_head=64, ssm_chunk=256,
    sliding_window=1024,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=256, head_dim=32,
        ssm_state=16, ssm_expand=2, ssm_head=32, ssm_chunk=32,
        sliding_window=64,
    )
