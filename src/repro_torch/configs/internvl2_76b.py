"""InternVL2-76B backbone (InternLM2-style decoder) [arXiv:2404.16821].

The InternViT frontend is a STUB per the assignment: ``input_specs()``
provides 256 precomputed patch-embedding tokens prepended to the text.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, n_vis_tokens=256,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=256, n_vis_tokens=8,
    )
