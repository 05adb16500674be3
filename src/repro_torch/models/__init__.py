"""Model layers, the decoder-only frame and the model API (serving and training).

Ported so far: the decoder-only frame (``transformer``) of the dense, vlm,
moe, ssm and hybrid families, their layers (``layers``), the MoE block
(``moe``), the SSD mixer (``ssm``) and ``model_zoo.get_api``.
"""
from . import layers, model_zoo, moe, ssm, transformer

__all__ = ["layers", "model_zoo", "moe", "ssm", "transformer"]
