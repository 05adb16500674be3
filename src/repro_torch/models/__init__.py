"""Model layers, the decoder-only frame and the model API (serving and training).

Ported so far: the dense and vlm families (``transformer``), their layers
(``layers``) and ``model_zoo.get_api``.
"""
from . import layers, model_zoo, transformer

__all__ = ["layers", "model_zoo", "transformer"]
