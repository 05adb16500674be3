"""Core of the PyTorch port: the block codec.

The reference's MARS, layout, transfer and executor modules are host numpy
and are not ported yet.
"""
from . import blockcodec
from .blockcodec import BlockCodecConfig

__all__ = ["BlockCodecConfig", "blockcodec"]
