"""Checkpointing of the port (``ckpt``), in the reference's on-disk layout."""
from . import ckpt

__all__ = ["ckpt"]
