"""Optimizers of the port: AdamW (``adamw``)."""
from . import adamw

__all__ = ["adamw"]
