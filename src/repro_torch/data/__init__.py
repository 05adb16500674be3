"""Data pipelines of the port: the synthetic token stream (``pipeline``)."""
from . import pipeline

__all__ = ["pipeline"]
