"""Serving: the lockstep, teacher-forced generation engine (``engine``)."""
from .engine import ServeEngine

__all__ = ["ServeEngine"]
