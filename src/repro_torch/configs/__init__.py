"""Model and run configurations (the port's copies of ``repro.configs``).

``base`` holds ``ModelConfig``, ``RunConfig``, ``SHAPES``, ``ARCH_IDS`` and
the loaders; each ``<id>.py`` holds one architecture's published
``CONFIG`` and its reduced ``smoke()`` config.
"""
from .base import (ARCH_IDS, SHAPES, ModelConfig, RunConfig, load_arch,
                   load_smoke, run_config_for)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "RunConfig", "load_arch",
           "load_smoke", "run_config_for"]
