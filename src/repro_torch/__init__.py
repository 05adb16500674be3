"""PyTorch / CUDA port of the reproduction (reference: the JAX package ``repro``).

Laid out module for module like ``repro``; ported so far is the paper's
device pipeline: the delta + bitplane block codec (``core.blockcodec``) and
the chunked-stencil macro-pipeline with its on-chip MARS carry, behind
``kernels.ops`` (``pack_codes``, ``unpack_codes``, ``jacobi1d_tiled``), with
hand-written CUDA kernels for Hopper (sm_90a) in ``kernels/csrc``.

The package imports ``torch`` and numpy, never ``jax`` or ``repro``.  It
imports without a GPU; kernels are built with ``nvcc`` at first launch.
``python3 chip_smoke.py`` at the repository root drives it on a card.
"""
from . import convert, core, kernels, obs

__all__ = ["convert", "core", "kernels", "obs"]
