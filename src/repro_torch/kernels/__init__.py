"""Hand-written CUDA kernels of the port, their plain versions and entry points.

Importing this package needs no GPU: kernels are compiled (``_build``) and
loaded at their first launch.
"""
from . import bitplane, flash_attention, jacobi_mars, kvpack, ops, ref

__all__ = ["bitplane", "flash_attention", "jacobi_mars", "kvpack", "ops", "ref"]
