"""Hand-written CUDA kernels of the port, their plain versions and entry points.

Importing this package needs no GPU: kernels are compiled (``_build``) and
loaded at their first launch.
"""
from . import bitplane, jacobi_mars, ops, ref

__all__ = ["bitplane", "jacobi_mars", "ops", "ref"]
