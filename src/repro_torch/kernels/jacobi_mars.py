"""Chunked jacobi-1d with the irredundant inter-chunk carry: kernel + plain.

``jacobi_chunked`` launches the hand-written kernel of ``csrc/jacobi_mars.cu``
(which replaces the Pallas kernel ``repro/kernels/jacobi_mars.py::_kernel``)
on a CUDA tensor and runs the plain PyTorch version ``jacobi_chunked_plain``
on a CPU tensor.  A CUDA tensor never takes the plain version.  Launches are
counted in ``jacobi_chunked.launches``.

Both compute the *skewed* buffer: y[c*W + k] = cell c*W - T + k at time T,
where the region left of cell 0 is frozen at x[0] (the kernel's carry is
initialised to x[0]).  ``repro_torch.kernels.ops.jacobi1d_tiled`` pads and
unskews it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref


def _lib() -> ctypes.CDLL:
    lib = _build.load("jacobi_mars")
    lib.jacobi_chunked_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.jacobi_chunked_launch.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, t_steps: int, width: int) -> None:
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"jacobi_chunked wants float32 [n], got {x.dtype} "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    if n == 0 or n % width:
        raise ValueError(f"n={n} must be a positive multiple of width={width}")
    if not 0 <= t_steps < width - 2:
        raise ValueError(f"carry depth must fit one chunk: t_steps={t_steps}, "
                         f"width={width}")


def jacobi_chunked_plain(x: torch.Tensor, t_steps: int,
                         width: int = 512) -> torch.Tensor:
    """Plain version: 2T copies of x[0] prepended, then T 'valid' steps.

    The result has length n and equals the kernel's skewed buffer: output j
    is cell j - T, which sees the frozen x[0] ghost on the left and only
    real cells on the right.
    """
    _check(x, t_steps, width)
    v = torch.cat([x[:1].expand(2 * t_steps), x])
    return ref.jacobi_valid_steps(v, t_steps)


def jacobi_chunked(x: torch.Tensor, t_steps: int,
                   width: int = 512) -> torch.Tensor:
    """T jacobi steps over [n] f32 in W-wide chunks; the skewed buffer."""
    _check(x, t_steps, width)
    if x.device.type == "cpu":
        return jacobi_chunked_plain(x, t_steps, width)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _lib()
    err = lib.jacobi_chunked_launch(
        x.data_ptr(), y.data_ptr(), x.shape[0], t_steps, width, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "jacobi_mars.jacobi_chunked")
    jacobi_chunked.launches += 1
    return y


jacobi_chunked.launches = 0
