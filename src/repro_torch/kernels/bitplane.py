"""Delta + bitplane pack / unpack: CUDA kernels and their plain versions.

``pack`` / ``unpack`` launch the hand-written kernels of ``csrc/bitplane.cu``
(which replace the Pallas kernels ``repro/kernels/bitplane.py::_pack_kernel``
and ``::_unpack_kernel``) on a CUDA tensor, and run the plain PyTorch
versions ``pack_plain`` / ``unpack_plain`` on a CPU tensor.  A CUDA tensor
never takes the plain version: the kernel runs or the call raises.

Each wrapper counts its kernel launches in ``pack.launches`` /
``unpack.launches``; the plain versions count nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.blockcodec import GROUP

from . import _build, ref

#: plain PyTorch versions: the same function, used on the CPU and as the
#: oracle the kernels are held against on the card
pack_plain = ref.pack_ref
unpack_plain = ref.unpack_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("bitplane")
    for fn in (lib.bitplane_pack_launch, lib.bitplane_unpack_launch):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check_args(bits: int, block: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in 1..32, got {bits}")
    if block <= 0 or block % GROUP:
        raise ValueError(f"block must be a positive multiple of {GROUP}, "
                         f"got {block}")


def _device_ok(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for others."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 codes [N, block] -> uint32 planes [N, block//32*bits]."""
    if q.dim() != 2 or q.dtype != torch.int32:
        raise ValueError(f"pack wants int32 [N, block], got {q.dtype} "
                         f"{tuple(q.shape)}")
    n, block = q.shape
    _check_args(bits, block)
    if not _device_ok(q):
        return pack_plain(q, bits)
    q = q.contiguous()
    out = torch.empty((n, block // GROUP * bits), dtype=torch.int32,
                      device=q.device)
    if n:
        lib = _lib()
        err = lib.bitplane_pack_launch(
            q.data_ptr(), out.data_ptr(), n, block, bits, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, err, "bitplane.pack")
        pack.launches += 1
    return out.view(torch.uint32)


def unpack(planes: torch.Tensor, bits: int, block: int) -> torch.Tensor:
    """uint32 (or int32-viewed) planes [N, block//32*bits] -> int32 [N, block]."""
    _check_args(bits, block)
    if (planes.dim() != 2 or planes.dtype not in (torch.uint32, torch.int32)
            or planes.shape[1] != block // GROUP * bits):
        raise ValueError(f"unpack wants uint32 [N, {block // GROUP * bits}], "
                         f"got {planes.dtype} {tuple(planes.shape)}")
    if not _device_ok(planes):
        return unpack_plain(planes, bits, block)
    p = planes.contiguous()
    if p.dtype == torch.uint32:
        p = p.view(torch.int32)
    n = p.shape[0]
    out = torch.empty((n, block), dtype=torch.int32, device=p.device)
    if n:
        lib = _lib()
        err = lib.bitplane_unpack_launch(
            p.data_ptr(), out.data_ptr(), n, block, bits, p.device.index,
            torch.cuda.current_stream(p.device).cuda_stream)
        _build.check(lib, err, "bitplane.unpack")
        unpack.launches += 1
    return out


pack.launches = 0
unpack.launches = 0
