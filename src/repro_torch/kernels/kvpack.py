"""Packed KV-cache rows (int8 / int4 + per-row scale): kernels and plain.

``kv_quant`` / ``kv_dequant`` launch the hand-written kernels of
``csrc/kvpack.cu`` (which replace the Pallas kernels
``repro/kernels/kvpack.py::_quant_kernel`` and ``::_dequant_kernel``) on a
CUDA tensor, and run the plain PyTorch versions ``kv_quant_plain`` /
``kv_dequant_plain`` on a CPU tensor.  A CUDA tensor never takes the plain
version: the kernel runs or the call raises.  Kernel and plain version
compute the same function bit for bit.

Each wrapper counts its kernel launches in ``kv_quant.launches`` /
``kv_dequant.launches``; the plain versions count nothing.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

#: plain PyTorch versions: the same function, used on the CPU and as the
#: oracle the kernels are held against on the card
kv_quant_plain = ref.kv_quant_ref
kv_dequant_plain = ref.kv_dequant_ref

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = _build.load("kvpack")
    lib.kv_quant_launch.argtypes = [_P, _I, _P, _P, _I64, _I, _I, _I, _P]
    lib.kv_dequant_launch.argtypes = [_P, _P, _P, _I64, _I, _I, _I, _P]
    lib.kv_quant_launch.restype = _I
    lib.kv_dequant_launch.restype = _I
    return lib


def _check_bits(bits: int) -> None:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for others."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (the kernels load column pairs)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kv_quant(x: torch.Tensor, bits: int = 8):
    """[rows, d] f32/bf16 -> (codes int8 [rows, d or d/2], scales f32 [rows, 1])."""
    _check_bits(bits)
    if (x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16)
            or x.shape[1] == 0 or x.shape[1] % 2):
        raise ValueError(f"kv_quant wants f32/bf16 [rows, even d], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not _on_cuda(x):
        return kv_quant_plain(x, bits)
    x = _aligned(x)
    rows, d = x.shape
    codes = torch.empty((rows, d if bits == 8 else d // 2), dtype=torch.int8,
                        device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows:
        lib = _lib()
        err = lib.kv_quant_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            scales.data_ptr(), rows, d, bits, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "kvpack.kv_quant")
        kv_quant.launches += 1
    return codes, scales


def kv_dequant(codes: torch.Tensor, scales: torch.Tensor,
               bits: int = 8) -> torch.Tensor:
    """(codes int8 [rows, cd], scales f32 [rows, 1]) -> f32 [rows, d]."""
    _check_bits(bits)
    if (codes.dim() != 2 or codes.dtype != torch.int8 or codes.shape[1] == 0
            or (bits == 8 and codes.shape[1] % 2)):
        raise ValueError(f"kv_dequant wants int8 [rows, cd], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    rows, cd = codes.shape
    if scales.dtype != torch.float32 or scales.shape != (rows, 1):
        raise ValueError(f"kv_dequant wants f32 scales [{rows}, 1], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if not _on_cuda(codes):
        return kv_dequant_plain(codes, scales, bits)
    if scales.device != codes.device:
        raise ValueError(f"codes on {codes.device}, scales on {scales.device}")
    codes, scales = _aligned(codes), scales.contiguous()
    d = cd if bits == 8 else 2 * cd
    out = torch.empty((rows, d), dtype=torch.float32, device=codes.device)
    if rows:
        lib = _lib()
        err = lib.kv_dequant_launch(
            codes.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, d, bits,
            codes.device.index, torch.cuda.current_stream(codes.device).cuda_stream)
        _build.check(lib, err, "kvpack.kv_dequant")
        kv_dequant.launches += 1
    return out


kv_quant.launches = 0
kv_dequant.launches = 0
