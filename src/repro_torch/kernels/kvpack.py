"""Packed KV-cache rows (int8 / int4 + per-row scale): kernels and plain.

``kv_quant`` / ``kv_dequant`` launch the hand-written kernels of
``csrc/kvpack.cu`` (which replace the Pallas kernels
``repro/kernels/kvpack.py::_quant_kernel`` and ``::_dequant_kernel``) on a
CUDA tensor, and run the plain PyTorch versions ``kv_quant_plain`` /
``kv_dequant_plain`` on a CPU tensor.  ``kv_quant_store`` is the packed
cache's write of one decode step: the same row quantization fused with the
store into the cache slot, one launch for the K and V rows of a layer.  A
CUDA tensor never takes the plain version: the kernel runs or the call
raises.  Kernel and plain version compute the same function bit for bit.

Each wrapper counts its kernel launches in ``kv_quant.launches``,
``kv_dequant.launches`` and ``kv_quant_store.launches``; the plain versions
count nothing.
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
    lib.kv_quant_store_launch.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _P]
    lib.kv_quant_launch.restype = _I
    lib.kv_dequant_launch.restype = _I
    lib.kv_quant_store_launch.restype = _I
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


def kv_quant_store_plain(cache_k: torch.Tensor, cache_v: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         slot: torch.Tensor, bits: int) -> None:
    """Plain ``kv_quant_store``: ``kv_quant_plain`` on the K and on the V
    rows, then four indexed writes at [b, clamp(slot[b], 0, S - 1)]."""
    B, _, KV, D = k_new.shape
    b = torch.arange(B, device=slot.device)
    s = torch.clamp(slot, 0, cache_k.shape[1] - 1)
    for codes, scales, new in ((cache_k, k_scale, k_new), (cache_v, v_scale, v_new)):
        q, sc = kv_quant_plain(new.reshape(B * KV, D), bits)
        codes[b, s] = q.reshape(B, KV, -1)
        scales[b, s] = sc.reshape(B, KV, 1)


def _check_store(cache_k, cache_v, k_scale, v_scale, k_new, v_new, slot,
                 bits) -> None:
    _check_bits(bits)
    if (k_new.dtype not in (torch.float32, torch.bfloat16)
            or v_new.dtype != k_new.dtype or k_new.dim() != 4
            or k_new.shape[1] != 1 or v_new.shape != k_new.shape
            or 0 in k_new.shape or k_new.shape[3] % 2):
        raise ValueError(f"kv_quant_store wants f32/bf16 k_new, v_new (B, 1, KV, "
                         f"even D), got {k_new.dtype} {tuple(k_new.shape)}, "
                         f"{v_new.dtype} {tuple(v_new.shape)}")
    B, _, KV, D = k_new.shape
    S = cache_k.shape[1] if cache_k.dim() == 4 else 0
    cd = D if bits == 8 else D // 2
    for name, t, dtype, shape in (
            ("cache_k", cache_k, torch.int8, (B, S, KV, cd)),
            ("cache_v", cache_v, torch.int8, (B, S, KV, cd)),
            ("k_scale", k_scale, torch.float32, (B, S, KV, 1)),
            ("v_scale", v_scale, torch.float32, (B, S, KV, 1))):
        if t.dtype != dtype or tuple(t.shape) != shape or S == 0:
            raise ValueError(f"kv_quant_store wants {name} {dtype} {shape} with "
                             f"S > 0, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"kv_quant_store writes {name} in place: it must "
                             f"be contiguous")
    if slot.dtype != torch.int32 or tuple(slot.shape) != (B,):
        raise ValueError(f"kv_quant_store wants int32 slot ({B},), got "
                         f"{slot.dtype} {tuple(slot.shape)}")
    devices = {t.device for t in (cache_k, cache_v, k_scale, v_scale, k_new,
                                  v_new, slot)}
    if len(devices) != 1:
        raise ValueError(f"kv_quant_store got tensors on {sorted(map(str, devices))}")


def kv_quant_store(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   slot: torch.Tensor, bits: int = 8) -> None:
    """Quantize the new rows k_new, v_new (B, 1, KV, D) f32/bf16 and write
    codes and scales in place at [b, clamp(slot[b], 0, S - 1)] of the packed
    cache: cache_k, cache_v int8 (B, S, KV, D or D/2), k_scale, v_scale f32
    (B, S, KV, 1), all contiguous; slot (B,) int32."""
    _check_store(cache_k, cache_v, k_scale, v_scale, k_new, v_new, slot, bits)
    if not _on_cuda(k_new):
        return kv_quant_store_plain(cache_k, cache_v, k_scale, v_scale, k_new,
                                    v_new, slot, bits)
    if cache_k.data_ptr() % 2 or cache_v.data_ptr() % 2:
        raise ValueError("kv_quant_store: the int8 caches must start on a "
                         "2-byte boundary (the kernel stores code pairs)")
    B, _, KV, D = k_new.shape
    slot = slot.contiguous()
    k_new, v_new = _aligned(k_new), _aligned(v_new)
    lib = _lib()
    err = lib.kv_quant_store_launch(
        k_new.data_ptr(), v_new.data_ptr(), int(k_new.dtype == torch.bfloat16),
        slot.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), B, cache_k.shape[1], KV, D, bits,
        k_new.device.index, torch.cuda.current_stream(k_new.device).cuda_stream)
    _build.check(lib, err, "kvpack.kv_quant_store")
    kv_quant_store.launches += 1


kv_quant.launches = 0
kv_dequant.launches = 0
kv_quant_store.launches = 0
