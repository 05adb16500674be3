"""Block codec in PyTorch: delta + bitplane packing (port of ``repro.core.blockcodec``).

Same functions, same shapes, same bits as the reference:

* values are grouped into fixed *blocks* (atomic, irredundant,
  independently decodable — the MARS analogue);
* within a block, deltas are taken along the minor axis, the first
  element raw (the paper's ``w0``);
* deltas are truncated to ``b`` two's-complement bits and bitplane-packed:
  a group of 32 words becomes ``b`` 32-bit planes, word i -> bit i;
* a per-block scale plays the role of the paper's §4.2.2 markers.

Integer arithmetic is done in int64 and wrapped to 32 bits explicitly, so
every result is defined and equal bit for bit to the reference's uint32 /
int32 wrap arithmetic (PyTorch has no shift, add or sum for ``uint32`` on
the CPU).  ``uint32`` appears only at the API edge, as a view of int32
storage.

These functions are the plain oracle of ``repro_torch.kernels.bitplane``.
``min_bitwidth`` and ``encode_varwidth`` are host-side numpy, copied from
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

GROUP = 32  # words per bitplane group (one 32-bit plane word per bit)

_U32 = 0xFFFFFFFF


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit pattern of an int32 / uint32 tensor as int64 in [0, 2^32)."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & _U32


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement wrap)."""
    return (((x + (1 << 31)) & _U32) - (1 << 31)).to(torch.int32)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> uint32 tensor of that pattern."""
    return _wrap_i32(x).view(torch.uint32)


def _f32_to_i32_sat(x: torch.Tensor) -> torch.Tensor:
    """float -> int32, truncating and saturating like XLA's convert."""
    return x.to(torch.int64).clamp(-(1 << 31), (1 << 31) - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# Bitplane transpose (static bitwidth b)
# ---------------------------------------------------------------------------

def bitplane_pack(v: torch.Tensor, b: int) -> torch.Tensor:
    """Pack int32 values (..., G, 32) into bitplanes (..., G, b) uint32.

    plane[..., g, j] holds bit j of the 32 words of group g (word i -> bit i).
    """
    assert 1 <= b <= 32
    u = _u32_bits(v)
    i = torch.arange(GROUP, dtype=torch.int64, device=v.device)
    planes = [(((u >> j) & 1) << i).sum(dim=-1) for j in range(b)]
    return _as_u32(torch.stack(planes, dim=-1))


def bitplane_unpack(planes: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of bitplane_pack; sign-extends from b bits to int32."""
    p = _u32_bits(planes)
    i = torch.arange(GROUP, dtype=torch.int64, device=planes.device)
    vals = torch.zeros(p.shape[:-1] + (GROUP,), dtype=torch.int64,
                       device=planes.device)
    for j in range(b):
        vals |= ((p[..., j, None] >> i) & 1) << j
    if b < 32:
        h = 1 << (b - 1)
        vals = (vals ^ h) - h
    return _wrap_i32(vals)


# ---------------------------------------------------------------------------
# Delta transform along the minor axis
# ---------------------------------------------------------------------------

def delta_encode(x: torch.Tensor) -> torch.Tensor:
    """x[..., k] -> x[..., k] - x[..., k-1]; x[..., 0] kept raw.

    int32 input wraps modulo 2^32, like the reference.
    """
    if x.dtype == torch.int32:
        x64 = x.to(torch.int64)
        return _wrap_i32(torch.cat([x64[..., :1], x64[..., 1:] - x64[..., :-1]],
                                   dim=-1))
    return torch.cat([x[..., :1], x[..., 1:] - x[..., :-1]], dim=-1)


def delta_decode(d: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the minor axis, in d's dtype (int32 wraps)."""
    if d.dtype == torch.int32:
        return _wrap_i32(torch.cumsum(d.to(torch.int64), dim=-1))
    return torch.cumsum(d, dim=-1, dtype=d.dtype)


# ---------------------------------------------------------------------------
# Fixed-width block compressor (gradient / activation path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockCodecConfig:
    bits: int = 8          # packed two's-complement width b
    block: int = 256       # values per block (multiple of GROUP)
    delta: bool = True     # apply delta transform before packing

    @property
    def ratio(self) -> float:
        return 32.0 / self.bits


def _reshape_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    assert x.numel() % block == 0, (tuple(x.shape), block)
    return x.reshape(-1, block)


def quantize(x: torch.Tensor, bits: int, block: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (int32 codes, per-block scale).  Symmetric, saturating."""
    xb = _reshape_blocks(x, block)
    maxval = xb.abs().amax(dim=-1, keepdim=True)
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.where(maxval > 0, maxval / qmax,
                        torch.ones_like(maxval)).to(torch.float32)
    q = _f32_to_i32_sat(torch.clamp(torch.round(xb / scale), -qmax, qmax))
    return q, scale[..., 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def compress(x: torch.Tensor, cfg: BlockCodecConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 array -> (packed planes uint32 [n_blocks, block/32, b], scales).

    With delta enabled, codes are clamped to the (b-1)-bit range before the
    delta so the deltas fit b bits exactly, as in the reference.
    """
    qbits = cfg.bits - 1 if cfg.delta else cfg.bits
    q, scale = quantize(x, qbits, cfg.block)
    if cfg.delta:
        q = delta_encode(q)
    g = q.reshape(q.shape[0], cfg.block // GROUP, GROUP)
    return bitplane_pack(g, cfg.bits), scale


def decompress(planes: torch.Tensor, scale: torch.Tensor,
               cfg: BlockCodecConfig) -> torch.Tensor:
    q = bitplane_unpack(planes, cfg.bits)
    q = q.reshape(q.shape[0], cfg.block)
    if cfg.delta:
        q = delta_decode(q)
    return dequantize(q, scale)


def compressed_bytes(n_values: int, cfg: BlockCodecConfig) -> int:
    """Wire size: planes + per-block scale (the markers analogue)."""
    n_blocks = n_values // cfg.block
    return n_blocks * (cfg.block // GROUP) * cfg.bits * 4 + n_blocks * 4


# ---------------------------------------------------------------------------
# Host-side variable-width variant (true data-dependent size, like the FPGA)
# ---------------------------------------------------------------------------

def min_bitwidth(q: np.ndarray) -> np.ndarray:
    """Per-block two's-complement width needed for int values [n, block]."""
    q = np.asarray(q, dtype=np.int64)
    mag = np.where(q >= 0, q, -q - 1)
    k = np.zeros_like(mag)
    nz = mag > 0
    k[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
    return np.maximum(k.max(axis=-1) + 1, 1)  # +1 sign bit


def encode_varwidth(x: np.ndarray, block: int = 256,
                    delta: bool = True) -> Tuple[int, np.ndarray]:
    """True compressed bit count with per-block minimal widths (host side).

    Returns (total_bits, per-block widths): the achievable (data-dependent)
    size, against which the static-b kernel is a conservative envelope.
    """
    xb = np.asarray(x).reshape(-1, block)
    if np.issubdtype(xb.dtype, np.floating):
        xb = xb.astype(np.float32).view(np.int32).astype(np.int64)
    d = np.concatenate([xb[:, :1], np.diff(xb, axis=1)], axis=1) if delta else xb
    widths = min_bitwidth(d)
    meta_bits = 8 + 32  # width byte + raw first word per block
    total = int(np.sum(widths * block) + len(widths) * meta_bits)
    return total, widths
