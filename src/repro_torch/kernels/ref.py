"""Plain PyTorch oracles for the port's kernels (port of ``repro.kernels.ref``).

Each function is the bit-exact (or tolerance-specified) reference the
kernels are held against: by the CPU tests against the JAX package, and by
``chip_smoke.py`` against the CUDA kernels on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import blockcodec as bc


# ---------------------------------------------------------------------------
# delta + bitplane pack / unpack (the paper's codec, block form)
# ---------------------------------------------------------------------------

def pack_ref(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 codes [N, block] -> packed planes uint32 [N, block//32 * bits].

    Delta along the minor axis (first element raw), truncate to ``bits``
    two's-complement bits, bitplane-transpose each 32-word group.
    """
    n, block = q.shape
    d = bc.delta_encode(q)
    g = d.reshape(n, block // bc.GROUP, bc.GROUP)
    planes = bc.bitplane_pack(g, bits)            # [N, G, bits]
    return planes.reshape(n, -1)


def unpack_ref(planes: torch.Tensor, bits: int, block: int) -> torch.Tensor:
    """Inverse of pack_ref -> int32 codes [N, block]."""
    n = planes.shape[0]
    g = planes.reshape(n, block // bc.GROUP, bits)
    d = bc.bitplane_unpack(g, bits).reshape(n, block)
    return bc.delta_decode(d)


# ---------------------------------------------------------------------------
# KV-cache block quantization (packed int8 / int4 + per-row scale markers)
# ---------------------------------------------------------------------------

def kv_quant_ref(x: torch.Tensor, bits: int = 8):
    """[rows, d] float -> (codes int8 [rows, d or d/2], scale f32 [rows, 1]).

    Symmetric per-row quantization, rounding half to even; int4 packs two
    codes per byte (lo nibble = even column) by pairing neighbouring
    columns.  Both divisions are by tensors on x's device, so on a GPU they
    are IEEE quotients (a host-scalar divisor would become a multiply by its
    reciprocal there; see ``jacobi_valid_steps``).
    """
    if bits not in (8, 4):
        raise ValueError(bits)
    x = x.to(torch.float32)
    qmax = torch.tensor(float(2 ** (bits - 1) - 1), dtype=torch.float32,
                        device=x.device)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    if bits == 8:
        return q.to(torch.int8), scale
    pairs = (q & 0xF).reshape(*q.shape[:-1], -1, 2)
    return (pairs[..., 0] | (pairs[..., 1] << 4)).to(torch.int8), scale


def kv_dequant_ref(codes: torch.Tensor, scale: torch.Tensor,
                   bits: int = 8) -> torch.Tensor:
    """Inverse of ``kv_quant_ref``: f32 ``codes * scale`` [rows, d]."""
    c = codes.to(torch.int32)
    if bits == 8:
        q = c
    elif bits == 4:
        def sext4(v):
            return ((v & 0xF) ^ 0x8) - 0x8
        q = torch.stack([sext4(c), sext4(c >> 4)], dim=-1).reshape(
            *c.shape[:-1], -1)
    else:
        raise ValueError(bits)
    return q.to(torch.float32) * scale


# ---------------------------------------------------------------------------
# Chunked jacobi-1d (read -> execute x T -> write macro-pipeline)
# ---------------------------------------------------------------------------

def jacobi_valid_steps(v: torch.Tensor, t_steps: int) -> torch.Tensor:
    """T 'valid' 3-point steps, (a + b + c) / 3 in that order; shrinks by 2T.

    The divisor is a 0-dim tensor on v's device, not a Python float: on a
    GPU, PyTorch divides by a host scalar as a multiply by its reciprocal,
    which is not the IEEE quotient, and the error builds up over T steps.
    """
    three = torch.tensor(3.0, dtype=torch.float32, device=v.device)
    for _ in range(t_steps):
        v = (v[:-2] + v[1:-1] + v[2:]) / three
    return v


def jacobi_chunked_ref(x: torch.Tensor, t_steps: int) -> torch.Tensor:
    """T jacobi steps on the edge-padded infinite extension of x.

    The input is extended left and right with its edge values *at time 0*,
    then evolved T steps; the n interior cells are returned.  (Influence
    distance is exactly T cells, so padding by T is exact.)
    """
    v = x.to(torch.float32)
    v = torch.cat([v[:1].expand(t_steps), v, v[-1:].expand(t_steps)])
    return jacobi_valid_steps(v, t_steps)
