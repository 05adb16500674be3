"""Plain PyTorch oracles for the port's kernels (port of ``repro.kernels.ref``).

Each function is the bit-exact (or tolerance-specified) reference the
kernels are held against: by the CPU tests against the JAX package, and by
``chip_smoke.py`` against the CUDA kernels on the card.  The KV-cache
oracles come with the KV kernels.
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
