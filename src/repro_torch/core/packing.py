"""Padding-vs-packing accounting (paper §2.4, Fig. 5 / Fig. 11).

The PyTorch port's own copy of ``repro.core.packing`` (host numpy; the port
imports nothing of ``repro``), numerically identical to it.

Custom-bitwidth words (e.g. 17-bit) must normally be padded to the bus
alignment for random access; contiguous MARS accesses allow *packing* them
back to back at the bit level.  These helpers compute the exact transferred
bit counts for both conventions, and the two compression ratios reported in
Fig. 11:

* ``true ratio``      = nbits * count / compressed_bits  (savings from the
  codec alone),
* ``ratio with padding`` = padded_bits * count / compressed_bits  (what the
  accelerator actually saves, because the uncompressed baseline must pad).
"""
from __future__ import annotations

import dataclasses

from .compression import DATA_TYPES


def padded_width(nbits: int) -> int:
    """Aligned storage width for an nbits word on a byte-addressable bus."""
    for w in (8, 16, 32, 64, 128):
        if nbits <= w:
            return w
    raise ValueError(f"unsupported width {nbits}")


def padded_bits(count: int, nbits: int) -> int:
    return count * padded_width(nbits)


def packed_bits(count: int, nbits: int) -> int:
    return count * nbits


@dataclasses.dataclass(frozen=True)
class Ratios:
    true_ratio: float
    ratio_with_padding: float


def compression_ratios(count: int, nbits: int, compressed_bits: int) -> Ratios:
    if compressed_bits <= 0:
        raise ValueError("empty stream")
    return Ratios(
        true_ratio=packed_bits(count, nbits) / compressed_bits,
        ratio_with_padding=padded_bits(count, nbits) / compressed_bits,
    )


def dtype_widths(dtype: str) -> tuple[int, int]:
    """(nbits, padded bits) for a paper data-type name."""
    nbits, padded = DATA_TYPES[dtype]
    return nbits, padded
