"""Faithful runtime differential compression (paper §2.5) + markers (§4.2.2).

The PyTorch port's own copy of ``repro.core.compression`` (host numpy; the port
imports nothing of ``repro``), numerically identical to it.

Encodes a sequence of N-bit words ``w0 w1 ... wn``:

* ``w0`` raw (N bits);
* for each subsequent word, ``d = w_i - w_{i-1}`` (two's complement, N bits),
  ``k`` = number of significant bits of ``d`` — ``k = bitlen(d)`` when
  ``d >= 0`` and ``k = bitlen(-d - 1)`` when ``d < 0`` (count after stripping
  leading zeros / leading ones respectively).  Emit a length field ``k`` in
  ``F = floor(1 + log2(N))`` bits, the sign bit, then the ``k - 1`` low bits
  of ``d`` (the top significant bit is implicit: 1 for positives, 0 for
  negatives).  ``d = 0`` costs F + 1 bits; ``d = -1`` likewise (k = 0).

Decoding: ``d = 2^(k-1) + low`` (sign 0, k > 0), ``d = low - 2^k`` (sign 1),
``d = 0`` / ``-1`` for k = 0.

This is a bit-exact software model of the paper's FPGA compressor (II = 1
pipelined there; here, a host-side reference).  ``CompressedStream`` also
maintains the *markers* of §4.2.2: for each MARS boundary a coarse position
(aligned bus words) + fine position (bit within the word), allowing a
consumer to seek to and decode exactly one MARS — the delta chain restarts at
every MARS so blocks stay atomic.

Floating-point data is compressed on its raw bit pattern (neighbouring values
share exponent/high-mantissa bits), exactly as the paper's hardware would.

Two implementations of the same bit format live here:

* the **fast path** (``BitWriter``/``BitReader`` + ``compress_words`` /
  ``decompress_words``): chunked uint64 word buffers and vectorized numpy
  delta/length/bit-packing — O(n) in stream length, no Python bignum;
* the **reference path** (``ReferenceBitWriter``/``ReferenceBitReader`` +
  ``compress_words_ref``/``decompress_words_ref``): the original per-word,
  single-bignum model, kept as the equivalence oracle — property tests and
  the parity tests assert the two produce bit-identical streams.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.obs import instrument as obs

_M64 = (1 << 64) - 1
_U64 = np.uint64


def length_field_bits(nbits: int) -> int:
    return int(math.floor(1 + math.log2(nbits)))


# ---------------------------------------------------------------------------
# Bit-level reader / writer (fast path: chunked uint64 buffers, no bignum)
# ---------------------------------------------------------------------------

class BitWriter:
    """Append-only bit stream held as 64-bit chunks (LSB-first bit order)."""

    __slots__ = ("_chunks", "_nbits")

    def __init__(self) -> None:
        self._chunks = np.zeros(16, dtype=np.uint64)
        self._nbits = 0

    def _reserve(self, nbits: int) -> None:
        need = (self._nbits + nbits) // 64 + 2
        if need > len(self._chunks):
            grown = np.zeros(max(need, 2 * len(self._chunks)), dtype=np.uint64)
            grown[: len(self._chunks)] = self._chunks
            self._chunks = grown

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._reserve(nbits)
        v = int(value) & ((1 << nbits) - 1)
        w, off = divmod(self._nbits, 64)
        self._chunks[w] |= _U64((v << off) & _M64)
        if off + nbits > 64:
            self._chunks[w + 1] = _U64(v >> (64 - off))
        self._nbits += nbits

    def write_many(self, values: np.ndarray, widths: np.ndarray) -> None:
        """Pack many variable-width fields (each <= 64 bits) at once.

        Fields land at consecutive bit offsets; a field spans at most two
        64-bit chunks, so the whole batch is two masked scatters.
        """
        values = np.asarray(values, dtype=np.uint64)
        widths = np.asarray(widths, dtype=np.int64)
        total = int(widths.sum())
        if total == 0:
            return
        self._reserve(total)
        offs = self._nbits + np.concatenate(
            ([0], np.cumsum(widths[:-1], dtype=np.int64)))
        w = offs >> 6
        sh = (offs & 63).astype(np.uint64)
        width_u = widths.astype(np.uint64)
        mask = np.where(widths >= 64, _U64(_M64),
                        (_U64(1) << (width_u & _U64(63))) - _U64(1))
        v = values & mask
        lo = v << sh
        hi = np.where(sh > 0, v >> ((_U64(64) - sh) & _U64(63)), _U64(0))
        np.bitwise_or.at(self._chunks, w, lo)
        np.bitwise_or.at(self._chunks, w + 1, hi)
        self._nbits += total

    @property
    def bit_length(self) -> int:
        return self._nbits

    def to_words(self, word_bits: int = 32) -> np.ndarray:
        n_words = (self._nbits + word_bits - 1) // word_bits
        used = (self._nbits + 63) // 64
        chunks = self._chunks[:used]
        if word_bits == 64:
            return chunks[:n_words].copy()
        if 64 % word_bits == 0:
            per = 64 // word_bits
            shifts = (np.arange(per, dtype=np.uint64) * _U64(word_bits))
            mask = _U64((1 << word_bits) - 1)
            split = (chunks[:, None] >> shifts[None, :]) & mask
            return split.reshape(-1)[:n_words].copy()
        reader = BitReader(chunks, self._nbits, 64)
        out = np.zeros(n_words, dtype=np.uint64)
        for k in range(n_words):
            out[k] = reader.read(min(word_bits, self._nbits - k * word_bits))
        return out


def _repack_chunks(words: np.ndarray, total_bits: int,
                   word_bits: int) -> List[int]:
    """word_bits-wide words -> list of 64-bit Python-int chunks (+1 pad)."""
    n_chunks = (total_bits + 63) // 64
    if word_bits == 64:
        out = [int(w) for w in np.asarray(words, dtype=np.uint64)[:n_chunks]]
    elif 64 % word_bits == 0:
        per = 64 // word_bits
        arr = np.asarray(words, dtype=np.uint64)
        mask = _U64((1 << word_bits) - 1)
        pad = (-len(arr)) % per
        if pad:
            arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint64)])
        arr = (arr & mask).reshape(-1, per)
        shifts = (np.arange(per, dtype=np.uint64) * _U64(word_bits))
        merged = np.bitwise_or.reduce(arr << shifts[None, :], axis=1)
        out = [int(c) for c in merged[:n_chunks]]
    else:
        out, cur, fill = [], 0, 0
        mask = (1 << word_bits) - 1
        for w in words:
            cur |= (int(w) & mask) << fill
            fill += word_bits
            while fill >= 64:
                out.append(cur & _M64)
                cur >>= 64
                fill -= 64
        if fill:
            out.append(cur & _M64)
        out = out[:n_chunks]
    out.extend([0] * (n_chunks + 2 - len(out)))
    return out


class BitReader:
    """Bit stream reader over 64-bit chunks (no bignum accumulator)."""

    __slots__ = ("_chunks", "_pos", "_len")

    def __init__(self, words: np.ndarray, total_bits: int, word_bits: int = 32):
        self._chunks = _repack_chunks(words, total_bits, word_bits)
        self._pos = 0
        self._len = total_bits

    def seek(self, bit: int) -> None:
        if not 0 <= bit <= self._len:
            raise ValueError(
                f"seek({bit}) out of bounds for stream of {self._len} bits")
        self._pos = bit

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self._pos + nbits > self._len:
            raise EOFError("read past end of compressed stream")
        w, off = divmod(self._pos, 64)
        v = self._chunks[w] >> off
        if off + nbits > 64:
            v |= self._chunks[w + 1] << (64 - off)
        self._pos += nbits
        return v & ((1 << nbits) - 1)


# ---------------------------------------------------------------------------
# Reference bit-level reader / writer (original single-bignum model)
# ---------------------------------------------------------------------------

class ReferenceBitWriter:
    """Original per-write bignum accumulator — equivalence oracle only."""

    __slots__ = ("_acc", "_nbits")

    def __init__(self) -> None:
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        mask = (1 << nbits) - 1
        self._acc |= (value & mask) << self._nbits
        self._nbits += nbits

    @property
    def bit_length(self) -> int:
        return self._nbits

    def to_words(self, word_bits: int = 32) -> np.ndarray:
        n_words = (self._nbits + word_bits - 1) // word_bits
        out = np.zeros(n_words, dtype=np.uint64)
        acc = self._acc
        mask = (1 << word_bits) - 1
        for k in range(n_words):
            out[k] = acc & mask
            acc >>= word_bits
        return out


class ReferenceBitReader:
    """Original single-bignum reader — equivalence oracle only."""

    __slots__ = ("_acc", "_pos", "_len")

    def __init__(self, words: np.ndarray, total_bits: int, word_bits: int = 32):
        acc = 0
        for k in range(len(words) - 1, -1, -1):
            acc = (acc << word_bits) | int(words[k])
        self._acc = acc
        self._pos = 0
        self._len = total_bits

    def seek(self, bit: int) -> None:
        if not 0 <= bit <= self._len:
            raise ValueError(
                f"seek({bit}) out of bounds for stream of {self._len} bits")
        self._pos = bit

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self._pos + nbits > self._len:
            raise EOFError("read past end of compressed stream")
        v = (self._acc >> self._pos) & ((1 << nbits) - 1)
        self._pos += nbits
        return v


# ---------------------------------------------------------------------------
# Word codec
# ---------------------------------------------------------------------------

def _significant_len(d: int) -> int:
    return (d if d >= 0 else -d - 1).bit_length()


def _bit_length_u64(v: np.ndarray) -> np.ndarray:
    """Exact per-element bit length of a uint64 array (binary search)."""
    v = v.copy()
    k = np.zeros(v.shape, dtype=np.uint64)
    for s in (32, 16, 8, 4, 2, 1):
        big = v >= (_U64(1) << _U64(s))
        k[big] += _U64(s)
        v[big] >>= _U64(s)
    return k + (v > 0)


def compress_words(words: Sequence[int], nbits: int, writer) -> None:
    """Append the compressed encoding of ``words`` to ``writer``.

    Vectorized: block-wise delta, significant-length and low-bit extraction
    in numpy, then one ``write_many`` packing all fields into the writer's
    uint64 chunk buffer.  Falls back to the scalar reference loop for
    writers without ``write_many`` (e.g. ``ReferenceBitWriter``).
    """
    if not hasattr(writer, "write_many"):
        compress_words_ref(words, nbits, writer)
        return
    arr = np.asarray(words, dtype=np.uint64).reshape(-1)
    n = arr.size
    if n == 0:
        return
    F = length_field_bits(nbits)
    mask = _U64((1 << nbits) - 1)
    half = _U64(1 << (nbits - 1))
    arr = arr & mask
    if n == 1:
        writer.write(int(arr[0]), nbits)
        return
    d = (arr[1:] - arr[:-1]) & mask          # delta mod 2^nbits
    neg = d >= half                          # signed delta < 0
    mag = np.where(neg, mask - d, d)         # |d| or |d|-1: -d-1 == mask-d
    k = _bit_length_u64(mag)
    low_width = np.maximum(k.astype(np.int64) - 1, 0)
    low_mask = np.where(k > 0, (_U64(1) << ((k - _U64(1)) & _U64(63)))
                        - _U64(1), _U64(0))
    low = d & low_mask                       # d mod 2^(k-1), both signs
    header = k | (neg.astype(np.uint64) << _U64(F))
    vals = np.zeros(2 * n - 1, dtype=np.uint64)
    wids = np.zeros(2 * n - 1, dtype=np.int64)
    vals[0], wids[0] = arr[0], nbits
    vals[1::2], wids[1::2] = header, F + 1
    vals[2::2], wids[2::2] = low, low_width
    writer.write_many(vals, wids)


def compress_words_ref(words: Sequence[int], nbits: int, writer) -> None:
    """Reference per-word encoder (original implementation, oracle only)."""
    F = length_field_bits(nbits)
    mask = (1 << nbits) - 1
    half = 1 << (nbits - 1)
    prev = None
    for w in words:
        w = int(w) & mask
        if prev is None:
            writer.write(w, nbits)
        else:
            d = (w - prev) & mask
            if d >= half:
                d -= 1 << nbits  # signed delta
            k = _significant_len(d)
            writer.write(k, F)
            writer.write(0 if d >= 0 else 1, 1)
            if k > 0:
                low = (d if d >= 0 else d + (1 << k)) & ((1 << (k - 1)) - 1)
                writer.write(low, k - 1)
        prev = w
    return


def decompress_words(reader: BitReader, count: int, nbits: int) -> np.ndarray:
    """Decode ``count`` words; vectorized reconstruction after a field scan.

    The field widths are data-dependent (the length field of word ``i`` sits
    after word ``i-1``'s low bits) so offsets are scanned sequentially —
    O(1) chunk reads per word, no bignum — and the delta chain is then
    rebuilt in one masked ``cumsum``.
    """
    if not isinstance(reader, BitReader):
        return decompress_words_ref(reader, count, nbits)
    out = np.zeros(count, dtype=np.uint64)
    if count == 0:
        return out
    F = length_field_bits(nbits)
    first = reader.read(nbits)
    if count == 1:
        out[0] = first
        return out
    f_mask = (1 << F) - 1
    chunks = reader._chunks
    pos, end = reader._pos, reader._len
    ks = np.zeros(count - 1, dtype=np.int64)
    signs = np.zeros(count - 1, dtype=np.uint64)
    lows = np.zeros(count - 1, dtype=np.uint64)
    for i in range(count - 1):
        if pos + F + 1 > end:
            raise EOFError("read past end of compressed stream")
        w, off = divmod(pos, 64)
        # 128-off valid bits: enough for header + low except when a long
        # low field straddles a third chunk (off > 128 - (F + k))
        window = (chunks[w] >> off) | (chunks[w + 1] << (64 - off))
        k = window & f_mask
        if k >= nbits:
            raise ValueError(
                f"corrupt stream: length field {k} >= word width {nbits}")
        width = F + 1 + (k - 1 if k > 0 else 0)
        if pos + width > end:
            raise EOFError("read past end of compressed stream")
        if k > 1:
            if 128 - off < F + k:
                window |= chunks[w + 2] << (128 - off)
            lows[i] = (window >> (F + 1)) & ((1 << (k - 1)) - 1)
        ks[i] = k
        signs[i] = (window >> F) & 1
        pos += width
    reader._pos = pos
    mask = _U64((1 << nbits) - 1)
    ku = ks.astype(np.uint64)
    pos_d = (_U64(1) << ((ku - _U64(1)) & _U64(63))) + lows   # 2^(k-1) + low
    neg_d = (lows - (_U64(1) << (ku & _U64(63)))) & mask      # low - 2^k
    d = np.where(ks > 0,
                 np.where(signs == 0, pos_d, neg_d),
                 np.where(signs == 0, _U64(0), mask))
    out[0] = first
    out[1:] = (_U64(first) + np.cumsum(d, dtype=np.uint64)) & mask
    return out


def decompress_words_ref(reader, count: int, nbits: int) -> np.ndarray:
    """Reference per-word decoder (original implementation, oracle only)."""
    F = length_field_bits(nbits)
    mask = (1 << nbits) - 1
    out = np.zeros(count, dtype=np.uint64)
    prev = None
    for i in range(count):
        if prev is None:
            prev = reader.read(nbits)
        else:
            k = reader.read(F)
            sign = reader.read(1)
            if k == 0:
                d = 0 if sign == 0 else -1
            else:
                low = reader.read(k - 1)
                d = ((1 << (k - 1)) + low) if sign == 0 else (low - (1 << k))
            prev = (prev + d) & mask
        out[i] = prev
    return out


def compressed_cost_bits(words: np.ndarray, nbits: int) -> int:
    """Vectorized size (bits) of the compressed encoding — no stream built.

    Used by the transfer-cycle experiments where only sizes matter (the paper
    measures cycles, i.e. sizes / bus width).
    """
    F = length_field_bits(nbits)
    w = np.asarray(words, dtype=np.uint64) & np.uint64((1 << nbits) - 1)
    if w.size == 0:
        return 0
    if w.size == 1:
        return nbits
    if nbits == 64:
        # uint64 subtraction wraps mod 2^64; reinterpret as signed delta
        d = (w[1:] - w[:-1]).view(np.int64)
    else:
        d = (w[1:].astype(np.int64) - w[:-1].astype(np.int64))
        # wrap to signed nbits range
        span = np.int64(1) << np.int64(nbits)
        d = ((d + span // 2) % span) - span // 2
    with np.errstate(over="ignore"):
        mag = np.where(d >= 0, d, -d - 1).astype(np.uint64)
    k = _bit_length_u64(mag).astype(np.int64)
    per_word = F + 1 + np.maximum(k - 1, 0)
    return int(nbits + per_word.sum())


# ---------------------------------------------------------------------------
# MARS stream with markers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Marker:
    """Position of a compressed MARS (§4.2.2): coarse word + fine bit."""
    coarse: int   # aligned bus-word index
    fine: int     # bit offset within the bus word


@dataclasses.dataclass
class CompressedStream:
    """Packed, compressed sequence of MARS with seek metadata."""
    words: np.ndarray            # uint64-held bus words
    total_bits: int
    bus_bits: int
    nbits: int                   # uncompressed word width
    markers: List[Marker]        # one per MARS, in layout order
    counts: List[int]            # uncompressed word count per MARS

    @property
    def compressed_bits(self) -> int:
        return self.total_bits

    def uncompressed_bits(self, padded_to: int | None = None) -> int:
        width = padded_to if padded_to is not None else self.nbits
        return width * sum(self.counts)


def compress_mars_stream(mars_data: Sequence[np.ndarray], nbits: int,
                         bus_bits: int = 64) -> CompressedStream:
    """Compress+pack MARS back to back; record markers at each boundary.

    The delta chain restarts at each MARS so any single MARS is independently
    decodable (atomicity), matching §4.2: "not all MARS from a given tile are
    decompressed, we need to be able to seek at the start of a particular
    MARS".
    """
    writer = BitWriter()
    markers: List[Marker] = []
    counts: List[int] = []
    record = obs.enabled()
    for arr in mars_data:
        markers.append(Marker(writer.bit_length // bus_bits,
                              writer.bit_length % bus_bits))
        flat = np.asarray(arr).reshape(-1)
        counts.append(flat.size)
        before = writer.bit_length
        compress_words(flat, nbits, writer)
        if record:
            # per-MARS compressed vs uncompressed (packed) bit histograms:
            # the Fig. 11 distribution, one observation per MARS
            obs.hist_observe("compression/mars_bits",
                             writer.bit_length - before,
                             kind="compressed", nbits=nbits)
            obs.hist_observe("compression/mars_bits", flat.size * nbits,
                             kind="uncompressed", nbits=nbits)
    if record:
        obs.counter_inc("compression/markers", len(markers), nbits=nbits)
        if writer.bit_length > 0:
            obs.hist_observe(
                "compression/ratio",
                nbits * sum(counts) / writer.bit_length, nbits=nbits)
    return CompressedStream(
        words=writer.to_words(32),
        total_bits=writer.bit_length,
        bus_bits=bus_bits,
        nbits=nbits,
        markers=markers,
        counts=counts,
    )


def decompress_mars(stream: CompressedStream, index: int) -> np.ndarray:
    """Seek (via marker) and decode exactly one MARS.

    Corrupt metadata fails loudly: a marker pointing past ``total_bits``
    or a count larger than the remaining stream raises ``ValueError``
    instead of decoding garbage.
    """
    if not 0 <= index < len(stream.markers):
        raise IndexError(
            f"MARS index {index} out of range ({len(stream.markers)} markers)")
    m = stream.markers[index]
    start = m.coarse * stream.bus_bits + m.fine
    if not 0 <= start <= stream.total_bits:
        raise ValueError(
            f"corrupt marker for MARS {index}: bit offset {start} outside "
            f"stream of {stream.total_bits} bits")
    count = stream.counts[index]
    if count < 0:
        raise ValueError(f"corrupt count for MARS {index}: {count}")
    reader = BitReader(stream.words, stream.total_bits, 32)
    reader.seek(start)
    try:
        return decompress_words(reader, count, stream.nbits)
    except (EOFError, ValueError) as e:
        raise ValueError(
            f"corrupt stream decoding MARS {index} "
            f"(count={count}, start bit {start}): {e}") from e


# ---------------------------------------------------------------------------
# Fixed-point helpers (paper data types: 12/18/24/28-bit fixed, float, double)
# ---------------------------------------------------------------------------

def quantize_fixed(x: np.ndarray, nbits: int, frac_bits: int | None = None) -> np.ndarray:
    """Real -> two's-complement fixed point, returned as unsigned words."""
    if frac_bits is None:
        frac_bits = nbits - 2
    scaled = np.round(np.asarray(x, dtype=np.float64) * (1 << frac_bits)).astype(np.int64)
    lo, hi = -(1 << (nbits - 1)), (1 << (nbits - 1)) - 1
    scaled = np.clip(scaled, lo, hi)
    return (scaled & ((1 << nbits) - 1)).astype(np.uint64)


def dequantize_fixed(w: np.ndarray, nbits: int, frac_bits: int | None = None) -> np.ndarray:
    if frac_bits is None:
        frac_bits = nbits - 2
    w = np.asarray(w, dtype=np.uint64).astype(np.int64)
    half = np.int64(1 << (nbits - 1))
    signed = np.where(w >= half, w - (np.int64(1) << np.int64(nbits)), w)
    return signed.astype(np.float64) / (1 << frac_bits)


def float_bits(x: np.ndarray, dtype: str) -> Tuple[np.ndarray, int]:
    """Raw bit patterns of float32/float64 data + word width."""
    if dtype == "float":
        return np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64), 32
    if dtype == "double":
        return np.asarray(x, dtype=np.float64).view(np.uint64), 64
    raise KeyError(dtype)


DATA_TYPES = {
    # name -> (nbits, padded storage bits on a 32/64-bit aligned bus)
    "fixed12": (12, 16),
    "fixed18": (18, 32),
    "fixed24": (24, 32),
    "fixed28": (28, 32),
    "float": (32, 32),
    "double": (64, 64),
}


def words_for(data: np.ndarray, dtype: str) -> Tuple[np.ndarray, int]:
    """Convert real-valued data to codec words for the named paper dtype."""
    if dtype.startswith("fixed"):
        nbits = DATA_TYPES[dtype][0]
        return quantize_fixed(data, nbits), nbits
    return float_bits(data, dtype)
