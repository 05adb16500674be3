"""The port's variable-width codec (paper §2.5, markers §4.2.2) and packing
accounting against the JAX package's.

Host numpy in both packages, so streams, markers, bit counts, round trips
and ratios must be equal exactly.
"""
import numpy as np
import pytest

from repro.core import compression as jcomp
from repro.core import packing as jpacking
from repro_torch.core import compression as comp
from repro_torch.core import packing

DTYPES = sorted(comp.DATA_TYPES)


def _mars_data(seed: int, smooth: bool, sizes=(1, 7, 40, 129, 2)):
    """Real-valued MARS blocks: a smooth field or noise, seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for k in sizes:
        if smooth:
            out.append(np.cumsum(rng.uniform(-0.01, 0.01, k)) + 1.0)
        else:
            out.append(rng.uniform(-1.5, 1.5, k))
    return out


def _words(blocks, dtype, pkg):
    conv = [pkg.words_for(b, dtype) for b in blocks]
    return [w for w, _ in conv], conv[0][1]


def test_data_types_equal():
    assert comp.DATA_TYPES == jcomp.DATA_TYPES
    for dtype in DTYPES:
        assert packing.dtype_widths(dtype) == jpacking.dtype_widths(dtype)
        nbits = comp.DATA_TYPES[dtype][0]
        assert comp.length_field_bits(nbits) == jcomp.length_field_bits(nbits)


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mars_stream_equal(dtype, smooth):
    blocks = _mars_data(7, smooth)
    words, nbits = _words(blocks, dtype, comp)
    jwords, jnbits = _words(blocks, dtype, jcomp)
    assert nbits == jnbits
    for w, jw in zip(words, jwords, strict=True):
        assert w.dtype == jw.dtype and np.array_equal(w, jw)
    s, js = comp.compress_mars_stream(words, nbits), jcomp.compress_mars_stream(jwords, nbits)
    assert np.array_equal(s.words, js.words)
    assert (s.total_bits, s.bus_bits, s.nbits, s.counts) == \
        (js.total_bits, js.bus_bits, js.nbits, js.counts)
    assert [(m.coarse, m.fine) for m in s.markers] == \
        [(m.coarse, m.fine) for m in js.markers]
    padded = comp.DATA_TYPES[dtype][1]
    assert s.uncompressed_bits(padded_to=padded) == js.uncompressed_bits(padded_to=padded)
    for i, w in enumerate(words):
        got = comp.decompress_mars(s, i)
        assert np.array_equal(got, jcomp.decompress_mars(js, i))
        assert np.array_equal(got, w)                       # the round trip
        assert comp.compressed_cost_bits(w, nbits) == jcomp.compressed_cost_bits(w, nbits)
    assert sum(comp.compressed_cost_bits(w, nbits) for w in words) == s.total_bits


@pytest.mark.parametrize("nbits", [12, 18, 24, 28, 32, 64])
def test_fast_and_reference_writers_agree(nbits):
    rng = np.random.default_rng(nbits)
    mask = (1 << nbits) - 1
    words = rng.integers(0, 1 << min(nbits, 63), size=300, dtype=np.uint64)
    words[100:200] = np.cumsum(words[100:200] % 7, dtype=np.uint64)
    words &= np.uint64(mask)
    streams = []
    for pkg in (comp, jcomp):
        for writer in (pkg.BitWriter, pkg.ReferenceBitWriter):
            w = writer()
            pkg.compress_words(words, nbits, w)
            streams.append((w.bit_length, w.to_words(32)))
    for bits, ws in streams[1:]:
        assert bits == streams[0][0] and np.array_equal(ws, streams[0][1])
    bits, ws = streams[0]
    for reader in (comp.BitReader, comp.ReferenceBitReader):
        out = comp.decompress_words(reader(ws, bits, 32), words.size, nbits)
        assert np.array_equal(out, words)
    assert comp.compressed_cost_bits(words, nbits) == bits


@pytest.mark.parametrize("word_bits", [16, 32, 64, 24])
def test_bit_writer_words_equal(word_bits):
    rng = np.random.default_rng(word_bits)
    vals = rng.integers(0, 1 << 40, size=50, dtype=np.uint64)
    widths = rng.integers(0, 41, size=50)
    out = []
    for pkg in (comp, jcomp):
        w = pkg.BitWriter()
        w.write_many(vals, widths)
        w.write(5, 3)
        out.append(w.to_words(word_bits))
    assert np.array_equal(*out)


@pytest.mark.parametrize("nbits,frac", [(12, None), (18, None), (24, 20), (28, None)])
def test_fixed_point_equal(nbits, frac):
    x = np.random.default_rng(3).uniform(-3.0, 3.0, 500)   # clips at the range
    q = comp.quantize_fixed(x, nbits, frac)
    assert np.array_equal(q, jcomp.quantize_fixed(x, nbits, frac))
    assert np.array_equal(comp.dequantize_fixed(q, nbits, frac),
                          jcomp.dequantize_fixed(q, nbits, frac))


@pytest.mark.parametrize("dtype", ["float", "double"])
def test_float_bits_equal(dtype):
    x = np.random.default_rng(4).standard_normal(64)
    (w, n), (jw, jn) = comp.float_bits(x, dtype), jcomp.float_bits(x, dtype)
    assert n == jn and np.array_equal(w, jw)


@pytest.mark.parametrize("count,nbits,cbits", [(100, 18, 900), (64, 12, 500),
                                               (10, 64, 321), (7, 32, 7)])
def test_compression_ratios_equal(count, nbits, cbits):
    r, jr = packing.compression_ratios(count, nbits, cbits), \
        jpacking.compression_ratios(count, nbits, cbits)
    assert (r.true_ratio, r.ratio_with_padding) == (jr.true_ratio, jr.ratio_with_padding)
    assert packing.padded_bits(count, nbits) == jpacking.padded_bits(count, nbits)
    assert packing.packed_bits(count, nbits) == jpacking.packed_bits(count, nbits)


def test_corrupt_streams_fail_alike():
    words, nbits = _words(_mars_data(9, True, sizes=(20, 30)), "fixed18", comp)
    streams = [pkg.compress_mars_stream(words, nbits) for pkg in (comp, jcomp)]
    for pkg, s in zip((comp, jcomp), streams):
        with pytest.raises(IndexError):
            pkg.decompress_mars(s, 2)
        s.markers[1] = pkg.Marker(s.total_bits, 0)          # past the end
        with pytest.raises(ValueError, match="corrupt marker"):
            pkg.decompress_mars(s, 1)
        s.counts[0] = 10 ** 6                               # more than the stream
        with pytest.raises(ValueError, match="corrupt stream"):
            pkg.decompress_mars(s, 0)
    for pkg in (packing, jpacking):
        with pytest.raises(ValueError):
            pkg.padded_width(129)
        with pytest.raises(ValueError):
            pkg.compression_ratios(4, 8, 0)
