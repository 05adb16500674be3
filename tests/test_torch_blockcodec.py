"""The port's block codec against the JAX reference, bit for bit (b = 1..32)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import blockcodec as jbc
from repro_torch import convert
from repro_torch.core import blockcodec as tbc

BITS = list(range(1, 33))


def _full_range(rng, shape):
    """int32 over the whole range, so deltas and sums wrap modulo 2^32."""
    return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)


def _cpu(a):
    return convert.to_torch(a, device="cpu")


def _np(t):
    return convert.to_numpy(t)


@pytest.mark.parametrize("b", BITS)
def test_bitplane_pack_unpack_bit_exact(b):
    rng = np.random.default_rng(100 + b)
    v = _full_range(rng, (3, 4, 32))
    jp = np.asarray(jbc.bitplane_pack(jnp.asarray(v), b))
    tp = tbc.bitplane_pack(_cpu(v), b)
    assert tp.dtype == torch.uint32 and jp.dtype == np.uint32
    assert np.array_equal(_np(tp), jp)
    ju = np.asarray(jbc.bitplane_unpack(jnp.asarray(jp), b))
    tu = tbc.bitplane_unpack(tp, b)
    assert tu.dtype == torch.int32
    assert np.array_equal(_np(tu), ju)


@pytest.mark.parametrize("shape", [(1, 32), (5, 256), (2, 3, 64)])
def test_delta_encode_decode_wrap(shape):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    x = _full_range(rng, shape)
    x.flat[:2] = [2**31 - 1, -2**31]          # a delta that overflows for sure
    jd = np.asarray(jbc.delta_encode(jnp.asarray(x)))
    td = tbc.delta_encode(_cpu(x))
    assert td.dtype == torch.int32
    assert np.array_equal(_np(td), jd)
    jr = np.asarray(jbc.delta_decode(jnp.asarray(jd)))
    tr = tbc.delta_decode(td)
    assert np.array_equal(_np(tr), jr)
    assert np.array_equal(_np(tr), x)


@pytest.mark.parametrize("b", BITS)
def test_quantize_dequantize_bit_exact(b):
    rng = np.random.default_rng(200 + b)
    x = (rng.standard_normal(4 * 64) * 3).astype(np.float32)
    x[64:128] = 0.0                                # an all-zero block: scale 1
    jq, js = jbc.quantize(jnp.asarray(x), b, 64)
    tq, ts = tbc.quantize(_cpu(x), b, 64)
    assert np.array_equal(_np(tq), np.asarray(jq))
    assert np.array_equal(_np(ts), np.asarray(js), equal_nan=True)
    jy = np.asarray(jbc.dequantize(jq, js))
    ty = tbc.dequantize(tq, ts)
    assert np.array_equal(_np(ty), jy, equal_nan=True)  # b=1: 0 * inf


@pytest.mark.parametrize("delta", [True, False])
@pytest.mark.parametrize("b", BITS)
def test_compress_decompress_bit_exact(b, delta):
    rng = np.random.default_rng(300 + b + 50 * delta)
    x = np.cumsum(rng.standard_normal(3 * 128)).astype(np.float32)
    jcfg = jbc.BlockCodecConfig(bits=b, block=128, delta=delta)
    tcfg = convert.codec_config(jcfg)
    assert tcfg == tbc.BlockCodecConfig(bits=b, block=128, delta=delta)
    jp, js = jbc.compress(jnp.asarray(x), jcfg)
    tp, ts = tbc.compress(_cpu(x), tcfg)
    assert np.array_equal(_np(tp), np.asarray(jp))
    assert np.array_equal(_np(ts), np.asarray(js), equal_nan=True)
    jy = np.asarray(jbc.decompress(jp, js, jcfg))
    ty = tbc.decompress(tp, ts, tcfg)
    assert np.array_equal(_np(ty), jy, equal_nan=True)  # b=1: 0 * inf


@pytest.mark.parametrize("n_values,bits,block", [
    (1024, 8, 256), (4096, 4, 128), (65536, 13, 512), (256, 32, 32)])
def test_compressed_bytes_and_ratio_equal(n_values, bits, block):
    jcfg = jbc.BlockCodecConfig(bits=bits, block=block)
    tcfg = tbc.BlockCodecConfig(bits=bits, block=block)
    assert tbc.compressed_bytes(n_values, tcfg) == jbc.compressed_bytes(n_values, jcfg)
    assert tcfg.ratio == jcfg.ratio


@pytest.mark.parametrize("kind", ["float", "int", "smooth_int"])
@pytest.mark.parametrize("delta", [True, False])
def test_encode_varwidth_equal(kind, delta):
    rng = np.random.default_rng(17)
    if kind == "float":
        x = rng.standard_normal(8 * 64).astype(np.float32)
    elif kind == "int":
        x = _full_range(rng, (8 * 64,))
    else:
        x = np.cumsum(rng.integers(-5, 6, 8 * 64)).astype(np.int32)
    jt, jw = jbc.encode_varwidth(x, block=64, delta=delta)
    tt, tw = tbc.encode_varwidth(x, block=64, delta=delta)
    assert jt == tt
    assert np.array_equal(jw, tw)
    assert np.array_equal(tbc.min_bitwidth(x.reshape(8, 64)),
                          jbc.min_bitwidth(x.reshape(8, 64)))
