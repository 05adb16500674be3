"""The port's main path end to end against the JAX chain, at a small size.

stencil (jacobi1d_tiled) -> quantize -> pack -> unpack -> dequantize: the
chain ``chip_smoke.py`` drives on the card at full size, here on the CPU.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import blockcodec as jbc
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import blockcodec as tbc
from repro_torch.kernels import ops

N, T, W = 4096, 16, 256
QBITS, BITS, BLOCK = 7, 8, 256


def _jax_chain(x):
    y = jops.jacobi1d_tiled(jnp.asarray(x), T, width=W, use_pallas="interpret")
    q, scale = jbc.quantize(y, QBITS, BLOCK)
    planes = jops.pack_codes(q, BITS, use_pallas="interpret")
    q2 = jops.unpack_codes(planes, BITS, BLOCK, use_pallas="interpret")
    return [np.asarray(a) for a in (y, q, scale, planes, jbc.dequantize(q2, scale))]


def _torch_chain(x):
    y = ops.jacobi1d_tiled(convert.to_torch(x, device="cpu"), T, width=W)
    q, scale = tbc.quantize(y, QBITS, BLOCK)
    planes = ops.pack_codes(q, BITS)
    q2 = ops.unpack_codes(planes, BITS, BLOCK)
    assert bool((q2 == q).all())
    return [convert.to_numpy(t) for t in (y, q, scale, planes, tbc.dequantize(q2, scale))]


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_matches_jax(seed):
    x = np.cumsum(np.random.default_rng(seed).uniform(-0.01, 0.01, N)).astype(np.float32)
    jy, jq, js, jp, jout = _jax_chain(x)
    ty, tq, ts, tp, tout = _torch_chain(x)
    assert np.abs(ty - jy).max() <= 1e-5
    assert tout.shape == jout.shape == (N // BLOCK, BLOCK)
    assert np.isfinite(tout).all()
    assert np.abs(tout - jout).max() <= 1e-5
    # the round trip loses only the quantization: half a step per block
    assert (np.abs(tout.reshape(-1) - ty).reshape(-1, BLOCK)
            <= ts[:, None] / 2 + 1e-6).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_same_codes_same_planes(seed):
    x = np.random.default_rng(seed).standard_normal(N).astype(np.float32)
    q, _ = jbc.quantize(jnp.asarray(x), QBITS, BLOCK)
    jp = np.asarray(jops.pack_codes(q, BITS, use_pallas="interpret"))
    tp = ops.pack_codes(convert.to_torch(np.asarray(q), device="cpu"), BITS)
    assert np.array_equal(convert.to_numpy(tp), jp)
    tq = ops.unpack_codes(convert.to_torch(jp, device="cpu"), BITS, BLOCK)
    assert np.array_equal(convert.to_numpy(tq), np.asarray(q))
