"""The port's packed KV-cache entry points (plain path on the CPU) against JAX.

``kv_quant`` / ``kv_dequant`` on CPU tensors run the kvpack kernels' plain
versions; the JAX side runs Pallas in interpret mode (the sweep and the
tolerance of tests/test_kernels.py) and ``repro.kernels.ref`` (bit for bit).
The CUDA kernels are held against the plain versions by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as jobs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.kernels import kvpack, ops


def _inputs(rows, d, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((rows, d)).astype(np.float32)
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return xj, convert.to_torch(np.asarray(xj), device="cpu")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows,d", [(8, 128), (32, 128), (16, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_vs_interpret_sweep(bits, rows, d, dtype):
    xj, xt = _inputs(rows, d, dtype, rows)
    c_int, s_int = jops.kv_quant(xj, bits, use_pallas="interpret")
    c_t, s_t = ops.kv_quant(xt, bits)
    assert c_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert c_t.shape == c_int.shape and s_t.shape == s_int.shape
    assert np.allclose(convert.to_numpy(s_t), np.asarray(s_int), rtol=1e-6)
    # through dequantization, as tests/test_kernels.py: 1-ulp scale
    # differences may flip round-half ties, so one quantization step is
    # allowed on <1% of entries
    y_int = np.asarray(jops.kv_dequant(c_int, s_int, bits, use_pallas="interpret"))
    y_t = convert.to_numpy(ops.kv_dequant(c_t, s_t, bits))
    step = convert.to_numpy(s_t)
    diff = np.abs(y_t - y_int)
    assert (diff <= step + 1e-6).all(), diff.max()
    assert (diff > 1e-6 * np.maximum(step, 1)).mean() < 0.01
    xf = np.asarray(xj, dtype=np.float32)
    qstep = np.abs(xf).max(axis=1) / (2 ** (bits - 1) - 1)
    assert (np.abs(y_t - xf).max(axis=1) <= qstep + 1e-5).all()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows,d", [(8, 128), (5, 128), (37, 64), (3, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_bit_exact_vs_ref(bits, rows, d, dtype):
    """Any row count (the TPU's multiple-of-8 tile is not the function)."""
    xj, xt = _inputs(rows, d, dtype, 100 + rows)
    xt[0] = 0  # an all-zero row takes scale 1
    xj = jnp.asarray(convert.to_numpy(xt), xj.dtype)
    c_ref, s_ref = jref.kv_quant_ref(xj, bits)
    c_t, s_t = kvpack.kv_quant(xt, bits)
    assert np.array_equal(convert.to_numpy(c_t), np.asarray(c_ref))
    assert np.array_equal(convert.to_numpy(s_t), np.asarray(s_ref))
    y_ref = jref.kv_dequant_ref(c_ref, s_ref, bits)
    y_t = kvpack.kv_dequant(c_t, s_t, bits)
    assert np.array_equal(convert.to_numpy(y_t), np.asarray(y_ref))


def test_int4_nibble_layout():
    """Even column in the low nibble; sign extension of both nibbles."""
    x = torch.tensor([[7.0, -7.0, 1.0, -1.0, 0.0, 3.0]])
    codes, scale = kvpack.kv_quant(x, 4)
    assert float(scale) == 1.0
    lo, hi = codes.to(torch.int32) & 0xF, (codes.to(torch.int32) >> 4) & 0xF
    assert lo.tolist() == [[7, 1, 0]] and hi.tolist() == [[9, 15, 3]]
    assert kvpack.kv_dequant(codes, scale, 4).tolist() == x.tolist()


@pytest.mark.parametrize("rows,d,bits,itemsize", [
    (64, 128, 8, 2), (16384, 128, 4, 4), (7, 6, 8, 4)])
def test_io_bytes_equal(rows, d, bits, itemsize):
    assert ops.kv_quant_io_bytes(rows, d, bits, itemsize) == \
        jops.kv_quant_io_bytes(rows, d, bits, itemsize)
    assert ops.kv_dequant_io_bytes(rows, d, bits) == \
        jops.kv_dequant_io_bytes(rows, d, bits)


def test_obs_series_equal_reference():
    """Same kernels/* counters, labels and values as the reference."""
    xj, xt = _inputs(16, 128, "bfloat16", 7)
    with jobs.enabled_scope() as (jreg, _):
        for bits in (8, 4):
            c, s = jops.kv_quant(xj, bits, use_pallas="ref")
            jops.kv_dequant(c, s, bits, use_pallas="ref")
    with tobs.enabled_scope() as (treg, trc):
        for bits in (8, 4):
            c, s = ops.kv_quant(xt, bits)
            ops.kv_dequant(c, s, bits)
    assert treg.snapshot().counters == jreg.snapshot().counters
    assert [r.name for r in trc.records] == [
        "kernels/kv_quant", "kernels/kv_dequant"] * 2


def test_cuda_backend_on_cpu_tensor_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.kv_quant(torch.zeros(8, 128), 8, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.kv_dequant(torch.zeros(8, 128, dtype=torch.int8),
                       torch.ones(8, 1), 8, backend="cuda")


@pytest.mark.parametrize("shape,dtype,bits", [
    ((8, 127), torch.float32, 8), ((8, 128), torch.float16, 8),
    ((8, 128), torch.float32, 5), ((128,), torch.float32, 8)])
def test_kv_quant_rejects_bad_input(shape, dtype, bits):
    with pytest.raises(ValueError):
        kvpack.kv_quant(torch.zeros(shape, dtype=dtype), bits)


def test_kv_dequant_rejects_bad_scales():
    with pytest.raises(ValueError):
        kvpack.kv_dequant(torch.zeros(8, 64, dtype=torch.int8),
                          torch.ones(8), 8)


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    c, s = ops.kv_quant(torch.ones(8, 128), 4)
    ops.kv_dequant(c, s, 4)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
