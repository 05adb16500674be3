"""The port's attention (plain path on the CPU) against the JAX package.

``flash_attention_plain`` (the flash kernel's plain version, which a CPU
tensor takes through ``flash_fwd``) and the port's ``blockwise_attention``
against the JAX Pallas flash kernel in interpret mode and the JAX
``blockwise_attention``, on the cases and tolerances of
tests/test_flash_attention.py, lse included.  The CUDA kernel is held
against the plain version by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention as jfa
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers


def _inputs(B, S, KV, G, D, seed=0, dtype="float32", Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sk or S
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    arrs = [jnp.asarray(rng.standard_normal(shape), jdt) for shape in
            ((B, S, KV, G, D), (B, Sk, KV, D), (B, Sk, KV, D))]
    return arrs, [convert.to_torch(np.asarray(a), device="cpu") for a in arrs]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return convert.to_numpy(a).astype(np.float32)
    return np.asarray(a, dtype=np.float32)


def _jax_fwd(qj, kj, vj, causal, window):
    """The Pallas forward in interpret mode: (o, lse)."""
    return jfa._flash_fwd(qj, kj, vj, causal=causal, window=window, bq=64,
                          bk=64, interpret=True)


def _torch_blockwise(q, k, v, causal, window, bq=64, bk=64):
    B, S, KV, G, D = q.shape
    o = layers.blockwise_attention(q.reshape(B, S, KV * G, D), k, v,
                                   causal=causal, window=window, q_block=bq,
                                   kv_block=bk)
    return o.reshape(B, S, KV, G, D)


@pytest.mark.parametrize("B,S,KV,G,D", [
    (1, 128, 1, 1, 64), (2, 256, 2, 2, 64), (1, 256, 4, 1, 128),
    (1, 512, 2, 4, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_interpret(B, S, KV, G, D, causal):
    (qj, kj, vj), (q, k, v) = _inputs(B, S, KV, G, D)
    oj, lj = _jax_fwd(qj, kj, vj, causal, 0)
    o, lse = fa.flash_fwd(q, k, v, causal, 0, 64, 64)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (B, KV, G, S) and lse.dtype == torch.float32
    assert np.abs(_f32(o) - _f32(oj)).max() < 2e-5
    assert np.abs(_f32(lse) - _f32(lj)).max() < 2e-5
    ob = _torch_blockwise(q, k, v, causal, 0)
    assert np.abs(_f32(ob) - _f32(oj)).max() < 2e-5


@pytest.mark.parametrize("window", [32, 64])
def test_sliding_window(window):
    (qj, kj, vj), (q, k, v) = _inputs(1, 256, 2, 2, 64, seed=1)
    oj, lj = _jax_fwd(qj, kj, vj, True, window)
    o, lse = fa.flash_fwd(q, k, v, True, window, 64, 64)
    assert np.abs(_f32(o) - _f32(oj)).max() < 2e-5
    assert np.abs(_f32(lse) - _f32(lj)).max() < 2e-5
    ob = _torch_blockwise(q, k, v, True, window)
    assert np.abs(_f32(ob) - _f32(oj)).max() < 2e-5


def test_bf16_forward():
    (qj, kj, vj), (q, k, v) = _inputs(1, 128, 2, 2, 64, dtype="bfloat16")
    oj, lj = _jax_fwd(qj, kj, vj, True, 0)
    o, lse = fa.flash_fwd(q, k, v, True, 0, 64, 64)
    assert o.dtype == torch.bfloat16
    assert np.abs(_f32(o) - _f32(oj)).max() < 3e-2
    assert np.abs(_f32(lse) - _f32(lj)).max() < 1e-3


@pytest.mark.parametrize("causal,window,bq,bk", [
    (True, 0, 32, 64), (True, 48, 16, 32), (False, 0, 128, 32),
    (False, 40, 32, 32)])
def test_blockwise_matches_jax_blockwise(causal, window, bq, bk):
    """The port's blockwise loop against the JAX one, band slicing included."""
    (qj, kj, vj), (q, k, v) = _inputs(2, 128, 2, 2, 32, seed=3)
    B, S, KV, G, D = q.shape
    oj = jlayers.blockwise_attention(qj.reshape(B, S, KV * G, D), kj, vj,
                                     causal=causal, window=window,
                                     q_block=bq, kv_block=bk)
    ot = _torch_blockwise(q, k, v, causal, window, bq, bk)
    assert np.abs(_f32(ot).reshape(B, S, KV * G, D) - _f32(oj)).max() < 2e-5


@pytest.mark.parametrize("S,Sk,causal,window", [
    (100, 100, True, 0), (77, 77, False, 16), (50, 20, True, 8)])
def test_plain_on_ragged_shapes_matches_jax_blockwise(S, Sk, causal, window):
    """Shapes the kernel tiles raggedly; in (50, 20, 8) some rows have no key
    left, and both average v uniformly (finite NEG_INF)."""
    (qj, kj, vj), (q, k, v) = _inputs(1, S, 2, 2, 32, seed=S, Sk=Sk)
    oj = jlayers.blockwise_attention(qj.reshape(1, S, 4, 32), kj, vj,
                                     causal=causal, window=window,
                                     q_block=S, kv_block=Sk)
    o, lse = fa.flash_attention_plain(q, k, v, causal, window)
    assert np.abs(_f32(o).reshape(1, S, 4, 32) - _f32(oj)).max() < 2e-5
    assert np.isfinite(_f32(lse)).all()


def test_forward_only_refuses_grad():
    (_, _, _), (q, k, v) = _inputs(1, 64, 1, 1, 32)
    with pytest.raises(RuntimeError, match="training slice"):
        fa.flash_fwd(q.requires_grad_(), k, v)


@pytest.mark.parametrize("qshape,kshape", [
    ((1, 64, 2, 2, 32), (1, 64, 1, 32)), ((1, 64, 2, 32), (1, 64, 2, 32)),
    ((1, 64, 2, 2, 32), (2, 64, 2, 32))])
def test_shape_mismatch_raises(qshape, kshape):
    with pytest.raises(ValueError):
        fa.flash_fwd(torch.zeros(qshape), torch.zeros(kshape), torch.zeros(kshape))


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    (_, _, _), (q, k, v) = _inputs(1, 64, 1, 2, 32)
    fa.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention.flash_fwd"] == 0
