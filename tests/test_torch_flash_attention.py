"""The port's attention (plain path on the CPU) against the JAX package.

``flash_attention_plain`` (the flash kernel's plain version, which a CPU
tensor takes through ``flash_fwd``) and the port's ``blockwise_attention``
against the JAX Pallas flash kernel in interpret mode and the JAX
``blockwise_attention``, on the cases and tolerances of
tests/test_flash_attention.py, lse included.  The backward: ``flash_bwd``
(the plain versions of the dK/dV and dQ kernels on CPU tensors),
``flash_bwd_plain`` and ``FlashAttentionFn`` against ``jax.grad`` of the
reference's blockwise attention, at the relative error 2e-4 of
``test_gradients_match_reference``.  The CUDA kernels are held against the
plain versions by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
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
    """``flash_fwd`` is the forward alone: its outputs carry no graph, while
    ``flash_attention`` differentiates through ``FlashAttentionFn``."""
    (_, _, _), (q, k, v) = _inputs(1, 64, 1, 1, 32)
    o, lse = fa.flash_fwd(q.requires_grad_(), k, v)
    assert not o.requires_grad and not lse.requires_grad
    o2 = fa.flash_attention(q, k, v)
    assert o2.requires_grad and type(o2.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(o2.detach(), o)


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


# -- backward -------------------------------------------------------------------

def _loss_grads_jax(qj, kj, vj, causal, window, bq, bk):
    """jax.grad of sum(o cos o) through the reference's blockwise attention
    (the oracle of tests/test_flash_attention.py::test_gradients_match_reference)."""
    B, S, KV, G, D = qj.shape

    def loss(q, k, v):
        o = jlayers.blockwise_attention(q.reshape(B, S, KV * G, D), k, v,
                                        causal=causal, window=window,
                                        q_block=bq, kv_block=bk)
        return jnp.sum(o * jnp.cos(o))

    return jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)


def _rel(a, b):
    b = _f32(b)
    return np.abs(_f32(a) - b).max() / (np.abs(b).max() + 1e-9)


@pytest.mark.parametrize("B,S,KV,G,D,causal,window", [
    (1, 128, 1, 1, 64, True, 0), (1, 128, 2, 2, 64, True, 0),
    (2, 128, 2, 4, 32, False, 0), (1, 256, 2, 2, 32, True, 32),
    (1, 256, 2, 2, 32, True, 64), (1, 128, 4, 1, 64, False, 48)])
def test_backward_matches_jax_grad(B, S, KV, G, D, causal, window):
    (qj, kj, vj), (q, k, v) = _inputs(B, S, KV, G, D, seed=2)
    gj = _loss_grads_jax(qj, kj, vj, causal, window, 64, 64)
    # through the autograd Function (forward and both backward kernels'
    # plain versions on CPU tensors)
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal, window, 64, 64)
    (o * torch.cos(o)).sum().backward()
    for got, want, name in zip((qt.grad, kt.grad, vt.grad), gj, "qkv"):
        assert _rel(got, want) < 2e-4, name
    # the plain backward by formula, with do = d(sum o cos o)/do
    o, lse = fa.flash_fwd(q, k, v, causal, window)
    do = torch.cos(o) - o * torch.sin(o)
    for got, want, name in zip(fa.flash_bwd_plain(q, k, v, o, lse, do, causal,
                                                  window), gj, "qkv"):
        assert got.dtype == torch.float32 and _rel(got, want) < 2e-4, name


@pytest.mark.parametrize("S,Sk,causal,window", [
    (128, 64, True, 8), (128, 128, False, 16), (64, 128, True, 0)])
def test_backward_matches_pallas_backward(S, Sk, causal, window):
    """Against the Pallas backward kernels in interpret mode, also where
    rows have no allowed key ((128, 64, causal, 8): queries 71 and up): a
    masked p is 0 there, so such rows add no gradient, unlike the
    blockwise path's uniform average."""
    (qj, kj, vj), (q, k, v) = _inputs(1, S, 2, 2, 32, seed=5, Sk=Sk)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, window, 32, 32, True)
        return jnp.sum(o * jnp.cos(o))

    gj = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    o, lse = fa.flash_fwd(q, k, v, causal, window)
    do = torch.cos(o) - o * torch.sin(o)
    got = fa.flash_bwd(q, k, v, o, lse, do, causal, window)
    for g, want, name in zip(got, gj, "qkv"):
        assert _rel(g, want) < 2e-4, name


def test_no_key_rows_get_zero_gradient():
    (_, _, _), (q, k, v) = _inputs(1, 50, 2, 2, 32, seed=7, Sk=20)
    o, lse = fa.flash_fwd(q, k, v, True, 8)
    do = torch.ones_like(o)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, True, 8)
    assert torch.all(dq[:, 27:] == 0)         # query s sees keys (s-8, s] < 20
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert torch.isfinite(dv).all() and dv.abs().sum() > 0


def test_backward_wrappers_on_cpu_run_the_plain_version():
    ops.reset_launch_counts()
    (_, _, _), (q, k, v) = _inputs(1, 64, 2, 2, 32, seed=8)
    o, lse = fa.flash_fwd(q, k, v, True, 0)
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(q.shape)).astype(np.float32))
    dq, dk, dv = fa.flash_bwd_plain(q, k, v, o, lse, do, True, 0)
    delta = (o * do).sum(-1).permute(0, 2, 3, 1)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, 0)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, 0)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    counts = ops.launch_counts()
    assert counts["flash_attention.flash_bwd_dkv"] == 0
    assert counts["flash_attention.flash_bwd_dq"] == 0


@pytest.mark.parametrize("bad", ["o", "lse", "delta"])
def test_backward_shape_mismatch_raises(bad):
    (_, _, _), (q, k, v) = _inputs(1, 64, 2, 2, 32)
    o, lse = fa.flash_fwd(q, k, v)
    with pytest.raises(ValueError):
        if bad == "o":
            fa.flash_bwd(q, k, v, o[:, :32], lse, o, True, 0)
        elif bad == "lse":
            fa.flash_bwd(q, k, v, o, lse[..., :32], o, True, 0)
        else:
            fa.flash_bwd_dq(q, k, v, o, lse, lse[..., :32], True, 0)


# -- the bf16 tensor-core kernels' rounding, emulated ---------------------------

#: chip_smoke.py's bf16 tolerances: forward o and lse absolute, backward
#: relative to each gradient's largest magnitude
_BF16_O_TOL, _BF16_LSE_TOL, _BF16_BWD_TOL = 3e-2, 1e-3, 1e-2


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_fwd(q, k, v, causal, window, bk):
    """The bf16 forward kernel's arithmetic: key tiles of ``bk``, scores and
    the online softmax in f32 from bf16 inputs, P rounded to bf16 before
    P V, f32 accumulation -> (o in bf16, lse f32)."""
    D, Sk = q.shape[-1], k.shape[1]
    s_all = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * D ** -0.5
    allowed = fa._mask(q.shape[1], Sk, causal, window, q.device)
    s_all = torch.where(allowed, s_all, torch.full_like(s_all, fa.NEG_INF))
    m = torch.full(s_all.shape[:-1], fa.NEG_INF)
    l = torch.zeros(s_all.shape[:-1])
    acc = torch.zeros(*s_all.shape[:-1], D)
    for k0 in range(0, Sk, bk):
        s = s_all[..., k0:k0 + bk]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", _bf16(p), v[:, k0:k0 + bk].float())
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    o = (acc / lc[..., None]).permute(0, 3, 1, 2, 4)
    return o.to(torch.bfloat16), m + torch.log(lc)


def _emulate_dkv(q, k, v, do, lse, delta, causal, window, bq=64):
    """The bf16 dK/dV kernel's arithmetic: query tiles of ``bq``, S^T and
    dP^T in f32 from bf16 inputs, P^T and dS^T rounded to bf16 before their
    products, f32 accumulation -> (dk, dv) in bf16."""
    D, S = q.shape[-1], q.shape[1]
    scale = D ** -0.5
    allowed = fa._mask(S, k.shape[1], causal, window, q.device)
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)
    for q0 in range(0, S, bq):
        qt, dot = q[:, q0:q0 + bq].float(), do[:, q0:q0 + bq].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qt, k.float()) * scale
        p = torch.where(allowed[q0:q0 + bq],
                        torch.exp(s - lse[..., q0:q0 + bq, None]),
                        torch.zeros_like(s))
        dp = torch.einsum("bqkgd,bskd->bkgqs", dot, v.float())
        ds = p * (dp - delta[..., q0:q0 + bq, None]) * scale
        dv += torch.einsum("bkgqs,bqkgd->bskd", _bf16(p), dot)
        dk += torch.einsum("bkgqs,bqkgd->bskd", _bf16(ds), qt)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _emulate_dq(q, k, v, do, lse, delta, causal, window, bk=128):
    """The bf16 dQ kernel's arithmetic: key tiles of ``bk`` (the kernel's 128,
    or its 64-key halves at D = 128), S and dP in f32 from bf16 inputs, dS
    rounded to bf16 before dS K, f32 accumulation tile by tile -> dq in
    bf16.  Each query row is independent, so the 128-row query tiles need
    no loop."""
    D, Sk = q.shape[-1], k.shape[1]
    scale = D ** -0.5
    allowed = fa._mask(q.shape[1], Sk, causal, window, q.device)
    qf, dof = q.float(), do.float()
    dq = torch.zeros(q.shape)
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kt) * scale
        p = torch.where(allowed[:, k0:k0 + bk], torch.exp(s - lse[..., None]),
                        torch.zeros_like(s))
        dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vt)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bkgqs,bskd->bqkgd", _bf16(ds), kt)
    return dq.to(torch.bfloat16)


@pytest.mark.parametrize("B,S,KV,G,D,causal,window,blk", [
    (1, 128, 2, 2, 64, True, 0, 64), (1, 128, 2, 2, 64, True, 32, 64),
    (1, 80, 2, 2, 64, True, 0, 16), (1, 128, 2, 2, 32, True, 0, 64),
    (2, 128, 1, 3, 32, False, 0, 32)])
def test_bf16_tensor_core_rounding_matches_jax(B, S, KV, G, D, causal, window,
                                               blk):
    """The tensor-core kernels round p (forward), p^T and ds^T (dK/dV) and
    ds (dQ) to bf16 before their products; emulated here on the CPU, on
    bf16 inputs, against the Pallas kernels in interpret mode (forward;
    ``jax.grad`` through them for the backward) at chip_smoke.py's bf16
    tolerances.
    The forward walks the kernel's 128-key tiles and 64-key ones; S = 80 is
    ragged against both (the reference blocks by ``blk``, which divides S).

    No kernel code runs here, so nothing in this test ties the emulation to
    the kernels: chip_smoke.py's attention and attention_bwd phases, which
    hold the kernels against the plain versions on the card, do. The
    emulation's tiles follow the kernels' (128-key forward tiles, 64-row
    dK/dV query tiles, 128-key dQ tiles); when those change, change ``bk``
    and ``bq`` here."""
    (qj, kj, vj), (q, k, v) = _inputs(B, S, KV, G, D, seed=11, dtype="bfloat16")
    oj, lj = jfa._flash_fwd(qj, kj, vj, causal=causal, window=window, bq=blk,
                            bk=blk, interpret=True)
    for bk in (128, 64):
        o, lse = _emulate_fwd(q, k, v, causal, window, bk)
        assert np.abs(_f32(o) - _f32(oj)).max() < _BF16_O_TOL, bk
        assert np.abs(_f32(lse) - _f32(lj)).max() < _BF16_LSE_TOL, bk

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, window, blk, blk, True)
        return jnp.sum(o.astype(jnp.float32) * jnp.cos(o.astype(jnp.float32)))

    dqj, dkj, dvj = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    of = o.float()
    do = (torch.cos(of) - of * torch.sin(of)).to(torch.bfloat16)
    delta = fa.bwd_delta(o, do)
    dk, dv = _emulate_dkv(q, k, v, do, lse, delta, causal, window)
    assert _rel(dk, dkj) < _BF16_BWD_TOL
    assert _rel(dv, dvj) < _BF16_BWD_TOL
    dq = _emulate_dq(q, k, v, do, lse, delta, causal, window)
    assert _rel(dq, dqj) < _BF16_BWD_TOL


def test_bf16_kernel_limits():
    """The bf16 route reads rows by TMA: it takes D % 8 == 0 only (checked
    before any launch; f32 takes any D <= 128), and a view at an address
    that is not 16-byte aligned is copied before its pointer is passed."""
    q = torch.zeros(1, 64, 1, 1, 12, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 1, 12, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa._check_kernel(q, k)
    fa._check_kernel(q.float(), k.float())
    base = torch.arange(1 + 64 * 32, dtype=torch.float32).to(torch.bfloat16)
    view = base[1:].view(1, 64, 1, 32)
    assert view.data_ptr() % 16 != 0
    moved = fa._aligned(view)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)
    assert fa._aligned(moved).data_ptr() == moved.data_ptr()
