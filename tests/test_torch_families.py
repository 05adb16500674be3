"""The port's moe, ssm and hybrid families (CPU) against the JAX package.

mixtral-8x7b and grok-1-314b (moe), mamba2-130m (ssm) and hymba-1.5b
(hybrid) at smoke size, with weights carried over from JAX by
``convert.params_from_jax`` and inputs drawn from seeded numpy: the MoE
block (output, aux loss, the chosen experts and the dropped copies), the
SSD mixer (the chunked scan, the causal conv, 16 recurrent decode steps),
then each family end to end: ``forward`` and ``prefill`` logits,
``decode_step`` at bits 16, 8 and 4, ``generate`` tokens (past the 64-slot
ring of the windowed models), ``loss_fn`` and every gradient with and
without remat, and three scenarios of the reference's tests/test_models.py
run through the port.

Tolerances, f32: logits within 1e-4, greedy tokens identical, each
gradient leaf within 1e-4 of its largest magnitude, the loss within 1e-5
relative.  bf16: within 3e-2 of the largest reference value (XLA and
PyTorch round bf16 at other places, ROADMAP Queue 3).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import model_zoo, moe, ssm, transformer
from repro_torch.serve import ServeEngine

ARCHES = ("mixtral-8x7b", "grok-1-314b", "mamba2-130m", "hymba-1.5b")
B = 2
F32_TOL, BF16_REL, GRAD_REL = 1e-4, 3e-2, 1e-4


def _np(a):
    if isinstance(a, torch.Tensor):
        return convert.to_numpy(a).astype(np.float32)
    return np.asarray(a, dtype=np.float32)


def _models(arch, dtype="float32", bits=16, seq_len=64, **cfg_kw):
    cfg_j = dataclasses.replace(jbase.load_smoke(arch), **cfg_kw)
    cfg_t = dataclasses.replace(tbase.load_smoke(arch), **cfg_kw)
    kw = dict(seq_len=seq_len, global_batch=B, kind="decode", param_dtype=dtype,
              kv_cache_bits=bits, q_block=16, kv_block=16, remat=False)
    rc_j, rc_t = jbase.RunConfig(**kw), tbase.RunConfig(**kw)
    japi = jzoo.get_api(cfg_j, rc_j)
    jp = japi.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg_t, "cpu")
    return ((cfg_j, rc_j, japi, jp),
            (cfg_t, rc_t, model_zoo.get_api(cfg_t, rc_t, "cpu"), tp))


def _tokens(n, seed=0, batch=B):
    return np.random.default_rng(seed).integers(0, 256, (batch, n)).astype(np.int32)


def _close(got, want, dtype):
    err, top = np.abs(_np(got) - _np(want)).max(), np.abs(_np(want)).max()
    return (err < F32_TOL if dtype == "float32" else err < BF16_REL * top), err


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# -- the MoE block -------------------------------------------------------------

def _reference_route(xf, router, cfg):
    """The reference's routing (moe.py:61-84), read back as numpy: chosen
    experts and which of the n*k copies fit their expert's capacity."""
    probs = jax.nn.softmax((xf @ router).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg.topk)
    e_flat = np.asarray(top_e).reshape(-1)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[e_flat]
    pos = (np.cumsum(onehot, axis=0) - onehot)[np.arange(len(e_flat)), e_flat]
    cap = max(int(cfg.capacity_factor * cfg.topk * xf.shape[0] / cfg.n_experts), 1)
    return np.asarray(top_e), pos < cap, cap


@pytest.mark.parametrize("dtype,S", [("float32", 32), ("float32", 1),
                                     ("bfloat16", 32)])
def test_moe_block_matches_reference(dtype, S):
    """Embedded tokens through layer 0's MoE block.  At (2, 32) the expert
    capacity is 40 and expert 0 gets 41 copies; at (2, 1), a decode step's
    shape, it is 1 and half the copies are dropped."""
    (cfg_j, _, _, jp), (cfg_t, _, _, tp) = _models("mixtral-8x7b", dtype)
    toks = _tokens(S, seed=0)
    xj = jlayers.embed(jnp.asarray(toks), jp.embed)
    xt = convert.to_torch(np.asarray(xj), "cpu")
    pj = _layer0(jp.layers.moe)
    oj, auxj = jmoe.moe_block(xj, pj, cfg_j)
    with torch.no_grad():
        ot, auxt = moe.moe_block(xt, tp.layers[0].moe, cfg_t)
    assert ot.dtype == xt.dtype and auxt.dtype == torch.float32

    top_e, keep, cap = _reference_route(xj.reshape(-1, cfg_j.d_model), pj.router, cfg_j)
    with torch.no_grad():
        r = moe.route(xt.reshape(-1, cfg_t.d_model), tp.layers[0].moe.router, cfg_t)
    assert r.cap == cap and (cap == 40 if S == 32 else cap == 1)
    assert np.array_equal(r.top_e.numpy(), top_e)      # same experts, same order
    assert np.array_equal(r.keep.numpy(), keep)        # the same copies dropped
    assert 0 < (~keep).sum() < keep.size
    ok, err = _close(ot, oj, dtype)
    assert ok, err
    assert abs(float(auxt) - float(auxj)) < 1e-6 * max(1.0, abs(float(auxj)))


def test_route_breaks_ties_as_lax_top_k():
    """Experts 1 and 2 (and 0 and 3) share a router column: their
    probabilities tie exactly, and the lower expert goes first, as in
    ``lax.top_k`` (bf16 router logits tie often)."""
    cfg = tbase.load_smoke("mixtral-8x7b")
    rng = np.random.default_rng(9)
    router = rng.standard_normal((cfg.d_model, 2)).astype(np.float32)
    router = router[:, [0, 1, 1, 0]]
    x = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router)),
                            cfg.topk)
    got = moe.route(torch.from_numpy(x), torch.from_numpy(router), cfg).top_e
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert set(map(tuple, got.tolist())) <= {(0, 3), (1, 2)}


# -- the SSD mixer ------------------------------------------------------------------

def _ssm_inputs(arch, S, seed=2):
    (cfg_j, _, _, jp), (cfg_t, _, _, tp) = _models(arch)
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg_j.d_model))
         .astype(np.float32))
    return cfg_j, _layer0(jp.layers.ssm), cfg_t, tp.layers[0].ssm, x


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssd_forward_matches_reference(arch):
    """Three chunks of 32: the carried state crosses two chunk edges."""
    cfg_j, pj, cfg_t, pt, x = _ssm_inputs(arch, 96)
    yj = jssm.ssd_forward(pj, jnp.asarray(x), cfg_j)
    with torch.no_grad():
        yt = ssm.ssd_forward(pt, torch.from_numpy(x), cfg_t)
    assert np.abs(_np(yt) - _np(yj)).max() < F32_TOL
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_forward(pt, torch.from_numpy(x[:, :48]), cfg_t)


def test_ssd_gradients_stay_finite_where_the_reference_overflows():
    """dt ~ 3 and A up to 16: a chunk's decay exp(cs_i - cs_j) passes f32's
    range in the upper triangle.  The forward agrees with the reference;
    the reference's gradient is NaN (0 x inf in the backward of its
    masked product), the port's is finite, as it masks the exponent first."""
    cfg_j, pj, cfg_t, pt, x = _ssm_inputs("mamba2-130m", 64, seed=5)
    pj = pj._replace(dt_bias=pj.dt_bias + 7.6)
    with torch.no_grad():
        pt.dt_bias += 7.6
    assert np.array_equal(_np(pt.dt_bias), _np(pj.dt_bias))
    xj = jnp.asarray(x)
    yj = jssm.ssd_forward(pj, xj, cfg_j)
    gj = jax.grad(lambda xx: jssm.ssd_forward(pj, xx, cfg_j).sum())(xj)
    xt = torch.from_numpy(x).requires_grad_()
    yt = ssm.ssd_forward(pt, xt, cfg_t)
    yt.sum().backward()
    assert np.abs(_np(yt) - _np(yj)).max() < F32_TOL
    assert np.isnan(np.asarray(gj)).any()
    assert torch.isfinite(xt.grad).all()
    for name, prm in pt.named_parameters():
        assert prm.grad is not None and torch.isfinite(prm.grad).all(), name


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssd_decode_matches_reference(arch):
    """16 recurrent steps from a zero state: output, h and conv each step
    (conv holds in_proj's products, which the two libraries round apart)."""
    cfg_j, pj, cfg_t, pt, x = _ssm_inputs(arch, 16, seed=3)
    sj = jssm.init_ssm_state(cfg_j, B)
    st = ssm.init_ssm_state(cfg_t, B, "cpu")
    assert st.h.dtype == st.conv.dtype == torch.float32
    for i in range(16):
        yj, sj = jssm.ssd_decode(pj, jnp.asarray(x[:, i:i + 1]), sj, cfg_j)
        with torch.no_grad():
            yt, st = ssm.ssd_decode(pt, torch.from_numpy(x[:, i:i + 1]), st, cfg_t)
        assert np.abs(_np(yt) - _np(yj)).max() < F32_TOL, i
        assert np.abs(_np(st.h) - _np(sj.h)).max() < F32_TOL, i
        assert np.abs(_np(st.conv) - _np(sj.conv)).max() < F32_TOL, i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    """A sum of K shifted products in the activation dtype: bit for bit."""
    rng = np.random.default_rng(4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, w, b, state = (jnp.asarray(rng.standard_normal(s), jdt)
                      for s in ((2, 9, 24), (4, 24), (24,), (2, 3, 24)))
    state = state if with_state else None
    yj, nj = jssm._causal_conv(x, w, b, state)
    t = [None if a is None else convert.to_torch(np.asarray(a), "cpu")
         for a in (x, w, b, state)]
    yt, nt = ssm._causal_conv(*t)
    assert np.array_equal(_np(nt), _np(nj))
    if dtype == "float32":
        assert np.abs(_np(yt) - _np(yj)).max() < 1e-6
    else:     # XLA's bf16 logistic is not the correctly rounded one
        assert np.abs(_np(yt) - _np(yj)).max() < BF16_REL * np.abs(_np(yj)).max()


def test_softplus_is_jax_softplus():
    """``jax.nn.softplus`` has no threshold; torch's switches to x past 20."""
    x = np.concatenate([np.linspace(-40, 40, 8001), [-100, 19.99, 20.01, 88]]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2 * np.spacing(np.abs(want)).max()


# -- each family end to end ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHES)
def test_forward_logits_and_aux_match_reference(arch):
    (cfg_j, rc_j, japi, jp), (cfg_t, rc_t, tapi, tp) = _models(arch)
    toks = _tokens(64)
    lj, auxj = jtransformer.forward(jp, jnp.asarray(toks), cfg_j, rc_j)
    with torch.no_grad():
        lt, auxt = transformer.forward(tp, torch.from_numpy(toks).long(), cfg_t, rc_t)
    assert lt.shape == (B, 64, cfg_t.vocab)
    assert np.abs(_np(lt) - _np(lj)).max() < F32_TOL
    assert abs(float(auxt) - float(auxj)) < 1e-6
    assert (float(auxt) > 0) == (cfg_t.family == "moe")


@pytest.mark.parametrize("arch,dtype,bits", [
    ("mixtral-8x7b", "float32", 16), ("mixtral-8x7b", "float32", 8),
    ("mixtral-8x7b", "float32", 4), ("grok-1-314b", "float32", 8),
    ("mamba2-130m", "float32", 16), ("hymba-1.5b", "float32", 16),
    ("hymba-1.5b", "float32", 8), ("hymba-1.5b", "float32", 4),
    ("mixtral-8x7b", "bfloat16", 8), ("mamba2-130m", "bfloat16", 16),
    ("hymba-1.5b", "bfloat16", 8)])
def test_prefill_and_decode_match_reference(arch, dtype, bits):
    """A 32-token prefill, then 12 teacher-forced decode steps from a fresh
    state (a MoE decode step at batch 2 has capacity 1 an expert)."""
    (_, _, japi, jp), (cfg_t, rc_t, tapi, tp) = _models(arch, dtype, bits)
    toks = _tokens(32, seed=5)
    lj = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
    lt = tapi.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert lt.shape == (B, cfg_t.vocab) and lt.dtype == rc_t.torch_dtype
    ok, err = _close(lt, lj, dtype)
    assert ok, ("prefill", err)
    sj, st = japi.init_decode_state(B), tapi.init_decode_state(B)
    step = jax.jit(japi.decode_step)
    for i in range(12):
        gj, sj = step(jp, sj, jnp.asarray(toks[:, i]))
        gt, st = tapi.decode_step(tp, st, torch.from_numpy(toks[:, i]).long())
        ok, err = _close(gt, gj, dtype)
        assert ok, ("decode step", i, err)
    assert st.pos.tolist() == [12] * B
    if cfg_t.family in ("ssm", "hybrid"):
        tol = F32_TOL if dtype == "float32" else BF16_REL * np.abs(_np(sj.caches.ssm.h)).max()
        for i, c in enumerate(st.caches):
            assert np.abs(_np(c.ssm.h) - _np(sj.caches.ssm.h[i])).max() < tol


@pytest.mark.parametrize("arch", ARCHES)
def test_generate_tokens_match_reference(arch):
    """100 decode steps at seq_len 128: the windowed models' 64-slot ring
    wraps; prompts of 61 and 40 tokens, 40 new each."""
    (cfg_j, rc_j, _, jp), (cfg_t, rc_t, _, tp) = _models(arch, bits=8, seq_len=128)
    toks = _tokens(61, seed=6)
    prompts = [toks[0].tolist(), toks[1, :40].tolist()]
    te = ServeEngine(cfg_t, rc_t, params=tp, device="cpu")
    if cfg_t.sliding_window:
        state = transformer.init_decode_state(cfg_t, rc_t, B, "cpu")
        assert state.caches[0].kv.k.shape[1] == cfg_t.sliding_window == 64
    gt = te.generate(prompts, max_new=40)
    gj = JEngine(cfg_j, rc_j, params=jp).generate(prompts, max_new=40)
    assert gt == gj and [len(g) for g in gt] == [40, 40]


@pytest.mark.parametrize("arch", ARCHES)
def test_loss_and_grads_match_reference(arch):
    """loss_fn (moe: + 0.01 aux) and every gradient, without and with remat."""
    (cfg_j, _, _, jp), (cfg_t, _, _, tp) = _models(arch)
    kw = dict(seq_len=32, global_batch=B, kind="train", param_dtype="float32",
              q_block=16, kv_block=16)
    toks, labels = _tokens(32, seed=7), _tokens(32, seed=8)
    japi = jzoo.get_api(cfg_j, jbase.RunConfig(remat=False, **kw))
    lj, gj = jax.jit(jax.value_and_grad(japi.loss_fn))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    leaves = {}
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        keys = [k.name for k in path]
        if keys[0] == "layers":
            for i in range(cfg_t.n_layers):
                leaves[".".join(["layers", str(i), *keys[1:]])] = np.asarray(g)[i]
        else:
            leaves[".".join(keys)] = np.asarray(g)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    for remat in (False, True):
        for p in tp.parameters():
            p.grad = None
        api = model_zoo.get_api(cfg_t, tbase.RunConfig(remat=remat, **kw), "cpu")
        lt = api.loss_fn(tp, batch)
        lt.backward()
        assert abs(float(lt.detach()) - float(lj)) < 1e-5 * abs(float(lj)), remat
        named = dict(tp.named_parameters())
        assert named.keys() == leaves.keys()
        for name, p in named.items():
            want = leaves[name]
            err = np.abs(_np(p.grad) - want).max() / max(np.abs(want).max(), 1e-30)
            assert err < GRAD_REL, (remat, name, err)


# -- the reference's scenarios (tests/test_models.py) through the port --------------

def _decode_all(api, params, toks, state=None):
    state = state or api.init_decode_state(toks.shape[0])
    out = []
    for i in range(toks.shape[1]):
        lg, state = api.decode_step(params, state, torch.from_numpy(toks[:, i]).long())
        out.append(_np(lg))
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_decode_matches_teacher_forcing(arch):
    _, (cfg_t, rc_t, api, tp) = _models(arch, seq_len=32)
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, (2, 16)).astype(np.int32)
    with torch.no_grad():
        full, _ = transformer.forward(tp, torch.from_numpy(toks).long(), cfg_t, rc_t)
    errs = np.abs(_decode_all(api, tp, toks) - _np(full)).max(axis=(0, 2))
    assert errs.max() < 2e-2, errs


def test_moe_decode_matches_with_no_drop_capacity():
    _, (cfg_t, rc_t, api, tp) = _models("mixtral-8x7b", seq_len=32,
                                        capacity_factor=8.0)
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, (2, 12)).astype(np.int32)
    with torch.no_grad():
        full, _ = transformer.forward(tp, torch.from_numpy(toks).long(), cfg_t, rc_t)
    errs = np.abs(_decode_all(api, tp, toks) - _np(full)).max(axis=(0, 2))
    assert errs.max() < 2e-4, errs


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "hymba-1.5b"])
def test_sliding_window_ring_cache_equals_full_cache(arch):
    """Window 8, 24 steps: the 8-slot ring (wrapped twice) against a
    32-slot cache read through the window mask.  ``init_decode_state`` sizes
    the cache min(seq_len, window), so the reference's test compares two
    rings; here the full cache is shaped without the window."""
    _, (cfg_t, rc_t, api, tp) = _models(arch, seq_len=32, capacity_factor=8.0,
                                        sliding_window=8)
    rc_t = dataclasses.replace(rc_t, global_batch=1)
    toks = np.random.default_rng(3).integers(0, 256, (1, 24)).astype(np.int32)
    ring = api.init_decode_state(1)
    full = transformer.init_decode_state(
        dataclasses.replace(cfg_t, sliding_window=0), rc_t, 1, "cpu")
    assert ring.caches[0].kv.k.shape[1] == 8 and full.caches[0].kv.k.shape[1] == 32
    got, want = _decode_all(api, tp, toks, ring), _decode_all(api, tp, toks, full)
    assert np.abs(got - want).max() < 2e-4
