"""The port's serving path (CPU) against the JAX package, at smoke size.

Configs, layers (rmsnorm, rope, mlp), ``prefill`` and ``decode_step``
logits, ``ServeEngine.generate`` tokens, ``kv_cache_bytes`` and the
``serve/*`` series, with weights carried over from JAX by
``convert.params_from_jax``.  On CPU tensors attention runs the blockwise
path and the packed cache the kvpack kernels' plain versions; the card's
kernels are held against those by ``chip_smoke.py``.

Tolerances: f32 logits within 1e-4 with identical greedy tokens.  bf16
logits within 3e-2 of the largest reference logit (the relative form of
tests/test_flash_attention.py:73-75), except with the int4 cache, which
has its own test below.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import obs as jobs
from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.models import layers, model_zoo, transformer
from repro_torch.serve import ServeEngine

ARCH = "granite-8b"
B, PROMPT, STEPS = 2, 16, 10

BF16_REL = 3e-2   # relative to the largest reference logit

def _np(a):
    if isinstance(a, torch.Tensor):
        return convert.to_numpy(a).astype(np.float32)
    return np.asarray(a, dtype=np.float32)


def _models(dtype, bits, arch=ARCH, seq_len=64):
    cfg_j, cfg_t = jbase.load_smoke(arch), tbase.load_smoke(arch)
    kw = dict(seq_len=seq_len, global_batch=B, kind="decode", param_dtype=dtype,
              kv_cache_bits=bits, q_block=8, kv_block=8)
    rc_j, rc_t = jbase.RunConfig(**kw), tbase.RunConfig(**kw)
    japi = jzoo.get_api(cfg_j, rc_j)
    jp = japi.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg_t, "cpu")
    return (cfg_j, rc_j, japi, jp), (cfg_t, rc_t, model_zoo.get_api(cfg_t, rc_t, "cpu"), tp)


def _tokens(n=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, n)).astype(np.int32)


def _close(a, b, dtype):
    err = np.abs(_np(a) - _np(b)).max()
    if dtype == "float32":
        return err < 1e-4, err
    return err < BF16_REL * np.abs(_np(b)).max(), err


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_equal_reference(arch):
    for load in ("load_arch", "load_smoke"):
        cj, ct = getattr(jbase, load)(arch), getattr(tbase, load)(arch)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()
    assert tbase.run_config_for("decode_32k", tbase.load_arch(arch)) == \
        tbase.RunConfig(**dataclasses.asdict(
            jbase.run_config_for("decode_32k", jbase.load_arch(arch))))
    assert tbase.ARCH_IDS == jbase.ARCH_IDS and tbase.SHAPES == jbase.SHAPES


@pytest.mark.parametrize("load", ["load_arch", "load_smoke"])
def test_get_api_builds_encdec_and_transformer_refuses_it(load):
    """``get_api`` builds whisper-tiny on the CPU (the encoder-decoder
    module); the decoder-only functions of ``transformer`` refuse its config."""
    cfg = getattr(tbase, load)("whisper-tiny")
    rc = tbase.RunConfig(seq_len=16, global_batch=1, kind="decode")
    api = model_zoo.get_api(cfg, rc, "cpu")
    state = api.init_decode_state(1)
    assert tuple(state.cross_k.shape) == (cfg.n_layers, 1, cfg.enc_seq,
                                          cfg.n_kv_heads, cfg.hd)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: transformer.init(gen, cfg),
                 lambda: transformer.init_decode_state(cfg, rc, 1, "cpu"),
                 lambda: transformer.check_family(cfg)):
        with pytest.raises(ValueError, match="encoder-decoder model"):
            call()


# -- layers --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((2, 5, 64)) * 3, jdt)
    w = jnp.asarray(rng.standard_normal(64), jdt)
    yj = jlayers.rmsnorm(x, w, 1e-5)
    yt = layers.rmsnorm(convert.to_torch(np.asarray(x), "cpu"),
                        convert.to_torch(np.asarray(w), "cpu"), 1e-5)
    assert np.abs(_np(yt) - _np(yj)).max() < (1e-5 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("shape", [(2, 7, 16), (2, 7, 4, 32), (1, 3, 2, 2, 8)])
def test_rope(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4096, shape[:2]).astype(np.int32)
    yj = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    yt = layers.rope(convert.to_torch(x, "cpu"), convert.to_torch(pos, "cpu"), 1e4)
    # angles up to 4096 rad: the libraries' f32 sin/cos of large arguments
    # differ in the last bits, hence 1e-4 and not the 1e-5 of rmsnorm
    assert np.abs(_np(yt) - _np(yj)).max() < 1e-4


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(3)
    d, ff = 32, 64
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((d, ff), (d, ff), (ff, d))]
    pj = jlayers.MlpParams(w_gate=jnp.asarray(w[0]) if act == "swiglu" else None,
                           w_up=jnp.asarray(w[1]), w_down=jnp.asarray(w[2]))
    pt = layers.MlpParams(w_gate=torch.from_numpy(w[0]) if act == "swiglu" else None,
                          w_up=torch.from_numpy(w[1]), w_down=torch.from_numpy(w[2]))
    yj = jlayers.mlp(jnp.asarray(x), pj, act)
    yt = layers.mlp(torch.from_numpy(x), pt, act)
    assert np.abs(_np(yt) - _np(yj)).max() < 1e-5


# -- the model and the engine -------------------------------------------------

def _decode_both(jside, tside, toks):
    """Teacher-forced decode on both sides: per-step logits and final states."""
    (_, _, japi, jp), (_, _, tapi, tp) = jside, tside
    sj, st = japi.init_decode_state(B), tapi.init_decode_state(B)
    step = jax.jit(japi.decode_step)
    out = []
    for i in range(STEPS):
        gj, sj = step(jp, sj, jnp.asarray(toks[:, i]))
        gt, st = tapi.decode_step(tp, st, torch.from_numpy(toks[:, i]).long())
        out.append((gj, gt))
    assert st.pos.tolist() == [STEPS] * B
    return out, sj, st


@pytest.mark.parametrize("dtype,bits", [
    ("float32", 16), ("float32", 8), ("float32", 4),
    ("bfloat16", 16), ("bfloat16", 8)])
def test_prefill_and_decode_match_reference(dtype, bits):
    jside, tside = _models(dtype, bits)
    (_, _, japi, jp), (cfg_t, rc_t, tapi, tp) = jside, tside
    toks = _tokens()
    lj = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
    lt = tapi.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert lt.shape == (B, cfg_t.vocab) and lt.dtype == rc_t.torch_dtype
    ok, err = _close(lt, lj, dtype)
    assert ok, ("prefill", err)
    steps, _, _ = _decode_both(jside, tside, toks)
    for i, (gj, gt) in enumerate(steps):
        ok, err = _close(gt, gj, dtype)
        assert ok, ("decode step", i, err)


def test_bf16_int4_decode_matches_reference_within_quantization():
    """bf16 with the int4 cache: 3e-2 cannot hold across frameworks.

    A code computed from bf16 values often sits on a rounding tie, one int4
    step is 1/7 of a row's maximum, and the reference rounds differently
    from the port in two places (ROADMAP Queue 3): under jit XLA computes
    ``amax / qmax`` as ``amax * (1 / qmax)``, and XLA's bf16 logistic is not
    the correctly rounded f32 sigmoid, so layer 1 onwards sees other bf16
    inputs.  So: layer 0, whose inputs are bit-identical, holds the kv rule
    of tests/test_kernels.py (one step at most, on <1% of entries), and the
    logits stay within half of what the int4 cache itself moves the
    reference's logits (its int4 run against its int8 run, same weights).
    """
    jside, tside = _models("bfloat16", 4)
    jside8, _ = _models("bfloat16", 8)
    toks = _tokens()
    steps, sj, st = _decode_both(jside, tside, toks)
    step8 = jax.jit(jside8[2].decode_step)
    s8 = jside8[2].init_decode_state(B)
    for i, (gj, gt) in enumerate(steps):
        g8, s8 = step8(jside8[3], s8, jnp.asarray(toks[:, i]))
        err = np.abs(_np(gt) - _np(gj)).max()
        quant = np.abs(_np(g8) - _np(gj)).max()
        assert err < 0.5 * quant, ("decode step", i, err, quant)
    kv, c = sj.caches.kv, st.caches[0].kv        # layer 0, the written slots
    for f in ("k", "v"):
        scale = np.asarray(getattr(kv, f + "_scale")[0])[:, :STEPS]
        yj = np.asarray(jlayers._dequant_rows(
            getattr(kv, f)[0][:, :STEPS], scale, 4))
        yt = _np(layers._dequant_rows(getattr(c, f)[:, :STEPS],
                                      getattr(c, f + "_scale")[:, :STEPS], 4))
        diff = np.abs(yt - yj)
        assert (diff <= scale + 1e-6).all(), (f, diff.max())
        assert (diff > 1e-6 * np.maximum(scale, 1)).mean() < 0.01


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_generate_tokens_match_reference(bits):
    (cfg_j, rc_j, _, jp), (cfg_t, rc_t, _, tp) = _models("float32", bits)
    prompts = [list(map(int, p)) for p in _tokens(12, seed=4)]
    prompts[1] = prompts[1][:5]
    gj = JEngine(cfg_j, rc_j, params=jp).generate(prompts, max_new=8)
    gt = ServeEngine(cfg_t, rc_t, params=tp, device="cpu").generate(prompts, max_new=8)
    assert gt == gj and [len(g) for g in gt] == [8, 8]


def test_forward_logits_match_reference():
    """Full (B, S, V) logits of ``forward``, multi-block prefill attention."""
    (cfg_j, rc_j, _, jp), (cfg_t, rc_t, _, tp) = _models("float32", 16)
    toks = _tokens()
    lj, _ = jtransformer.forward(jp, jnp.asarray(toks), cfg_j, rc_j)
    lt, aux = transformer.forward(tp, torch.from_numpy(toks).long(), cfg_t, rc_t)
    assert lt.shape == (B, PROMPT, cfg_t.vocab) and float(aux) == 0.0
    assert np.abs(_np(lt) - _np(lj)).max() < 1e-4


def test_vlm_prefill_with_prefix_matches_reference():
    (cfg_j, rc_j, japi, jp), (cfg_t, rc_t, tapi, tp) = _models(
        "float32", 16, arch="internvl2-76b")
    toks = _tokens(8)
    vis = np.random.default_rng(5).standard_normal(
        (B, cfg_t.n_vis_tokens, cfg_t.d_model)).astype(np.float32)
    lj = japi.prefill(jp, {"tokens": jnp.asarray(toks), "vis_embeds": jnp.asarray(vis)})
    lt = tapi.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                           "vis_embeds": torch.from_numpy(vis)})
    assert np.abs(_np(lt) - _np(lj)).max() < 1e-4


@pytest.mark.parametrize("arch,seq_len,bits,dtype,batch", [
    ("granite-8b", 64, 16, "bfloat16", 2), ("granite-8b", 256, 8, "bfloat16", 8),
    ("granite-8b", 256, 4, "float32", 3), ("mixtral-8x7b", 32768, 8, "bfloat16", 4),
    ("qwen1.5-110b", 4096, 16, "float32", 1), ("mamba2-130m", 256, 8, "bfloat16", 8),
    ("hymba-1.5b", 1280, 8, "bfloat16", 8), ("hymba-1.5b", 512, 16, "float32", 2)])
def test_kv_cache_bytes_equal_reference(arch, seq_len, bits, dtype, batch):
    """Counted on the meta device, so the full-size configs cost nothing."""
    kw = dict(seq_len=seq_len, global_batch=batch, kind="decode",
              param_dtype=dtype, kv_cache_bits=bits)
    cfg_j, cfg_t = jbase.load_arch(arch), tbase.load_arch(arch)
    je = JEngine.__new__(JEngine)
    je.cfg, je.rc, je._kv_bytes = cfg_j, jbase.RunConfig(**kw), {}
    je.api = jzoo.get_api(cfg_j, je.rc)
    te = ServeEngine.__new__(ServeEngine)
    te.cfg, te.rc, te._kv_bytes = cfg_t, tbase.RunConfig(**kw), {}
    assert te.kv_cache_bytes(batch) == je.kv_cache_bytes(batch)


def test_serve_series_equal_reference():
    """serve/* alike.  The port's packed cache also publishes kernels/kv_*
    series (its quantizer is the kvpack entry point; the reference's decode
    step runs the same arithmetic inline under jit, which records nothing)."""
    (cfg_j, rc_j, _, jp), (cfg_t, rc_t, _, tp) = _models("float32", 8)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    with jobs.enabled_scope() as (jreg, jtr):
        JEngine(cfg_j, rc_j, params=jp).generate(prompts, max_new=3)
    with tobs.enabled_scope() as (treg, ttr):
        ServeEngine(cfg_t, rc_t, params=tp, device="cpu").generate(prompts, max_new=3)
    js, ts = jreg.snapshot(), treg.snapshot()
    assert ts.gauges == js.gauges
    serve = {k: v for k, v in js.counters.items() if k.startswith("serve/")}
    assert {k: v for k, v in ts.counters.items() if k.startswith("serve/")} == serve
    assert set(ts.histograms) == set(js.histograms)
    assert [r.name for r in ttr.records if r.name.startswith("serve/")] == \
        [r.name for r in jtr.records if r.name.startswith("serve/")]


def test_generate_rejects_too_long():
    (_, _, _, _), (cfg_t, rc_t, _, tp) = _models("float32", 16, seq_len=16)
    with pytest.raises(ValueError, match="seq_len"):
        ServeEngine(cfg_t, rc_t, params=tp, device="cpu").generate([[1] * 10], max_new=8)
