"""The port's encoder-decoder family (CPU) against the JAX package.

whisper-tiny's smoke config (2 + 2 layers, d_model 128, 4 heads of 32,
enc_seq 64), weights carried over from JAX by ``convert.params_from_jax``,
inputs drawn from seeded numpy: ``layers.cross_attention`` alone,
``encode``, ``decoder_forward`` and ``prefill`` logits, ``decode_step`` at
bits 16, 8 and 4 from the zero state and from seeded non-zero cross K/V
(the reference's serve path never fills them, so zeros alone would hide a
wrong decode cross-attention), ``generate`` tokens, ``loss_fn`` and every
gradient with and without remat, 3 train steps against the reference's
``make_train_step``, ``adamw.stacked_rank`` on the ``enc_layers.`` and
``dec_layers.`` prefixes, checkpoints across the packages, the parameter
tree at whisper-tiny's full size, and ``kv_cache_bytes`` against the
state's shapes.

Tolerances, as tests/test_torch_families.py: f32 logits within 1e-4,
greedy tokens identical, each gradient leaf within 1e-4 of its largest
magnitude, the loss within 1e-5 relative; bf16 within 3e-2 of the largest
reference value (XLA and PyTorch round bf16 at other places, ROADMAP
Queue 3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeEngine as JEngine
from repro.train import step as jstep_mod
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.models import encdec, layers, model_zoo
from repro_torch.optim import adamw
from repro_torch.serve import ServeEngine
from repro_torch.train import step as tstep_mod

ARCH = "whisper-tiny"
B = 2
F32_TOL, BF16_REL, GRAD_REL = 1e-4, 3e-2, 1e-4


def _np(a):
    if isinstance(a, torch.Tensor):
        return convert.to_numpy(a).astype(np.float32)
    return np.asarray(a, dtype=np.float32)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _close(got, want, dtype):
    err, top = np.abs(_np(got) - _np(want)).max(), np.abs(_np(want)).max()
    return (err < F32_TOL if dtype == "float32" else err < BF16_REL * top), err


def _models(dtype="float32", bits=16, seq_len=64, remat=False):
    cfg_j, cfg_t = jbase.load_smoke(ARCH), tbase.load_smoke(ARCH)
    kw = dict(seq_len=seq_len, global_batch=B, kind="decode", param_dtype=dtype,
              kv_cache_bits=bits, q_block=16, kv_block=16, remat=remat)
    rc_j, rc_t = jbase.RunConfig(**kw), tbase.RunConfig(**kw)
    japi = jzoo.get_api(cfg_j, rc_j)
    jp = japi.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg_t, "cpu")
    return ((cfg_j, rc_j, japi, jp),
            (cfg_t, rc_t, model_zoo.get_api(cfg_t, rc_t, "cpu"), tp))


def _tokens(n, seed=0, batch=B):
    return np.random.default_rng(seed).integers(0, 256, (batch, n)).astype(np.int32)


def _frames(cfg, seed=1, dtype="float32", batch=B):
    """Stub frame embeddings at the pipeline's scale, in the model dtype
    (the same values on both sides)."""
    x = (np.random.default_rng(seed).standard_normal((batch, cfg.enc_seq, cfg.d_model))
         * 0.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return jx, convert.to_torch(np.asarray(jx), "cpu")


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


# -- cross-attention ------------------------------------------------------------

@pytest.mark.parametrize("dtype,S,M", [("float32", 32, 64), ("float32", 7, 64),
                                       ("float32", 16, 40), ("bfloat16", 32, 64)])
def test_cross_attention_matches_reference(dtype, S, M):
    """Queries of layer 0's cross-attention against a memory of M rows: the
    blocked path (16-row blocks) and, at S = 7 or M = 40, the single block
    the reference takes for ragged shapes."""
    (cfg_j, _, _, jp), (cfg_t, _, _, tp) = _models(dtype)
    rng = np.random.default_rng(3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, mem = (jnp.asarray(rng.standard_normal((B, n, cfg_j.d_model)), jdt)
              for n in (S, M))
    oj = jlayers.cross_attention(x, mem, _layer(jp.dec_layers.cross_attn), cfg_j, 16, 16)
    with torch.no_grad():
        ot = layers.cross_attention(convert.to_torch(np.asarray(x), "cpu"),
                                    convert.to_torch(np.asarray(mem), "cpu"),
                                    tp.dec_layers[0].cross_attn, cfg_t, 16, 16)
    assert ot.shape == (B, S, cfg_t.d_model) and ot.dtype == tp.embed.table.dtype
    ok, err = _close(ot, oj, dtype)
    assert ok, err


# -- the encoder and the decoder --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    (cfg_j, rc_j, _, jp), (cfg_t, rc_t, _, tp) = _models(dtype)
    fj, ft = _frames(cfg_j, dtype=dtype)
    mj = jencdec.encode(jp, fj, cfg_j, rc_j)
    with torch.no_grad():
        mt = encdec.encode(tp, ft, cfg_t, rc_t)
    assert mt.shape == (B, cfg_t.enc_seq, cfg_t.d_model)
    ok, err = _close(mt, mj, dtype)
    assert ok, err


@pytest.mark.parametrize("dtype,S", [("float32", 32), ("float32", 31),
                                     ("bfloat16", 32)])
def test_decoder_forward_and_prefill_match_reference(dtype, S):
    """Full logits of the decoder on the encoder's memory, and the prefill's
    last-position logits; S = 31 is the pipeline's odd decoder length (a
    single block on the CPU)."""
    (cfg_j, rc_j, japi, jp), (cfg_t, rc_t, tapi, tp) = _models(dtype)
    fj, ft = _frames(cfg_j, seed=2, dtype=dtype)
    toks = _tokens(S, seed=4)
    mj = jencdec.encode(jp, fj, cfg_j, rc_j)
    lj = jencdec.decoder_forward(jp, jnp.asarray(toks), mj, cfg_j, rc_j)
    with torch.no_grad():
        mt = encdec.encode(tp, ft, cfg_t, rc_t)
        lt = encdec.decoder_forward(tp, torch.from_numpy(toks).long(), mt, cfg_t, rc_t)
    assert lt.shape == (B, S, cfg_t.vocab)
    ok, err = _close(lt, lj, dtype)
    assert ok, ("forward", err)
    pj = japi.prefill(jp, {"frames": fj, "tokens": jnp.asarray(toks)})
    pt = tapi.prefill(tp, {"frames": ft, "tokens": torch.from_numpy(toks).long()})
    assert pt.shape == (B, cfg_t.vocab) and pt.dtype == rc_t.torch_dtype
    ok, err = _close(pt, pj, dtype)
    assert ok, ("prefill", err)


# -- decode -----------------------------------------------------------------------

def _seeded_cross(sj, st, seed=5):
    """The same seeded cross K/V in both states, in the reference's layout
    (L, B, enc_seq, KV, hd) and the model dtype."""
    rng = np.random.default_rng(seed)
    ck, cv = (jnp.asarray(rng.standard_normal(sj.cross_k.shape), sj.cross_k.dtype)
              for _ in range(2))
    st.cross_k.copy_(convert.to_torch(np.asarray(ck), "cpu"))
    st.cross_v.copy_(convert.to_torch(np.asarray(cv), "cpu"))
    return sj._replace(cross_k=ck, cross_v=cv)


@pytest.mark.parametrize("dtype,bits,cross", [
    ("float32", 16, "zero"), ("float32", 8, "zero"), ("float32", 4, "zero"),
    ("float32", 16, "seeded"), ("float32", 8, "seeded"), ("float32", 4, "seeded"),
    ("bfloat16", 16, "seeded"), ("bfloat16", 8, "seeded")])
def test_decode_step_matches_reference(dtype, bits, cross):
    """12 teacher-forced decode steps from a fresh state, its cross K/V
    zero (the reference's serve path) or seeded noise."""
    (_, _, japi, jp), (cfg_t, _, tapi, tp) = _models(dtype, bits)
    toks = _tokens(12, seed=6)
    sj, st = japi.init_decode_state(B), tapi.init_decode_state(B)
    assert tuple(st.cross_k.shape) == sj.cross_k.shape
    assert st.cross_k.data_ptr() != st.cross_v.data_ptr()
    if cross == "seeded":
        sj = _seeded_cross(sj, st)
    step = jax.jit(japi.decode_step)
    for i in range(12):
        gj, sj = step(jp, sj, jnp.asarray(toks[:, i]))
        gt, st = tapi.decode_step(tp, st, torch.from_numpy(toks[:, i]).long())
        assert gt.shape == (B, cfg_t.vocab)
        ok, err = _close(gt, gj, dtype)
        assert ok, ("decode step", i, err)
    assert st.pos.tolist() == [12] * B
    for i, kv in enumerate(st.self_kv):
        for name in ("k", "v", "k_scale", "v_scale"):
            got, want = getattr(kv, name), getattr(sj.self_kv, name)
            if got is None:
                assert want is None
                continue
            if dtype == "float32" and bits == 16:
                assert np.abs(_np(got) - _np(want[i])).max() < F32_TOL, (i, name)


def test_seeded_cross_kv_moves_the_logits():
    """The seeded cross K/V change every decode step's logits (the check
    above would pass on a decode that ignored them only by accident)."""
    (_, _, japi, jp), (_, _, tapi, tp) = _models()
    toks = torch.from_numpy(_tokens(1, seed=7)[:, 0]).long()
    zero = tapi.init_decode_state(B)
    seeded = tapi.init_decode_state(B)
    _seeded_cross(japi.init_decode_state(B), seeded)
    a, _ = tapi.decode_step(tp, zero, toks)
    b, _ = tapi.decode_step(tp, seeded, toks)
    assert np.abs(_np(a) - _np(b)).max() > 1e-2


@pytest.mark.parametrize("bits", [16, 8])
def test_generate_tokens_match_reference(bits):
    """``ServeEngine.generate`` on both packages: prompts of 20 and 9
    tokens, 24 new each (zero cross K/V, as the reference serves)."""
    (cfg_j, rc_j, _, jp), (cfg_t, rc_t, _, tp) = _models(bits=bits)
    toks = _tokens(20, seed=8)
    prompts = [toks[0].tolist(), toks[1, :9].tolist()]
    gt = ServeEngine(cfg_t, rc_t, params=tp, device="cpu").generate(prompts, max_new=24)
    gj = JEngine(cfg_j, rc_j, params=jp).generate(prompts, max_new=24)
    assert gt == gj and [len(g) for g in gt] == [24, 24]


# -- the state ----------------------------------------------------------------------

@pytest.mark.parametrize("bits", [16, 8, 4])
def test_kv_cache_bytes_counts_every_leaf(bits):
    """The self-attention caches with their scales and the two cross
    tensors, from the shapes (the reference's count reads a field its
    encoder-decoder state has not, so there is no reference number)."""
    cfg = tbase.load_smoke(ARCH)
    rc = tbase.RunConfig(seq_len=48, global_batch=3, kind="decode",
                         kv_cache_bits=bits)
    L, S, KV, hd = cfg.n_layers, rc.seq_len, cfg.n_kv_heads, cfg.hd
    if bits == 16:
        self_kv = 2 * 3 * S * KV * hd * 2
    else:
        self_kv = 2 * 3 * S * KV * (hd if bits == 8 else hd // 2) + 2 * 3 * S * KV * 4
    cross = 2 * L * 3 * cfg.enc_seq * KV * hd * 2
    engine = ServeEngine(cfg, rc, device="cpu")
    assert engine.kv_cache_bytes(3) == L * self_kv + cross
    state = engine.api.init_decode_state(3)
    assert engine.kv_cache_bytes(3) == sum(t.numel() * t.element_size()
                                           for t in encdec.cache_leaves(state))


def test_reset_decode_state_zeroes_in_place():
    """Every leaf of a used state back to ``init_decode_state``'s zeros, in
    the same tensors (a CUDA graph captured on them stays valid)."""
    _, (cfg_t, rc_t, tapi, tp) = _models(bits=8)
    state = tapi.init_decode_state(B)
    _seeded_cross(jzoo.get_api(jbase.load_smoke(ARCH), jbase.RunConfig(
        seq_len=64, global_batch=B, kind="decode", param_dtype="float32",
        kv_cache_bits=8)).init_decode_state(B), state)
    for t in _tokens(3, seed=9).T:
        _, state = tapi.decode_step(tp, state, torch.from_numpy(t).long())
    leaves = list(tapi.cache_leaves(state)) + [state.pos]
    assert all(bool(t.abs().sum() > 0) for t in leaves)
    ptrs = [t.data_ptr() for t in leaves]
    reset = tapi.reset_decode_state(state)
    got = list(tapi.cache_leaves(reset)) + [reset.pos]
    want = list(tapi.cache_leaves(tapi.init_decode_state(B))) + [state.pos.new_zeros(B)]
    assert [t.data_ptr() for t in got] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- training ------------------------------------------------------------------------

def _grad_leaves(gj, cfg):
    """The reference's gradient tree as the port's parameter names."""
    leaves = {}
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        keys = [k.name for k in path]
        n = {"enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers}.get(keys[0])
        if n is None:
            leaves[".".join(keys)] = np.asarray(g)
            continue
        for i in range(n):
            leaves[".".join([keys[0], str(i), *keys[1:]])] = np.asarray(g)[i]
    return leaves


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    """loss_fn and every gradient (the reference without remat)."""
    (cfg_j, _, _, jp), (cfg_t, _, _, tp) = _models()
    kw = dict(seq_len=32, global_batch=B, kind="train", param_dtype="float32",
              q_block=16, kv_block=16)
    fj, ft = _frames(cfg_j, seed=10)
    toks, labels = _tokens(31, seed=11), _tokens(31, seed=12)
    japi = jzoo.get_api(cfg_j, jbase.RunConfig(remat=False, **kw))
    lj, gj = jax.jit(jax.value_and_grad(japi.loss_fn))(
        jp, {"frames": fj, "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    leaves = _grad_leaves(gj, cfg_t)
    api = model_zoo.get_api(cfg_t, tbase.RunConfig(remat=remat, **kw), "cpu")
    lt = api.loss_fn(tp, {"frames": ft, "tokens": torch.from_numpy(toks).long(),
                          "labels": torch.from_numpy(labels).long()})
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) < 1e-5 * abs(float(lj))
    named = dict(tp.named_parameters())
    assert named.keys() == leaves.keys()
    for name, p in named.items():
        want = leaves[name]
        err = np.abs(_np(p.grad) - want).max() / max(np.abs(want).max(), 1e-30)
        assert err < GRAD_REL, (name, err)


def _configs(**kw):
    kw = {"seq_len": 32, "global_batch": 2, "kind": "train", "q_block": 16,
          "kv_block": 16, **kw}
    return ((jbase.load_smoke(ARCH), jbase.RunConfig(**kw)),
            (tbase.load_smoke(ARCH), tbase.RunConfig(**kw)))


def _assert_states_equal(ts, js):
    flat_t = ckpt.flatten(tstep_mod.checkpoint_tree(ts))
    flat_j = jax.tree_util.tree_flatten_with_path(js)[0]
    assert [p for p, _ in flat_t] == [jax.tree_util.keystr(k) for k, _ in flat_j]
    for (path, leaf), (_, ref) in zip(flat_t, flat_j):
        got = torch.stack(leaf.parts) if isinstance(leaf, ckpt.Stacked) else leaf
        assert np.array_equal(_bits(got), _bits(ref)), path


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_trajectory_matches_reference(remat):
    """3 AdamW steps on the pipeline's batches (frames, and at seq_len 31 a
    decoder length ragged against the 16-row blocks): a missed weight decay
    of the stacked norms would move the loss from the second step on."""
    (cj, rj), (ct, rt) = _configs(param_dtype="float32", lr=1e-2, seq_len=31,
                                  weight_decay=0.1, remat=remat)
    japi, tapi = jzoo.get_api(cj, rj), model_zoo.get_api(ct, rt, "cpu")
    js = jstep_mod.init_state(japi, rj, jax.random.PRNGKey(0))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), ct, "cpu")
    _assert_states_equal(ts, js)
    jstep = jax.jit(jstep_mod.make_train_step(japi, cj, rj))
    tstep = tstep_mod.make_train_step(tapi, ct, rt)
    pj, pt = jpipe.SyntheticPipeline(cj, rj), tpipe.SyntheticPipeline(ct, rt)
    ops.reset_launch_counts()
    for _ in range(3):
        bj, bt = pj.next(), pt.next()
        assert bt["frames"].shape == (2, ct.enc_seq, ct.d_model)
        assert bt["tokens"].shape == (2, 31)
        js, mj = jstep(js, jpipe.device_batch(bj, cj, rj))
        ts, mt = tstep(ts, tpipe.device_batch(bt, ct, rt, "cpu"))
        assert abs(float(mt["loss"]) - float(mj["loss"])) < 1e-5 * float(mj["loss"])
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) < \
            1e-4 * float(mj["grad_norm"])
    assert int(ts.step) == int(js.step) == 3 and int(ts.opt.count) == 3
    assert all(v == 0 for v in ops.launch_counts().values())   # CPU: no kernel
    named = dict(ts.params.named_parameters())
    for name, want in (("enc_layers.1.ln2", np.asarray(js.params.enc_layers.ln2)[1]),
                       ("dec_layers.0.ln_x", np.asarray(js.params.dec_layers.ln_x)[0]),
                       ("enc_norm", np.asarray(js.params.enc_norm))):
        assert np.abs(_np(named[name]) - want).max() < 1e-5, name


def test_stacked_rank_decays_the_stacked_norms():
    """Every layer's ln1, ln2 and ln_x is (L, d) once stacked: the reference
    decays them, and so does the port; ``enc_norm`` and
    ``embed.final_norm`` are (d,) and are not decayed."""
    (cj, rj), (ct, _) = _configs(param_dtype="float32")
    jp = jzoo.get_api(cj, rj).init(jax.random.PRNGKey(3))
    tp = dict(convert.params_from_jax(jax.tree.map(np.asarray, jp), ct,
                                      "cpu").named_parameters())
    acfg = dict(lr=1e-2, weight_decay=0.5, warmup_steps=0)
    jp2, _ = jadamw.update(jax.tree.map(jnp.zeros_like, jp),
                           jadamw.init(jp, jadamw.AdamConfig(**acfg)), jp,
                           jadamw.AdamConfig(**acfg))
    before = {n: p.detach().clone() for n, p in tp.items()}
    adamw.update({n: torch.zeros_like(p) for n, p in tp.items()},
                 adamw.init(tp, adamw.AdamConfig(**acfg)), tp,
                 adamw.AdamConfig(**acfg))
    norms = [(s, f, i) for s, fields, n in (("enc_layers", ("ln1", "ln2"), ct.enc_layers),
                                            ("dec_layers", ("ln1", "ln_x", "ln2"), ct.n_layers))
             for f in fields for i in range(n)]
    for stack, f, i in norms:
        name = f"{stack}.{i}.{f}"
        assert tp[name].dim() == 1 and adamw.stacked_rank(name, tp[name]) == 2
        assert not torch.equal(tp[name], before[name]), name        # decayed
        assert np.array_equal(_np(tp[name]),
                              np.asarray(getattr(getattr(jp2, stack), f))[i]), name
    for name, ref in (("enc_norm", jp2.enc_norm), ("embed.final_norm",
                                                   jp2.embed.final_norm)):
        assert adamw.stacked_rank(name, tp[name]) == 1
        assert torch.equal(tp[name], before[name]), name              # not decayed
        assert np.array_equal(_np(tp[name]), np.asarray(ref)), name
    for name, p in tp.items():                       # and every other leaf
        assert adamw.stacked_rank(name, p) == p.dim() + name.startswith(
            ("enc_layers.", "dec_layers.")), name


def test_parameter_tree_matches_reference_at_full_size():
    """whisper-tiny at its published size: the port's parameters are the
    reference's leaves (paths in order, shapes, dtypes), and their count is
    ``param_count()`` plus ``enc_norm``'s d_model, which the formula leaves
    out."""
    cj, ct = jbase.load_arch(ARCH), tbase.load_arch(ARCH)
    rc = tbase.RunConfig(seq_len=448, global_batch=1, kind="train")
    tp = model_zoo.get_api(ct, rc, "cpu").init(0)
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: jencdec.init(jax.random.PRNGKey(0), cj, jnp.bfloat16)))[0]
    flat = ckpt.flatten(tstep_mod.reference_tree(dict(tp.named_parameters())))
    assert [p for p, _ in flat] == [jax.tree_util.keystr(k) for k, _ in want]
    assert ".dec_layers.cross_attn.wq" in [p for p, _ in flat]
    for (_, leaf), (_, ref) in zip(flat, want):
        got = torch.stack(leaf.parts) if isinstance(leaf, ckpt.Stacked) else leaf
        assert tuple(got.shape) == ref.shape and got.dtype == torch.bfloat16
    n = sum(p.numel() for p in tp.parameters())
    assert ct.param_count() == 36_439_296 and n == ct.param_count() + ct.d_model


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoints_cross_between_the_packages(dtype, tmp_path):
    """A state after two reference steps: the reference's checkpoint
    restores into a fresh port state bit for bit, and the port's
    checkpoint of that state restores into the reference bit for bit."""
    (cj, rj), (ct, rt) = _configs(param_dtype=dtype, lr=1e-2)
    japi = jzoo.get_api(cj, rj)
    js = jstep_mod.init_state(japi, rj, jax.random.PRNGKey(0))
    step = jax.jit(jstep_mod.make_train_step(japi, cj, rj))
    pipe = jpipe.SyntheticPipeline(cj, rj)
    for _ in range(2):
        js, _ = step(js, jpipe.device_batch(pipe.next(), cj, rj))
    JManager(str(tmp_path / "j"), async_save=False).save(2, js, extra={"data_step": 2})
    ts = tstep_mod.init_state(model_zoo.get_api(ct, rt, "cpu"), rt, seed=9)
    _, extra = CheckpointManager(str(tmp_path / "j")).restore(
        2, tstep_mod.checkpoint_tree(ts))
    assert extra == {"data_step": 2} and int(ts.step) == 2
    _assert_states_equal(ts, js)
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(
        2, tstep_mod.checkpoint_tree(ts), extra={"data_step": 2})
    out, extra = JManager(str(tmp_path / "t")).restore(
        2, jstep_mod.abstract_state(japi, rj))
    assert extra == {"data_step": 2}
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_restored_state_trains_like_the_reference(tmp_path):
    """The port, restored from the reference's checkpoint, takes its next
    step as the reference does (f32: loss within 1e-5 relative)."""
    (cj, rj), (ct, rt) = _configs(param_dtype="float32", lr=1e-2)
    japi = jzoo.get_api(cj, rj)
    js = jstep_mod.init_state(japi, rj, jax.random.PRNGKey(1))
    jstep = jax.jit(jstep_mod.make_train_step(japi, cj, rj))
    pj, pt = jpipe.SyntheticPipeline(cj, rj), tpipe.SyntheticPipeline(ct, rt)
    js, _ = jstep(js, jpipe.device_batch(pj.next(), cj, rj))
    pt.next()
    JManager(str(tmp_path), async_save=False).save(1, js)
    tapi = model_zoo.get_api(ct, rt, "cpu")
    ts = tstep_mod.init_state(tapi, rt, seed=5)
    CheckpointManager(str(tmp_path)).restore(1, tstep_mod.checkpoint_tree(ts))
    js, mj = jstep(js, jpipe.device_batch(pj.next(), cj, rj))
    ts, mt = tstep_mod.make_train_step(tapi, ct, rt)(
        ts, tpipe.device_batch(pt.next(), ct, rt, "cpu"))
    assert abs(float(mt["loss"]) - float(mj["loss"])) < 1e-5 * float(mj["loss"])
