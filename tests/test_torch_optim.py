"""The port's AdamW against the JAX package's, on the CPU.

The same parameters and gradients (numpy, seeded) go through
``repro.optim.adamw.update`` and ``repro_torch.optim.adamw.update`` for
several steps.  Tolerances: f32 parameters and moments within 1e-6
relative to each leaf's largest magnitude (the same f32 formulas; only the
order of the global-norm sum differs).  With bf16 moments the stored
moments are rounded to bf16 on both sides, so a 1-ulp f32 difference can
move a moment by one bf16 step (2^-8 relative): 1e-2 there.  Also the
reference's own tests (tests/test_optim.py) on the port, the schedule,
and the weight-decay rule on the stacked rank.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.optim import adamw


def _np(a):
    if isinstance(a, torch.Tensor):
        return convert.to_numpy(a).astype(np.float32)
    return np.asarray(a, dtype=np.float32)


def _rel(a, b):
    b = _np(b)
    return np.abs(_np(a) - b).max() / max(np.abs(b).max(), 1e-30)


# -- the reference's tests on the port ----------------------------------------

def test_converges_on_quadratic():
    cfg = adamw.AdamConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                           total_steps=200)
    x = torch.tensor([5.0, -3.0])
    params = {"x": x}
    state = adamw.init(params, cfg)
    for _ in range(150):
        params, state = adamw.update({"x": 2 * x}, state, params, cfg)
    assert x.abs().max() < 1e-2


def test_grad_clip_limits_update():
    cfg = adamw.AdamConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0,
                           warmup_steps=0)
    params = {"x": torch.zeros(3)}
    state = adamw.init(params, cfg)
    p2, _ = adamw.update({"x": torch.tensor([1e6, -1e6, 1e6])}, state,
                         params, cfg)
    assert p2["x"].abs().max() <= 1.0 + 1e-6


def test_bf16_state_dtype():
    cfg = adamw.AdamConfig(dtype="bfloat16")
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = adamw.init(params, cfg)
    assert st.mu["w"].dtype == torch.bfloat16
    g = {"w": torch.full((4, 4), 0.1, dtype=torch.bfloat16)}
    p2, st2 = adamw.update(g, st, params, cfg)
    assert st2.mu["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == torch.bfloat16
    assert st2.count.dtype == torch.int32 and int(st2.count) == 1


def test_weight_decay_skips_vectors():
    cfg = adamw.AdamConfig(lr=1e-2, weight_decay=0.5, warmup_steps=0)
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    st = adamw.init(params, cfg)
    p2, _ = adamw.update({"w": torch.zeros((4, 4)), "b": torch.zeros((4,))},
                         st, params, cfg)
    assert torch.all(p2["w"] < 1.0)
    assert torch.allclose(p2["b"], torch.ones(4))


def test_given_grad_norm_equals_computed():
    """``update`` with the caller's ``global_norm`` (as the train step passes
    it) moves the parameters and moments exactly as computing it inside."""
    cfg = adamw.AdamConfig(lr=1e-2, grad_clip=1e-2, warmup_steps=0)
    rng = np.random.default_rng(3)
    g = {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))}
    out = []
    for pass_norm in (False, True):
        params = {"w": torch.ones((4, 4))}
        st = adamw.init(params, cfg)
        gn = adamw.global_norm(g.values()) if pass_norm else None
        p2, st2 = adamw.update(g, st, params, cfg, gn)
        out.append((p2["w"], st2.mu["w"], st2.nu["w"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# -- against the reference ------------------------------------------------------

@pytest.mark.parametrize("state_dtype,clip", [
    ("float32", 1.0), ("float32", 1e-2), ("bfloat16", 1.0), ("bfloat16", 1e-2)])
def test_update_matches_reference(state_dtype, clip):
    """Five steps with fresh gradients each; clip 1e-2 keeps clipping active."""
    kw = dict(lr=3e-2, weight_decay=0.1, grad_clip=clip, warmup_steps=2,
              total_steps=6, dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamConfig(**kw), adamw.AdamConfig(**kw)
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    js, ts = jadamw.init(jp, jcfg), adamw.init(tp, tcfg)
    jstep = jax.jit(lambda g, s, p: jadamw.update(g, s, p, jcfg))
    tol = 1e-6 if state_dtype == "float32" else 1e-2
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in init.items()}
        gn_j = jadamw.global_norm({k: jnp.asarray(v) for k, v in g.items()})
        gn_t = adamw.global_norm(torch.from_numpy(v) for v in g.values())
        assert _rel(gn_t, gn_j) < 1e-6
        jp, js = jstep({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = adamw.update({k: torch.from_numpy(v) for k, v in g.items()},
                              ts, tp, tcfg)
        for k in init:
            assert _rel(tp[k], jp[k]) < tol, k
            assert _rel(ts.mu[k], js.mu[k]) < tol and _rel(ts.nu[k], js.nu[k]) < tol
            assert ts.mu[k].dtype == (torch.bfloat16 if state_dtype == "bfloat16"
                                      else torch.float32)
        assert int(ts.count) == int(js.count)


def test_schedule_matches_reference():
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg, tcfg = jadamw.AdamConfig(**kw), adamw.AdamConfig(**kw)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.schedule(jcfg, s))(jnp.asarray(steps)))
    got = adamw.schedule(tcfg, torch.from_numpy(steps)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * 1e-3
    assert got[0] == 0 and abs(got[10] - 1e-3) < 1e-9 and abs(got[-1] - 1e-4) < 1e-9


def test_weight_decay_follows_stacked_rank():
    """The reference decays every stacked layer leaf (ln1, ln2 are
    (n_layers, d)) and not final_norm (d,): the port follows it although it
    stores ln1 per layer as (d,)."""
    cfg_j, cfg_t = jbase.load_smoke("tinyllama-1.1b"), tbase.load_smoke("tinyllama-1.1b")
    kw = dict(seq_len=16, global_batch=1, kind="train", param_dtype="float32")
    jp = jzoo.get_api(cfg_j, jbase.RunConfig(**kw)).init(jax.random.PRNGKey(3))
    tp = dict(convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg_t,
                                      "cpu").named_parameters())
    acfg = dict(lr=1e-2, weight_decay=0.5, warmup_steps=0)
    jp2, _ = jadamw.update(jax.tree.map(jnp.zeros_like, jp),
                           jadamw.init(jp, jadamw.AdamConfig(**acfg)), jp,
                           jadamw.AdamConfig(**acfg))
    before = {n: p.detach().clone() for n, p in tp.items()}
    adamw.update({n: torch.zeros_like(p) for n, p in tp.items()},
                 adamw.init(tp, adamw.AdamConfig(**acfg)), tp,
                 adamw.AdamConfig(**acfg))
    assert adamw.stacked_rank("layers.0.ln1", tp["layers.0.ln1"]) == 2
    assert adamw.stacked_rank("embed.final_norm", tp["embed.final_norm"]) == 1
    for i in range(cfg_t.n_layers):
        for f in ("ln1", "ln2"):
            t = tp[f"layers.{i}.{f}"]
            assert torch.all(t < before[f"layers.{i}.{f}"])      # decayed
            assert np.array_equal(_np(t), np.asarray(getattr(jp2.layers, f))[i])
    assert torch.equal(tp["embed.final_norm"], before["embed.final_norm"])
    assert np.array_equal(_np(tp["embed.final_norm"]),
                          np.asarray(jp2.embed.final_norm))
    assert _rel(tp["layers.1.attn.wq"], np.asarray(jp2.layers.attn.wq)[1]) < 1e-6
