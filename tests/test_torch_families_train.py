"""Training and checkpoint plumbing of the moe, ssm and hybrid families (CPU).

At smoke size, against the JAX package: the parameter tree (leaf count
and leaf paths), ``convert.state_from_jax`` and a 3-step train-step
trajectory, checkpoints written by either package and restored by the
other, AdamW's weight decay on the SSM's f32 ``(H,)`` leaves (rank 2 once
stacked, so decayed, as in the reference), and ``train.loop.train`` with an
injected failure.  Tolerances as tests/test_torch_train.py: f32 losses
within 1e-5 relative and gradient norms within 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro.train import step as jstep_mod
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.optim import adamw
from repro_torch.train import step as tstep_mod
from repro_torch.train.loop import LoopConfig, train

ARCHES = ("mixtral-8x7b", "grok-1-314b", "mamba2-130m", "hymba-1.5b")


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


def _rel(a, b):
    b = _np(b)
    return np.abs(_np(a) - b).max() / max(np.abs(b).max(), 1e-30)


def _configs(arch, **kw):
    kw = {"seq_len": 32, "global_batch": 2, "kind": "train", "q_block": 16,
          "kv_block": 16, **kw}
    return ((jbase.load_smoke(arch), jbase.RunConfig(**kw)),
            (tbase.load_smoke(arch), tbase.RunConfig(**kw)))


@pytest.mark.parametrize("arch", ARCHES)
def test_parameter_tree_matches_reference(arch):
    """The port's parameters are the reference's leaves: the same count of
    weights and, through ``reference_tree``, the same leaf paths in order.
    ``param_count()`` is exact for moe; for ssm and hybrid it leaves out the
    conv, the (H,) leaves and the norms, as the reference's does."""
    (cj, rj), (ct, rt) = _configs(arch)
    jp = jzoo.get_api(cj, rj).init(jax.random.PRNGKey(0))
    tp = model_zoo.get_api(ct, rt, "cpu").init(0)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    assert (ct.param_count() == n_ref) == (ct.family == "moe")
    flat = ckpt.flatten(tstep_mod.reference_tree(dict(tp.named_parameters())))
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [p for p, _ in flat] == [jax.tree_util.keystr(k) for k, _ in want]
    for (_, leaf), (_, ref) in zip(flat, want):
        got = torch.stack(leaf.parts) if isinstance(leaf, ckpt.Stacked) else leaf
        assert tuple(got.shape) == ref.shape and \
            str(got.dtype).split(".")[1] == ref.dtype.name


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-130m", "hymba-1.5b"])
def test_train_step_trajectory_matches_reference(arch):
    (cj, rj), (ct, rt) = _configs(arch, param_dtype="float32", lr=1e-3)
    japi, tapi = jzoo.get_api(cj, rj), model_zoo.get_api(ct, rt, "cpu")
    js = jstep_mod.init_state(japi, rj, jax.random.PRNGKey(0))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), ct, "cpu")
    _assert_states_equal(ts, js)
    jstep = jax.jit(jstep_mod.make_train_step(japi, cj, rj))
    tstep = tstep_mod.make_train_step(tapi, ct, rt)
    pj, pt = jpipe.SyntheticPipeline(cj, rj), tpipe.SyntheticPipeline(ct, rt)
    ops.reset_launch_counts()
    for _ in range(3):
        js, mj = jstep(js, jpipe.device_batch(pj.next(), cj, rj))
        ts, mt = tstep(ts, tpipe.device_batch(pt.next(), ct, rt, "cpu"))
        assert _rel(mt["loss"], mj["loss"]) < 1e-5
        assert _rel(mt["grad_norm"], mj["grad_norm"]) < 1e-4
    assert int(ts.step) == int(js.step) == 3 and int(ts.opt.count) == 3
    assert all(v == 0 for v in ops.launch_counts().values())   # CPU: no kernel


def _assert_states_equal(ts, js):
    flat_t = ckpt.flatten(tstep_mod.checkpoint_tree(ts))
    flat_j = jax.tree_util.tree_flatten_with_path(js)[0]
    assert [p for p, _ in flat_t] == [jax.tree_util.keystr(k) for k, _ in flat_j]
    for (path, leaf), (_, ref) in zip(flat_t, flat_j):
        got = torch.stack(leaf.parts) if isinstance(leaf, ckpt.Stacked) else leaf
        assert np.array_equal(_bits(got), _bits(ref)), path


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "hymba-1.5b"])
def test_checkpoints_cross_between_the_packages(arch, tmp_path):
    """A bf16 state after two reference steps: the reference's checkpoint
    restores into a fresh port state bit for bit, and the port's
    checkpoint of that state restores into the reference bit for bit."""
    (cj, rj), (ct, rt) = _configs(arch, lr=1e-2)
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


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_weight_decay_of_ssm_leaves_equals_reference(arch):
    """``a_log``, ``dt_bias`` and ``d_skip`` are (H,) per layer, (L, H) once
    stacked: the reference decays them, and so does the port."""
    (cj, rj), (ct, _) = _configs(arch, param_dtype="float32")
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
    for f in ("a_log", "dt_bias", "d_skip"):
        for i in range(ct.n_layers):
            name = f"layers.{i}.ssm.{f}"
            assert tp[name].dtype == torch.float32 and tp[name].dim() == 1
            assert adamw.stacked_rank(name, tp[name]) == 2
            assert not torch.equal(tp[name], before[name]), name  # decayed
            assert np.array_equal(_np(tp[name]),
                                  np.asarray(getattr(jp2.layers.ssm, f))[i]), name


def test_loop_resumes_a_hybrid_run_after_a_failure(tmp_path):
    """``train()`` on hymba's smoke config: checkpoints of the hybrid tree,
    one injected failure, and the resumed losses equal the uninterrupted
    run's."""
    cfg = tbase.load_smoke("hymba-1.5b")
    rc = tbase.RunConfig(seq_len=32, global_batch=4, kind="train", remat=False,
                         q_block=16, kv_block=16, lr=1e-3)
    loop = dict(total_steps=8, ckpt_every=3)
    ref = train(cfg, rc, LoopConfig(ckpt_dir=str(tmp_path / "a"), **loop),
                device="cpu", log_every=0)
    fired = []

    def hook(step):
        if step == 5 and not fired:
            fired.append(1)
            raise RuntimeError("injected node failure")

    got = train(cfg, rc, LoopConfig(ckpt_dir=str(tmp_path / "b"), **loop),
                device="cpu", failure_hook=hook, log_every=0)
    assert ref["restarts"] == 0 and got["restarts"] == 1
    assert np.allclose(ref["loss"][-3:], got["loss"][-3:], atol=1e-5)
    assert np.isfinite(ref["loss"]).all()
