"""The port's checkpoints against the JAX package's, on the CPU.

Both managers write and read one layout (``manifest.json`` with each
leaf's ``keystr`` path, ``leaf_<i>.npy``, bf16 as uint16 words), so a
TrainState written by ``repro.checkpoint.ckpt.CheckpointManager`` restores
into the port bit for bit, bf16 parameters included, and the reverse holds.
Also the reference's own tests (tests/test_checkpoint.py) on the port:
keep-k, ``.tmp`` ignored, idempotent publish, async save.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models import model_zoo as jzoo
from repro.train import step as jstep_mod
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model_zoo
from repro_torch.train import step as tstep_mod


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((16, 8)).astype(
                np.float32)).to(torch.bfloat16),
            "nested": {"b": torch.arange(7, dtype=torch.int32)},
            "scalar": torch.tensor(3.5)}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _bits(t) -> np.ndarray:
    """The exact bits of a leaf (bf16 as its 16-bit words)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# -- the reference's tests on the port ------------------------------------------

def test_roundtrip_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t = _tree()
    mgr.save(5, t, extra={"data_step": 5})
    out, extra = mgr.restore(5, _zeros_like(t))
    assert extra == {"data_step": 5}
    for (pa, a), (pb, b) in zip(ckpt.flatten(t), ckpt.flatten(out)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_tmp_dirs_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert mgr.all_steps() == [1]


def test_idempotent_publish(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, _tree())
    mgr.save(7, _tree(1))      # same step again: the first publish wins
    assert mgr.all_steps() == [7]
    out, _ = mgr.restore(7, _zeros_like(_tree()))
    assert torch.equal(out["w"], _tree()["w"])


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = _tree()
    mgr.save(3, t)
    t["nested"]["b"] += 100    # the save copied the leaves before returning
    mgr.wait()
    out, _ = mgr.restore(3, _zeros_like(t))
    assert torch.equal(out["nested"]["b"], torch.arange(7, dtype=torch.int32))
    mgr.close()


def test_restore_checks_the_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    bad = _zeros_like(_tree())
    bad["w"] = torch.zeros((16, 8))                    # f32, not bf16
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.restore(1, bad)
    with pytest.raises(ValueError, match="holds leaves"):
        mgr.restore(1, {"w": torch.zeros((16, 8), dtype=torch.bfloat16)})


# -- across the two packages -------------------------------------------------------

def test_generic_tree_paths_match_reference(tmp_path):
    t = _tree()
    JManager(str(tmp_path / "j"), async_save=False).save(
        2, jax.tree.map(lambda x: jnp.asarray(convert.to_numpy(x)).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else x.numpy().dtype), t))
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(2, t)
    mj, mt = (json.load(open(tmp_path / d / "step_00000002" / "manifest.json"))
              for d in ("j", "t"))
    assert mj == mt
    out, _ = CheckpointManager(str(tmp_path / "j"), async_save=False).restore(
        2, _zeros_like(t))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(ckpt.flatten(t), ckpt.flatten(out)))


def _states(steps=2):
    """The reference's TrainState after a few steps (bf16 params, f32
    moments), and a fresh port state of the same model."""
    cfg_j, cfg_t = jbase.load_smoke("tinyllama-1.1b"), tbase.load_smoke("tinyllama-1.1b")
    kw = dict(seq_len=32, global_batch=2, kind="train", q_block=16, kv_block=16,
              lr=1e-2)
    rc_j, rc_t = jbase.RunConfig(**kw), tbase.RunConfig(**kw)
    japi = jzoo.get_api(cfg_j, rc_j)
    js = jstep_mod.init_state(japi, rc_j, jax.random.PRNGKey(0))
    step = jax.jit(jstep_mod.make_train_step(japi, cfg_j, rc_j))
    pipe = jpipe.SyntheticPipeline(cfg_j, rc_j)
    for _ in range(steps):
        js, _ = step(js, jpipe.device_batch(pipe.next(), cfg_j, rc_j))
    ts = tstep_mod.init_state(model_zoo.get_api(cfg_t, rc_t, "cpu"), rc_t, seed=9)
    return (cfg_j, rc_j, japi, js), (cfg_t, rc_t, ts)


def _assert_states_equal(ts, js):
    flat_t = ckpt.flatten(tstep_mod.checkpoint_tree(ts))
    flat_j = jax.tree_util.tree_flatten_with_path(js)[0]
    assert [p for p, _ in flat_t] == [jax.tree_util.keystr(k) for k, _ in flat_j]
    for (path, leaf), (_, ref) in zip(flat_t, flat_j):
        got = torch.stack(leaf.parts) if isinstance(leaf, ckpt.Stacked) else leaf
        assert np.array_equal(_bits(got), _bits(ref)), path


def test_reference_checkpoint_restores_into_port(tmp_path):
    (_, _, _, js), (_, _, ts) = _states()
    JManager(str(tmp_path), async_save=False).save(2, js, extra={"data_step": 2})
    _, extra = CheckpointManager(str(tmp_path)).restore(
        2, tstep_mod.checkpoint_tree(ts))
    assert extra == {"data_step": 2} and int(ts.step) == 2
    assert ts.params.embed.table.dtype == torch.bfloat16
    _assert_states_equal(ts, js)


def test_port_checkpoint_restores_into_reference(tmp_path):
    (cfg_j, rc_j, japi, js), (cfg_t, _, ts) = _states()
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), cfg_t, "cpu")
    CheckpointManager(str(tmp_path), async_save=False).save(
        2, tstep_mod.checkpoint_tree(ts), extra={"data_step": 2})
    like = jstep_mod.abstract_state(japi, rc_j)
    out, extra = JManager(str(tmp_path)).restore(2, like)
    assert extra == {"data_step": 2}
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_restored_port_state_trains_like_the_reference(tmp_path):
    """One step after a reference checkpoint: the port's loss is the
    reference's (bf16 loss within 2e-2 relative, as tests/test_torch_train.py)."""
    (cfg_j, rc_j, japi, js), (cfg_t, rc_t, ts) = _states()
    JManager(str(tmp_path), async_save=False).save(2, js)
    CheckpointManager(str(tmp_path)).restore(2, tstep_mod.checkpoint_tree(ts))
    pj, pt = jpipe.SyntheticPipeline(cfg_j, rc_j, step=2), \
        tpipe.SyntheticPipeline(cfg_t, rc_t, step=2)
    _, mj = jax.jit(jstep_mod.make_train_step(japi, cfg_j, rc_j))(
        js, jpipe.device_batch(pj.next(), cfg_j, rc_j))
    _, mt = tstep_mod.make_train_step(model_zoo.get_api(cfg_t, rc_t, "cpu"),
                                      cfg_t, rc_t)(
        ts, tpipe.device_batch(pt.next(), cfg_t, rc_t, "cpu"))
    assert abs(float(mt["loss"]) - float(mj["loss"])) < 2e-2 * abs(float(mj["loss"]))
