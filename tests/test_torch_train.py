"""The port's training path (CPU) against the JAX package, at smoke size.

The synthetic pipeline, ``loss_fn`` and its gradients, the train step over
several steps, and the fault-tolerant loop, with weights carried over from
JAX by ``convert.params_from_jax`` / ``state_from_jax``.  On CPU tensors
attention runs the blockwise path, differentiated by autograd (the flash
kernels are held against their plain versions by ``chip_smoke.py``).

Tolerances, f32: the loss within 1e-5 relative and each gradient leaf
within 1e-4 of its largest magnitude (the same formulas summed in another
order through two layers, the chunked loss and the blockwise attention);
over 5 train steps the losses within 1e-5 relative and the gradient norms
within 1e-4.  bf16: losses within 2e-2 relative (XLA and PyTorch round bf16
at other places, ROADMAP Queue 3).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.train import step as jstep_mod
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.models import layers, model_zoo
from repro_torch.train import step as tstep_mod
from repro_torch.train.loop import LoopConfig, train


def _np(a):
    if isinstance(a, torch.Tensor):
        return convert.to_numpy(a).astype(np.float32)
    return np.asarray(a, dtype=np.float32)


def _rel(a, b):
    b = _np(b)
    return np.abs(_np(a) - b).max() / max(np.abs(b).max(), 1e-30)


def _configs(arch, **kw):
    kw = {"seq_len": 32, "global_batch": 2, "kind": "train", "q_block": 16,
          "kv_block": 16, **kw}
    return ((jbase.load_smoke(arch), jbase.RunConfig(**kw)),
            (tbase.load_smoke(arch), tbase.RunConfig(**kw)))


def _leaf(tree, name: str) -> np.ndarray:
    """The reference's leaf for a port parameter name (layers are stacked)."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree.layers
        for f in parts[2:]:
            node = getattr(node, f)
        return np.asarray(node)[int(parts[1])]
    node = tree
    for f in parts:
        node = getattr(node, f)
    return np.asarray(node)


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-76b",
                                  "whisper-tiny"])
def test_pipeline_batches_bit_identical(arch):
    (cj, rj), (ct, rt) = _configs(arch)
    pj, pt = jpipe.SyntheticPipeline(cj, rj, seed=3), tpipe.SyntheticPipeline(ct, rt, seed=3)
    for _ in range(3):
        bj, bt = pj.next(), pt.next()
        assert bj.keys() == bt.keys()
        for k in bj:
            assert bj[k].dtype == bt[k].dtype and np.array_equal(bj[k], bt[k]), k
    assert pt.state() == pj.state() == {"data_step": 3, "data_seed": 3}
    pt.restore({"data_step": 1})
    pj.restore({"data_step": 1})
    bj, bt = pj.next(), pt.next()
    assert all(np.array_equal(bj[k], v) for k, v in bt.items())


@pytest.mark.parametrize("arch,dtype", [
    ("internvl2-76b", "float32"), ("internvl2-76b", "bfloat16"),
    ("tinyllama-1.1b", "bfloat16"), ("whisper-tiny", "bfloat16")])
def test_device_batch_follows_input_specs(arch, dtype):
    (cj, rj), (ct, rt) = _configs(arch, param_dtype=dtype)
    batch = tpipe.SyntheticPipeline(ct, rt).next()
    got = tpipe.device_batch(batch, ct, rt, "cpu")
    specs = model_zoo.input_specs(ct, rt)
    jspecs = jzoo.input_specs(cj, rj)
    assert specs.keys() == jspecs.keys() == got.keys()
    for k, spec in specs.items():
        assert tuple(got[k].shape) == spec.shape == jspecs[k].shape
        assert str(spec.dtype).split(".")[1] == jspecs[k].dtype.name
        assert got[k].dtype == spec.dtype
    assert torch.equal(got["tokens"], torch.from_numpy(batch["tokens"]))
    decode = dataclasses.replace(rt, kind="decode")
    assert model_zoo.input_specs(ct, decode)["tokens"].shape == (rt.global_batch,)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(4)
    lg = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    want = jlayers.cross_entropy(jnp.asarray(lg), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(torch.from_numpy(lg), torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    assert _rel(got, want) < 1e-6


# -- loss and gradients ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-76b"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(arch, remat):
    (cj, rj), (ct, rt) = _configs(arch, param_dtype="float32", remat=remat)
    japi = jzoo.get_api(cj, rj)
    jp = japi.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), ct, "cpu")
    batch = tpipe.SyntheticPipeline(ct, rt).next()
    lj, gj = jax.jit(jax.value_and_grad(japi.loss_fn))(
        jp, jpipe.device_batch(batch, cj, rj))
    lt = model_zoo.get_api(ct, rt, "cpu").loss_fn(
        tp, tpipe.device_batch(batch, ct, rt, "cpu"))
    lt.backward()
    assert lt.dtype == torch.float32 and _rel(lt, lj) < 1e-5
    n_leaves = len(jax.tree.leaves(gj.embed)) + cj.n_layers * len(jax.tree.leaves(gj.layers))
    assert len(list(tp.parameters())) == n_leaves
    for name, p in tp.named_parameters():
        assert p.grad is not None and _rel(p.grad, _leaf(gj, name)) < 1e-4, name


def test_remat_recomputes_without_changing_grads():
    (_, _), (ct, rt) = _configs("tinyllama-1.1b", param_dtype="float32")
    api = model_zoo.get_api(ct, rt, "cpu")
    batch = tpipe.device_batch(tpipe.SyntheticPipeline(ct, rt).next(), ct, rt, "cpu")
    grads = []
    for remat in (False, True):
        p = api.init(0)
        rc = dataclasses.replace(rt, remat=remat)
        model_zoo.get_api(ct, rc, "cpu").loss_fn(p, batch).backward()
        grads.append({n: q.grad for n, q in p.named_parameters()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_save_collectives_policy_on_one_device_is_full():
    """``remat_policy="save_collectives"`` keeps the outputs of the named
    collectives; one device has none, so its gradients are ``"full"``'s,
    bit for bit (and serving ignores the policy)."""
    (_, _), (ct, rt) = _configs("tinyllama-1.1b", param_dtype="float32")
    batch = tpipe.device_batch(tpipe.SyntheticPipeline(ct, rt).next(), ct, rt, "cpu")
    grads = []
    for policy in ("full", "save_collectives"):
        rc = dataclasses.replace(rt, remat=True, remat_policy=policy)
        api = model_zoo.get_api(ct, rc, "cpu")
        p = api.init(0)
        api.loss_fn(p, batch).backward()
        grads.append({n: q.grad for n, q in p.named_parameters()})
        with torch.no_grad():
            assert torch.isfinite(api.loss_fn(api.init(0), batch))
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


#: (mesh, leaf, block a rank holds) at full size, by the rules
FULL_BLOCKS = {
    "mamba2-130m": ((1, 2), {"layers.0.ssm.in_proj": (768, 1676),   # cut mid-x
                             "layers.0.ssm.conv_w": (4, 896),
                             "layers.0.ssm.gate_norm": (768,),
                             "layers.0.ssm.out_proj": (768, 768),
                             "layers.0.ssm.a_log": (24,)}),
    "hymba-1.5b": ((1, 4), {"layers.0.ssm.in_proj": (1600, 6482),   # 6482 % 4: whole
                            "layers.0.ssm.conv_w": (4, 808),
                            "layers.0.ssm.gate_norm": (800,),       # 12.5 heads
                            "layers.0.attn.wq": (1600, 400),
                            "layers.0.attn.wk": (1600, 80),
                            "embed.table": (32001, 1600)}),         # vocab whole
    "whisper-tiny": ((1, 4), {"enc_layers.0.attn.wq": (384, 96),    # 1.5 heads
                              "dec_layers.0.cross_attn.wv": (384, 96),
                              "dec_layers.0.mlp.w_down": (384, 384),
                              "embed.table": (51865, 384)}),
    "tinyllama-1.1b": ((1, 2), {"layers.0.attn.wq": (2048, 1024),
                                "layers.0.attn.wk": (2048, 128)}),
}


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b", "whisper-tiny",
                                  "tinyllama-1.1b"])
def test_mesh_raises(arch):
    """Every family builds its step on a ``model`` axis above 1 (the name
    is the one this test had when the ssm, hybrid and encdec families
    raised), and at full size the rules cut each mixer leaf as the
    reference's do (``FULL_BLOCKS``): mamba2's ``in_proj`` (768, 3352) at
    column 1676 on two ranks, hymba's left whole on four (6482 % 4 = 2)
    while its ``gate_norm`` is cut mid-head, whisper's 6 heads at 1.5 a
    rank."""
    from repro_torch.launch.mesh import abstract_mesh
    (_, _), (ct, rt) = _configs(arch)
    api = model_zoo.get_api(ct, rt, "cpu")
    tstep_mod.make_train_step(api, ct, rt, mesh=abstract_mesh((1, 2), ("data", "model")))
    shape, blocks = FULL_BLOCKS[arch]
    mesh = abstract_mesh(shape, ("data", "model"))
    cfg = tbase.load_arch(arch)
    full = model_zoo.get_api(cfg, rt, "cpu")
    tstep_mod.make_train_step(full, cfg, rt, mesh=mesh)
    specs = tstep_mod.param_partition(full, rt, mesh)
    shapes = tstep_mod.full_shapes(full)
    for n, want in blocks.items():
        got = tuple(d // (shape[1] if part == "model" or
                          (isinstance(part, tuple) and "model" in part) else 1)
                    for d, part in zip(shapes[n], specs[n]))
        assert got == want, (n, got, want, specs[n])


# -- the train step ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_trajectory_matches_reference(dtype):
    (cj, rj), (ct, rt) = _configs("tinyllama-1.1b", param_dtype=dtype, lr=1e-3)
    japi, tapi = jzoo.get_api(cj, rj), model_zoo.get_api(ct, rt, "cpu")
    js = jstep_mod.init_state(japi, rj, jax.random.PRNGKey(0))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js), ct, "cpu")
    for name, p in ts.params.named_parameters():
        assert np.array_equal(_np(p), _leaf(js.params, name).astype(np.float32))
    assert ts.opt.mu["layers.1.mlp.w_up"].dtype == torch.float32
    jstep = jax.jit(jstep_mod.make_train_step(japi, cj, rj))
    tstep = tstep_mod.make_train_step(tapi, ct, rt)
    pj, pt = jpipe.SyntheticPipeline(cj, rj), tpipe.SyntheticPipeline(ct, rt)
    ops.reset_launch_counts()
    for _ in range(5):
        js, mj = jstep(js, jpipe.device_batch(pj.next(), cj, rj))
        ts, mt = tstep(ts, tpipe.device_batch(pt.next(), ct, rt, "cpu"))
        if dtype == "float32":
            assert _rel(mt["loss"], mj["loss"]) < 1e-5
            assert _rel(mt["grad_norm"], mj["grad_norm"]) < 1e-4
        else:
            assert _rel(mt["loss"], mj["loss"]) < 2e-2
    assert int(ts.step) == int(js.step) == 5 and int(ts.opt.count) == 5
    assert all(v == 0 for v in ops.launch_counts().values())   # CPU: no kernel


def test_init_state_is_trainable_and_zeroed():
    (_, _), (ct, rt) = _configs("tinyllama-1.1b")
    st = tstep_mod.init_state(model_zoo.get_api(ct, rt, "cpu"), rt, seed=1)
    params = dict(st.params.named_parameters())
    assert all(p.requires_grad and p.dtype == torch.bfloat16 for p in params.values())
    assert st.opt.mu.keys() == params.keys() and st.resid is None
    assert all(m.dtype == torch.float32 and not m.any() for m in st.opt.mu.values())
    assert int(st.step) == 0 and st.step.dtype == torch.int32


# -- the loop (ports of tests/test_train_loop.py) ------------------------------------

@pytest.fixture()
def cfg_rc():
    cfg = tbase.load_smoke("tinyllama-1.1b")
    rc = tbase.RunConfig(seq_len=64, global_batch=8, kind="train", remat=False,
                         q_block=32, kv_block=32, lr=1e-3)
    return cfg, rc


def test_loss_decreases(cfg_rc, tmp_path):
    cfg, rc = cfg_rc
    hist = train(cfg, rc, LoopConfig(total_steps=30, ckpt_every=10,
                                     ckpt_dir=str(tmp_path)), device="cpu",
                 log_every=0)
    assert hist["loss"][-1] < hist["loss"][0] - 0.3
    assert hist["restarts"] == 0


def test_failure_recovery_resumes_batch_sequence(cfg_rc, tmp_path):
    cfg, rc = cfg_rc
    ref_dir, failed_dir = str(tmp_path / "a"), str(tmp_path / "b")
    ref = train(cfg, rc, LoopConfig(total_steps=25, ckpt_every=5,
                                    ckpt_dir=ref_dir), device="cpu", log_every=0)
    fired = []

    def hook(step):
        if step == 13 and not fired:
            fired.append(1)
            raise RuntimeError("injected node failure")

    got = train(cfg, rc, LoopConfig(total_steps=25, ckpt_every=5,
                                    ckpt_dir=failed_dir),
                device="cpu", failure_hook=hook, log_every=0)
    assert got["restarts"] == 1
    assert np.allclose(ref["loss"][-5:], got["loss"][-5:], atol=1e-5)


def test_gives_up_after_max_restarts(cfg_rc, tmp_path):
    cfg, rc = cfg_rc

    def hook(step):
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError):
        train(cfg, rc, LoopConfig(total_steps=10, ckpt_every=5,
                                  ckpt_dir=str(tmp_path), max_restarts=2),
              device="cpu", failure_hook=hook, log_every=0)
