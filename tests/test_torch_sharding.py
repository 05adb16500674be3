"""The port's sharding rules and logical-axis trees against the JAX package.

``Rules.resolve`` / ``spec`` on abstract meshes case for case (the cases of
``tests/test_sharding.py``), every family's ``param_specs`` at full size,
the train state's logical specs and their resolution, exactly equal.
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax

from repro.configs import base as jbase
from repro.distributed import sharding as jshd
from repro.launch.mesh import abstract_mesh as jabstract
from repro.models import model_zoo as jzoo
from repro.train import step as jstep
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import model_zoo
from repro_torch.train import step as tstep

NAMES = ("pod", "data", "model")


def _rules(sizes, names, **kw):
    return (shd.Rules(mesh=abstract_mesh(sizes, names), **kw),
            jshd.Rules(mesh=jabstract(sizes, names), **kw))


def _flat_logical(tree):
    """(path, logical tuple) pairs of a reference logical tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jshd._is_logical_leaf)[0]
    return [(jax.tree_util.keystr(k), v) for k, v in flat]


# (case, mesh sizes, mesh names, rules kwargs, [(logical, dim)])
RESOLVE_CASES = {
    "batch_composition": ((2, 2, 2), NAMES, {}, [("batch", 8), ("batch", 3),
                                                 ("batch", 4), ("batch", 6)]),
    "divisibility_fallbacks": ((2, 2, 2), NAMES, {}, [
        ("heads", 6), ("heads", 7), ("vocab", 32001), ("ff", 256),
        ("cache_seq", 10), ("tp", 5), ("experts", 8), (None, 4)]),
    "toggles_off": ((2, 2), ("data", "model"), dict(seq_shard=False, fsdp=False),
                    [("seq", 128), ("fsdp", 128), ("heads", 128)]),
    "toggles_on": ((2, 2), ("data", "model"), dict(seq_shard=True, fsdp=True),
                   [("seq", 128), ("fsdp", 128), ("fsdp", 3), ("seq", 3)]),
    "vocab_unsharded": ((2, 2, 2), NAMES, dict(shard_vocab=False),
                        [("vocab", 256), ("heads", 256)]),
    "exclude_pod": ((2, 2, 2), NAMES, dict(exclude=frozenset({"pod"})),
                    [("batch", 8), ("batch", 2), ("fsdp", 8)]),
    "data_only": ((4,), ("data",), {}, [("batch", 8), ("heads", 6), ("seq", 5),
                                        ("fsdp", 6)]),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_matches_reference(case):
    sizes, names, kw, pairs = RESOLVE_CASES[case]
    rt, rj = _rules(sizes, names, **kw)
    for logical, dim in pairs:
        assert rt.resolve(logical, dim) == rj.resolve(logical, dim), (logical, dim)
    with pytest.raises(KeyError):
        rt.resolve("nonsense", 4)


@pytest.mark.parametrize("shape,logical", [
    ((8, 64, 128), ("batch", "seq", None)),
    ((3, 64, 6), ("batch", "seq", "heads")),
    ((256, 128), ("vocab", "fsdp")),
    ((2, 128, 256), (None, "fsdp", "ff")),
])
def test_spec_matches_reference(shape, logical):
    rt, rj = _rules((2, 2, 2), NAMES)
    got, want = rt.spec(shape, logical), rj.spec(shape, logical)
    assert tuple(got) == tuple(want) and isinstance(got, shd.PartitionSpec)
    assert repr(shd.P(("pod", "data"), "model", None)) == \
        "P(('pod', 'data'), 'model', None)"
    excluded = dataclasses.replace(rt, exclude=frozenset({"pod"}))
    assert tuple(excluded.spec(shape, logical)) == tuple(
        dataclasses.replace(rj, exclude=frozenset({"pod"})).spec(shape, logical))


def test_no_rules_is_noop():
    shd.set_rules(None)
    x = torch.ones(4, 4)
    assert shd.act(x, "batch", None) is x
    assert shd.tp_out_proj(torch.ones(2, 3, 4), torch.ones(4, 5)) is None
    assert shd.named_sharding(shd.P("data")) is None
    specs = model_zoo.get_api(tbase.load_smoke("yi-9b"),
                              tbase.RunConfig(seq_len=8, global_batch=2, kind="train"),
                              "cpu").param_specs()
    assert all(v == shd.P() for _, v in ckpt.flatten(shd.spec_tree(specs, specs)))


#: mixer leaves' blocks a rank holds on (1, 1, 2) by the rules (the smoke
#: configs: mamba2 / hymba d 128, di 256, N 16, 8 SSD heads, in_proj 552
#: columns; hymba 4 heads of 32, 2 KV heads; whisper 4 heads of 32, ff 256)
MIXER_BLOCKS = {
    "mamba2-130m": {"layers.0.ssm.in_proj": (128, 276), "layers.0.ssm.conv_w": (4, 144),
                    "layers.0.ssm.conv_b": (144,), "layers.0.ssm.gate_norm": (128,),
                    "layers.0.ssm.out_proj": (128, 128), "layers.0.ssm.a_log": (8,)},
    "hymba-1.5b": {"layers.1.ssm.in_proj": (128, 276), "layers.1.ssm.d_skip": (8,),
                   "layers.1.attn.wq": (128, 64), "layers.1.attn.wk": (128, 32),
                   "layers.1.ln_ssm_out": (128,), "layers.1.mlp.w_down": (128, 128)},
    "whisper-tiny": {"enc_layers.0.attn.wq": (128, 64), "dec_layers.1.cross_attn.wk": (128, 64),
                     "dec_layers.1.cross_attn.wo": (64, 128), "dec_layers.0.mlp.w_up": (128, 128),
                     "embed.table": (128, 128), "enc_norm": (128,)},
}


def test_model_axis_of_one_is_a_noop_and_out_of_slice_families_raise():
    """A ``model`` axis of 1 (or excluded) moves nothing; above 1 every
    family builds its train step (none is refused any more: the name is
    the one this test had when the ssm, hybrid and encdec families raised),
    and each mixer leaf's block is its rule's (``MIXER_BLOCKS``)."""
    rt, _ = _rules((2, 2, 1), NAMES)
    x = torch.ones(8, 4, 6)
    with shd.use_rules(rt):
        assert shd.act(x, "batch", "seq", None) is x
        assert shd.tp_out_proj(x, torch.ones(6, 3)) is None
        assert shd.named_sharding(shd.P("pod")).spec == shd.P("pod")
        assert shd.tp_block("heads", 8) is None and not shd.seq_split(4)
    assert shd.get_rules() is None
    tp, _ = _rules((1, 1, 2), NAMES)
    excluded = dataclasses.replace(tp, exclude=frozenset({"model"}))
    with shd.use_rules(excluded):
        assert shd.act(x, "batch", "seq", None) is x
        assert shd.tp_out_proj(x, torch.ones(6, 3)) is None
    assert not hasattr(shd, "check_model_axis") and not hasattr(shd, "TP_FAMILIES")
    rc = tbase.RunConfig(seq_len=64, global_batch=8, kind="train")
    for arch in ("tinyllama-1.1b", "internvl2-76b", "mixtral-8x7b", "mamba2-130m",
                 "hymba-1.5b", "whisper-tiny"):
        cfg = tbase.load_smoke(arch)
        api = model_zoo.get_api(cfg, rc, "cpu")
        tstep.make_train_step(api, cfg, rc, tp.mesh)
        specs = tstep.param_partition(api, rc, tp.mesh)
        shapes = tstep.full_shapes(api)
        blocks = {n: tuple(d // (2 if "model" in shd._axes(part) else 1)
                           for d, part in zip(shapes[n], specs[n])) for n in specs}
        for n, want in MIXER_BLOCKS.get(arch, {}).items():
            assert blocks[n] == want, (arch, n, blocks[n], want)


def _full_size(arch):
    """The port's parameters at full size as fake tensors (no memory)."""
    cfg = tbase.load_arch(arch)
    rc = tbase.RunConfig(seq_len=64, global_batch=1, kind="train")
    api = model_zoo.get_api(cfg, rc, "cpu")
    with FakeTensorMode():
        params = api.init(0)
    return cfg, api, tstep.reference_tree(dict(params.named_parameters()))


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_param_specs_match_reference_at_full_size(arch):
    """Every family's logical tree, path for path, and its resolution on a
    (2, 2, 2) mesh against the reference's full-size abstract parameters."""
    cfg, api, tree = _full_size(arch)
    cj = jbase.load_arch(arch)
    rj = jbase.RunConfig(seq_len=64, global_batch=1, kind="train")
    japi = jzoo.get_api(cj, rj)
    got = [(p, v) for p, v in ckpt.flatten(api.param_specs())]
    assert got == _flat_logical(japi.param_specs())
    rt, rjr = _rules((2, 2, 2), NAMES)
    with shd.use_rules(rt):
        specs = ckpt.flatten(shd.spec_tree(api.param_specs(), tree))
    with jshd.use_rules(rjr):
        want = jax.tree_util.tree_flatten_with_path(
            jshd.spec_tree(japi.param_specs(), japi.abstract_params()),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert [(p, tuple(s)) for p, s in specs] == \
        [(jax.tree_util.keystr(k), tuple(s)) for k, s in want]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-76b", "whisper-tiny"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_batch_logical_specs_match_reference(arch, kind):
    ct, cj = tbase.load_smoke(arch), jbase.load_smoke(arch)
    kw = dict(seq_len=32, global_batch=2, kind=kind)
    assert model_zoo.batch_logical_specs(ct, tbase.RunConfig(**kw)) == \
        jzoo.batch_logical_specs(cj, jbase.RunConfig(**kw))


@pytest.mark.parametrize("bits", [0, 8])
def test_state_specs_match_reference(bits):
    """The train state's logical specs ('pod_dim' on the residuals),
    abstract shapes and resolved specs on a (2, 2, 2) mesh."""
    kw = dict(seq_len=32, global_batch=8, kind="train", grad_compress_bits=bits)
    ct, cj = tbase.load_smoke("tinyllama-1.1b"), jbase.load_smoke("tinyllama-1.1b")
    rt, rj = tbase.RunConfig(**kw), jbase.RunConfig(**kw)
    api, japi = model_zoo.get_api(ct, rt, "cpu"), jzoo.get_api(cj, rj)
    (mt, mj) = (abstract_mesh((2, 2, 2), NAMES), jabstract((2, 2, 2), NAMES))
    logical = tstep.state_logical_specs(api, rt, mt)
    assert ckpt.flatten(logical) == _flat_logical(jstep.state_logical_specs(japi, rj, mj))
    abstract = tstep.abstract_state(api, rt, mt)
    jabs = jax.tree_util.tree_flatten_with_path(jstep.abstract_state(japi, rj, mj))[0]
    assert [(p, tuple(a.shape), str(a.dtype).split(".")[1]) for p, a in ckpt.flatten(abstract)] == \
        [(jax.tree_util.keystr(k), a.shape, a.dtype.name) for k, a in jabs]
    rules_t, rules_j = _rules((2, 2, 2), NAMES)
    with shd.use_rules(rules_t):
        specs = ckpt.flatten(tstep.resolve_state_specs(logical, abstract))
    with jshd.use_rules(rules_j):
        want = jax.tree_util.tree_flatten_with_path(
            jstep.resolve_state_specs(jstep.state_logical_specs(japi, rj, mj),
                                      jstep.abstract_state(japi, rj, mj)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert [(p, tuple(s)) for p, s in specs] == \
        [(jax.tree_util.keystr(k), tuple(s)) for k, s in want]
    if bits:
        assert dict(specs)[".resid.layers.attn.wq"][0] == "pod"
