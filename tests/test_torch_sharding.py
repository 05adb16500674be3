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


def test_model_axis_of_one_is_a_noop_and_out_of_slice_families_raise():
    """A ``model`` axis of 1 (or excluded) moves nothing; above 1 the
    ssm, hybrid and encdec families raise, naming the slice that brings
    them (the dense, vlm and moe families run tensor-parallel:
    tests/test_torch_tensor_parallel.py)."""
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
    for arch in ("mamba2-130m", "hymba-1.5b", "whisper-tiny"):
        with pytest.raises(NotImplementedError, match="'model' axis to the ssm"):
            shd.check_model_axis(tp.mesh, tbase.load_smoke(arch))
    for arch in ("tinyllama-1.1b", "internvl2-76b", "mixtral-8x7b"):
        shd.check_model_axis(tp.mesh, tbase.load_smoke(arch))


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
