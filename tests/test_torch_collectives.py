"""The port's compressed-exchange codec against the JAX package, exactly.

``_quant_lastdim`` / ``_dequant_lastdim`` bit for bit against the
reference's eager functions (its jitted step computes ``amax * (1 / qmax)``,
ROADMAP Queue 3), on seeded inputs with zero blocks and rounding ties; the
cases of ``tests/test_collectives.py``; ``quantize_tree`` and
``dequant_mean_tree`` on the same trees, the pods mapped by ``jax.vmap``
on the reference's side; ``exchange_stats`` for every family's full-size
tree.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.distributed import collectives as JC
from repro.models import model_zoo as jzoo
from repro.obs import instrument as jobs
from repro_torch import convert, obs
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.distributed import collectives as C
from repro_torch.models import model_zoo
from repro_torch.train import step as tstep


def _same(a: torch.Tensor, b) -> bool:
    """Equal bits, shape and dtype (bf16 as its 16-bit words)."""
    b = np.asarray(b)
    if a.dtype == torch.bfloat16:
        return b.dtype.name == "bfloat16" and a.shape == b.shape and np.array_equal(
            a.view(torch.int16).numpy().view(np.uint16), b.view(np.uint16))
    a = convert.to_numpy(a)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _inputs(seed: int, bits: int) -> np.ndarray:
    """(3, 5, 256) f32: normal values, a zero block, a block of rounding
    ties (values (k + 1/2) * scale with an exact scale), one tiny block and
    one huge block."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    qmax = 2 ** (bits - 1) - 1
    x[0, 0, :32] = 0.0
    ties = (np.arange(32) % qmax - qmax // 2 + 0.5).astype(np.float32)
    ties[0] = qmax                       # amax = qmax: scale 1.0 exactly
    x[1, 2, 64:96] = ties
    x[2, 4, 224:] *= 1e-30
    x[2, 1, :32] *= 1e30
    return x


@pytest.mark.parametrize("bits", [4, 6, 8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_quant_dequant_bit_equal_to_eager_reference(bits, seed):
    x = _inputs(seed, bits)
    pj, sj = JC._quant_lastdim(jnp.asarray(x), bits)
    pt, st = C._quant_lastdim(torch.from_numpy(x), bits)
    assert pt.dtype == torch.uint32 and _same(pt, pj) and _same(st, sj)
    assert _same(C._dequant_lastdim(pt, st, bits, x.shape),
                 JC._dequant_lastdim(pj, sj, bits, x.shape))
    assert float(st[0, 0, 0]) == 1.0                  # the zero block
    codes = convert.to_numpy(C.bc.bitplane_unpack(pt, bits))
    assert np.array_equal(codes[1, 2, 2], np.round(x[1, 2, 64:96]))   # half to even


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_quant_lastdim_roundtrip_error_bound(bits):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 8, 128)).astype(np.float32))
    planes, scale = C._quant_lastdim(x, bits)
    y = C._dequant_lastdim(planes, scale, bits, x.shape)
    step = x.reshape(6, 8, 4, 32).abs().amax(-1) / (2 ** (bits - 1) - 1)
    err = (x - y).abs().reshape(6, 8, 4, 32).amax(-1)
    assert bool((err <= step + 1e-6).all())


def test_quant_preserves_shape_and_wire_size():
    planes, scale = C._quant_lastdim(torch.ones(4, 64), 8)
    assert planes.shape == (4, 2, 8) and scale.shape == (4, 2)
    assert abs(C.compressed_bytes_per_param(8) - (1.0 + 4 / 32)) < 1e-9
    assert C.compressed_bytes_per_param(4) == JC.compressed_bytes_per_param(4)


@pytest.mark.parametrize("shape", [(128, 128), (10,), (4096, 31), (4096,),
                                   (2, 2048), (4095,), (22, 2048)])
def test_compressible_criteria(shape):
    assert C.compressible(torch.zeros(shape)) == JC.compressible(jnp.zeros(shape))
    # decided on the reference's stacked leaf: 22 per-layer (2048,) norms
    stacked = ckpt.Stacked([torch.zeros(shape[1:])] * shape[0]) if len(shape) > 1 else None
    if stacked is not None:
        assert C.compressible(stacked) == JC.compressible(jnp.zeros(shape))


def test_error_feedback_converges_unbiased():
    """Repeated compression of a constant with error feedback: the mean of
    the decompressed stream tends to the true value."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    resid, acc, n = torch.zeros_like(g), torch.zeros_like(g), 24
    for _ in range(n):
        x = g + resid
        approx = C._dequant_lastdim(*C._quant_lastdim(x, 4), 4, x.shape)
        resid = x - approx
        acc = acc + approx
    err = float((acc / n - g).abs().max())
    one_shot = float((C._dequant_lastdim(*C._quant_lastdim(g, 4), 4, g.shape) - g).abs().max())
    assert err < one_shot / 3, (err, one_shot)


def _trees(dtype: str, n_pods: int = 2):
    """Seeded gradients and residuals of tinyllama's smoke model for each
    pod: the reference's trees (pods on a leading axis) and the port's
    reference-view trees, one per pod."""
    cfg_j, cfg_t = jbase.load_smoke("tinyllama-1.1b"), tbase.load_smoke("tinyllama-1.1b")
    rc = jbase.RunConfig(seq_len=32, global_batch=2, kind="train", param_dtype=dtype)
    shapes = jax.eval_shape(lambda: jzoo.get_api(cfg_j, rc).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def draw(s, scale, dt):
        return (rng.standard_normal((n_pods,) + s.shape) * scale).astype(dt)
    g_np = jax.tree.map(lambda s: draw(s, 1e-2, np.float32).astype(s.dtype), shapes)
    r_np = jax.tree.map(lambda s: draw(s, 1e-4, np.float32), shapes)

    def port(tree, i):
        named = {n: p.detach() for n, p in convert.params_from_jax(
            jax.tree.map(lambda a: a[i], tree), cfg_t, "cpu").named_parameters()}
        return tstep.reference_tree(named)
    return (g_np, r_np), [(port(g_np, i), port(r_np, i)) for i in range(n_pods)]


def _leaves_equal(port_tree, ref_tree, pod=None):
    flat_t = ckpt.flatten(port_tree)
    flat_j = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert [p for p, _ in flat_t] == [jax.tree_util.keystr(k) for k, _ in flat_j]
    for (path, leaf), (_, ref) in zip(flat_t, flat_j):
        ref = np.asarray(ref)[pod] if pod is not None else np.asarray(ref)
        got = torch.stack(leaf.parts) if isinstance(leaf, ckpt.Stacked) else leaf
        assert _same(got, ref), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_and_dequant_mean_trees_bit_equal(dtype, bits):
    """Each pod's planes, scales and new residuals, the raw leaves' pod
    mean, and the dequantized pod mean, against the reference's
    ``quantize_tree`` (vmapped over the pods, ``pmean`` over the mapped
    axis) and ``dequant_mean_tree``."""
    (g_np, r_np), pods = _trees(dtype)
    pj, sj, rawj, residj = jax.vmap(
        lambda g, r: JC.quantize_tree(g, r, bits, "pod"), axis_name="pod")(
        jax.tree.map(jnp.asarray, g_np), jax.tree.map(jnp.asarray, r_np))
    planes, scales = [], []
    for i, (g, r) in enumerate(pods):
        p, s, raw, new_r = C.quantize_tree(g, r, bits)
        _leaves_equal(p, pj, i)
        _leaves_equal(s, sj, i)
        _leaves_equal(new_r, residj, i)
        planes.append(p)
        scales.append(s)
    # the raw leaves' mean over the pods, in pod order
    raw_t = ckpt.map_tree(lambda *leaves: None if C.compressible(leaves[0]) else ckpt.Stacked(
        [C.pod_mean(torch.stack([lv.parts[k].float() for lv in leaves]), leaves[0].parts[k].dtype)
         for k in range(len(leaves[0].parts))]) if isinstance(leaves[0], ckpt.Stacked)
        else C.pod_mean(torch.stack([lv.float() for lv in leaves]), leaves[0].dtype),
        *[g for g, _ in pods])
    _leaves_equal(raw_t, jax.tree.map(lambda a: a[0], rawj))
    # pods stacked on a leading axis, as the exchange returns them
    lead = lambda *ts: ckpt.Stacked([torch.stack([t.parts[k] for t in ts])  # noqa: E731
                                     for k in range(len(ts[0].parts))]) \
        if isinstance(ts[0], ckpt.Stacked) else torch.stack(ts)
    mean_t = C.dequant_mean_tree(pods[0][0], ckpt.map_tree(lead, *planes),
                                 ckpt.map_tree(lead, *scales), raw_t, bits, 2)
    # the reference's tree holds None for absent fields, which its
    # dequant_mean_tree takes for leaves: hand it the present leaves
    is_none = lambda x: x is None  # noqa: E731
    flat = [jax.tree.flatten(t, is_leaf=is_none)[0] for t in (
        jax.tree.map(lambda a: jnp.asarray(a[0]), g_np), pj, sj,
        jax.tree.map(lambda a: a[0], rawj))]
    keep = [i for i, leaf in enumerate(flat[0]) if leaf is not None]
    mean_j = JC.dequant_mean_tree(*([f[i] for i in keep] for f in flat), bits, 2)
    got = ckpt.flatten(mean_t)
    assert len(got) == len(mean_j)
    for (path, leaf), ref in zip(got, mean_j):
        t = torch.stack(leaf.parts) if isinstance(leaf, ckpt.Stacked) else leaf
        assert _same(t, ref), path


def _full_size_tree(arch):
    cfg = tbase.load_arch(arch)
    api = model_zoo.get_api(cfg, tbase.RunConfig(seq_len=64, global_batch=1,
                                                 kind="train"), "cpu")
    with FakeTensorMode():
        params = api.init(0)
    return tstep.reference_tree(dict(params.named_parameters()))


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_exchange_stats_match_reference_at_full_size(arch):
    """Counted on the reference's stacked leaves: field for field, at bits
    4, 8 and 16, from shapes alone (fake tensors; eval_shape)."""
    tree = _full_size_tree(arch)
    cj = jbase.load_arch(arch)
    shapes = jax.eval_shape(lambda: jzoo.get_api(cj, jbase.RunConfig(
        seq_len=64, global_batch=1, kind="train")).init(jax.random.PRNGKey(0)))
    for bits in (4, 8, 16):
        got, want = C.exchange_stats(tree, bits), JC.exchange_stats(shapes, bits)
        assert got == C.ExchangeStats(**want.__dict__), (bits, got, want)
        assert got.reduction == want.reduction


def test_publish_emits_the_reference_series():
    stats = C.exchange_stats(_full_size_tree("tinyllama-1.1b"), 8)
    want = JC.ExchangeStats(**stats.__dict__)
    with obs.enabled_scope() as (reg, _):
        stats.publish(arch="tinyllama")
    with jobs.enabled_scope() as (jreg, _):
        want.publish(arch="tinyllama")
    assert reg.snapshot().to_dict() == jreg.snapshot().to_dict()
    # only final_norm (2048) goes raw: the stacked (22, 2048) ln1 and ln2
    # are compressed, though each per-layer (2048,) tensor is too small
    assert stats.compressed_leaves == 11 and stats.raw_leaves == 1


def test_init_residuals():
    params = {"a": torch.ones(3, 32, dtype=torch.bfloat16), "b": torch.ones(5)}
    r = C.init_residuals(params, 2)
    assert r.keys() == params.keys() and r["a"].shape == (2, 3, 32)
    assert all(t.dtype == torch.float32 and not t.any() for t in r.values())
    assert C.init_residuals(params)["b"].shape == (1, 5)
