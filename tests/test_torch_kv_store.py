"""The packed cache's fused quantize-and-store (plain path on the CPU) against
the reference's ``update_cache``, and the in-place reset of a decode state.

``ops.kv_quant_store`` on CPU tensors runs ``kvpack.kv_quant_store_plain``;
the JAX side is ``repro.models.layers.update_cache`` run eagerly (``jit``
would turn its ``amax / qmax`` into a multiply by the reciprocal, see
ROADMAP Queue 3).  Both must agree bit for bit: codes and scales at the
written slots, and every other slot of a cache pre-filled with seeded noise
left as it was.  The CUDA kernel is held against the plain version by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.kernels import kvpack, ops
from repro_torch.models import layers, model_zoo, transformer

#: (B, KV, D, S): every value of B in {1, 3}, KV in {1, 2}, D in {8, 128}
#: and S in {4, 16} appears, each pair of B and KV together
SHAPES = [(1, 1, 8, 4), (3, 2, 128, 16), (3, 1, 128, 4), (1, 2, 8, 16),
          (3, 2, 8, 4)]


def _positions(kind, B, S, rng):
    """Per-sequence positions: inside the cache, past its end (the reference
    clamps to S - 1), or ring slots pos % S of positions past the end."""
    if kind == "inside":
        pos = rng.integers(0, S, B)
    elif kind == "past_end":
        pos = S - 1 + rng.integers(0, 3 * S, B)
    else:
        pos = rng.integers(S, 5 * S, B) % S
    return pos.astype(np.int32)


def _case(B, KV, D, S, dtype, bits, kind, seed):
    rng = np.random.default_rng(seed)
    cd = D if bits == 8 else D // 2
    new = rng.standard_normal((2, B, 1, KV, D)).astype(np.float32) * 3
    new[0, 0, 0, 0] = 0.0                      # an all-zero row: scale 1
    codes = rng.integers(-128, 128, (2, B, S, KV, cd)).astype(np.int8)
    scales = rng.random((2, B, S, KV, 1)).astype(np.float32) + 0.5
    return new, codes, scales, _positions(kind, B, S, rng)


def _reference(new, codes, scales, pos, dtype, bits):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cache = jlayers.KVCache(*(jnp.asarray(a) for a in
                              (codes[0], codes[1], scales[0], scales[1])))
    out = jlayers.update_cache(cache, jnp.asarray(new[0], jdt),
                               jnp.asarray(new[1], jdt), jnp.asarray(pos), bits)
    return [np.asarray(a) for a in out]


def _port(new, codes, scales, pos, dtype, bits):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ck, cv = (torch.from_numpy(codes[i].copy()) for i in (0, 1))
    ks, vs = (torch.from_numpy(scales[i].copy()) for i in (0, 1))
    k_new, v_new = (torch.from_numpy(new[i]).to(tdt) for i in (0, 1))
    ops.kv_quant_store(ck, cv, ks, vs, k_new, v_new, torch.from_numpy(pos), bits)
    return [convert.to_numpy(t) for t in (ck, cv, ks, vs)]


@pytest.mark.parametrize("kind", ["inside", "past_end", "ring"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,D,S", SHAPES)
def test_kv_quant_store_bit_exact_vs_update_cache(B, KV, D, S, dtype, bits, kind):
    new, codes, scales, pos = _case(B, KV, D, S, dtype, bits, kind,
                                    seed=B * 1000 + KV * 100 + D + S)
    want = _reference(new, codes, scales, pos, dtype, bits)
    got = _port(new, codes, scales, pos, dtype, bits)
    for name, g, w in zip(("k", "v", "k_scale", "v_scale"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    # the rows it wrote changed, every other slot kept its noise
    slot = np.clip(pos, 0, S - 1)
    written = np.zeros((B, S), bool)
    written[np.arange(B), slot] = True
    for i, (g, before) in enumerate(zip(got, (codes[0], codes[1], scales[0],
                                             scales[1]))):
        assert np.array_equal(g[~written], before[~written]), i


@pytest.mark.parametrize("bits", [8, 4])
def test_update_cache_goes_through_kv_quant_store(bits):
    """``layers.update_cache`` on a packed cache publishes one
    kernels/kv_quant_store call, with the bytes the fused store moves."""
    B, KV, D, S = 3, 2, 16, 8
    new, codes, scales, pos = _case(B, KV, D, S, "bfloat16", bits, "inside", 5)
    cache = layers.KVCache(*(torch.from_numpy(a.copy()) for a in
                             (codes[0], codes[1], scales[0], scales[1])))
    k_new, v_new = (torch.from_numpy(new[i]).to(torch.bfloat16) for i in (0, 1))
    with tobs.enabled_scope() as (reg, trc):
        layers.update_cache(cache, k_new, v_new, torch.from_numpy(pos), bits)
    counters = reg.snapshot().counters
    read, write = ops.kv_quant_store_io_bytes(B, KV, D, bits, 2)
    assert (read, write) == (2 * B * KV * D * 2,
                             2 * B * KV * (D if bits == 8 else D // 2) + 8 * B * KV)
    calls = {k: v for k, v in counters.items() if k.startswith("kernels/calls")}
    assert list(calls.values()) == [1] and "kv_quant_store" in next(iter(calls))
    hbm = {k: v for k, v in counters.items() if k.startswith("kernels/hbm_bytes")}
    assert sorted(hbm.values()) == sorted([read, write])
    assert [r.name for r in trc.records] == ["kernels/kv_quant_store"]


def _valid_args(bits=8, B=2, KV=2, D=8, S=4, dtype=torch.float32):
    cd = D if bits == 8 else D // 2
    return dict(cache_k=torch.zeros((B, S, KV, cd), dtype=torch.int8),
                cache_v=torch.zeros((B, S, KV, cd), dtype=torch.int8),
                k_scale=torch.ones((B, S, KV, 1)), v_scale=torch.ones((B, S, KV, 1)),
                k_new=torch.ones((B, 1, KV, D), dtype=dtype),
                v_new=torch.ones((B, 1, KV, D), dtype=dtype),
                slot=torch.zeros((B,), dtype=torch.int32), bits=bits)


def _noncontiguous(t):
    """The same values in a strided view (every other element of a 2x tensor)."""
    big = torch.zeros((*t.shape[:-1], 2 * t.shape[-1]), dtype=t.dtype)
    return big[..., ::2]


@pytest.mark.parametrize("name,bad", [
    ("k_new", lambda a: a["k_new"].to(torch.float16)),              # dtype
    ("v_new", lambda a: a["v_new"].to(torch.bfloat16)),             # K and V differ
    ("cache_k", lambda a: a["cache_k"].to(torch.int16)),
    ("k_scale", lambda a: a["k_scale"].to(torch.float64)),
    ("slot", lambda a: a["slot"].to(torch.float32)),
    ("slot", lambda a: a["slot"].to(torch.int64)),
    ("k_new", lambda a: torch.ones((2, 2, 2, 8))),                  # two tokens
    ("k_new", lambda a: torch.ones((2, 1, 2, 7))),                  # odd D
    ("cache_v", lambda a: torch.zeros((2, 4, 2, 4), dtype=torch.int8)),  # int4 width at 8 bits
    ("v_scale", lambda a: torch.ones((2, 4, 2))),
    ("slot", lambda a: torch.zeros((3,), dtype=torch.int32)),
    ("cache_k", lambda a: torch.zeros((2, 0, 2, 8), dtype=torch.int8)),  # S = 0
    ("cache_k", lambda a: _noncontiguous(a["cache_k"])),
    ("v_scale", lambda a: _noncontiguous(a["v_scale"])),
    ("slot", lambda a: a["slot"].to("meta")),                       # device mix
    ("k_new", lambda a: a["k_new"].to("meta")),
])
def test_kv_quant_store_rejects_bad_input(name, bad):
    args = _valid_args()
    args[name] = bad(args)
    with pytest.raises(ValueError):
        kvpack.kv_quant_store(**args)


def test_kv_quant_store_rejects_bad_bits():
    args = _valid_args()
    args["bits"] = 5
    with pytest.raises(ValueError):
        kvpack.kv_quant_store(**args)


def test_kv_quant_store_cuda_backend_on_cpu_tensor_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.kv_quant_store(**_valid_args(), backend="cuda")


@pytest.mark.parametrize("bits", [8, 4])
def test_cpu_path_launches_no_kernel(bits):
    ops.reset_launch_counts()
    args = _valid_args(bits)
    ops.kv_quant_store(**args)
    kvpack.kv_quant_store(**args)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert "kvpack.kv_quant_store" in ops.KERNELS


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_reset_decode_state_equals_init(bits):
    """A used state, zeroed in place, equals a fresh ``init_decode_state``
    leaf by leaf, in the same tensors."""
    cfg = tbase.load_smoke("granite-8b")
    rc = tbase.RunConfig(seq_len=16, global_batch=2, kind="decode",
                         param_dtype="float32", kv_cache_bits=bits)
    api = model_zoo.get_api(cfg, rc, "cpu")
    params = api.init(0)
    state = api.init_decode_state(2)
    for tok in ([1, 2], [3, 4], [5, 6]):
        _, state = api.decode_step(params, state, torch.tensor(tok))
    leaves = list(transformer.cache_leaves(state)) + [state.pos]
    assert any(bool(t.any()) for t in leaves)
    ptrs = [t.data_ptr() for t in leaves]
    reset = transformer.reset_decode_state(state)
    fresh = api.init_decode_state(2)
    got = list(transformer.cache_leaves(reset)) + [reset.pos]
    want = list(transformer.cache_leaves(fresh)) + [fresh.pos]
    assert [t.data_ptr() for t in got] == ptrs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert [c.kv.k_scale is None for c in reset.caches] == \
        [c.kv.k_scale is None for c in fresh.caches]
