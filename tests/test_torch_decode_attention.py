"""The port's single-device decode attention (CPU) against the JAX package.

``layers.decode_attention`` routes one device's step through
``ops.kv_decode_attention``: on a CUDA tensor one kernel
(``csrc/decode_attention.cu``) reads the cache once, dequantizes it on chip
and attends; on a CPU tensor the plain version runs the dequant, the cast
to the compute dtype and the decode softmax op by op.  Here, on the CPU:

* the port's ``decode_attention`` against ``repro.models.layers.
  decode_attention`` on the same weights, cache and positions, made with
  numpy from a seed: bits 16, 8 and 4, f32 and bf16, causal, window and
  ring caches, G = 1, 4 and 5;
* a head block cut mid-group (the ``index_select`` route) against the
  reference's output heads (``wo`` the identity);
* the plain route bit-equal to the composition it replaced (dequant,
  cast, ``_attend``), and the wrapper's checks, byte charge and series;
* ``valid_interval``, the interval of slots the kernel walks, against the
  support of ``valid_slots``, and the tiles and slots the kernel's walk
  counts.

The card's kernel is held against the plain version by ``chip_smoke.py``'s
``kvpack`` phase and ``tests/test_torch_decode_attention_card.py``.
Tolerances: f32 within 1e-4 (the serve tests' rule), bf16 within 3e-2 of
the largest reference value.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.kernels import decode_attention as dattn
from repro_torch.kernels import ops
from repro_torch.models import layers

B, HD = 3, 32
F32_TOL, BF16_REL = 1e-4, 3e-2
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (None, torch.bfloat16, jnp.bfloat16)}
#: (query heads, KV heads): G = 1 (whisper's), 4 (granite's), 5 (hymba's)
GROUPS = {1: (4, 4), 4: (8, 2), 5: (10, 2)}
#: (cache slots, window, positions a row): causal over the whole cache, a
#: window shorter than the cache, a ring cache of the window's length
#: whose positions wrap past it
MASKS = {"causal": (40, 0, (39, 0, 17)),
         "window": (40, 12, (39, 5, 23)),
         "ring": (16, 16, (52, 3, 16))}


def _cfgs(G: int, d_model: int = 64):
    H, KV = GROUPS[G]
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=HD, d_model=d_model)
    return (dataclasses.replace(jbase.load_smoke("granite-8b"), **kw),
            dataclasses.replace(tbase.load_smoke("granite-8b"), **kw))


def _cast(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor in ``dtype``."""
    _, tdt, jdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def _inputs(rng, cfg, S: int, bits: int, dtype: str, wo_eye: bool = False):
    """Weights, x (B, 1, d) and a cache full of seeded values, each as
    (JAX, port) pairs."""
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    w = {n: rng.standard_normal(s).astype(np.float32) * d ** -0.5
         for n, s in (("wq", (d, H * HD)), ("wk", (d, KV * HD)), ("wv", (d, KV * HD)))}
    w["wo"] = (np.eye(H * HD, d, dtype=np.float32) if wo_eye else
               rng.standard_normal((H * HD, d)).astype(np.float32) * (H * HD) ** -0.5)
    pj = jlayers.AttnParams(**{n: _cast(a, dtype)[0] for n, a in w.items()},
                            bq=None, bk=None, bv=None)
    pt = layers.AttnParams(**{n: _cast(a, dtype)[1] for n, a in w.items()})
    x = _cast(rng.standard_normal((B, 1, d)).astype(np.float32), dtype)
    if bits == 16:
        kv = [_cast(rng.standard_normal((B, S, KV, HD)).astype(np.float32), dtype)
              for _ in range(2)]
        cj = jlayers.KVCache(kv[0][0], kv[1][0], None, None)
        ct = layers.KVCache(kv[0][1], kv[1][1], None, None)
    else:
        cd = HD if bits == 8 else HD // 2
        a = [rng.integers(-128, 128, (B, S, KV, cd)).astype(np.int8) for _ in range(2)]
        s = [(rng.random((B, S, KV, 1)) * 0.05 + 0.01).astype(np.float32)
             for _ in range(2)]
        cj = jlayers.KVCache(*(jnp.asarray(t) for t in (*a, *s)))
        ct = layers.KVCache(*(torch.from_numpy(t.copy()) for t in (*a, *s)))
    return pj, pt, x, cj, ct


def _close(got, want, dtype):
    got, want = convert.to_numpy(got).astype(np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    if dtype == "float32":
        return err <= F32_TOL, err
    return err <= BF16_REL * float(np.abs(want).max()), err


@pytest.mark.parametrize("G", sorted(GROUPS))
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", (16, 8, 4))
def test_decode_attention_matches_reference(bits, dtype, mask, G):
    cfg_j, cfg_t = _cfgs(G)
    S, window, positions = MASKS[mask]
    rng = np.random.default_rng(bits * 100 + G)
    pj, pt, (xj, xt), cj, ct = _inputs(rng, cfg_t, S, bits, dtype)
    pos = np.asarray(positions, np.int32)
    want, _ = jlayers.decode_attention(xj, pj, cfg_j, cj, jnp.asarray(pos), bits,
                                       window)
    before = ops.launch_counts()
    with torch.no_grad():
        got, cache = layers.decode_attention(xt, pt, cfg_t, ct, torch.from_numpy(pos),
                                             bits, window)
    ok, err = _close(got, want, dtype)
    assert ok, (bits, dtype, mask, G, err)
    assert cache is ct and ops.launch_counts() == before   # CPU: nothing launched


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", (16, 8, 4))
@pytest.mark.parametrize("block", ((2, 5), (3, 2), (5, 1), (4, 4)))
def test_head_block_matches_reference_heads(block, bits, dtype):
    """Query heads [q0, q0 + n) of G = 4, cut mid-group or whole, against
    the reference's output with ``wo`` the identity (its attention
    output, head by head)."""
    q0, n = block
    cfg_j, cfg_t = _cfgs(4, d_model=8 * HD)
    S, window, positions = MASKS["causal"]
    rng = np.random.default_rng(7 + bits)
    pj, pt, (xj, xt), cj, ct = _inputs(rng, cfg_t, S, bits, dtype, wo_eye=True)
    pos = np.asarray(positions, np.int32)
    want, cj = jlayers.decode_attention(xj, pj, cfg_j, cj, jnp.asarray(pos), bits)
    with torch.no_grad():
        tpos = torch.from_numpy(pos)
        q, k_new, v_new = layers.decode_queries(xt, pt, cfg_t, tpos)
        layers.update_cache(ct, k_new, v_new, tpos, bits)
        # the reference's stored rows, so that only the attention is compared
        for t, a in zip(ct, cj):
            if t is not None:
                t.copy_(torch.from_numpy(np.array(a.astype(jnp.float32))).to(t.dtype))
        got = ops.kv_decode_attention(q[:, :, q0:q0 + n], ct, tpos, bits, q0, 4,
                                      dtype=xt.dtype)
    ok, err = _close(got.to(xt.dtype), np.asarray(want.astype(jnp.float32))[
        ..., q0 * HD:(q0 + n) * HD], dtype)
    assert ok, (block, bits, dtype, err)


def _composition(q, cache, pos, bits, q0, G, S_all, window, ring, cdt):
    """The single-device decode before the kernel, as it stood: the cache
    dequantized through ``kv_dequant`` and cast, the mask, ``_attend``."""
    S = cache.k.shape[1]
    if bits == 16:
        k, v = cache.k, cache.v
    else:
        k = layers._dequant_rows(cache.k, cache.k_scale, bits).to(cdt)
        v = layers._dequant_rows(cache.v, cache.v_scale, bits).to(cdt)
    j = torch.arange(S, device=q.device)[None, :]
    if ring:
        k_pos = pos[:, None] - torch.remainder(pos[:, None] - j, S_all)
        valid = k_pos >= 0
    else:
        k_pos = j
        valid = k_pos <= pos[:, None]
        if window > 0:
            valid &= (pos[:, None] - k_pos) < window
    return layers._attend(q, k, v, q0, G, valid, group=None)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", (16, 8, 4))
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_plain_route_bit_equal_to_the_composition(mask, bits, dtype):
    _, cfg_t = _cfgs(5)
    S, window, positions = MASKS[mask]
    ring = window > 0 and S <= window
    rng = np.random.default_rng(11)
    _, _, _, _, ct = _inputs(rng, cfg_t, S, bits, dtype)
    pos = torch.tensor(positions, dtype=torch.int32)
    qn = rng.standard_normal((B, 1, cfg_t.n_heads, HD)).astype(np.float32)
    q = _cast(qn, dtype)[1]
    for q0, n in ((0, 10), (3, 4), (5, 5), (7, 1)):
        qb = q[:, :, q0:q0 + n]
        got = ops.kv_decode_attention(qb, ct, pos, bits, q0, 5, s_all=S,
                                      window=window, ring=ring, dtype=q.dtype)
        want = _composition(qb, ct, pos, bits, q0, 5, S, window, ring, q.dtype)
        assert got.dtype == torch.float32 and got.shape == (B, 1, n * HD)
        assert torch.equal(got, want), (mask, bits, dtype, q0, n)


def test_round_p_false_keeps_f32_probabilities():
    """``round_p=False`` (the cross-attention's rule) is ``_attend``'s."""
    _, cfg_t = _cfgs(4)
    rng = np.random.default_rng(3)
    _, _, _, _, ct = _inputs(rng, cfg_t, 24, 8, "bfloat16")
    pos = torch.tensor([23, 4, 11], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, 1, 8, HD)).astype(np.float32)).to(
        torch.bfloat16)
    got = ops.kv_decode_attention(q, ct, pos, 8, 0, 4, round_p=False)
    k = layers._dequant_rows(ct.k, ct.k_scale, 8).to(torch.bfloat16)
    v = layers._dequant_rows(ct.v, ct.v_scale, 8).to(torch.bfloat16)
    valid = dattn.valid_slots(pos, 24, 0, 24, 0, False)
    assert torch.equal(got, layers._attend(q, k, v, 0, 4, valid, round_p=False))


def test_io_bytes_and_series():
    """The byte charge (q, codes and scales of every slot read, positions;
    o written) and the ``kernels/*`` series of one plain call."""
    assert ops.kv_decode_attention_io_bytes(8, 256, 8, 128, 32, 8) == (
        8 * 32 * 128 * 2 + 2 * 8 * 256 * 8 * (128 + 4) + 8 * 4, 8 * 32 * 128 * 4)
    assert ops.kv_decode_attention_io_bytes(2, 10, 3, 64, 6, 4, 4) == (
        2 * 6 * 64 * 4 + 2 * 2 * 10 * 3 * (32 + 4) + 2 * 4, 2 * 6 * 64 * 4)
    assert ops.kv_decode_attention_io_bytes(2, 10, 3, 64, 6, 16, 2, 4) == (
        2 * 6 * 64 * 2 + 2 * 2 * 10 * 3 * 64 * 4 + 2 * 4, 2 * 6 * 64 * 4)
    _, cfg_t = _cfgs(4)
    rng = np.random.default_rng(5)
    _, _, _, _, ct = _inputs(rng, cfg_t, 16, 4, "float32")
    q = torch.from_numpy(rng.standard_normal((B, 1, 3, HD)).astype(np.float32))
    with tobs.enabled_scope() as (reg, trc):
        ops.kv_decode_attention(q, ct, torch.tensor([15, 0, 7], dtype=torch.int32),
                                4, 2, 4)
    r, w = ops.kv_decode_attention_io_bytes(B, 16, 2, HD, 3, 4, 4)
    labels = dict(kernel="kv_decode_attention", mode="ref", bits=4)
    assert reg.counter_value("kernels/calls", **labels) == 1
    assert [reg.counter_value("kernels/hbm_bytes", dir=d, **labels)
            for d in ("read", "write")] == [r, w]
    assert [rec.name for rec in trc.records] == ["kernels/kv_decode_attention"]


def _bad_calls():
    c8 = layers.KVCache(torch.zeros(2, 8, 2, 32, dtype=torch.int8),
                        torch.zeros(2, 8, 2, 32, dtype=torch.int8),
                        torch.ones(2, 8, 2, 1), torch.ones(2, 8, 2, 1))
    q = torch.zeros(2, 1, 4, 32)
    pos = torch.zeros(2, dtype=torch.int32)
    return {
        "bits": (q, c8, pos, 6, 0, 2),
        "q_rank": (q[:, 0], c8, pos, 8, 0, 2),
        "q_dtype": (q.half(), c8, pos, 8, 0, 2),
        "rows": (q, c8, pos, 4, 0, 2),
        "scales": (q, c8._replace(k_scale=torch.ones(2, 8, 2, 1, dtype=torch.float64)),
                   pos, 8, 0, 2),
        "codes": (q, c8._replace(k=c8.k.float(), v=c8.v.float()), pos, 8, 0, 2),
        "bf16_16": (q, c8._replace(k=c8.k.half(), v=c8.v.half()), pos, 16, 0, 2),
        "pos": (q, c8, pos[:1], 8, 0, 2),
        "heads": (q, c8, pos, 8, 1, 2),
        "batch": (q[:1], c8, pos[:1], 8, 0, 2),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects(case):
    with pytest.raises(ValueError):
        dattn.kv_decode_attention(*_bad_calls()[case])


def test_kernel_checks_refuse_what_the_kernel_does_not_take():
    """The kernel's own limits (checked before a launch): hd 32 / 64 / 128,
    G <= 16, int32 positions, a contiguous cache, bf16 probabilities
    rounded (the tensor cores take P in bf16), a ring's block inside the
    ring (where its valid slots form one interval)."""
    c = layers.KVCache(torch.zeros(1, 8, 1, 32, dtype=torch.int8),
                       torch.zeros(1, 8, 1, 32, dtype=torch.int8),
                       torch.ones(1, 8, 1, 1), torch.ones(1, 8, 1, 1))
    pos = torch.zeros(1, dtype=torch.int32)
    f32, bf16 = torch.float32, torch.bfloat16
    dattn._check_kernel(torch.zeros(1, 1, 16, 32), c, pos, 8, 16, f32, False)
    dattn._check_kernel(torch.zeros(1, 1, 16, 32), c, pos, 8, 16, bf16, True)
    dattn._check_kernel(torch.zeros(1, 1, 4, 32), c, pos, 8, 4, bf16, True, 8, 16,
                        True)
    with pytest.raises(ValueError, match="ring"):
        dattn._check_kernel(torch.zeros(1, 1, 4, 32), c, pos, 8, 4, bf16, True, 12,
                            16, True)
    with pytest.raises(ValueError):
        dattn._check_kernel(torch.zeros(1, 1, 4, 32), c, pos, 8, 4, bf16, False)
    for q, cache, p, G in ((torch.zeros(1, 1, 4, 48), c, pos, 4),
                           (torch.zeros(1, 1, 17, 32), c, pos, 17),
                           (torch.zeros(1, 1, 4, 32), c, pos.long(), 4),
                           (torch.zeros(1, 1, 4, 32),
                            c._replace(k=torch.zeros(1, 8, 2, 32, dtype=torch.int8)
                                       [:, :, :1]), pos, 4)):
        with pytest.raises(ValueError):
            dattn._check_kernel(q, cache, p, 8, G, bf16, True)


#: (S, lo, s_all, window, ring): a causal cache, a window, a ring before
#: it wraps, blocks [lo, lo + S) of a larger cache (a rank's share) under
#: each mask, a ring past its wrap, and a block no position below lo
#: reaches
INTERVALS = {"causal": (40, 0, 40, 0, False),
             "window": (40, 0, 40, 12, False),
             "ring": (64, 0, 64, 64, True),
             "lo_block": (24, 32, 96, 0, False),
             "lo_window": (24, 32, 96, 20, False),
             "lo_ring": (24, 32, 96, 96, True),
             "wrapped_ring": (16, 0, 16, 16, True),
             "empty_block": (24, 200, 256, 0, False)}


@pytest.mark.parametrize("case", sorted(INTERVALS))
def test_valid_interval_is_the_support_of_valid_slots(case):
    """``valid_interval`` against ``valid_slots`` at every position from
    before the cache to past a wrap; ``slots_read`` and ``walked_tiles``
    against the mask itself, slot by slot and tile by tile."""
    S, lo, s_all, window, ring = INTERVALS[case]
    pos = torch.arange(-3, s_all + 90, dtype=torch.int32)
    mask = dattn.valid_slots(pos, S, lo, s_all, window, ring)
    a, b = dattn.valid_interval(pos, S, lo, s_all, window, ring)
    s = torch.arange(S)[None, :]
    inside = (s >= a[:, None]) & (s < b[:, None])
    assert torch.equal(inside, mask), case
    assert torch.equal(a < b, inside.any(1))
    if case == "empty_block":
        assert not bool(mask[pos < lo].any()) and bool((a >= b)[pos < lo].all())
    # the kernel reads the interval, or every slot of a row with none
    read = torch.where(inside.any(1)[:, None], inside, torch.ones_like(inside))
    assert dattn.slots_read(pos, S, lo, s_all, window, ring) == int(read.sum())
    for sc in (dattn.TILE, 2 * dattn.TILE):       # a CTA's slots, split or whole
        want = 0
        for s0 in range(0, S, sc):
            cta = read[:, s0:min(S, s0 + sc)]
            want += sum(int(cta[:, t:t + dattn.TILE].any(1).sum())
                        for t in range(0, cta.shape[1], dattn.TILE))
        assert dattn.walked_tiles(pos, S, lo, s_all, window, ring, sc) == want
    assert dattn.tiles_allocated(len(pos), S, 3) == 3 * len(pos) * -(-S // dattn.TILE)


def test_io_bytes_charge_the_slots_read():
    """``slots`` replaces every slot of every row in the byte charge; the
    card's partial-position access case walks the same bytes of the cache
    (``access._valid_rows_bytes``) as its charge counts."""
    from repro_torch.analysis import access
    full = ops.kv_decode_attention_io_bytes(8, 256, 8, 128, 32, 8)
    assert ops.kv_decode_attention_io_bytes(8, 256, 8, 128, 32, 8,
                                            slots=8 * 256) == full
    r, w = ops.kv_decode_attention_io_bytes(8, 256, 8, 128, 32, 4, slots=100)
    assert (r, w) == (8 * 32 * 128 * 2 + 2 * 8 * 100 * (64 + 4) + 8 * 4, full[1])
    B, S, KV, Dh = access.STORE_SHAPE
    pos = torch.tensor(access.PARTIAL_POS, dtype=torch.int32)
    for bits in access.GRID_BITS:
        cd = Dh if bits == 8 else Dh // 2
        codes = torch.zeros(B, S, KV, cd, dtype=torch.int8)
        scales = torch.ones(B, S, KV, 1)
        q = torch.zeros(B, 1, KV * 4, Dh, dtype=torch.bfloat16)
        slots = dattn.slots_read(pos, S, 0, S, 0, False)
        r, _ = ops.kv_decode_attention_io_bytes(B, S, KV, Dh, KV * 4, bits, slots=slots)
        walked = (q.numel() * 2 + pos.numel() * 4
                  + access._valid_rows_bytes((q, codes, codes, scales, scales, pos)))
        assert walked == r and slots < B * S
