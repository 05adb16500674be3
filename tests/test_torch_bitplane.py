"""The bitplane kernels' launch plan, and their order of work emulated in numpy.

``csrc/bitplane.cu`` runs only on a GPU.  What can be checked here is the
Python that cuts the work (``bitplane.launch_plan``) and the kernels'
arithmetic in the order the kernels do it: one thread per 32-word group,
the bit transpose in byte slices (PRMT gathers, an 8x8 bit transpose, PRMT
scatters), unpack's in-thread prefix sum, the block-wide scan of group
totals segmented by row, and the carry across the chunks of a long row.
The emulation follows the tiles of the launch plan and is held bit for bit
to the plain versions and to the JAX reference.  ``chip_smoke.py`` holds
the kernels themselves to the plain versions on the card.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.kernels import _build, bitplane, ops

BLOCKS = (32, 96, 256, 4096, 65536)
U32 = np.uint32
#: SMs of the emulated card: a grid of BLOCKS_PER_SM blocks, which the
#: emulated row counts outnumber, so each block walks several units
SMS = 1


def _cpu(a):
    return convert.to_torch(a, device="cpu")


def _np(t):
    return convert.to_numpy(t)


def _rows(block: int) -> int:
    """A row count ragged against the tile, of more units than the grid of
    SMS SMs has blocks: five whole tiles and a part, or five long rows."""
    plan = bitplane.launch_plan("pack", 1, block, 8, SMS)
    return 5 * plan.rows_per_tile + 1 if plan.chunks == 1 else 5


def _walks(plan) -> bool:
    """True when some block of the plan takes a second unit, and, for rows
    longer than a tile, a second row after the first row's last chunk."""
    per_block = {}
    for b, _, _, c in plan.tiles():
        per_block[b] = per_block.get(b, 0) + (c == 0)
    return max(per_block.values()) > 1


# -- the launch plan ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["pack", "unpack"])
@pytest.mark.parametrize("block", BLOCKS)
def test_launch_plan_covers_every_group_once(kind, block):
    groups = block // 32
    for bits in range(1, 33):
        for n in (1, _rows(block), 1000):
            for sms in (1, 3, 132):
                plan = bitplane.launch_plan(kind, n, block, bits, sms)
                assert plan.smem <= bitplane.SMEM_PER_BLOCK
                assert plan.smem == bitplane.smem_bytes(kind, bits)
                assert 1 <= plan.grid <= plan.units
                seen = np.zeros(n * groups, dtype=np.int64)
                last = {}
                for b, g0, ng, c in plan.tiles():
                    assert 1 <= ng <= bitplane.TILE_GROUPS
                    seen[g0:g0 + ng] += 1
                    if plan.chunks == 1:      # whole rows
                        assert g0 % groups == 0 and ng % groups == 0 and c == 0
                    else:                     # one row, chunks in order
                        assert g0 % groups == c * plan.chunk
                        assert c == 0 or last[b] == (g0 - plan.chunk, c - 1)
                        last[b] = (g0, c)
                assert (seen == 1).all(), (kind, block, bits, n, sms)


def test_launch_plan_main_shape():
    plan = bitplane.launch_plan("pack", 1 << 18, 256, 8, 132)
    assert (plan.rows_per_tile, plan.chunks, plan.units) == (32, 1, 8192)
    assert plan.grid == 132 * bitplane.BLOCKS_PER_SM
    plan = bitplane.launch_plan("unpack", 3, 65536, 32, 132)
    assert (plan.rows_per_tile, plan.chunk, plan.chunks) == (1, 256, 8)
    assert plan.grid == 3


@pytest.mark.parametrize("kind,n,bits,block", [
    ("pack", 4, 0, 64), ("pack", 4, 33, 64), ("unpack", 4, 8, 48),
    ("pack", 0, 8, 64), ("copy", 4, 8, 64)])
def test_launch_plan_rejects_bad_requests(kind, n, bits, block):
    with pytest.raises(ValueError):
        bitplane.launch_plan(kind, n, block, bits, 132)


def test_launch_refuses_cpu_tensors():
    q = torch.zeros(4, 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        bitplane._launch("pack", q, torch.empty(4, 16, dtype=torch.int32), 64, 8)


def test_plan_constants_match_the_kernels():
    """The launch plan's block size and blocks an SM are the ones the CUDA
    source compiles its kernels for (``__launch_bounds__``)."""
    src = (_build.CSRC / "bitplane.cu").read_text()
    assert re.search(rf"constexpr int kThreads = {bitplane.TILE_GROUPS};", src)
    assert re.search(rf"constexpr int kBlocksPerSm = {bitplane.BLOCKS_PER_SM};", src)
    assert src.count("__launch_bounds__(kThreads, kBlocksPerSm)") == 2


# -- the kernels' order of work, in numpy -------------------------------------

def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm: result byte n is byte (sel >> 4n) & 7 of {y:x}."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, dtype=np.uint64)
    for n in range(4):
        b = (sel >> (4 * n)) & 7
        out |= ((src >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(U32)


def gather4(a, b, c, d, sel: int):
    return byte_perm(byte_perm(a, b, sel), byte_perm(c, d, sel), 0x5410)


def transpose8(lo, hi):
    t = (lo ^ (lo >> U32(7))) & U32(0x00AA00AA)
    lo = lo ^ t ^ (t << U32(7))
    t = (hi ^ (hi >> U32(7))) & U32(0x00AA00AA)
    hi = hi ^ t ^ (t << U32(7))
    t = (lo ^ (lo >> U32(14))) & U32(0x0000CCCC)
    lo = lo ^ t ^ (t << U32(14))
    t = (hi ^ (hi >> U32(14))) & U32(0x0000CCCC)
    hi = hi ^ t ^ (t << U32(14))
    t = (lo ^ (hi << U32(4))) & U32(0xF0F0F0F0)
    return lo ^ t, hi ^ (t >> U32(4))


def emulate_pack(q: np.ndarray, bits: int) -> np.ndarray:
    """pack_kernel's arithmetic, tile by tile; each array entry is a thread."""
    n, block = q.shape
    groups = block // 32
    plan = bitplane.launch_plan("pack", n, block, bits, SMS)
    assert _walks(plan)
    words = q.view(U32).reshape(-1, 32)
    out = np.zeros((n * groups, bits), dtype=U32)
    for _, g0, ng, c in plan.tiles():
        w = [words[g0:g0 + ng, k].copy() for k in range(32)]
        t = np.arange(ng)
        row_start = (t % groups == 0) if plan.chunks == 1 else (t == 0) & (c == 0)
        before = words[g0 - 1, 31] if g0 else U32(0)     # memory before a chunk
        prev = np.concatenate([[before], w[31][:-1]]).astype(U32)
        prev[row_start] = 0
        for k in range(31, 0, -1):
            w[k] = w[k] - w[k - 1]
        w[0] = w[0] - prev
        for s in range((bits + 7) // 8):
            sel = s | ((s + 4) << 4)
            lo, hi = [], []
            for o in range(4):
                x, y = transpose8(gather4(*w[8 * o:8 * o + 4], sel),
                                  gather4(*w[8 * o + 4:8 * o + 8], sel))
                lo.append(x)
                hi.append(y)
            for r in range(8):
                if 8 * s + r < bits:
                    sr = (r & 3) | (((r & 3) + 4) << 4)
                    out[g0:g0 + ng, 8 * s + r] = gather4(*(lo if r < 4 else hi), sr)
    return out.reshape(n, groups * bits)


def emulate_unpack(planes: np.ndarray, bits: int, block: int) -> np.ndarray:
    """unpack_kernel's arithmetic, tile by tile: per-group rebuild, in-thread
    prefix, the block's scan of group totals segmented by row, and the
    carry a block keeps across the chunks of a long row."""
    n = planes.shape[0]
    groups = block // 32
    tg = bitplane.TILE_GROUPS
    plan = bitplane.launch_plan("unpack", n, block, bits, SMS)
    assert _walks(plan)
    pl = planes.reshape(-1, bits)
    out = np.zeros((n * groups, 32), dtype=U32)
    h = U32(1 << (bits - 1)) if bits < 32 else U32(0)
    carry = {}
    for b, g0, ng, c in plan.tiles():
        v = [np.zeros(tg, dtype=U32) for _ in range(32)]
        for s in range((bits + 7) // 8):
            pw = [np.zeros(tg, dtype=U32) for _ in range(8)]
            for r in range(8):
                if 8 * s + r < bits:
                    pw[r][:ng] = pl[g0:g0 + ng, 8 * s + r]
            put = [(0x3210 & ~(0xF << (4 * s))) | ((4 + k) << (4 * s)) for k in range(4)]
            for o in range(4):
                sel = o | ((o + 4) << 4)
                lo, hi = transpose8(gather4(*pw[:4], sel), gather4(*pw[4:], sel))
                for k in range(4):
                    v[8 * o + k] = byte_perm(v[8 * o + k], lo, put[k])
                    v[8 * o + 4 + k] = byte_perm(v[8 * o + 4 + k], hi, put[k])
        if bits < 32:
            v = [(x ^ h) - h for x in v]
        for k in range(1, 32):
            v[k] = v[k] + v[k - 1]
        total = v[31].copy()
        total[ng:] = 0                                  # idle threads add 0
        incl = np.cumsum(total, dtype=U32)
        excl = incl - total
        t = np.arange(tg)
        first = t - t % groups if plan.chunks == 1 else np.zeros(tg, dtype=np.int64)
        if c == 0:
            carry[b] = 0
        before = excl - excl[first] + U32(carry[b])
        carry[b] = (carry[b] + int(incl[-1])) & 0xFFFFFFFF
        out[g0:g0 + ng] = np.stack([x[:ng] + before[:ng] for x in v], axis=1)
    return out.reshape(n, block).view(np.int32)


def _codes(rng, n: int, block: int) -> np.ndarray:
    """Full-range int32 codes: deltas wrap int32 and overflow every width."""
    return rng.integers(-2**31, 2**31, size=(n, block), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("bits", [1, 7, 8, 13, 32])
@pytest.mark.parametrize("block", BLOCKS)
def test_emulated_pack_order_is_bit_exact(block, bits):
    rng = np.random.default_rng(block + bits)
    q = _codes(rng, _rows(block), block)
    got = emulate_pack(q, bits)
    assert np.array_equal(got, _np(bitplane.pack_plain(_cpu(q), bits)))
    want = np.asarray(jops.pack_codes(jnp.asarray(q), bits, use_pallas="ref"))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bits", [1, 7, 8, 13, 32])
@pytest.mark.parametrize("block", BLOCKS)
def test_emulated_unpack_order_is_bit_exact(block, bits):
    rng = np.random.default_rng(7 * block + bits)
    q = _codes(rng, _rows(block), block)
    planes = _np(bitplane.pack_plain(_cpu(q), bits))
    got = emulate_unpack(planes, bits, block)
    assert np.array_equal(got, _np(bitplane.unpack_plain(_cpu(planes), bits, block)))
    assert np.array_equal(got, _np(ops.unpack_codes(_cpu(planes), bits, block)))
    want = np.asarray(jops.unpack_codes(jnp.asarray(planes), bits, block,
                                        use_pallas="ref"))
    assert np.array_equal(got, want)
    if bits == 32:
        assert np.array_equal(got, q)
