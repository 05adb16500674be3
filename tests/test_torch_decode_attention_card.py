"""The decode attention kernel on the card: it walks only the tiles a row's
position makes valid, and reads no masked slot.

The kernel has no CPU mode, so every test here is marked ``cuda`` and skips
without a card.  On a machine with one, from the repository root:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_decode_attention_card.py

No JAX here: the kernel is held to its plain PyTorch version through
``chip_smoke.py``'s own checks (``da_case``): within the plain version's
tolerance, ``torch.equal`` to itself on a cache whose slots outside each
row's valid interval hold NaN scales and extreme codes, and its tiles
walked, by its own counter, equal to ``decode_attention.walked_tiles``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import decode_attention as dattn  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the decode attention kernel has no "
                    "CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("bits", (16, 8, 4))
@pytest.mark.parametrize("mask", sorted(cs.DA_MASKS))
def test_masked_slots_are_never_read(dev, mask, bits, dtype):
    rng = np.random.default_rng(cs.SEED + bits)
    for i, G in enumerate(sorted(cs.DA_GROUPS)):
        row = cs.da_case(dev, rng, *cs.da_shape(mask, G, i), bits,
                         getattr(torch, dtype), mask)
        assert row["ok"] and row["poisoned_equal"], row
        assert row["tiles"][0] == row["tiles"][1], row


@pytest.mark.parametrize("label", ("granite_chat_p511", "granite_32k_p29696"))
def test_partial_positions_walk_the_valid_tiles(dev, label):
    """granite's chat batch at position 511 of 2,048 and the 32k cache at
    29,696: the plain version's output, the poisoned cache's, and the tiles
    walked, fewer than the tiles held."""
    B, S, KV, G, hd, window, at = cs.DA_TIMED[label]
    rng = np.random.default_rng(cs.SEED)
    cache = cs.da_inputs(dev, rng, B, S, KV, hd, 8, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * G, hd)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    pos = torch.full((B,), at, dtype=torch.int32, device=dev)
    args = (pos, 8, 0, G, 0, S, window, False, True, torch.bfloat16)
    got = dattn.kv_decode_attention(q, cache, *args)
    want = dattn.kv_decode_attention_plain(q, cache, *args)
    _, ok = cs.da_err(got.reshape(B, 1, -1, hd), want.reshape(B, 1, -1, hd),
                      torch.bfloat16)
    assert ok
    poisoned = cs.da_poisoned(cache, pos, S, window, False)
    assert torch.equal(dattn.kv_decode_attention(q, poisoned, *args), got)
    walked, twin = cs.da_tiles(q, cache, pos, 8, 0, G, window, False)
    assert walked == twin < dattn.tiles_allocated(B, S, KV)
