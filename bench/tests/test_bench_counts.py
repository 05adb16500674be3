"""The frozen byte and FLOP counts against hand-worked values."""
import numpy as np
import pytest

from _tiny import config
from bench import counts, spec

LLAMA, _ = spec.architecture("llama")


def test_decode_attention_bytes_count_valid_slots_only():
    cfg = config()               # H 4, KV 2, hd 16
    pos = np.array([0, 5, 47])   # valid slots 1, 6, 48 of a 48-slot cache
    valid = LLAMA.layer_slots(cfg, 0, pos, 48)
    assert valid.tolist() == [1, 6, 48]
    got = counts.decode_attention_bytes(cfg, valid, 8)
    q = 3 * 4 * 16 * 2
    cache = 2 * (1 + 6 + 48) * 2 * (16 + 4)
    assert got == q + cache + 3 * 4 + 3 * 4 * 16 * 4
    at_100 = LLAMA.layer_slots(cfg, 1, np.array([100]), 48)   # every slot
    assert counts.decode_attention_bytes(cfg, at_100, 4) == \
        4 * 16 * 2 + 2 * 48 * 2 * (8 + 4) + 4 + 4 * 16 * 4


def test_step_counts_by_hand():
    cfg = config()
    d, V, ff, L = 64, 97, 128, 2
    pos = np.array([3, 9])
    c = counts.step_counts(cfg, LLAMA, pos, 48, 8)
    per_token = 2 * (L * (d * 64 * 2 + d * 32 * 2 + 3 * d * ff) + d * V)
    assert c["flops"] == 2 * per_token + L * 4 * (4 + 10) * 4 * 16
    weights = 2 * (L * (d * 64 * 2 + d * 32 * 2 + 3 * d * ff + 2 * d) + d * V + d)
    attn = L * counts.decode_attention_bytes(cfg, pos + 1, 8)
    assert c["bytes"] == weights + attn + L * 2 * 2 * 2 * 20 + 2 * d * 2 + 2 * V * 2
    assert c["least_s"] == max(c["flops"] / 989e12, c["bytes"] / 3.35e12)


def test_moe_reads_every_expert_and_multiplies_topk():
    cfg = config("moe")
    dense = config()
    mlp = 3 * 64 * 128
    assert LLAMA.weight_bytes(cfg) - LLAMA.weight_bytes(dense) == \
        2 * 2 * (3 * mlp + 64 * 4)
    assert LLAMA.matmul_flops_per_token(cfg) - LLAMA.matmul_flops_per_token(dense) == \
        2 * 2 * (mlp + 64 * 4)


def test_device_idle_reads_the_untraced_step():
    from bench import spec
    idle = spec.load_module(spec.BENCH / "metrics" / "device_idle.py", "metric_device_idle")
    ctx = {"profile": {"busy_s": 0.45, "window_s": 0.6}, "profile_steps": 10,
           "window": {"seconds": 50.0, "steps": 1000}}
    assert idle.read(ctx) == pytest.approx(0.1)      # 45 ms busy of a 50 ms step
    assert idle.read(dict(ctx, profile=None)) is None
