"""The yardstick's arithmetic: the card's peaks and what a step needs.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (the port's
``launch/roofline.py`` constants, copied).  Bytes and operations are
counted from the shapes and from each row's position, as the inputs need
them: a cache slot counts only where the row's layer may read it (the
architecture's ``layer_slots``: causal, slots ``0 .. pos``, for the llama
block), every weight once a step (the architecture's ``weight_bytes``),
every input byte read once and every output written once.

Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np

BF16_FLOPS_PER_S = 989e12     # H100 SXM, bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3


def code_bytes(hd: int, bits: int) -> int:
    """Bytes of one cached row (one slot, one KV head) of K or of V: int8
    codes hd, int4 hd / 2 (two a byte), bf16 2 hd; plus a packed row's f32
    scale."""
    if bits == 16:
        return 2 * hd
    return (hd if bits == 8 else hd // 2) + 4


def decode_attention_bytes(cfg: dict, valid: np.ndarray, bits: int,
                           q_itemsize: int = 2) -> int:
    """One launch of the decode attention (one layer, one step) whose rows
    read ``valid`` (B,) slots each: q (B, H, hd) in, the codes and scales of
    those slots of K and V, the int32 positions, o (B, H, hd) f32 out."""
    B = len(valid)
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    cache = 2 * int(np.sum(valid)) * KV * code_bytes(hd, bits)
    return B * H * hd * q_itemsize + cache + 4 * B + B * H * hd * 4


def layers_slots(cfg: dict, arch, pos: np.ndarray, slots: int) -> list:
    """(B,) slots each layer reads at decode position ``pos``
    (``arch.layer_slots``), layer by layer."""
    return [arch.layer_slots(cfg, i, pos, slots) for i in range(cfg["n_layers"])]


def step_counts(cfg: dict, arch, pos: np.ndarray, slots: int, bits: int) -> dict:
    """What one decode step of the batch at positions ``pos`` needs: its
    FLOPs (the matmuls, and q.K and P.V over each layer's valid slots) and
    its bytes (weights once, each layer's valid slots, the new K and V
    written, each token's embedding row, the bf16 logits out), and the least
    time by the peaks.  ``arch`` is the configuration's ``arch/<arch>.py``."""
    B = len(pos)
    L, H, KV, hd = cfg["n_layers"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    d, V = cfg["d_model"], cfg["vocab"]
    per_layer = layers_slots(cfg, arch, pos, slots)
    valid = sum(int(v.sum()) for v in per_layer)
    flops = B * arch.matmul_flops_per_token(cfg) + 4 * valid * H * hd
    attn = sum(decode_attention_bytes(cfg, v, bits) for v in per_layer)
    new_kv = L * 2 * B * KV * code_bytes(hd, bits)
    nbytes = arch.weight_bytes(cfg) + attn + new_kv + B * d * 2 + B * V * 2
    least = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return {"flops": flops, "bytes": nbytes, "least_s": least, "attn_bytes": attn}
