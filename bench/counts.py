"""The yardstick's arithmetic: the card's peaks and what a step needs.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (the port's
``launch/roofline.py`` constants, copied).  Bytes and operations are
counted from the shapes and from each row's position, as the inputs need
them: a cache slot counts only where the row may read it (causal: slots
``0 .. pos``; the kernel today reads every allocated slot, so a kernel
that skips masked tiles stays under 100%), every weight once a step (for
a MoE block: the experts some token is routed to; at the batches served
here every expert), every input byte read once and every output written
once.

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


def valid_slots(pos: np.ndarray, slots: int) -> np.ndarray:
    """Slots each row reads at decode position ``pos`` (B,) in a causal
    cache of ``slots``: the written ones, the current included."""
    return np.minimum(np.asarray(pos, np.int64) + 1, slots)


def decode_attention_bytes(cfg: dict, pos: np.ndarray, slots: int, bits: int,
                           q_itemsize: int = 2) -> int:
    """One launch of the decode attention (one layer, one step): q (B, H,
    hd) in, the codes and scales of the valid slots of K and V, the int32
    positions, o (B, H, hd) f32 out."""
    B = len(pos)
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    cache = 2 * int(valid_slots(pos, slots).sum()) * KV * code_bytes(hd, bits)
    return B * H * hd * q_itemsize + cache + 4 * B + B * H * hd * 4


def weight_bytes(cfg: dict) -> int:
    """bf16 bytes of every weight read in one decode step: all layers, the
    final norm and the unembedding, one embedding row a token (counted with
    the activations, so not here)."""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    H, KV, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    attn = d * H * hd * 2 + d * KV * hd * 2
    ffn = 3 * d * ff * (cfg["n_experts"] if cfg["family"] == "moe" else 1)
    router = d * cfg["n_experts"] if cfg["family"] == "moe" else 0
    per_layer = attn + ffn + router + 2 * d
    unembed = d * V
    return 2 * (L * per_layer + unembed + d)


def matmul_flops_per_token(cfg: dict) -> int:
    """2 x the weights one token multiplies (its top-k experts of a MoE)."""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    H, KV, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    attn = d * H * hd * 2 + d * KV * hd * 2
    if cfg["family"] == "moe":
        ffn = 3 * d * ff * cfg["topk"] + d * cfg["n_experts"]
    else:
        ffn = 3 * d * ff
    return 2 * (L * (attn + ffn) + d * V)


def step_counts(cfg: dict, pos: np.ndarray, slots: int, bits: int) -> dict:
    """What one decode step of the batch at positions ``pos`` needs: its
    FLOPs (the matmuls, and q.K and P.V over the valid slots) and its bytes
    (weights once, the valid slots, the new K and V written, each token's
    embedding row, the bf16 logits out), and the least time by the peaks."""
    B = len(pos)
    L, H, KV, hd = cfg["n_layers"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    d, V = cfg["d_model"], cfg["vocab"]
    valid = int(valid_slots(pos, slots).sum())
    flops = B * matmul_flops_per_token(cfg) + L * 4 * valid * H * hd
    attn = L * decode_attention_bytes(cfg, pos, slots, bits)
    new_kv = L * 2 * B * KV * code_bytes(hd, bits)
    nbytes = weight_bytes(cfg) + attn + new_kv + B * d * 2 + B * V * 2
    least = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return {"flops": flops, "bytes": nbytes, "least_s": least,
            "attn_bytes": attn, "valid_slots": valid}
