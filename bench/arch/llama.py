"""The llama-style block, plain: what the harness knows of its architecture.

Per layer: RMSNorm, GQA self-attention with interleaved-pair RoPE (one
``rope_theta`` for every layer), causal over the session's whole cache, the
output projection and a residual; RMSNorm, then a SwiGLU MLP (``family``
``dense``) or a dropless top-k mixture of SwiGLU experts (``moe``), and a
residual.  Granite and Mixtral are such models.

A configuration names this file by its ``"arch"``; the program's side of
the same block is ``bridges/llama.py``.  Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import reference as R


def routes(cfg: dict) -> bool:
    """Whether the FFN routes tokens to experts."""
    if cfg["family"] not in ("dense", "moe"):
        raise ValueError(f"the llama block has a dense or moe FFN, not "
                         f"{cfg['family']!r}")
    return cfg["family"] == "moe"


def layout(cfg: dict) -> List[Tuple[str, tuple, object]]:
    """(name, shape, init) of every weight: init is a std (normal) or
    ``"ones"``.  Names follow the port's module tree."""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    H, KV, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    s = d ** -0.5
    out = [("embed.table", (V, d), 0.02)]
    if not cfg.get("tie_embeddings", False):
        out.append(("embed.unembed", (d, V), s))
    out.append(("embed.final_norm", (d,), "ones"))
    moe = routes(cfg)
    for i in range(L):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), "ones"),
                (p + "attn.wq", (d, H * hd), s), (p + "attn.wk", (d, KV * hd), s),
                (p + "attn.wv", (d, KV * hd), s),
                (p + "attn.wo", (H * hd, d), (H * hd) ** -0.5),
                (p + "ln2", (d,), "ones")]
        if moe:
            E = cfg["n_experts"]
            out += [(p + "moe.router", (d, E), s),
                    (p + "moe.w_gate", (E, d, ff), s), (p + "moe.w_up", (E, d, ff), s),
                    (p + "moe.w_down", (E, ff, d), ff ** -0.5)]
        else:
            out += [(p + "mlp.w_gate", (d, ff), s), (p + "mlp.w_up", (d, ff), s),
                    (p + "mlp.w_down", (ff, d), ff ** -0.5)]
    return out


def layer(cfg: dict, i: int, lw: Dict[str, torch.Tensor], x: torch.Tensor,
          pos: torch.Tensor, kv_bits: int,
          past: Optional[Tuple[torch.Tensor, torch.Tensor]],
          margin: Optional[list]) -> torch.Tensor:
    """Layer ``i`` of the reference: ``x`` (T, d) f32 at positions ``pos``,
    ``lw`` the layer's f32 weights, ``past`` the session's packed history
    (K, V (start, KV, hd) f32) or ``None``; ``margin`` gets a MoE layer's
    router margins (``reference.moe``)."""
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    T = x.shape[0]
    h = R.rmsnorm(x, lw["ln1"], eps)
    q = R.rope((h @ lw["attn.wq"]).reshape(T, H, hd), pos, theta)
    k = R.packed(R.rope((h @ lw["attn.wk"]).reshape(T, KV, hd), pos, theta), kv_bits)
    v = R.packed((h @ lw["attn.wv"]).reshape(T, KV, hd), kv_bits)
    if past is not None:
        k, v = torch.cat([past[0], k]), torch.cat([past[1], v])
    x = x + R.attention(q, k, v, pos) @ lw["attn.wo"]
    h = R.rmsnorm(x, lw["ln2"], eps)
    if routes(cfg):
        return x + R.moe(h, lw, cfg, margin)
    return x + R.swiglu(h, lw["mlp.w_gate"], lw["mlp.w_up"], lw["mlp.w_down"])


def layer_slots(cfg: dict, i: int, pos: np.ndarray, slots: int) -> np.ndarray:
    """Slots layer ``i`` reads at decode position ``pos`` (B,) in a causal
    cache of ``slots``: the written ones, the current included."""
    return np.minimum(np.asarray(pos, np.int64) + 1, slots)


def weight_bytes(cfg: dict) -> int:
    """bf16 bytes of every weight read in one decode step: all layers, the
    final norm and the unembedding, one embedding row a token (counted with
    the activations, so not here).  A MoE block reads every expert: at the
    batches served here some token is routed to each."""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    H, KV, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    attn = d * H * hd * 2 + d * KV * hd * 2
    moe = routes(cfg)
    ffn = 3 * d * ff * (cfg["n_experts"] if moe else 1)
    router = d * cfg["n_experts"] if moe else 0
    per_layer = attn + ffn + router + 2 * d
    unembed = d * V
    return 2 * (L * per_layer + unembed + d)


def matmul_flops_per_token(cfg: dict) -> int:
    """2 x the weights one token multiplies (its top-k experts of a MoE)."""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    H, KV, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    attn = d * H * hd * 2 + d * KV * hd * 2
    if routes(cfg):
        ffn = 3 * d * ff * cfg["topk"] + d * cfg["n_experts"]
    else:
        ffn = 3 * d * ff
    return 2 * (L * (attn + ffn) + d * V)
