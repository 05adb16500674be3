"""The plain reference: the served model's forward pass in float32 PyTorch.

It follows the published architecture as the configuration file states it
and knows nothing of the program: it imports no ``repro_torch``, takes no
tensor the program made, and works out again whatever the program derives
(the packed cache's codes and scales).  Weights are the benchmark's bf16
inputs, each layer's cast to f32 as it is used; activations, scores and
softmax are f32, with TF32 off (``fp32_matmuls``).

The model: token embedding; each layer as its architecture's file
(``arch/<arch>.py``, which the configuration names) computes it, from the
helpers here (RMSNorm, interleaved-pair RoPE, the packed cache, GQA
attention, SwiGLU, a dropless top-k mixture); a final RMSNorm and the
unembedding.

The configuration states a KV cache packed to ``kv_bits``: each cached row
(one position, one KV head, hd values) is quantized symmetrically with an
f32 scale ``max|x| / (2^(bits-1) - 1)`` (1 where the row is zero), codes
rounded half to even and clipped, and read back as ``code * scale``.  A
session's history enters the cache the same way from its bf16 keys and
values.

Layer by layer over the requests checked (each layer's weights cast once):
``logits`` returns the f32 logits at every position of each request's
turn.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

F32 = torch.float32


@contextmanager
def fp32_matmuls():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd): pairs (2i, 2i+1) rotated by pos * theta^(-2i/hd)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None, None] * freqs            # (T, 1, half)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x0 * torch.cos(ang) - x1 * torch.sin(ang)
    out[..., 1::2] = x0 * torch.sin(ang) + x1 * torch.cos(ang)
    return out


def packed(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Rows of x (..., hd) through the packed cache: quantized per row to
    ``bits`` with an f32 scale, read back as f32.  Bits 16: the cache holds
    the model's bf16 values."""
    x = x.to(F32)
    if bits == 16:
        return x.to(torch.bfloat16).to(F32)
    qmax = torch.tensor(float(2 ** (bits - 1) - 1), dtype=F32, device=x.device)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor) -> torch.Tensor:
    """q (T, H, hd) at positions ``q_pos``; k, v (S, KV, hd) the cache's
    slots 0..S-1; query t reads the slots <= q_pos[t].  -> (T, H * hd)."""
    T, H, hd = q.shape
    S, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(T, KV, G, hd)
    s = torch.einsum("tkgd,skd->kgts", qg, k) * hd ** -0.5
    mask = torch.arange(S, device=q.device)[None, :] <= q_pos[:, None]   # (T, S)
    s = torch.where(mask, s, torch.tensor(float("-inf"), device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("kgts,skd->tkgd", p, v)
    return o.reshape(T, H * hd)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    return (g * torch.sigmoid(g) * (x @ w_up)) @ w_down


def moe(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
        margin: Optional[list] = None) -> torch.Tensor:
    """Dropless top-k: every token through its k best experts, weighted by
    its renormalised router probabilities (``w`` one layer's f32 weights).
    ``margin``, where given, gets each token's gap between its k-th and its
    (k+1)-th router probability (how near its choice is to a tie)."""
    k = cfg["topk"]
    probs = torch.softmax(x @ w["moe.router"], dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top = order.indices[:, :k]
    if margin is not None:
        margin.append(order.values[:, k - 1] - order.values[:, k])
    tw = torch.gather(probs, 1, top)
    tw = tw / tw.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        tok, slot = torch.nonzero(top == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], w["moe.w_gate"][e], w["moe.w_up"][e], w["moe.w_down"][e])
        out.index_add_(0, tok, y * tw[tok, slot][:, None])
    return out


@dataclass
class Turn:
    tokens: torch.Tensor    # (T,) fed at positions start .. start + T - 1
    start: int              # the history's length: the cache's slots below
    row: int = 0            # the session's row in the history's batch


def layer_weights(w: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    p = f"layers.{i}."
    return {k[len(p):]: t.to(F32) for k, t in w.items() if k.startswith(p)}


def logits(cfg: dict, arch, w: Dict[str, torch.Tensor], turns: List[Turn],
           kv_bits: int, history: Optional[Callable[[int], tuple]] = None,
           margins: Optional[List[list]] = None) -> List[torch.Tensor]:
    """f32 logits (T, V) of each turn, each layer by ``arch.layer``.
    ``history(layer)`` -> bf16 K, V (rows, slots, KV, hd): a turn's session
    holds ``K[row, :start]``.  ``margins`` (a MoE), where given, gets one
    list a turn of each layer's router margins (``moe``)."""
    eps = cfg["norm_eps"]
    xs, poss = [], []
    for t in turns:
        poss.append(t.start + torch.arange(t.tokens.shape[0], device=t.tokens.device))
        xs.append(w["embed.table"][t.tokens].to(F32))
    with fp32_matmuls():
        for i in range(cfg["n_layers"]):
            lw = layer_weights(w, i)
            hist = history(i) if any(t.start for t in turns) else None
            for n, t in enumerate(turns):
                past = None
                if t.start:
                    past = (packed(hist[0][t.row, :t.start], kv_bits),
                            packed(hist[1][t.row, :t.start], kv_bits))
                xs[n] = arch.layer(cfg, i, lw, xs[n], poss[n], kv_bits, past,
                                   None if margins is None else margins[n])
            del lw, hist
        out = w.get("embed.unembed")
        out = (w["embed.table"].T if out is None else out).to(F32)
        return [rmsnorm(x, w["embed.final_norm"], eps) @ out for x in xs]


def served_gaps(lg: torch.Tensor, served: List[int], first: int) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best:
    row ``first + j`` of ``lg`` predicts ``served[j]``."""
    rows = lg[first:first + len(served)]
    idx = torch.tensor(served, device=lg.device)
    return rows.max(dim=-1).values - rows.gather(1, idx[:, None])[:, 0]
