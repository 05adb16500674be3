"""Top-k MoE block (mixtral / grok): scatter-based token dispatch.

Port of ``repro.models.moe``.  Static-shape dropping dispatch: each expert
has capacity ``cap = max(int(capacity_factor * k * n / E), 1)`` rows; each
token goes to its top-k experts, its row in an expert is the running count
of earlier copies routed there, and copies past ``cap`` are dropped.  The
(E, cap, d) dispatch buffers are the MoE analogue of MARS blocks: an expert
consumes its buffer whole, each kept copy is stored once.

The reference's ``.at[...].add(mode="drop")`` becomes a scatter into an
(E, cap + 1, d) buffer whose spare row takes every dropped copy and is
sliced off; the kept (expert, row) pairs are unique, so the scatter needs
no accumulation.  Nothing here reads a tensor on the host (no boolean
indexing, no ``nonzero``), so the block runs under CUDA graph capture, and
nothing adds with atomics (the k copies of a token are summed over a
(n, k, d) view in the order k = 0, 1, ...), so a CUDA run is deterministic.
There is no Pallas kernel for this in the reference; these are torch ops.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.checkpoint.ckpt import Attrs
from repro_torch.configs.base import ModelConfig
from . import layers as L

F32 = torch.float32


class MoeParams(nn.Module):
    """router (d, E), w_gate / w_up (E, d, ff), w_down (E, ff, d)."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = map(
            L._param, (router, w_gate, w_up, w_down))


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> MoeParams:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = d ** -0.5
    return MoeParams(
        router=L._normal(gen, (d, E), s, dtype),
        w_gate=L._normal(gen, (E, d, ff), s, dtype),
        w_up=L._normal(gen, (E, d, ff), s, dtype),
        w_down=L._normal(gen, (E, ff, d), ff ** -0.5, dtype),
    )


def moe_specs() -> Attrs:
    return Attrs(router=("fsdp", None), w_gate=("experts", "fsdp", "ff"),
                 w_up=("experts", "fsdp", "ff"),
                 w_down=("experts", "ff", "fsdp"))


class Route(NamedTuple):
    """Where each of the n x k routed copies goes (copy i*k + j is token i's
    j-th choice)."""
    probs: torch.Tensor   # (n, E) f32 router softmax
    top_w: torch.Tensor   # (n, k) f32 combine weights, renormalised
    top_e: torch.Tensor   # (n, k) int64 chosen experts, best first
    pos: torch.Tensor     # (n*k,) row of the copy in its expert's buffer
    keep: torch.Tensor    # (n*k,) bool, pos < cap
    cap: int              # rows per expert


def route(xf: torch.Tensor, router: torch.Tensor, cfg: ModelConfig) -> Route:
    """Top-k routing and capacity of the tokens ``xf`` (n, d)."""
    probs = torch.softmax((xf @ router).to(F32), dim=-1)
    # a stable sort breaks ties as ``lax.top_k`` does, the lower expert
    # first, on every device (``torch.topk`` leaves the order of ties open,
    # and bf16 router logits tie often)
    top_e = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :cfg.topk]
    return assign(probs, top_e, cfg)


def assign(probs: torch.Tensor, top_e: torch.Tensor, cfg: ModelConfig) -> Route:
    """The route of tokens with router softmax ``probs`` (n, E) to the
    experts ``top_e`` (n, k), best first: their combine weights and rows."""
    n = probs.shape[0]
    E, k = cfg.n_experts, cfg.topk
    top_w = torch.gather(probs, 1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(cfg.capacity_factor * k * n / E), 1)
    e_flat = top_e.reshape(-1)
    onehot = F.one_hot(e_flat, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                       e_flat[:, None])[:, 0]
    return Route(probs, top_w, top_e, pos, pos < cap, cap)


def moe_block(x: torch.Tensor, p: MoeParams, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), load-balance aux loss, f32 0-dim)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.topk
    n = B * S
    xf = x.reshape(n, d)
    r = route(xf, p.router, cfg)

    # aux load-balancing loss (Switch eq. 4/5)
    frac_tokens = torch.mean(F.one_hot(r.top_e[:, 0], E).to(F32), dim=0)
    aux = E * torch.sum(frac_tokens * torch.mean(r.probs, dim=0))

    e_flat = r.top_e.reshape(-1)
    x_dup = xf[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = torch.zeros((E, r.cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((e_flat, torch.where(r.keep, r.pos, r.cap)), x_dup)
    buf = buf[:, :r.cap]                                  # (E, C, d)

    h = L.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    out_buf = torch.bmm(h, p.w_down)                      # (E, C, d)

    gathered = out_buf[e_flat, torch.where(r.keep, r.pos, 0)]
    gathered = torch.where(r.keep[:, None], gathered, 0)
    w = r.top_w.reshape(-1)[:, None].to(x.dtype)
    contrib = (gathered * w).reshape(n, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.reshape(B, S, d), aux
