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

On a mesh (rules installed by ``train.step``) the block keeps the
reference's semantics, which are functions of the whole batch: ``cap``
counts the tokens of every rank of the batch axes the rules act on (the
pod's ranks on the compressed path, which excludes ``pod``), a copy's row is
its rank-local running count plus each expert's count on the batch ranks
before it (an all-gather of E counts, in the global batch's row order), and
the load-balance fractions are means over the whole batch (all-reduced, so
the backward of the probabilities' sum gives each rank its share of the
single device's gradient once the step averages over the batch ranks).
The experts' ff is sharded over ``model``; ``w_down``'s partial products
are summed like the MLP's (``shd.reduce_partial``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.checkpoint.ckpt import Attrs
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.obs import instrument as obs
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


class Batch(NamedTuple):
    """The ranks whose tokens share the capacity: their group (``None`` for
    one), how many and this rank's place among them."""
    group: object = None
    ranks: int = 1
    index: int = 0


def batch_ranks() -> Batch:
    """The batch axes the rules act on (``pod`` and ``data``, less the
    excluded ones), as a ``Batch``."""
    r = shd.get_rules()
    if r is None or r.mesh is None:
        return Batch()
    axes = tuple(a for a in ("pod", "data")
                 if a in r.mesh.axis_names and a not in r.exclude)
    if not axes or r.mesh.size(axes) == 1:
        return Batch()
    return Batch(r.mesh.get_group(axes), r.mesh.size(axes), r.mesh.index(axes))


def route(xf: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          batch: Batch = Batch()) -> Route:
    """Top-k routing and capacity of the tokens ``xf`` (n, d)."""
    probs = torch.softmax((xf @ router).to(F32), dim=-1)
    # a stable sort breaks ties as ``lax.top_k`` does, the lower expert
    # first, on every device (``torch.topk`` leaves the order of ties open,
    # and bf16 router logits tie often)
    top_e = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :cfg.topk]
    return assign(probs, top_e, cfg, batch)


def assign(probs: torch.Tensor, top_e: torch.Tensor, cfg: ModelConfig,
           batch: Batch = Batch()) -> Route:
    """The route of tokens with router softmax ``probs`` (n, E) to the
    experts ``top_e`` (n, k), best first: their combine weights and rows
    (rows in the whole batch's buffers where ``batch`` has several ranks)."""
    n = probs.shape[0]
    E, k = cfg.n_experts, cfg.topk
    top_w = torch.gather(probs, 1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(cfg.capacity_factor * k * n * batch.ranks / E), 1)
    e_flat = top_e.reshape(-1)
    onehot = F.one_hot(e_flat, E)
    before = torch.cumsum(onehot, dim=0) - onehot
    if batch.ranks > 1:
        counts = collectives.all_gather(onehot.sum(0), batch.group)
        before = before + counts[:batch.index].sum(0)
    pos = torch.gather(before, 1, e_flat[:, None])[:, 0]
    return Route(probs, top_w, top_e, pos, pos < cap, cap)


def _aux(r: Route, E: int, batch: Batch) -> torch.Tensor:
    """Switch's load-balance loss (eq. 4/5) over the whole batch."""
    first = F.one_hot(r.top_e[:, 0], E).to(F32)
    if batch.ranks == 1:
        return E * torch.sum(torch.mean(first, dim=0) * torch.mean(r.probs, dim=0))
    n = r.probs.shape[0] * batch.ranks
    frac_tokens = collectives.all_reduce(first.sum(0), batch.group) / n
    frac_probs = collectives.all_reduce(r.probs.sum(0), batch.group) / n
    return E * torch.sum(frac_tokens * frac_probs)


def moe_block(x: torch.Tensor, p: MoeParams, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), load-balance aux loss, f32 0-dim).

    ``x`` is whole over the sequence; the output is where the residual
    stream lives under the rules (this rank's block of the sequence, or
    whole)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.topk
    n = B * S
    xf = x.reshape(n, d)
    batch = batch_ranks()
    obs.device_mark("moe.route")
    r = route(xf, p.router, cfg, batch)
    aux = _aux(r, E, batch)

    obs.device_mark("moe.dispatch")
    e_flat = r.top_e.reshape(-1)
    rows, pos = r.cap, r.pos
    if batch.ranks > 1:
        # this rank's copies sit at rows [offset_e, offset_e + count_e) of
        # the whole batch's buffer of expert e: its own buffer holds them
        # from row 0 (rows are independent through the experts)
        rows, pos = min(r.cap, n * k), _local_rows(e_flat, E)
    x_dup = xf[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = torch.zeros((E, rows + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((e_flat, torch.where(r.keep, pos, rows)), x_dup)
    buf = buf[:, :rows]                                    # (E, C, d)

    obs.device_mark("moe.experts")
    h = L.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    tp = shd.tp_block("ff", cfg.d_ff) is not None
    out_buf = shd.mm_f32(h, p.w_down) if tp else \
        torch.bmm(h, p.w_down)                             # (E, C, d)

    obs.device_mark("moe.combine")
    gathered = out_buf[e_flat, torch.where(r.keep, pos, 0)]
    gathered = torch.where(r.keep[:, None], gathered, 0)
    w = r.top_w.reshape(-1)[:, None].to(out_buf.dtype)
    contrib = (gathered * w).reshape(n, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    out = out.reshape(B, S, d)
    if tp:
        return shd.reduce_partial(out).to(x.dtype), aux
    return shd.act(out, "batch", "seq", None), aux


def _local_rows(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Each copy's running count among this rank's copies to its expert."""
    onehot = F.one_hot(e_flat, E)
    return torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                        e_flat[:, None])[:, 0]
