"""Shared transformer layers: norms, RoPE, GQA attention, KV cache, MLPs, losses.

Port of ``repro.models.layers`` for the serving and training paths.
Parameters live in small ``nn.Module``s under the reference's field names
and are trainable; the layer functions are plain functions on tensors, as
in the reference.  Weights keep the reference's ``(in, out)`` orientation,
so ``x @ wq`` is the same product.

* attention on a CUDA tensor runs the flash kernels
  (``kernels.flash_attention``: the forward, and under autograd both
  backward kernels); on a CPU tensor it runs the blockwise online-softmax
  path below (the reference's non-TPU path), differentiated by autograd;
* the packed KV cache quantizes and stores each step's new rows through
  ``kernels.ops.kv_quant_store``; on one device the decode step attends
  over it through ``kernels.ops.kv_decode_attention`` (on a GPU one kernel
  a layer and step reads the codes once, dequantizes them on chip and
  attends), and where a ``model`` axis splits the cache's slots it
  dequantizes its block through ``kv_dequant`` and combines the softmax
  over the ranks (``_attend``);
* RoPE uses the interleaved (GPT-J) pairing; GQA is computed in grouped form
  (B, S, KV, G, D) with no repeated kv heads;
* ``fused_ce_loss`` checkpoints each sequence chunk
  (``torch.utils.checkpoint``), as the reference's ``@jax.checkpoint``.

* ``cross_attention`` (the encoder-decoder family) dispatches as
  ``attention`` does: the non-causal flash kernels on a CUDA tensor, at a
  key length (the encoder's) other than the query length; the blockwise
  path on a CPU tensor, with the reference's single-block rule for ragged
  shapes.  The reference runs it blockwise on every backend.

Under rules whose mesh has a ``model`` axis above 1 (``train.step``) the
layers run tensor-parallel, as the reference's logical specs place them
(``distributed.sharding``): ``attention`` on this rank's query heads with
the KV heads they read, ``mlp`` and the MoE on its block of ff, ``embed``
and ``fused_ce_loss`` on its block of the vocabulary; each takes its input
whole over the sequence and returns its output where the residual stream
lives (``shd.reduce_partial``).  The reference's ``checkpoint_name`` labels
become names on the collectives (``"kv_gathered"``, ``"proj_out"``), which
the ``save_collectives`` remat policy keeps.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.ckpt import Attrs
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import decode_attention as dattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.obs import instrument as obs

F32 = torch.float32
NEG_INF = -1e30


def _param(t: torch.Tensor) -> nn.Parameter:
    """A trainable weight (serving runs under ``torch.no_grad``)."""
    return nn.Parameter(t)


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """N(0, 1) in f32 on the generator's device, times std, cast to dtype."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=F32) * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RoPE (interleaved pairing)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, ..., D) with pairs (2i, 2i+1); pos: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[..., None] * freqs                   # (B, S, half)
    extra = x.dim() - 3
    ang = ang.reshape(ang.shape[0], ang.shape[1], *([1] * extra), half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.to(F32).reshape(*x.shape[:-1], half, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention parameters
# ---------------------------------------------------------------------------

class AttnParams(nn.Module):
    """wq (d, H*hd), wk / wv (d, KV*hd), wo (H*hd, d); biases or None."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        for name, b in (("bq", bq), ("bk", bk), ("bv", bv)):
            self.register_parameter(name, None if b is None else _param(b))


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype) -> AttnParams:
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    bias = (lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)) \
        if cfg.qkv_bias else (lambda n: None)
    return AttnParams(
        wq=_normal(gen, (d, H * hd), s, dtype),
        wk=_normal(gen, (d, KV * hd), s, dtype),
        wv=_normal(gen, (d, KV * hd), s, dtype),
        wo=_normal(gen, (H * hd, d), (H * hd) ** -0.5, dtype),
        bq=bias(H * hd), bk=bias(KV * hd), bv=bias(KV * hd),
    )


# ---------------------------------------------------------------------------
# Blockwise attention (prefill)
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig) -> Attrs:
    """Logical axes of ``AttnParams``, the reference's tree."""
    b = ("heads",) if cfg.qkv_bias else None
    return Attrs(wq=("fsdp", "heads"), wk=("fsdp", "heads"),
                 wv=("fsdp", "heads"), wo=("heads", "fsdp"), bq=b, bk=b, bv=b)


def _grouped(q: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, KV, G, D)."""
    B, S, H, D = q.shape
    return q.reshape(B, S, KV, H // KV, D)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int,
                        q_block: int, kv_block: int) -> torch.Tensor:
    """Flash-style attention.  q: (B,S,H,D); k,v: (B,S,KV,D) -> (B,S,H,D).

    The reference's non-TPU path, loop for loop: full-causal mode scans
    every kv block per q block with masking; sliding-window mode takes a
    (window + q_block)-wide band of kv blocks per q block.
    """
    B, S, H, D = q.shape
    Sk = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    scale = D ** -0.5
    if S % q_block or Sk % kv_block:
        raise ValueError(f"S={S}, Sk={Sk} must be multiples of the blocks "
                         f"q_block={q_block}, kv_block={kv_block}")
    nq = S // q_block
    qg = _grouped(q, KV)                                   # (B,S,KV,G,D)
    kf, vf = k.to(F32), v.to(F32)
    outs = []
    for qi in range(nq):
        qs = qg[:, qi * q_block:(qi + 1) * q_block].to(F32)
        q_pos = qi * q_block + torch.arange(q_block, device=q.device)
        if window > 0:
            band = min(window + q_block, Sk)
            nkb = -(-band // kv_block)
            k_start = max(qi * q_block + q_block - band, 0)
            k_start = max(min(k_start, Sk - nkb * kv_block), 0)
        else:
            nkb = Sk // kv_block
            k_start = 0
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((B, KV, G, q_block), dtype=F32, device=q.device)
        acc = torch.zeros((B, KV, G, q_block, D), dtype=F32, device=q.device)
        for kb in range(nkb):
            start = k_start + kb * kv_block
            ks = kf[:, start:start + kv_block]
            vs = vf[:, start:start + kv_block]
            s = torch.einsum("bqkgd,bskd->bkgqs", qs, ks) * scale
            k_pos = start + torch.arange(kv_block, device=q.device)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vs)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,KV,G,Bq,D)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,Bq,KV,G,D)
    return torch.cat(outs, dim=1).reshape(B, S, H, D).to(q.dtype)


class _Heads(NamedTuple):
    """Which heads this rank computes and how they read the KV heads."""
    rows: Optional[Tuple[int, int]]  # wo's rows this rank holds (None: all)
    q: Tuple[int, int]           # query heads [start, stop)
    q_gather: bool               # q's columns gathered (a block cut mid-head)
    kv_gather: bool              # k / v gathered over ``model``
    kv_local: Tuple[int, int]    # KV heads in the (local or gathered) k / v
    kv_index: Optional[list]     # per query head when groups do not line up


def _heads(cfg: ModelConfig) -> _Heads:
    """This rank's share of attention under the rules: every head where
    there is no ``model`` axis or ``heads`` is left whole.

    ``wq``'s H*hd columns and ``wk``'s KV*hd columns are each sharded
    wherever tp divides them.  A query block that cuts a head is gathered
    and the heads that cover the block are computed (o is cut back to wo's
    rows); a head cut between two ranks is computed on both.  The KV heads
    that the local query heads read (head h reads h // G) are the local
    ones where the blocks line up; otherwise k and v are gathered whole,
    as the reference does (its ``kv_gathered``), and the needed heads are
    picked.
    """
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qb = shd.tp_block("heads", H * hd)
    if qb is None:
        return _Heads(None, (0, H), False, False, (0, KV), None)
    G = H // KV
    q_gather = qb[0] % hd != 0 or qb[1] % hd != 0
    q = (qb[0] // hd, -(-(qb[0] + qb[1]) // hd))
    need = (q[0] // G, (q[1] - 1) // G + 1)
    kb = shd.tp_block("heads", KV * hd)
    base, kv_gather = 0, False
    if kb is not None:
        lo, hi = kb[0] // hd, (kb[0] + kb[1]) // hd
        kv_gather = (kb[0] % hd or kb[1] % hd or need[0] < lo or need[1] > hi)
        base = 0 if kv_gather else lo
    n_q = q[1] - q[0]
    aligned = (q[0] % G == 0 and n_q % G == 0) or need[1] - need[0] == 1
    index = None if aligned else [h // G - base for h in range(*q)]
    return _Heads(qb, q, q_gather, bool(kv_gather),
                  (need[0] - base, need[1] - base), index)


def _qkv(x: torch.Tensor, p: AttnParams, cfg: ModelConfig,
         pos: Optional[torch.Tensor], plan: _Heads,
         memory: Optional[torch.Tensor] = None):
    """q on the plan's query heads, k and v on the KV heads those read
    (grouped as ``_grouped`` expects, or one KV head a query head where
    the groups do not line up).  Self-attention: k and v from x, the
    biases added, q and k roped at ``pos``; cross-attention: k and v from
    ``memory``, no bias and no RoPE (the reference reads only the four
    weights)."""
    B, S, _ = x.shape
    hd = cfg.hd
    src = x if memory is None else memory
    q = x @ p.wq
    k = src @ p.wk
    v = src @ p.wv
    if memory is None and p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if plan.q_gather:
        q = shd.act(q, "batch", None, None, src=("batch", None, "heads"))
    if plan.kv_gather:
        k, v = (shd.act(t, "batch", None, None, src=("batch", None, "heads"),
                        name="kv_gathered") for t in (k, v))
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, src.shape[1], -1, hd)
    v = v.reshape(B, src.shape[1], -1, hd)
    if plan.q_gather:
        q = q[:, :, plan.q[0]:plan.q[1]]
    if plan.kv_index is not None:
        idx = torch.tensor(plan.kv_index, device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    else:
        k, v = (t[:, :, plan.kv_local[0]:plan.kv_local[1]] for t in (k, v))
    if memory is None:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def _out_proj(o: torch.Tensor, p: AttnParams, cfg: ModelConfig,
              plan: _Heads) -> torch.Tensor:
    """o (B, S, heads, hd) through ``wo``, where the residual stream lives:
    the plain product (all heads), or this rank's rows of the covering
    heads' output through ``shd.tp_out_proj``."""
    B, S = o.shape[:2]
    of = o.reshape(B, S, -1)
    if plan.rows is None:
        return shd.act(of @ p.wo, "batch", "seq", None)
    if plan.q_gather:
        lo = plan.rows[0] - plan.q[0] * cfg.hd
        of = of[..., lo:lo + plan.rows[1]]
    return shd.tp_out_proj(of, p.wo)


def attention(x: torch.Tensor, p: AttnParams, cfg: ModelConfig,
              pos: torch.Tensor, q_block: int, kv_block: int,
              window_override: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """Full prefill self-attention with output projection.

    On a CUDA tensor the inner loops run as the flash kernel; on a CPU
    tensor the blockwise path runs (same math, held equal in the tests), as
    the reference dispatches on TPU / not TPU.  Under tensor parallelism
    (``_heads``) both run on this rank's heads, and the out-projection's
    partial products are summed by ``shd.tp_out_proj`` (the output is
    where the residual stream lives: this rank's block of the sequence, or
    whole).
    """
    B, S, _ = x.shape
    plan = _heads(cfg)
    q, k, v = _qkv(x, p, cfg, pos, plan)
    window = cfg.sliding_window if window_override is None else window_override
    if window >= S:
        window = 0  # band covers everything: plain causal
    qb = min(q_block, S)
    kb = min(kv_block, S)
    if S % qb:
        qb = S   # odd lengths (e.g. vlm prefix + text): single block
    if S % kb:
        kb = S
    if x.device.type == "cuda":
        og = fa.flash_attention(_grouped(q, k.shape[2]), k, v, causal,
                                window, qb, kb)
        o = og.reshape(B, S, -1, cfg.hd)
    else:
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                q_block=qb, kv_block=kb)
    return _out_proj(o, p, cfg, plan)


def cross_attention(x: torch.Tensor, memory: torch.Tensor, p: AttnParams,
                    cfg: ModelConfig, q_block: int, kv_block: int) -> torch.Tensor:
    """Encoder-decoder cross attention: q from x (B, S, d), k and v from the
    encoder's ``memory`` (B, M, d, whole on every rank); no RoPE on either
    side, no mask, and no bias (the reference reads only the four weights).
    Under tensor parallelism it runs on this rank's heads as ``attention``
    does (k and v from the rank's ``wk`` / ``wv`` columns, gathered where a
    block cuts a head)."""
    B, S, _ = x.shape
    M = memory.shape[1]
    plan = _heads(cfg)
    q, k, v = _qkv(x, p, cfg, None, plan, memory)
    if x.device.type == "cuda":
        o = fa.flash_attention(_grouped(q, k.shape[2]), k, v, causal=False,
                               window=0)
    else:
        qb, kb = min(q_block, S), min(kv_block, M)
        if S % qb or M % kb:
            qb, kb = S, M  # tiny shapes: single block
        o = blockwise_attention(q, k, v, causal=False, window=0,
                                q_block=qb, kv_block=kb)
    return _out_proj(o.reshape(B, S, -1, cfg.hd), p, cfg, plan)


# ---------------------------------------------------------------------------
# Decode-step attention with KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor        # (B, S_cache, KV, D), or int8 codes (.., D or D/2)
    v: torch.Tensor
    # scales are present only for packed (int8/int4) caches
    k_scale: Optional[torch.Tensor]  # (B, S_cache, KV, 1) f32
    v_scale: Optional[torch.Tensor]


def cache_specs(bits: int = 16) -> Attrs:
    """Logical axes of a ``KVCache``, the reference's tree: each row's
    batch and slot (``cache_seq``); the scales only where the cache is
    packed."""
    s = ("batch", "cache_seq", None, None) if bits != 16 else None
    return Attrs(k=("batch", "cache_seq", None, None),
                 v=("batch", "cache_seq", None, None), k_scale=s, v_scale=s)


def init_cache(cfg: ModelConfig, batch: int, s_cache: int, bits: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    KV, hd = cfg.n_kv_heads, cfg.hd
    if bits == 16:
        shape = (batch, s_cache, KV, hd)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), None, None)
    cd = hd if bits == 8 else hd // 2
    codes = (batch, s_cache, KV, cd)
    scale = (batch, s_cache, KV, 1)
    return KVCache(torch.zeros(codes, dtype=torch.int8, device=device),
                   torch.zeros(codes, dtype=torch.int8, device=device),
                   torch.ones(scale, dtype=F32, device=device),
                   torch.ones(scale, dtype=F32, device=device))


def _dequant_rows(codes: torch.Tensor, scale: torch.Tensor,
                  bits: int) -> torch.Tensor:
    return dattn.dequant_rows(codes, scale, bits, ops.kv_dequant)


def update_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, bits: int) -> KVCache:
    """Insert (B, 1, KV, D) new kv at per-batch position ``pos`` (B,).

    Writes into the cache's tensors in place (the reference returns a new
    cache; the port saves the copy) and returns the same cache.  Like the
    reference's dynamic update slice, a position past the end is clamped to
    the last slot.
    """
    if bits == 16:
        b = torch.arange(pos.shape[0], device=pos.device)
        slot = torch.clamp(pos, 0, cache.k.shape[1] - 1)
        cache.k[b, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[b, slot] = v_new[:, 0].to(cache.v.dtype)
        return cache
    # the packed cache: quantize and store the K and V rows in one call (one
    # kernel launch on a GPU), the reference's _quant_rows and its fused
    # dynamic_update_slice
    ops.kv_quant_store(cache.k, cache.v, cache.k_scale, cache.v_scale,
                       k_new, v_new, pos, bits)
    return cache


def _store_held(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                slot: torch.Tensor, bits: int, lo: int) -> None:
    """``update_cache`` on this rank's block of the cache's slots, ``[lo,
    lo + S)`` of the whole cache: each row is written only where the
    rank holds its slot (``slot``, already within the whole cache).  The
    store itself clamps a slot past the block to its last slot, as the
    reference's update does, so a row whose slot another rank holds is put
    back as it was: its cache rows stay bit-unchanged."""
    S = cache.k.shape[1]
    local = slot - lo
    held = ((local >= 0) & (local < S))[:, None, None]
    at = torch.clamp(local, 0, S - 1)
    b = torch.arange(slot.shape[0], device=slot.device)
    old = [None if t is None else t[b, at] for t in cache]
    update_cache(cache, k_new, v_new, at, bits)
    for t, o in zip(cache, old):
        if t is not None:
            t[b, at] = torch.where(held, t[b, at], o)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
            G: int, valid: Optional[torch.Tensor] = None,
            round_p: bool = True, group=None) -> torch.Tensor:
    """``kernels.decode_attention.attend_plain``: one query a row against
    cached keys, q (B, 1, n, hd) the query heads ``[q0, q0 + n)`` of ``G``
    a KV head, k and v (B, S, KV, hd), ``valid`` (B, S) the slots each row
    may read.  With ``group`` (the ``model`` axis, each rank holding a
    block of the slots) the softmax is taken over the slots of every rank:
    the scores' max and the sum of their exponentials all-reduced before
    the probabilities are formed, so that each is the single device's value
    up to the order of the sum, and P·V's partial sums all-reduced.
    -> o (B, 1, n * hd) f32."""
    if group is None:
        return dattn.attend_plain(q, k, v, q0, G, valid, round_p)
    return dattn.attend_plain(
        q, k, v, q0, G, valid, round_p,
        all_max=lambda t: collectives.all_reduce_max(t, group),
        all_sum=lambda t: collectives.all_reduce(t, group))


def decode_queries(x: torch.Tensor, p: AttnParams, cfg: ModelConfig,
                   pos: Optional[torch.Tensor] = None):
    """q, k and v of one token a row for every head: (B, 1, heads, hd),
    k and v ``None`` for the cross-attention (``pos`` None: no bias, no
    RoPE).  Each product on this rank's columns is gathered whole over
    ``model`` where the ``heads`` rule cuts it."""
    B, hd = x.shape[0], cfg.hd
    names = ("q",) if pos is None else ("q", "k", "v")
    out = []
    for name in names:
        t = x @ getattr(p, "w" + name)
        if pos is not None and p.bq is not None:
            t = t + getattr(p, "b" + name)
        heads = cfg.n_heads if name == "q" else cfg.n_kv_heads
        if shd.tp_block("heads", heads * hd) is not None:
            t = shd.act(t, "batch", None, None, src=("batch", None, "heads"))
        t = t.reshape(B, 1, -1, hd)
        out.append(t if pos is None or name == "v" else
                   rope(t, pos[:, None], cfg.rope_theta))
    return out[0] if pos is None else tuple(out)


def decode_out(o: torch.Tensor, p: AttnParams, cfg: ModelConfig,
               q0: int = 0) -> torch.Tensor:
    """o (B, 1, n * hd), the query heads from ``q0``, through ``wo`` where
    the residual stream lives: the plain product where ``wo`` is whole (o
    holds every head), else this rank's rows of it through
    ``shd.tp_out_proj``."""
    rows = _heads(cfg).rows
    if rows is None:
        return o @ p.wo
    lo = rows[0] - q0 * cfg.hd
    return shd.tp_out_proj(o[..., lo:lo + rows[1]], p.wo)


def decode_attention(x: torch.Tensor, p: AttnParams, cfg: ModelConfig,
                     cache: KVCache, pos: torch.Tensor, bits: int,
                     window: int = 0, s_cache: Optional[int] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token attention against the cache.  x: (B, 1, d); pos: (B,).

    When the cache is shorter than the sequence (sliding-window models) it is
    a ring buffer: slot j holds the key written at global position
    ``pos - ((pos - j) mod S_cache)``.

    On a ``model`` axis above 1 (rules installed) the cache holds this
    rank's block of the ``s_cache`` slots of the whole cache where the
    ``cache_seq`` rule splits them (``decode_state_specs``), every KV head
    (without one, the cache's own length is the whole cache's).
    q, k and v are gathered for every head (``decode_queries``), the row's
    new k and v are stored only by the rank that holds its slot
    (``_store_held``; slots and the validity mask in the whole cache's
    indices), and each rank attends every head over its slots, the softmax
    combined over ``model`` (``_attend``).  Where the slots are whole (one
    device among them), every rank stores the row (each holds the same
    cache) and attends its own heads (``_heads``: all of them on one
    device) over every slot through ``ops.kv_decode_attention``: on a GPU
    one kernel reads the cache once, dequantizes it on chip and attends.
    The out-projection then runs on this rank's rows of ``wo``
    (``decode_out``).
    """
    H, KV = cfg.n_heads, cfg.n_kv_heads
    S = cache.k.shape[1]
    group = shd.model_group()
    S_all = S if s_cache is None or group is None else s_cache
    ring = window > 0 and S_all <= window
    slot = pos % S_all if ring else pos
    obs.device_mark("attn.qkv")
    q, k_new, v_new = decode_queries(x, p, cfg, pos)
    block = shd.tp_block("cache_seq", S_all)
    obs.device_mark("attn.store")
    if block is None:
        update_cache(cache, k_new, v_new, slot, bits)
        q0, q1 = _heads(cfg).q
        obs.device_mark("attn.kernel")
        # the reference multiplies in the cache dtype with f32 accumulation;
        # one kernel a layer and step on a GPU
        o = ops.kv_decode_attention(q[:, :, q0:q1], cache, pos, bits, q0, H // KV,
                                    s_all=S_all, window=window, ring=ring,
                                    dtype=x.dtype)
        obs.device_mark("attn.out")
        return decode_out(o.to(x.dtype), p, cfg, q0), cache
    lo = block[0]
    _store_held(cache, k_new, v_new, torch.clamp(slot, 0, S_all - 1), bits, lo)
    obs.device_mark("attn.kernel")
    cdt = x.dtype
    if bits == 16:
        k, v = cache.k, cache.v
    else:
        k = _dequant_rows(cache.k, cache.k_scale, bits).to(cdt)
        v = _dequant_rows(cache.v, cache.v_scale, bits).to(cdt)
    valid = dattn.valid_slots(pos, S, lo, S_all, window, ring)
    # the product of two bf16 values is exact in f32, so f32 operands are
    # the reference's product in the cache dtype with f32 accumulation
    o = _attend(q, k, v, 0, H // KV, valid, group=group)
    obs.device_mark("attn.out")
    return decode_out(o.to(x.dtype), p, cfg, 0), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MlpParams(nn.Module):
    """w_gate (d, ff) or None (gelu), w_up (d, ff), w_down (ff, d)."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.register_parameter("w_gate",
                                None if w_gate is None else _param(w_gate))
        self.w_up, self.w_down = _param(w_up), _param(w_down)


def init_mlp(gen: torch.Generator, d: int, ff: int, act: str,
             dtype) -> MlpParams:
    s = d ** -0.5
    return MlpParams(
        w_gate=_normal(gen, (d, ff), s, dtype) if act == "swiglu" else None,
        w_up=_normal(gen, (d, ff), s, dtype),
        w_down=_normal(gen, (ff, d), ff ** -0.5, dtype),
    )


def mlp_specs(act: str) -> Attrs:
    return Attrs(w_gate=("fsdp", "ff") if act == "swiglu" else None,
                 w_up=("fsdp", "ff"), w_down=("ff", "fsdp"))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), two rounded operations."""
    return x * torch.sigmoid(x)


def mlp(x: torch.Tensor, p: MlpParams, act: str,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP on x.  With ``d_ff`` (the full hidden width) and rules that
    shard ``ff`` over ``model``, the weights are this rank's columns / rows
    and the down-projection's partial products are summed by
    ``shd.tp_out_proj``; the output is where the residual stream lives."""
    if act == "swiglu":
        h = silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = F.gelu(x @ p.w_up, approximate="tanh")  # jax.nn.gelu's default
    if d_ff is not None and shd.tp_block("ff", d_ff) is not None:
        return shd.tp_out_proj(h, p.w_down)
    return shd.act(h @ p.w_down, "batch", "seq", None)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

class EmbedParams(nn.Module):
    """table (V, d), unembed (d, V) or None when tied, final_norm (d,)."""

    def __init__(self, table, unembed, final_norm):
        super().__init__()
        self.table = _param(table)
        self.register_parameter("unembed",
                                None if unembed is None else _param(unembed))
        self.final_norm = _param(final_norm)


def init_embed(gen: torch.Generator, cfg: ModelConfig, dtype) -> EmbedParams:
    return EmbedParams(
        table=_normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        unembed=None if cfg.tie_embeddings else
        _normal(gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dtype),
        final_norm=init_rmsnorm(cfg.d_model, dtype, gen.device),
    )


def embed_specs(cfg: ModelConfig) -> Attrs:
    return Attrs(table=("vocab", "fsdp"),
                 unembed=None if cfg.tie_embeddings else ("fsdp", "vocab"),
                 final_norm=(None,))


def _vocab(cfg: ModelConfig):
    """This rank's (start, size) of the vocabulary, or ``None`` (whole)."""
    return shd.tp_block("vocab", cfg.vocab)


def embed(tokens: torch.Tensor, p: EmbedParams,
          cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """The rows of ``tokens``.  Vocab-parallel where the rules shard the
    table's vocabulary (``cfg`` given): the rows outside this rank's block
    are zero, and the sum over ``model`` (exact: one rank holds each row)
    is every rank's."""
    block = None if cfg is None else _vocab(cfg)
    if block is None:
        # the row gather; its backward is the embedding backward, which
        # PyTorch does not list among its nondeterministic CUDA operations
        return F.embedding(tokens, p.table)
    local = tokens.long() - block[0]
    inside = (local >= 0) & (local < block[1])
    rows = F.embedding(torch.where(inside, local, 0), p.table)
    rows = torch.where(inside[..., None], rows, 0)
    return collectives.all_reduce(rows, shd.model_group())


def logits(x: torch.Tensor, p: EmbedParams, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, p.final_norm, cfg.norm_eps)
    w = p.table.T if cfg.tie_embeddings else p.unembed
    if _vocab(cfg) is None:
        return x @ w
    return shd.act(x @ w, *(None,) * x.dim(),
                   src=(None,) * (x.dim() - 1) + ("vocab",))


def _nll(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood of f32 logits, stable in f32."""
    m = lg.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(lg - m), dim=-1))
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; stable in f32."""
    nll = _nll(lg.to(F32), labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _ce_chunk(group, start: int, xc: torch.Tensor, w: torch.Tensor,
              lc: torch.Tensor, mc: torch.Tensor):
    """The chunk's summed NLL and mask.  ``w`` holds the vocabulary's
    columns from ``start``; where they are one rank's block (``group``, the
    ``model`` axis's; ``None``: the whole vocabulary) the max, the sum of
    exponentials and the gold logit are reduced over ``group``."""
    lg = (xc @ w).to(F32)
    m = collectives.all_reduce_max(lg.amax(dim=-1), group)
    se = collectives.all_reduce(torch.sum(torch.exp(lg - m[..., None]), dim=-1),
                                group)
    local = lc.long() - start
    inside = (local >= 0) & (local < lg.shape[-1])
    gold = torch.gather(lg, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    gold = collectives.all_reduce(torch.where(inside, gold, 0), group)
    nll = (m + torch.log(se) - gold) * mc
    return torch.sum(nll), torch.sum(mc)


def fused_ce_loss(x: torch.Tensor, p: EmbedParams, cfg: ModelConfig,
                  labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  chunk: int = 512) -> torch.Tensor:
    """Unembed + cross-entropy fused over sequence chunks.

    Never holds the (B, S, V) logits: each chunk computes its (B, C, V)
    logits, reduces them to per-token NLL and, under autograd, is
    checkpointed, so backward recomputes the chunk instead of keeping it.
    ``x`` is whole over the sequence; where the rules shard the vocabulary
    each chunk's logits are this rank's columns (``_ce_chunk``).
    """
    B, S, _ = x.shape
    x = rmsnorm(x, p.final_norm, cfg.norm_eps)
    w = p.table.T if cfg.tie_embeddings else p.unembed
    block = _vocab(cfg)
    fn = functools.partial(_ce_chunk, None, 0) if block is None else \
        functools.partial(_ce_chunk, shd.model_group(), block[0])
    chunk = min(chunk, S)
    total = torch.zeros((), dtype=F32, device=x.device)
    count = torch.zeros((), dtype=F32, device=x.device)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        mc = (mask[:, lo:hi].to(F32) if mask is not None
              else torch.ones((B, hi - lo), dtype=F32, device=x.device))
        args = (x[:, lo:hi], w, labels[:, lo:hi], mc)
        if torch.is_grad_enabled():
            t, c = checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            t, c = fn(*args)
        total, count = total + t, count + c
    return total / torch.clamp(count, min=1.0)
