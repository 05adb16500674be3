"""Whisper-style encoder-decoder backbone (conv/mel frontend stubbed).

Port of ``repro.models.encdec``.  ``model_zoo.input_specs`` supplies
precomputed frame embeddings (B, enc_seq, d): the frontend stub.  The
encoder is bidirectional self-attention (RoPE on q and k); the decoder adds
causal self-attention and cross-attention to the encoder's output.  Decode
keeps a self-attention KV cache per layer beside the cross K/V, one
(L, B, enc_seq, KV, hd) tensor each.

The reference scans one stacked layer body; here the layers are
``nn.ModuleList``s walked by a Python loop, each under
``torch.utils.checkpoint`` with ``rc.remat`` while autograd records (the
reference's ``jax.checkpoint`` with ``nothing_saveable``).  Attention runs
as ``layers.attention`` and ``layers.cross_attention`` dispatch it: the
flash kernels on a CUDA tensor, the blockwise path on a CPU tensor.

On a mesh the layers run tensor-parallel over heads, ff and (where tp
divides it) the vocabulary, as ``models.layers`` does for the decoder-only
families, with one difference: the reference passes no ``tp_scatter``
here, so the residual stream stays whole over ``model`` (``encode`` and
``decoder_backbone`` run under the rules with ``seq_shard`` off) and each
out-projection's partial products are all-reduced.  The encoder's memory
is whole on every rank; each rank projects it through its own ``wk`` /
``wv`` columns in the cross-attention.

As in the reference, ``init_decode_state`` gives zero cross K/V and
nothing in the serve path fills them (ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, List, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.ckpt import Attrs, Stacked, map_tree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import sharding as shd
from . import layers as L

F32 = torch.float32


class EncLayer(nn.Module):
    """ln1, attn, ln2, mlp."""

    #: the reference's field order (``named_parameters`` lists the norms
    #: first; ``train.step.reference_tree`` puts this order back)
    FIELDS = ("ln1", "attn", "ln2", "mlp")

    def __init__(self, ln1, attn: L.AttnParams, ln2, mlp: L.MlpParams):
        super().__init__()
        self.ln1 = L._param(ln1)
        self.attn = attn
        self.ln2 = L._param(ln2)
        self.mlp = mlp


class DecLayer(nn.Module):
    """ln1, self_attn, ln_x, cross_attn, ln2, mlp."""

    FIELDS = ("ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp")

    def __init__(self, ln1, self_attn: L.AttnParams, ln_x,
                 cross_attn: L.AttnParams, ln2, mlp: L.MlpParams):
        super().__init__()
        self.ln1 = L._param(ln1)
        self.self_attn = self_attn
        self.ln_x = L._param(ln_x)
        self.cross_attn = cross_attn
        self.ln2 = L._param(ln2)
        self.mlp = mlp


class EncDecParams(nn.Module):
    """Decoder token embeddings (and unembed), the encoder's layers and
    final norm, the decoder's layers (lists, where the reference stacks)."""

    FIELDS = ("embed", "enc_layers", "enc_norm", "dec_layers")

    def __init__(self, embed: L.EmbedParams, enc_layers: List[EncLayer],
                 enc_norm, dec_layers: List[DecLayer]):
        super().__init__()
        self.embed = embed
        self.enc_layers = nn.ModuleList(enc_layers)
        self.enc_norm = L._param(enc_norm)
        self.dec_layers = nn.ModuleList(dec_layers)


def init(gen: torch.Generator, cfg: ModelConfig,
         dtype=torch.bfloat16) -> EncDecParams:
    """Random weights on ``gen.device``, the reference's distributions,
    drawn in a fixed order: the embedding, the encoder's layers, the
    decoder's layers."""
    d, dev = cfg.d_model, gen.device

    def norm():
        return L.init_rmsnorm(d, dtype, dev)

    def mlp():
        return L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_act, dtype)

    emb = L.init_embed(gen, cfg, dtype)
    enc = [EncLayer(ln1=norm(), attn=L.init_attn(gen, cfg, dtype), ln2=norm(),
                    mlp=mlp()) for _ in range(cfg.enc_layers)]
    dec = [DecLayer(ln1=norm(), self_attn=L.init_attn(gen, cfg, dtype),
                    ln_x=norm(), cross_attn=L.init_attn(gen, cfg, dtype),
                    ln2=norm(), mlp=mlp()) for _ in range(cfg.n_layers)]
    return EncDecParams(emb, enc, norm(), dec)


def param_specs(cfg: ModelConfig) -> Attrs:
    """Logical axes of every parameter, in the reference's
    ``EncDecParams`` tree (the layer lists stacked)."""
    def stack(t):
        return map_tree(lambda x: (None,) + x, t)
    enc = Attrs(ln1=(None,), attn=L.attn_specs(cfg), ln2=(None,),
                mlp=L.mlp_specs(cfg.mlp_act))
    dec = Attrs(ln1=(None,), self_attn=L.attn_specs(cfg), ln_x=(None,),
                cross_attn=L.attn_specs(cfg), ln2=(None,),
                mlp=L.mlp_specs(cfg.mlp_act))
    return Attrs(embed=L.embed_specs(cfg), enc_layers=stack(enc),
                 enc_norm=(None,), dec_layers=stack(dec))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _layers(body, layers, x: torch.Tensor, rc: RunConfig, *args) -> torch.Tensor:
    """x through ``body(x, *args, lp)`` for each layer, each checkpointed
    with ``rc.remat`` while autograd records; ``lp`` as the layer reads it
    (``sharding.gathered``: ZeRO-3's blocks gathered over ``data``)."""
    remat = rc.remat and torch.is_grad_enabled()
    rules = shd.get_rules()

    def run(x, *rest):
        *a, lp = rest
        return body(x, *a, shd.gathered(lp))

    for lp in layers:
        x = checkpoint(shd.under, rules, run, x, *args, lp, use_reentrant=False,
                       preserve_rng_state=False) if remat else run(x, *args, lp)
    return x


def _whole_stream(fn):
    """``fn`` under the rules with ``seq_shard`` off: the stream stays whole
    over ``model``, as the reference's calls without ``tp_scatter`` keep
    it, and ``shd.reduce_partial`` all-reduces."""
    @functools.wraps(fn)
    def run(*args):
        r = shd.get_rules()
        if r is None or not r.seq_shard:
            return fn(*args)
        with shd.use_rules(dataclasses.replace(r, seq_shard=False)):
            return fn(*args)
    return run


@_whole_stream
def encode(params: EncDecParams, frames: torch.Tensor, cfg: ModelConfig,
           rc: RunConfig) -> torch.Tensor:
    """frames: (B, enc_seq, d) stub embeddings -> encoder memory."""
    B, S, _ = frames.shape
    pos = _positions(B, S, frames.device)

    def body(x, lp: EncLayer):
        # layers.attention takes a single block where S is ragged against
        # the blocks, the reference's rule here
        h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
        x = x + L.attention(h, lp.attn, cfg, pos, rc.q_block, rc.kv_block,
                            causal=False)
        h = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
        return x + L.mlp(h, lp.mlp, cfg.mlp_act, cfg.d_ff)

    x = _layers(body, params.enc_layers, frames, rc)
    return L.rmsnorm(x, params.enc_norm, cfg.norm_eps)


@_whole_stream
def decoder_backbone(params: EncDecParams, tokens: torch.Tensor,
                     memory: torch.Tensor, cfg: ModelConfig,
                     rc: RunConfig) -> torch.Tensor:
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)

    def body(x, memory, lp: DecLayer):
        h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
        x = x + L.attention(h, lp.self_attn, cfg, pos, rc.q_block, rc.kv_block)
        h = L.rmsnorm(x, lp.ln_x, cfg.norm_eps)
        x = x + L.cross_attention(h, memory, lp.cross_attn, cfg, rc.q_block,
                                  rc.kv_block)
        h = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
        return x + L.mlp(h, lp.mlp, cfg.mlp_act, cfg.d_ff)

    return _layers(body, params.dec_layers,
                   L.embed(tokens, shd.gathered(params.embed), cfg), rc,
                   memory)


def decoder_forward(params: EncDecParams, tokens: torch.Tensor,
                    memory: torch.Tensor, cfg: ModelConfig,
                    rc: RunConfig) -> torch.Tensor:
    """Full logits (tests); serving uses last-position prefill below."""
    x = decoder_backbone(params, tokens, memory, cfg, rc)
    return L.logits(x, shd.gathered(params.embed), cfg)


def prefill(params: EncDecParams, batch, cfg: ModelConfig,
            rc: RunConfig) -> torch.Tensor:
    memory = encode(params, batch["frames"], cfg, rc)
    x = decoder_backbone(params, batch["tokens"], memory, cfg, rc)
    return L.logits(x[:, -1:], shd.gathered(params.embed), cfg)[:, 0]


def loss_fn(params: EncDecParams, batch, cfg: ModelConfig,
            rc: RunConfig) -> torch.Tensor:
    """batch: dict(frames (B,enc_seq,d), tokens (B,S), labels (B,S) [, mask])."""
    memory = encode(params, batch["frames"], cfg, rc)
    x = decoder_backbone(params, batch["tokens"], memory, cfg, rc)
    return L.fused_ce_loss(x, shd.gathered(params.embed), cfg, batch["labels"],
                           batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class EncDecDecodeState(NamedTuple):
    self_kv: List[L.KVCache]  # one per decoder layer (the reference stacks)
    cross_k: torch.Tensor     # (L, B, enc_seq, KV, hd)
    cross_v: torch.Tensor     # the same shape; its own tensor
    pos: torch.Tensor         # (B,) next position per sequence


def decode_state_specs(cfg: ModelConfig, rc: RunConfig) -> Attrs:
    """Logical axes of the decode state, the reference's
    ``EncDecDecodeState`` tree (the self-attention caches stacked): the
    cross K/V split over the batch only."""
    return Attrs(
        self_kv=map_tree(lambda t: (None,) + t, L.cache_specs(rc.kv_cache_bits)),
        cross_k=(None, "batch", None, None, None),
        cross_v=(None, "batch", None, None, None),
        pos=(None,))


def state_tree(state: EncDecDecodeState) -> Attrs:
    """The state as the reference's tree, for ``decode_state_specs``: each
    field of the per-layer self-attention caches one ``Stacked`` leaf."""
    first = state.self_kv[0]
    kv = Attrs((f, None if getattr(first, f) is None else Stacked(
        [getattr(c, f) for c in state.self_kv])) for f in L.KVCache._fields)
    return Attrs(self_kv=kv, cross_k=state.cross_k, cross_v=state.cross_v,
                 pos=state.pos)


def init_decode_state(cfg: ModelConfig, rc: RunConfig, batch: int,
                      device="cuda", mesh=None) -> EncDecDecodeState:
    """Every leaf zero, the kv scales included, as the reference's.  The
    reference binds one zero array as both cross_k and cross_v; here they
    are two tensors.  With ``mesh``, this rank's block of every leaf
    (``sharding.local_state``), as ``transformer.init_decode_state``."""
    if mesh is not None:
        whole = init_decode_state(cfg, rc, batch, "meta")
        return shd.local_state(whole, state_tree(whole),
                               decode_state_specs(cfg, rc), mesh, device)

    def kv():
        return L.KVCache(*(None if t is None else torch.zeros_like(t) for t in
                           L.init_cache(cfg, batch, rc.seq_len, rc.kv_cache_bits,
                                        rc.torch_dtype, device)))

    shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
    return EncDecDecodeState(
        self_kv=[kv() for _ in range(cfg.n_layers)],
        cross_k=torch.zeros(shape, dtype=rc.torch_dtype, device=device),
        cross_v=torch.zeros(shape, dtype=rc.torch_dtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def cache_leaves(state: EncDecDecodeState) -> Iterator[torch.Tensor]:
    """Every tensor of the state but ``pos``: the self-attention caches
    layer by layer (with their scales), then cross_k and cross_v."""
    for kv in state.self_kv:
        yield from (t for t in kv if t is not None)
    yield state.cross_k
    yield state.cross_v


def reset_decode_state(state: EncDecDecodeState) -> EncDecDecodeState:
    """Zero ``state`` in place and return it (a CUDA graph captured on its
    tensors stays valid)."""
    for t in cache_leaves(state):
        t.zero_()
    state.pos.zero_()
    return state


def _cross_decode(h: torch.Tensor, p: L.AttnParams, ck: torch.Tensor,
                  cv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One query against the cached cross K/V (B, enc_seq, KV, hd): the
    reference's f32 softmax, K and V cast to f32 at every step.  On a
    ``model`` axis above 1 each rank runs its own heads (``layers._heads``)
    against the cross K/V of its rows, every KV head."""
    q0, q1 = L._heads(cfg).q
    q = L.decode_queries(h, p, cfg)[:, :, q0:q1]
    o = L._attend(q, ck, cv, q0, cfg.n_heads // cfg.n_kv_heads, round_p=False)
    return L.decode_out(o.to(h.dtype), p, cfg, q0)


def decode_step(params: EncDecParams, state: EncDecDecodeState,
                tokens: torch.Tensor, cfg: ModelConfig, rc: RunConfig):
    """One decode step.  tokens: (B,) -> (logits (B, V), new state).

    The self-attention caches advance in place (``layers.update_cache``);
    the returned state holds the same tensors and the advanced positions.
    On a mesh, as ``transformer.decode_step``: this rank's rows and blocks,
    the logits whole on every rank.
    """
    B = state.pos.shape[0]
    pos, tokens = shd.rank_rows(state.pos, B), shd.rank_rows(tokens, B)
    embed = shd.gathered(params.embed)
    x = L.embed(tokens[:, None], embed, cfg)              # (B, 1, d)
    for i, (lp, kv) in enumerate(zip(params.dec_layers, state.self_kv)):
        lp = shd.gathered(lp)
        h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
        a, _ = L.decode_attention(h, lp.self_attn, cfg, kv, pos,
                                  rc.kv_cache_bits, s_cache=rc.seq_len)
        x = x + a
        h = L.rmsnorm(x, lp.ln_x, cfg.norm_eps)
        x = x + _cross_decode(h, lp.cross_attn, state.cross_k[i],
                              state.cross_v[i], cfg)
        h = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
        x = x + L.mlp(h, lp.mlp, cfg.mlp_act, cfg.d_ff)
    lg = L.logits(x, embed, cfg)[:, 0]
    return shd.whole_batch(lg, B), state._replace(pos=state.pos + 1)
