"""Decoder-only LM frame for the dense and vlm families: init, forward, loss, serving.

Port of ``repro.models.transformer`` for the serving and training paths.
The reference scans one stacked layer body over ``n_layers``; here the
layers are an ``nn.ModuleList`` and a Python loop walks them.  With
``rc.remat`` each layer runs under ``torch.utils.checkpoint`` while autograd
records (the reference's ``"full"`` policy: nothing saved, all recomputed).
The moe, ssm and hybrid families (ROADMAP Queue 1 item 6) are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from . import layers as L

#: families whose model this slice of the port runs
PORTED_FAMILIES = ("dense", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP Queue 1 item 6); ported: {', '.join(PORTED_FAMILIES)}")


class LayerParams(nn.Module):
    """One decoder layer of the dense / vlm families."""

    #: the reference's field order; ``named_parameters`` lists a module's own
    #: parameters (ln1, ln2) before its submodules' (attn, mlp)
    FIELDS = ("ln1", "attn", "ln2", "mlp")

    def __init__(self, ln1, attn: L.AttnParams, ln2, mlp: L.MlpParams):
        super().__init__()
        self.ln1 = L._param(ln1)
        self.attn = attn
        self.ln2 = L._param(ln2)
        self.mlp = mlp


class DenseParams(nn.Module):
    """Embedding plus ``n_layers`` layers (a list, where the reference stacks)."""

    def __init__(self, embed: L.EmbedParams, layers: List[LayerParams]):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> LayerParams:
    d = cfg.d_model
    return LayerParams(
        ln1=L.init_rmsnorm(d, dtype, gen.device),
        attn=L.init_attn(gen, cfg, dtype),
        ln2=L.init_rmsnorm(d, dtype, gen.device),
        mlp=L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_act, dtype),
    )


def init(gen: torch.Generator, cfg: ModelConfig,
         dtype=torch.bfloat16) -> DenseParams:
    """Random weights on ``gen.device``, the reference's distributions.

    Every weight is drawn from ``gen`` in a fixed order (embedding, then the
    layers in turn), so one seed gives one model on one device type.
    """
    check_family(cfg)
    emb = L.init_embed(gen, cfg, dtype)
    return DenseParams(emb, [init_layer(gen, cfg, dtype)
                             for _ in range(cfg.n_layers)])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: ModelConfig, rc: RunConfig, x: torch.Tensor,
               pos: torch.Tensor, lp: LayerParams) -> torch.Tensor:
    h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
    x = x + L.attention(h, lp.attn, cfg, pos, rc.q_block, rc.kv_block)
    h2 = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
    return x + L.mlp(h2, lp.mlp, cfg.mlp_act)


def backbone(params: DenseParams, tokens: torch.Tensor, cfg: ModelConfig,
             rc: RunConfig, vis_embeds: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_text) [+ optional stub prefix] -> (final hidden x, aux).

    ``aux`` is the reference's MoE auxiliary loss, zero for these families.
    """
    check_family(cfg)
    x = L.embed(tokens, params.embed)
    if vis_embeds is not None:
        x = torch.cat([vis_embeds.to(x.dtype), x], dim=1)
    B, Sq, _ = x.shape
    pos = torch.arange(Sq, device=x.device)[None, :].expand(B, Sq)
    remat = rc.remat and torch.is_grad_enabled()
    if remat and rc.remat_policy == "save_collectives":
        raise NotImplementedError(
            "remat_policy='save_collectives' saves the outputs of sharding "
            "collectives, which the port does not have yet (ROADMAP Queue 1 "
            "item 9); use 'full'")
    for lp in params.layers:
        if remat:
            x = checkpoint(_layer_fwd, cfg, rc, x, pos, lp, use_reentrant=False)
        else:
            x = _layer_fwd(cfg, rc, x, pos, lp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: DenseParams, tokens: torch.Tensor, cfg: ModelConfig,
            rc: RunConfig, vis_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full logits (tests / tiny shapes)."""
    x, aux = backbone(params, tokens, cfg, rc, vis_embeds)
    return L.logits(x, params.embed, cfg), aux


def loss_fn(params: DenseParams, batch, cfg: ModelConfig,
            rc: RunConfig) -> torch.Tensor:
    """batch: dict(tokens (B,S), labels (B,S) [, vis_embeds, mask]) -> f32 loss.

    For the vlm family the loss covers the text positions only.
    """
    vis = batch.get("vis_embeds")
    x, _ = backbone(params, batch["tokens"], cfg, rc, vis_embeds=vis)
    if vis is not None:
        x = x[:, vis.shape[1]:]
    return L.fused_ce_loss(x, params.embed, cfg, batch["labels"],
                           batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: List[L.KVCache]   # one per layer (the reference stacks them)
    pos: torch.Tensor         # (B,) next position per sequence


def init_decode_state(cfg: ModelConfig, rc: RunConfig, batch: int,
                      device="cuda") -> DecodeState:
    check_family(cfg)
    s_cache = rc.seq_len
    if cfg.sliding_window:
        s_cache = min(s_cache, cfg.sliding_window)
    # every leaf zero, the scales included (the reference zero-fills the
    # state it shapes from ``init_cache``, whose own scales are ones)
    caches = [L.KVCache(*(
        None if t is None else torch.zeros_like(t) for t in L.init_cache(
            cfg, batch, s_cache, rc.kv_cache_bits, rc.torch_dtype, device)))
        for _ in range(cfg.n_layers)]
    return DecodeState(caches=caches,
                       pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def reset_decode_state(state: DecodeState) -> DecodeState:
    """Zero ``state`` in place and return it: what ``init_decode_state``
    gives (every leaf zero, the scales included), in the same tensors, so a
    CUDA graph captured on them stays valid."""
    for cache in state.caches:
        for t in cache:
            if t is not None:
                t.zero_()
    state.pos.zero_()
    return state


def decode_step(params: DenseParams, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig, rc: RunConfig
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  tokens: (B,) -> (logits (B, V), new state).

    The caches are updated in place (``layers.update_cache``); the returned
    state holds them and the advanced positions.
    """
    check_family(cfg)
    x = L.embed(tokens[:, None], params.embed)            # (B, 1, d)
    caches = []
    for lp, cache in zip(params.layers, state.caches):
        h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
        a, kv = L.decode_attention(h, lp.attn, cfg, cache, state.pos,
                                   rc.kv_cache_bits, cfg.sliding_window)
        x = x + a
        h2 = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
        x = x + L.mlp(h2, lp.mlp, cfg.mlp_act)
        caches.append(kv)
    lg = L.logits(x, params.embed, cfg)[:, 0]
    return lg, DecodeState(caches=caches, pos=state.pos + 1)


def prefill(params: DenseParams, tokens: torch.Tensor, cfg: ModelConfig,
            rc: RunConfig, vis_embeds: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Prefill: logits for the LAST position only (serving semantics)."""
    x, _ = backbone(params, tokens, cfg, rc, vis_embeds=vis_embeds)
    return L.logits(x[:, -1:], params.embed, cfg)[:, 0]
