"""Decoder-only LM frame: the dense, vlm, moe, ssm and hybrid families.

Port of ``repro.models.transformer``.  The reference scans one stacked
layer body over ``n_layers``; here the layers are an ``nn.ModuleList`` and
a Python loop walks them.  The family picks a layer's sublayers, as in the
reference: attention (dense, vlm, moe, hybrid), the SSD mixer (ssm,
hybrid; hybrid averages the two branches after a norm each), an MLP
(dense, vlm, hybrid) or the MoE block (moe); a field the family has not is
``None``.  With ``rc.remat`` each layer runs under
``torch.utils.checkpoint`` while autograd records: the reference's
``"full"`` policy saves nothing and recomputes all; ``"save_collectives"``
keeps the outputs of the collectives named ``proj_out`` and
``kv_gathered`` (``collectives.SavePolicy``) and recomputes the rest, so
that backward does not run them again (on one device there are none, and
it is ``"full"``).  No op of a layer draws random numbers, so the
checkpoint keeps no RNG state (``preserve_rng_state=False``): setting a
CUDA generator's state is what a graph capture cannot record
(``train.step.GraphedTrainStep``).  The encoder-decoder family is
``models/encdec.py``; the functions here refuse its configs
(``check_family``), and ``model_zoo.get_api`` dispatches to either module.

On a mesh (rules installed by ``train.step``) each layer reads its
parameters through ``sharding.gathered`` (ZeRO-3 over ``data``) and, on a
``model`` axis above 1, runs tensor-parallel: between layers the residual
stream is (B, S / tp, d), this rank's block of positions, wherever
``rc.seq_shard`` holds and tp divides S (the vlm prefix is joined before
the split), the norms run on that block, and the attention, the SSD
mixer, the MLP and the MoE take it gathered and each return their output
where the stream lives, so that hybrid's two branches meet in
``_merge`` on the same positions and are normed there with the whole (d,)
``ln_attn_out`` / ``ln_ssm_out``.  The backbone returns the stream whole.
``rc.tp_scatter`` selects nothing here: the port always issues the
reference's ``tp_scatter`` schedule (an f32 partial product,
reduce-scattered onto the sequence), which is also what GSPMD's own
schedule computes.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.ckpt import Attrs, Stacked, map_tree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from . import layers as L
from . import moe as M
from . import ssm as S

#: the reference's model families, all ported; the last runs in
#: ``models/encdec.py``, the others here
PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def check_family(cfg: ModelConfig, decoder_only: bool = True) -> None:
    """Raise on a family the port does not know, and (``decoder_only``) on
    the encoder-decoder family, whose model is ``models/encdec.py``."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; ported: "
            f"{', '.join(PORTED_FAMILIES)}")
    if decoder_only and cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model: models.transformer runs "
            f"the decoder-only families; use models.encdec (model_zoo.get_api "
            f"picks the module by family)")


def _has_attn(cfg: ModelConfig) -> bool:
    return cfg.family in ("dense", "vlm", "moe", "hybrid", "encdec")


def _has_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _has_mlp(cfg: ModelConfig) -> bool:
    return cfg.family in ("dense", "vlm", "hybrid", "encdec")


class LayerParams(nn.Module):
    """One decoder layer; a field the family has not is ``None``."""

    #: the reference's field order; ``named_parameters`` lists a module's own
    #: parameters (the norms) before its submodules', so
    #: ``train.step.reference_tree`` puts this order back
    FIELDS = ("ln1", "attn", "ssm", "ln_attn_out", "ln_ssm_out", "ln2", "mlp",
              "moe")

    def __init__(self, ln1, attn: Optional[L.AttnParams] = None,
                 ssm: Optional[S.SsmParams] = None, ln_attn_out=None,
                 ln_ssm_out=None, ln2=None, mlp: Optional[L.MlpParams] = None,
                 moe: Optional[M.MoeParams] = None):
        super().__init__()
        for name, t in (("ln1", ln1), ("ln_attn_out", ln_attn_out),
                        ("ln_ssm_out", ln_ssm_out), ("ln2", ln2)):
            self.register_parameter(name, None if t is None else L._param(t))
        for name, m in (("attn", attn), ("ssm", ssm), ("mlp", mlp), ("moe", moe)):
            self.register_module(name, m)


class DenseParams(nn.Module):
    """Embedding plus ``n_layers`` layers (a list, where the reference stacks)."""

    def __init__(self, embed: L.EmbedParams, layers: List[LayerParams]):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)


def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> LayerParams:
    d, dev = cfg.d_model, gen.device
    hybrid = cfg.family == "hybrid"
    return LayerParams(
        ln1=L.init_rmsnorm(d, dtype, dev),
        attn=L.init_attn(gen, cfg, dtype) if _has_attn(cfg) else None,
        ssm=S.init_ssm(gen, cfg, dtype) if _has_ssm(cfg) else None,
        ln_attn_out=L.init_rmsnorm(d, dtype, dev) if hybrid else None,
        ln_ssm_out=L.init_rmsnorm(d, dtype, dev) if hybrid else None,
        ln2=L.init_rmsnorm(d, dtype, dev)
        if _has_mlp(cfg) or cfg.family == "moe" else None,
        mlp=L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_act, dtype)
        if _has_mlp(cfg) else None,
        moe=M.init_moe(gen, cfg, dtype) if cfg.family == "moe" else None,
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


def layer_specs(cfg: ModelConfig) -> Attrs:
    """Logical axes of one layer, the reference's ``LayerParams`` tree."""
    hybrid = cfg.family == "hybrid"
    return Attrs(
        ln1=(None,),
        attn=L.attn_specs(cfg) if _has_attn(cfg) else None,
        ssm=S.ssm_specs() if _has_ssm(cfg) else None,
        ln_attn_out=(None,) if hybrid else None,
        ln_ssm_out=(None,) if hybrid else None,
        ln2=(None,) if _has_mlp(cfg) or cfg.family == "moe" else None,
        mlp=L.mlp_specs(cfg.mlp_act) if _has_mlp(cfg) else None,
        moe=M.moe_specs() if cfg.family == "moe" else None,
    )


def param_specs(cfg: ModelConfig) -> Attrs:
    """Logical axes of every parameter, in the reference's tree
    (``DenseParams``: ``layers`` stacked, a leading ``None`` for the layer
    axis)."""
    return Attrs(embed=L.embed_specs(cfg),
                 layers=map_tree(lambda t: (None,) + t, layer_specs(cfg)))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _merge(cfg: ModelConfig, lp: LayerParams, a: Optional[torch.Tensor],
           s: Optional[torch.Tensor]) -> torch.Tensor:
    """The sequence mixer's output from the attention branch ``a`` and the
    SSD branch ``s``: the one the family has, or (hybrid) both, each
    normed, averaged."""
    if cfg.family != "hybrid":
        return s if a is None else a
    return 0.5 * (L.rmsnorm(a, lp.ln_attn_out, cfg.norm_eps)
                  + L.rmsnorm(s, lp.ln_ssm_out, cfg.norm_eps))


#: the reference's ``save_only_these_names`` under ``"save_collectives"``
SAVED_NAMES = ("proj_out", "kv_gathered")


def _stream(S: int) -> tuple:
    """The residual stream's logical placement for a sequence of S."""
    return ("batch", "seq", None) if shd.seq_split(S) else ("batch", None, None)


def _ffn(cfg: ModelConfig, x: torch.Tensor, lp: LayerParams,
         stream: tuple = ("batch", None, None)):
    """The layer's MLP or MoE block on x, the residual stream placed as
    ``stream`` -> (x + out, aux)."""
    h2 = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
    h2 = shd.act(h2, "batch", None, None, src=stream)
    if cfg.family == "moe":
        out, aux = M.moe_block(h2, lp.moe, cfg)
        return x + out, aux
    return x + L.mlp(h2, lp.mlp, cfg.mlp_act, cfg.d_ff), None


def _layer_fwd(cfg: ModelConfig, rc: RunConfig, x: torch.Tensor,
               pos: torch.Tensor, lp: LayerParams
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (x, the layer's MoE aux loss, f32 0-dim; None without a MoE block).

    ``x`` is the residual stream as ``backbone`` places it; ``pos`` covers
    the whole sequence."""
    lp = shd.gathered(lp)
    stream = _stream(pos.shape[1])
    h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
    h = shd.act(h, "batch", None, None, src=stream)
    a = None if lp.attn is None else L.attention(h, lp.attn, cfg, pos,
                                                 rc.q_block, rc.kv_block)
    s = None if lp.ssm is None else S.ssd_forward(lp.ssm, h, cfg)
    x = x + _merge(cfg, lp, a, s)
    if lp.ln2 is None:
        return x, None
    return _ffn(cfg, x, lp, stream)


def backbone(params: DenseParams, tokens: torch.Tensor, cfg: ModelConfig,
             rc: RunConfig, vis_embeds: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_text) [+ optional stub prefix] -> (final hidden x, aux).

    ``aux`` is the MoE load-balance loss averaged over the layers (zero for
    the other families).  ``x`` is whole over the sequence.
    """
    check_family(cfg)
    x = L.embed(tokens, shd.gathered(params.embed), cfg)
    if vis_embeds is not None:
        x = torch.cat([vis_embeds.to(x.dtype), x], dim=1)
    B, Sq, _ = x.shape
    pos = torch.arange(Sq, device=x.device)[None, :].expand(B, Sq)
    stream = _stream(Sq)
    x = shd.act(x, *stream)
    remat = rc.remat and torch.is_grad_enabled()
    kw = {}
    if remat and rc.remat_policy == "save_collectives":
        kw["context_fn"] = collectives.SavePolicy.context_fn(SAVED_NAMES)
    elif remat and rc.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {rc.remat_policy!r}")
    rules = shd.get_rules()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        if remat:
            x, inc = checkpoint(shd.under, rules, _layer_fwd, cfg, rc, x, pos,
                                lp, use_reentrant=False,
                                preserve_rng_state=False, **kw)
        else:
            x, inc = _layer_fwd(cfg, rc, x, pos, lp)
        if inc is not None:
            aux = aux + inc
    return shd.act(x, "batch", None, None, src=stream), aux / cfg.n_layers


def forward(params: DenseParams, tokens: torch.Tensor, cfg: ModelConfig,
            rc: RunConfig, vis_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full logits (tests / tiny shapes)."""
    x, aux = backbone(params, tokens, cfg, rc, vis_embeds)
    return L.logits(x, shd.gathered(params.embed), cfg), aux


def loss_fn(params: DenseParams, batch, cfg: ModelConfig,
            rc: RunConfig) -> torch.Tensor:
    """batch: dict(tokens (B,S), labels (B,S) [, vis_embeds, mask]) -> f32 loss.

    For the vlm family the loss covers the text positions only; for moe it
    adds 0.01 x the aux loss, as the reference.
    """
    vis = batch.get("vis_embeds")
    x, aux = backbone(params, batch["tokens"], cfg, rc, vis_embeds=vis)
    if vis is not None:
        x = x[:, vis.shape[1]:]
    loss = L.fused_ce_loss(x, shd.gathered(params.embed), cfg,
                           batch["labels"], batch.get("mask"))
    if cfg.family == "moe":
        loss = loss + 0.01 * aux
    return loss


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class LayerCache(NamedTuple):
    kv: Optional[L.KVCache]      # attention families
    ssm: Optional[S.SsmState]    # ssm and hybrid


class DecodeState(NamedTuple):
    caches: List[LayerCache]  # one per layer (the reference stacks them)
    pos: torch.Tensor         # (B,) next position per sequence


def cache_leaves(state: DecodeState) -> Iterator[torch.Tensor]:
    """Every tensor of the state's caches, layer by layer (kv, then ssm)."""
    for cache in state.caches:
        for part in cache:
            if part is not None:
                yield from (t for t in part if t is not None)


def cache_len(cfg: ModelConfig, rc: RunConfig) -> int:
    """Slots of a layer's whole KV cache: the sequence, or the window of a
    sliding-window model (a ring)."""
    if cfg.sliding_window:
        return min(rc.seq_len, cfg.sliding_window)
    return rc.seq_len


def decode_state_specs(cfg: ModelConfig, rc: RunConfig) -> Attrs:
    """Logical axes of the decode state, the reference's ``DecodeState``
    tree (its per-layer caches stacked: a leading ``None`` for the layer
    axis)."""
    one = Attrs(kv=L.cache_specs(rc.kv_cache_bits) if _has_attn(cfg) else None,
                ssm=S.ssm_state_specs() if _has_ssm(cfg) else None)
    return Attrs(caches=map_tree(lambda t: (None,) + t, one), pos=(None,))


def state_tree(state: DecodeState) -> Attrs:
    """The state as the reference's tree, for ``decode_state_specs``: each
    leaf of the per-layer caches one ``Stacked`` leaf of the layers'
    tensors."""
    def stacked(part: str, fields) -> Optional[Attrs]:
        first = getattr(state.caches[0], part)
        if first is None:
            return None
        return Attrs((f, None if getattr(first, f) is None else Stacked(
            [getattr(getattr(c, part), f) for c in state.caches]))
            for f in fields)

    return Attrs(caches=Attrs(kv=stacked("kv", L.KVCache._fields),
                              ssm=stacked("ssm", S.SsmState._fields)),
                 pos=state.pos)


def init_decode_state(cfg: ModelConfig, rc: RunConfig, batch: int,
                      device="cuda", mesh=None) -> DecodeState:
    """A zero decode state for ``batch`` sequences.  With ``mesh`` (a
    ``launch.mesh.Mesh``) this rank's block of it, each leaf cut by its
    resolved ``decode_state_specs`` (``sharding.local_state``): the batch
    split over ``pod`` and ``data`` where they divide it, the cache's slots
    over ``model`` where it divides them, ``pos`` whole."""
    check_family(cfg)
    if mesh is not None:
        whole = init_decode_state(cfg, rc, batch, "meta")
        return shd.local_state(whole, state_tree(whole),
                               decode_state_specs(cfg, rc), mesh, device)
    s_cache = cache_len(cfg, rc)

    def layer():
        # every leaf zero, the kv scales included (the reference zero-fills
        # the state it shapes from ``init_cache``, whose own scales are ones)
        kv = L.KVCache(*(None if t is None else torch.zeros_like(t) for t in
                         L.init_cache(cfg, batch, s_cache, rc.kv_cache_bits,
                                      rc.torch_dtype, device))) \
            if _has_attn(cfg) else None
        ssm = S.init_ssm_state(cfg, batch, device) if _has_ssm(cfg) else None
        return LayerCache(kv=kv, ssm=ssm)

    return DecodeState(caches=[layer() for _ in range(cfg.n_layers)],
                       pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def reset_decode_state(state: DecodeState) -> DecodeState:
    """Zero ``state`` in place and return it: what ``init_decode_state``
    gives (every leaf zero, the scales included), in the same tensors, so a
    CUDA graph captured on them stays valid."""
    for t in cache_leaves(state):
        t.zero_()
    state.pos.zero_()
    return state


def decode_step(params: DenseParams, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig, rc: RunConfig
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  tokens: (B,) -> (logits (B, V), new state).

    The state is advanced in place: the kv caches by ``layers.update_cache``,
    the SSM state (h, conv) by a copy into its own tensors, so a CUDA graph
    captured on the state advances it at every replay.  The returned state
    holds the same caches and the advanced positions.

    On a mesh (rules installed, the parameters cut by
    ``train.step.param_partition``, ``state`` this rank's blocks from
    ``init_decode_state(..., mesh=)``) the step runs on this rank's rows of
    the batch (``tokens`` whole or already cut), each layer reading its
    parameters through ``sharding.gathered``, and returns the logits whole
    on every rank: gathered over the vocabulary and over the batch axes.
    """
    check_family(cfg)
    B = state.pos.shape[0]
    pos, tokens = shd.rank_rows(state.pos, B), shd.rank_rows(tokens, B)
    s_cache = cache_len(cfg, rc)
    x = L.embed(tokens[:, None], shd.gathered(params.embed), cfg)  # (B, 1, d)
    for lp, cache in zip(params.layers, state.caches):
        lp = shd.gathered(lp)
        h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
        a = s = None
        if cache.kv is not None:
            a, _ = L.decode_attention(h, lp.attn, cfg, cache.kv, pos,
                                      rc.kv_cache_bits, cfg.sliding_window,
                                      s_cache)
        if cache.ssm is not None:
            s, new = S.ssd_decode(lp.ssm, h, cache.ssm, cfg)
            cache.ssm.h.copy_(new.h)
            cache.ssm.conv.copy_(new.conv)
        x = x + _merge(cfg, lp, a, s)
        if lp.ln2 is not None:
            x, _ = _ffn(cfg, x, lp)
    lg = L.logits(x, shd.gathered(params.embed), cfg)[:, 0]
    return shd.whole_batch(lg, B), DecodeState(caches=state.caches,
                                               pos=state.pos + 1)


def prefill(params: DenseParams, tokens: torch.Tensor, cfg: ModelConfig,
            rc: RunConfig, vis_embeds: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Prefill: logits for the LAST position only (serving semantics)."""
    x, _ = backbone(params, tokens, cfg, rc, vis_embeds=vis_embeds)
    return L.logits(x[:, -1:], shd.gathered(params.embed), cfg)[:, 0]
