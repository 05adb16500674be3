"""Unified model API: config -> init / loss / prefill / decode / input specs.

Port of ``repro.models.model_zoo`` for every family: the encoder-decoder
family runs in ``encdec``, the decoder-only ones in ``transformer``.
``param_specs`` and ``decode_state_specs`` give the logical axes of the
parameters and of the decode state in the reference's trees
(``distributed.sharding`` resolves them; ``state_tree`` lays a state out
as that tree).  The reference's ``abstract_params`` serves its dry-run
tooling; the port's dry run (``launch.dryrun``) builds the model under
``FakeTensorMode`` instead.  ``init_decode_state(batch, mesh=)`` gives this
rank's blocks of the state on a mesh.  The port adds ``cache_leaves`` and
``reset_decode_state``, which the serving engine's CUDA graph needs (the
reference rebuilds its state).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from . import encdec, transformer


class ModelApi(NamedTuple):
    init: Callable               # (seed) -> params on the device
    param_specs: Callable        # () -> logical axes, the reference's tree
    loss_fn: Callable            # (params, batch) -> scalar f32 loss
    prefill: Callable            # (params, batch) -> logits (B, V)
    decode_step: Callable        # (params, state, tokens) -> (logits, state)
    init_decode_state: Callable  # (batch, mesh=None) -> state (a rank's blocks)
    decode_state_specs: Callable  # () -> logical axes, the reference's tree
    state_tree: Callable         # (state) -> the reference's tree of it
    cache_leaves: Callable       # (state) -> every tensor of it but pos
    reset_decode_state: Callable  # (state) -> the state, zeroed in place


def get_api(cfg: ModelConfig, rc: RunConfig, device="cuda") -> ModelApi:
    """The entry points of one model on ``device`` (the card by default).

    ``init(seed)`` draws the weights from ``torch.Generator(device)`` seeded
    with ``seed``.  ``loss_fn`` is differentiable; ``prefill`` and
    ``decode_step`` run without autograd.
    """
    transformer.check_family(cfg, decoder_only=False)
    dtype = rc.torch_dtype
    m = encdec if cfg.family == "encdec" else transformer

    def init(seed: int):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return m.init(gen, cfg, dtype)

    @torch.no_grad()
    def prefill(params, batch):
        if m is encdec:
            return encdec.prefill(params, batch, cfg, rc)
        return transformer.prefill(params, batch["tokens"], cfg, rc,
                                   vis_embeds=batch.get("vis_embeds"))

    @torch.no_grad()
    def decode_step(params, state, tokens):
        return m.decode_step(params, state, tokens, cfg, rc)

    return ModelApi(
        init=init,
        param_specs=lambda: m.param_specs(cfg),
        loss_fn=lambda params, batch: m.loss_fn(params, batch, cfg, rc),
        prefill=prefill,
        decode_step=decode_step,
        init_decode_state=lambda batch, mesh=None: m.init_decode_state(
            cfg, rc, batch, device, mesh),
        decode_state_specs=lambda: m.decode_state_specs(cfg, rc),
        state_tree=m.state_tree,
        cache_leaves=m.cache_leaves,
        reset_decode_state=m.reset_decode_state,
    )


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the reference's ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, rc: RunConfig) -> Dict[str, TensorSpec]:
    """Inputs of the cell's step function.

    train / prefill: token batch (+ stub modality embeddings); decode: one
    token per sequence.
    """
    B, S = rc.global_batch, rc.seq_len
    i32 = torch.int32
    if cfg.family == "encdec":
        if rc.kind == "decode":
            return {"tokens": TensorSpec((B,), i32)}
        return {"frames": TensorSpec((B, cfg.enc_seq, cfg.d_model), rc.torch_dtype),
                "tokens": TensorSpec((B, S), i32),
                "labels": TensorSpec((B, S), i32)}
    if rc.kind == "decode":
        return {"tokens": TensorSpec((B,), i32)}
    if cfg.family == "vlm":
        nv = cfg.n_vis_tokens
        return {"tokens": TensorSpec((B, S - nv), i32),
                "labels": TensorSpec((B, S - nv), i32),
                "vis_embeds": TensorSpec((B, nv, cfg.d_model), rc.torch_dtype)}
    return {"tokens": TensorSpec((B, S), i32), "labels": TensorSpec((B, S), i32)}


def batch_logical_specs(cfg: ModelConfig, rc: RunConfig) -> Dict[str, tuple]:
    """Logical sharding names for the batch dict."""
    if rc.kind == "decode":
        return {"tokens": ("batch",)}
    out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.family == "encdec":
        out["frames"] = ("batch", None, None)
    if cfg.family == "vlm":
        out["vis_embeds"] = ("batch", None, None)
    return out
