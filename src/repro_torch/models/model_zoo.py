"""Unified model API: config -> init / loss / prefill / decode / input specs.

Port of ``repro.models.model_zoo`` for the decoder-only families (dense,
vlm, moe, ssm, hybrid); the encoder-decoder family raises
``NotImplementedError``.  The reference's ``abstract_params``, ``param_specs`` and ``decode_state_specs``
serve its sharding and dry-run tooling, which the port does not have yet.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from . import transformer


class ModelApi(NamedTuple):
    init: Callable               # (seed) -> params on the device
    loss_fn: Callable            # (params, batch) -> scalar f32 loss
    prefill: Callable            # (params, batch) -> logits (B, V)
    decode_step: Callable        # (params, state, tokens) -> (logits, state)
    init_decode_state: Callable  # (batch) -> state


def get_api(cfg: ModelConfig, rc: RunConfig, device="cuda") -> ModelApi:
    """The entry points of one model on ``device`` (the card by default).

    ``init(seed)`` draws the weights from ``torch.Generator(device)`` seeded
    with ``seed``.  ``loss_fn`` is differentiable; ``prefill`` and
    ``decode_step`` run without autograd.
    """
    transformer.check_family(cfg)
    dtype = rc.torch_dtype

    def init(seed: int):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return transformer.init(gen, cfg, dtype)

    @torch.no_grad()
    def prefill(params, batch):
        return transformer.prefill(params, batch["tokens"], cfg, rc,
                                   vis_embeds=batch.get("vis_embeds"))

    @torch.no_grad()
    def decode_step(params, state, tokens):
        return transformer.decode_step(params, state, tokens, cfg, rc)

    return ModelApi(
        init=init,
        loss_fn=lambda params, batch: transformer.loss_fn(params, batch, cfg, rc),
        prefill=prefill,
        decode_step=decode_step,
        init_decode_state=lambda batch: transformer.init_decode_state(
            cfg, rc, batch, device),
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
