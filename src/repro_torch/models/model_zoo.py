"""Unified model API: config -> init / prefill / decode.

Port of ``repro.models.model_zoo`` for the serving path of the dense and
vlm families.  The reference's ``loss_fn`` comes with the training slice;
its ``abstract_params``, ``param_specs`` and ``decode_state_specs`` serve
its sharding and dry-run tooling, which the port does not have yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from . import transformer


class ModelApi(NamedTuple):
    init: Callable               # (seed) -> params on the device
    prefill: Callable            # (params, batch) -> logits (B, V)
    decode_step: Callable        # (params, state, tokens) -> (logits, state)
    init_decode_state: Callable  # (batch) -> state


def get_api(cfg: ModelConfig, rc: RunConfig, device="cuda") -> ModelApi:
    """The entry points of one model on ``device`` (the card by default).

    ``init(seed)`` draws the weights from ``torch.Generator(device)`` seeded
    with ``seed``.  ``prefill`` and ``decode_step`` run without autograd.
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
        prefill=prefill,
        decode_step=decode_step,
        init_decode_state=lambda batch: transformer.init_decode_state(
            cfg, rc, batch, device),
    )
