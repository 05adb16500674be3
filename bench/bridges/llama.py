"""The program's side of the llama-style block (``arch/llama.py``).

What ``system.Server`` asks of an architecture: the program's parameter
modules over the benchmark's weights, a session's history written into the
program's decode state, and the kernel wrappers a layer of its decode step
launches.  With ``system.py`` the only files of the benchmark that import
the program.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

#: the kernel wrappers a decode step launches: (name, launches a layer)
DECODE_KERNELS = {"kvpack.kv_quant_store": 1,
                  "decode_attention.kv_decode_attention": 1}


def program_params(cfg: dict, w: Dict[str, torch.Tensor]) -> T.DenseParams:
    """The program's parameter modules over the benchmark's weights (the
    same tensors, no copy): an MLP or, for ``family`` ``moe``, a mixture of
    experts in each layer."""
    emb = L.EmbedParams(w["embed.table"], w.get("embed.unembed"),
                        w["embed.final_norm"])
    layers = []
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        attn = L.AttnParams(*(w[p + "attn." + n] for n in ("wq", "wk", "wv", "wo")))
        mlp = moe = None
        if cfg["family"] == "moe":
            moe = M.MoeParams(*(w[p + "moe." + n]
                                for n in ("router", "w_gate", "w_up", "w_down")))
        else:
            mlp = L.MlpParams(*(w[p + "mlp." + n] for n in ("w_gate", "w_up", "w_down")))
        layers.append(T.LayerParams(ln1=w[p + "ln1"], attn=attn, ln2=w[p + "ln2"],
                                    mlp=mlp, moe=moe))
    return T.DenseParams(emb, layers)


def fill_history(state, history_fn, bits: int) -> None:
    """Write each layer's history (``history_fn(layer)`` -> bf16 K, V (B,
    slots, KV, hd)) into the packed cache of the decode state through
    ``ops.kv_quant``: every layer's cache holds as many slots as the
    history."""
    for i, cache in enumerate(c.kv for c in state.caches):
        k, v = history_fn(i)
        for src, codes, scales in ((k, cache.k, cache.k_scale),
                                   (v, cache.v, cache.v_scale)):
            if bits == 16:
                codes.copy_(src)
                continue
            c, s = ops.kv_quant(src.reshape(-1, src.shape[-1]), bits)
            codes.copy_(c.view(codes.shape))
            scales.copy_(s.view(scales.shape))
        del k, v
