"""The inputs both sides are handed: weights and session histories, from the seed.

Made on the card with a ``torch.Generator`` there, in the type they are
served in (bf16), in a few large calls: the weights of each initial
distribution share one flat buffer, filled by ``normal_`` in chunks, and
every leaf is a view into it.  The leaves and their distributions are the
architecture's (``arch/<arch>.py``'s ``layout``): the port's initial ones,
such as N(0, 0.02) for the embedding, N(0, 1 / fan_in) for every
projection, ones for the norms.

A session's history is its keys and values (bf16, post-RoPE), drawn per
layer from its own stream of the seed, so that the reference can draw any
layer again, bit for bit, after the program's cache is gone.

Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

CHUNK = 1 << 30       # elements a ``normal_`` call
_WEIGHTS, _HIST_K, _HIST_V = 11, 12, 13


def generator(seed: int, device, *tags: int) -> torch.Generator:
    """A torch generator on ``device`` for one stream of the seed."""
    words = np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(words[0]) << 31 ^ int(words[1]))
    return g


def weights(cfg: dict, arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``cfg`` in bf16 on ``device``, drawn from ``seed``:
    the rows of ``arch.layout(cfg)`` (name, shape, init), where init is a
    std (normal) or ``"ones"``."""
    dtype = torch.bfloat16
    leaves = arch.layout(cfg)
    groups: Dict[object, list] = {}
    for name, shape, init in leaves:
        groups.setdefault(init, []).append((name, shape))
    g = generator(seed, device, _WEIGHTS)
    out = {}
    for init in sorted(groups, key=str):
        members = groups[init]
        n = sum(int(np.prod(shape)) for _, shape in members)
        if init == "ones":
            buf = torch.ones(n, dtype=dtype, device=device)
        else:
            buf = torch.empty(n, dtype=dtype, device=device)
            for lo in range(0, n, CHUNK):
                buf[lo:lo + CHUNK].normal_(0.0, float(init), generator=g)
        at = 0
        for name, shape in members:
            k = int(np.prod(shape))
            out[name] = buf[at:at + k].view(shape)
            at += k
    return {name: out[name] for name, _, _ in leaves}


def history_kv(cfg: dict, hist: dict, seed: int, layer: int, batch: int,
               slots: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``layer``'s history keys and values (batch, slots, KV, hd) bf16,
    N(0, k_std) and N(0, v_std), each from its own stream of the seed."""
    shape = (batch, slots, cfg["n_kv_heads"], cfg["head_dim"])
    out = []
    for tag, std in ((_HIST_K, hist["k_std"]), (_HIST_V, hist["v_std"])):
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        t.normal_(0.0, float(std), generator=generator(seed, device, tag, layer))
        out.append(t)
    return out[0], out[1]
