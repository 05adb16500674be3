"""AdamW with global-norm clipping and a cosine schedule.

Port of ``repro.optim.adamw``: the same f32 arithmetic, leaf for leaf, with
the bias corrections computed from an f32 ``count``.  The moments' dtype is
``AdamConfig.dtype`` (``RunConfig.opt_dtype``: bf16 for the largest archs).

The port's parameters are named tensors (``{name: tensor}``, e.g. from
``nn.Module.named_parameters``), and ``update`` writes the new parameters
and moments into the given tensors in place, under ``torch.no_grad`` (the
reference returns new arrays; its jitted step donates the old ones).

Weight decay follows the reference's rule on its *stacked* leaves: a leaf
is decayed when its rank is 2 or more, and the reference stacks every
per-layer leaf on a leading ``n_layers`` axis.  So a tensor named
``layers.<i>.…`` counts one rank more than it has here: the layer norms
and qkv biases are decayed, ``embed.final_norm`` is not (ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import torch

F32 = torch.float32


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]     # like the parameters, AdamConfig.dtype
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor             # int32 scalar, on the parameters' device


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    dtype: str = "float32"


def init(params: Mapping[str, torch.Tensor], cfg: AdamConfig) -> AdamState:
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else F32
    zeros = {n: torch.zeros(p.shape, dtype=dt, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return AdamState(mu=zeros, nu={n: torch.zeros_like(z) for n, z in zeros.items()},
                     count=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warm-up, cosine to 10%.

    Both divisors are 0-dim f32 tensors on step's device: a GPU divides by
    a host scalar as a multiply by its reciprocal, not as IEEE division.
    """
    step = step.to(F32)

    def divisor(v: int) -> torch.Tensor:
        return torch.full((), float(max(v, 1)), dtype=F32, device=step.device)

    warm = torch.clamp(step / divisor(cfg.warmup_steps), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / divisor(cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(leaves: Iterable[torch.Tensor],
                groups: Optional[Iterable] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.

    ``groups`` (one a leaf) is where the leaves are blocks of sharded
    tensors: a leaf's squares are summed over the process group of the
    ranks that hold its other blocks (``None``: no other), once, so that a
    block held whole on several ranks is counted once.  Every rank gets the
    same value.
    """
    from repro_torch.distributed import collectives
    by_group: dict = {}
    for x, g in zip(leaves, itertools.repeat(None) if groups is None else groups):
        by_group.setdefault(g, []).append(torch.sum(torch.square(x.to(F32))))
    total = None
    for g, squares in by_group.items():
        part = sum(squares)
        if g is not None:
            part = collectives.all_reduce(part, g)
        total = part if total is None else total + part
    return torch.sqrt(total)


#: the name prefixes of the per-layer lists, stacked in the reference
STACKED_PREFIXES = ("layers.", "enc_layers.", "dec_layers.")


def stacked_rank(name: str, p: torch.Tensor) -> int:
    """The rank of ``p``'s leaf in the reference, whose layers are stacked
    (the decoder-only ``layers``, the encoder-decoder's ``enc_layers`` and
    ``dec_layers``)."""
    return p.dim() + (1 if name.startswith(STACKED_PREFIXES) else 0)


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: AdamState,
           params: Mapping[str, torch.Tensor], cfg: AdamConfig,
           gnorm: Optional[torch.Tensor] = None
           ) -> Tuple[Mapping[str, torch.Tensor], AdamState]:
    """One AdamW step: ``params``, ``state.mu`` and ``state.nu`` in place.

    ``gnorm`` is ``global_norm(grads)`` when the caller has it already (a
    full f32 pass over the gradients); it is computed here otherwise.
    Returns ``(params, state)`` as the reference does: the same parameter
    and moment tensors, and ``count`` advanced in place.  Every constant is
    made on the device (``torch.full``), so a CUDA graph can capture the
    update: it copies nothing from the host and reads no value back.
    """
    count = state.count.add_(1)
    c32 = count.to(F32)
    lr = schedule(cfg, count)
    if gnorm is None:
        gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    # python float ** f32 tensor, as the reference's cfg.b1 ** count
    bc1 = 1 - torch.pow(torch.full((), cfg.b1, dtype=F32, device=c32.device), c32)
    bc2 = 1 - torch.pow(torch.full((), cfg.b2, dtype=F32, device=c32.device), c32)
    for name, p in params.items():
        m, v = state.mu[name], state.nu[name]
        g = grads[name].to(F32) * scale
        m_new = cfg.b1 * m.to(F32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(F32) + (1 - cfg.b2) * g * g
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        decay = cfg.weight_decay if stacked_rank(name, p) >= 2 else 0.0
        p.copy_(p.to(F32) * (1 - lr * decay) - lr * step)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)
