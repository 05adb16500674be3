"""Train-step factory: loss -> grads -> AdamW.

Port of ``repro.train.step`` on its plain gradient path: one device,
``loss.backward()`` for the reference's ``jax.value_and_grad``.  The
reference's compressed cross-pod path (``rc.grad_compress_bits`` on a mesh
with several pods) needs the distributed slice, not ported yet; a mesh
raises ``NotImplementedError``, and without one the reference, too, takes
the plain path.

The step updates the parameters and moments in place (the reference's
jitted step donates its state): the returned ``TrainState`` holds the same
tensors.
"""
from __future__ import annotations

from typing import Any, List, Mapping, NamedTuple, Optional

import torch

from repro_torch.checkpoint.ckpt import Attrs, Stacked
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.encdec import DecLayer, EncDecParams, EncLayer
from repro_torch.models.model_zoo import ModelApi
from repro_torch.models.transformer import LayerParams
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any              # the model's parameters (an nn.Module)
    opt: adamw.AdamState     # moments keyed by parameter name
    resid: Optional[Any]     # error-feedback residuals: None on one device
    step: torch.Tensor       # int32 scalar on the parameters' device


def adam_config(rc: RunConfig, total_steps: int = 10_000) -> adamw.AdamConfig:
    return adamw.AdamConfig(lr=rc.lr, weight_decay=rc.weight_decay,
                            grad_clip=rc.grad_clip, dtype=rc.opt_dtype,
                            total_steps=total_steps)


def init_state(api: ModelApi, rc: RunConfig, seed: int = 0) -> TrainState:
    """Fresh parameters from ``api.init(seed)`` and zero AdamW moments, on
    the device ``api`` was made for (``model_zoo.get_api``, the card by
    default)."""
    params = api.init(seed)
    named = dict(params.named_parameters())
    opt = adamw.init(named, adam_config(rc))
    device = next(iter(named.values())).device
    return TrainState(params=params, opt=opt, resid=None,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(api: ModelApi, cfg: ModelConfig, rc: RunConfig, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``metrics`` holds the f32 ``loss`` and the gradients' ``grad_norm``
    (before clipping), as 0-dim tensors on the device.  A ``mesh``
    (sharding, the compressed cross-pod gradient exchange) raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (sharding, the compressed cross-pod gradient "
            "exchange) needs the distributed slice of the port, not ported "
            "yet")
    acfg = adam_config(rc)

    def train_step(state: TrainState, batch) -> tuple:
        params = dict(state.params.named_parameters())
        for p in params.values():
            p.grad = None
        loss = api.loss_fn(state.params, batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        gnorm = adamw.global_norm(grads.values())
        _, opt = adamw.update(grads, state.opt, params, acfg, gnorm)
        for p in params.values():
            p.grad = None          # free the gradients before the next step
        metrics = {"loss": loss.detach().to(torch.float32), "grad_norm": gnorm}
        return TrainState(params=state.params, opt=opt, resid=state.resid,
                          step=state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# The reference's checkpoint layout of a TrainState
# ---------------------------------------------------------------------------

def _put(tree: Attrs, path: List[str], leaf: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, Attrs())
    tree[path[-1]] = leaf


#: each per-layer list of the port, stacked in the reference, with the
#: reference's field order of one layer
STACKED = {"layers": LayerParams.FIELDS, "enc_layers": EncLayer.FIELDS,
           "dec_layers": DecLayer.FIELDS}
#: the reference's order of the top-level fields of every family's tree
#: (``DenseParams``: embed, layers; ``EncDecParams``: its FIELDS)
TOP_FIELDS = ("embed", "layers") + EncDecParams.FIELDS[1:]


def _ordered(node: Attrs, fields) -> Attrs:
    """``node`` with ``fields`` first, in their order, then the rest."""
    return Attrs([(f, node[f]) for f in fields if f in node]
                 + [(k, v) for k, v in node.items() if k not in fields])


def reference_tree(named: Mapping[str, torch.Tensor]) -> Attrs:
    """Tensors keyed by the port's parameter names, as the reference's
    ``DenseParams`` or ``EncDecParams`` tree: the ``<list>.<i>.<path>``
    tensors of each per-layer list (``layers``, ``enc_layers``,
    ``dec_layers``) become one ``Stacked`` leaf at ``<list>.<path>``, other
    names nest on their dots.

    ``named`` must be in ``named_parameters()`` order: a Stacked leaf takes
    its parts in the order the layers come, and the modules register their
    fields in the reference's order, but for a module's own parameters (a
    layer's norms, ``enc_norm``), which ``named_parameters`` lists first:
    ``STACKED`` and ``TOP_FIELDS`` put the reference's order back.  Absent
    fields (tied unembedding, no qkv bias, gelu's w_gate, a sublayer the
    family has not) are not parameters, so they are not leaves, as ``None``
    is none in the reference's tree.
    """
    tree, stacks = Attrs(), {}
    for name, t in named.items():
        path = name.split(".")
        if path[0] not in STACKED:
            _put(tree, path, t)
            continue
        key = (path[0], *path[2:])
        if key not in stacks:
            stacks[key] = Stacked([])
            _put(tree, list(key), stacks[key])
        stacks[key].parts.append(t)
    for node, fields in STACKED.items():
        if node in tree:
            tree[node] = _ordered(tree[node], fields)
    return _ordered(tree, TOP_FIELDS)


def checkpoint_tree(state: TrainState) -> Attrs:
    """The state as the reference's ``TrainState`` tree, for
    ``CheckpointManager.save`` and ``restore`` (leaf paths such as
    ``.params.layers.attn.wq``, ``.params.dec_layers.cross_attn.wq`` and
    ``.opt.count``)."""
    if state.resid is not None:
        raise NotImplementedError("error-feedback residuals come with the "
                                  "distributed slice, not ported yet")
    return Attrs(params=reference_tree(dict(state.params.named_parameters())),
                 opt=Attrs(mu=reference_tree(state.opt.mu),
                           nu=reference_tree(state.opt.nu),
                           count=state.opt.count),
                 resid=None, step=state.step)
