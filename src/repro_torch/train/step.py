"""Train-step factory: loss -> grads -> (optionally compressed) exchange -> AdamW.

Port of ``repro.train.step``: ``loss.backward()`` for the reference's
``jax.value_and_grad``.  Without a mesh the step runs on one device.  On a
mesh of torch.distributed ranks (``launch.mesh``) the ``pod`` and ``data``
axes are data parallelism: each rank runs the model on its rows of the
global batch (``data.pipeline.device_batch``), in the order the reference's
``P(("pod", "data"))`` lays them out.  Two gradient paths, as in the
reference:

* plain (``rc.grad_compress_bits`` 0, or one pod): the gradients and the
  loss are averaged in f32 over the pod and data ranks (all-reduce), which
  is what GSPMD's gradient reduction computes;
* compressed (bits > 0 on several pods): each pod's gradients are those of
  its own mean loss, averaged over its data ranks; each compressible leaf
  ``g`` then goes ``x = g + resid``, ``distributed.collectives``'
  quantize and bitplane-pack, ``resid = x - dequant(quant(x))``, the
  exchange of the packed planes and scales between the pods, and the
  pods' dequantized gradients summed in pod order over ``n_pods`` and cast
  to the parameter's dtype (the reference's order, its ``step.py``
  vmapped path); raw leaves are averaged over the pods in pod order and
  their residuals zeroed.  The loss is the mean of the pod losses.

``TrainState.resid`` holds the error-feedback residuals on the compressed
path: f32, keyed by parameter name, each ``(1, *shape)``, this rank's
slice of the reference's ``(n_pods, ...)`` leaf, sharded over ``pod``.

What raises ``NotImplementedError``: a mesh whose ``model`` axis is above 1
(tensor parallelism, the next slice); the moe family where a rank holds
part of what the reference computes its capacity and load-balance loss
over: on the plain path whenever the batch is split over more than one
rank, on the compressed path whenever a pod has more than one ``data``
rank (moe with one ``data`` rank a pod is the reference's per-pod vmap).
``rc.fsdp`` on a ``data`` axis above 1 replicates the parameters and
moments on every rank: the numbers are the reference's up to reduction
order, the memory a rank holds is not its ZeRO-3 share.

The step updates the parameters, moments and residuals in place (the
reference's jitted step donates its state): the returned ``TrainState``
holds the same tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import Attrs, Stacked, flatten, leaf_shape, map_tree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import collectives, sharding as shd
from repro_torch.models.encdec import DecLayer, EncDecParams, EncLayer
from repro_torch.models.model_zoo import ModelApi, TensorSpec
from repro_torch.models.transformer import LayerParams
from repro_torch.optim import adamw

F32 = torch.float32
#: f32 values a bucket of the plain path's gradient all-reduce
BUCKET = 1 << 26


class TrainState(NamedTuple):
    params: Any              # the model's parameters (an nn.Module)
    opt: adamw.AdamState     # moments keyed by parameter name
    resid: Optional[Dict[str, torch.Tensor]]  # error feedback, (pods, *shape)
    step: torch.Tensor       # int32 scalar on the parameters' device


def adam_config(rc: RunConfig, total_steps: int = 10_000) -> adamw.AdamConfig:
    return adamw.AdamConfig(lr=rc.lr, weight_decay=rc.weight_decay,
                            grad_clip=rc.grad_clip, dtype=rc.opt_dtype,
                            total_steps=total_steps)


def _n_pods(mesh) -> int:
    return mesh.shape["pod"] if (mesh is not None and "pod" in mesh.axis_names) else 1


def _compress(rc: RunConfig, mesh) -> bool:
    return bool(rc.grad_compress_bits) and _n_pods(mesh) > 1


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch is split over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def init_state(api: ModelApi, rc: RunConfig, seed: int = 0,
               mesh=None) -> TrainState:
    """Fresh parameters from ``api.init(seed)``, zero AdamW moments and, on
    the compressed path, zero residuals (this rank's pod), on the device
    ``api`` was made for (``model_zoo.get_api``, the card by default)."""
    params = api.init(seed)
    named = dict(params.named_parameters())
    opt = adamw.init(named, adam_config(rc))
    device = next(iter(named.values())).device
    resid = collectives.init_residuals(named) if _compress(rc, mesh) else None
    return TrainState(params=params, opt=opt, resid=resid,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def abstract_state(api: ModelApi, rc: RunConfig, mesh=None) -> Attrs:
    """Shapes and dtypes (``TensorSpec``) of the state in the reference's
    ``TrainState`` tree, the residuals at all pods, allocating nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        state = init_state(api, rc, 0)
        named = dict(state.params.named_parameters())
        resid = (collectives.init_residuals(named, _n_pods(mesh))
                 if _compress(rc, mesh) else None)
        tree = checkpoint_tree(state, resid)
    return map_tree(lambda t: TensorSpec(leaf_shape(t), (
        t.parts[0] if isinstance(t, Stacked) else t).dtype), tree)


def state_logical_specs(api: ModelApi, rc: RunConfig, mesh=None) -> Attrs:
    """Logical axis names for the whole state, the reference's tree."""
    pspecs = api.param_specs()
    resid = None
    if _compress(rc, mesh):
        # residuals are pod-local: a leading pod dim, then the param's spec
        resid = map_tree(lambda t: ("pod_dim",) + t, pspecs)
    return Attrs(params=pspecs, opt=Attrs(mu=pspecs, nu=pspecs, count=()),
                 resid=resid, step=())


def resolve_state_specs(logical: Attrs, abstract: Attrs) -> Attrs:
    """Resolve logical specs to ``PartitionSpec``s ('pod_dim' -> 'pod')."""
    r = shd.get_rules()

    def one(log, shp):
        if r is None:
            return shd.P()
        shape = leaf_shape(shp)
        if log and log[0] == "pod_dim":
            return shd.P("pod", *r.spec(shape[1:], log[1:]))
        return r.spec(shape, log)

    return map_tree(one, logical, abstract)


def _average(tensors: List[torch.Tensor], group, n: int) -> None:
    """Each tensor replaced by its mean over ``group`` (``n`` ranks), summed
    in f32 by all-reduce in buckets of ``BUCKET`` values, in place."""
    div = torch.full((), float(n), dtype=F32, device=tensors[0].device)
    i = 0
    while i < len(tensors):
        j, size = i, 0
        while j < len(tensors) and (j == i or size + tensors[j].numel() <= BUCKET):
            size += tensors[j].numel()
            j += 1
        buf = torch.cat([t.reshape(-1).to(F32) for t in tensors[i:j]])
        dist.all_reduce(buf, group=group)
        buf = buf / div
        at = 0
        for t in tensors[i:j]:
            t.copy_(buf[at:at + t.numel()].view(t.shape))
            at += t.numel()
        i = j


def _by_name(names_tree: Attrs, tree: Attrs) -> Iterator[Tuple[str, torch.Tensor]]:
    """(parameter name, tensor) over two reference trees of one structure,
    the first holding names."""
    for (_, ns), (_, ts) in zip(flatten(names_tree), flatten(tree)):
        if isinstance(ns, Stacked):
            yield from zip(ns.parts, ts.parts)
        else:
            yield ns, ts


MOE_SLICE = ("the MoE capacity and load-balance loss are functions of the "
             "whole batch; a rank holding part of it needs their collective, "
             "which comes with the distributed slice that brings the 'model' "
             "axis, not ported yet")


def _check_moe(cfg: ModelConfig, mesh, compress: bool) -> None:
    if cfg.family != "moe" or mesh is None:
        return
    if compress and "data" in mesh.axis_names and mesh.shape["data"] > 1:
        raise NotImplementedError(
            f"{cfg.name} on the compressed path with {mesh.shape['data']} "
            f"data ranks a pod: {MOE_SLICE}")
    ranks = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    if not compress and ranks > 1:
        raise NotImplementedError(
            f"{cfg.name} with its batch split over {ranks} ranks: {MOE_SLICE}")


def make_train_step(api: ModelApi, cfg: ModelConfig, rc: RunConfig, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds this rank's rows (``device_batch(..., mesh=mesh)``).
    ``metrics`` holds the f32 ``loss`` (the mean over the global batch) and
    the gradients' ``grad_norm`` (after the exchange, before clipping), as
    0-dim tensors on the device.
    """
    shd.check_model_axis(mesh)
    compress = _compress(rc, mesh)
    _check_moe(cfg, mesh, compress)
    acfg = adam_config(rc)
    bits, n_pods = rc.grad_compress_bits, _n_pods(mesh)

    def reduce(grads: Dict[str, torch.Tensor], loss: torch.Tensor, axes) -> None:
        n = mesh.size(axes)
        if n > 1:
            _average([loss, *grads.values()], mesh.get_group(axes), n)

    def exchange(params, grads, loss, resid):
        """The compressed path: (grads, loss) averaged over the pods."""
        if "data" in mesh.axis_names:
            reduce(grads, loss, "data")
        group = mesh.get_group("pod")
        names = reference_tree({n: n for n in grads})
        planes, scales, raw, _ = collectives.quantize_tree(
            reference_tree(grads), reference_tree(
                {n: r[0] for n, r in resid.items()}), bits, group)
        for p in params.values():
            p.grad = None         # the exchange needs the parameters' shapes only
        grads.clear()
        planes, scales = collectives.exchange(planes, scales, group)
        mean = collectives.dequant_mean_tree(reference_tree(params), planes,
                                             scales, raw, bits, n_pods)
        _average([loss], group, n_pods)
        return dict(_by_name(names, mean)), loss

    def train_step(state: TrainState, batch) -> tuple:
        params = dict(state.params.named_parameters())
        for p in params.values():
            p.grad = None
        loss = api.loss_fn(state.params, batch)
        loss.backward()
        loss = loss.detach().to(F32)
        grads = {n: p.grad for n, p in params.items()}
        if compress:
            grads, loss = exchange(params, grads, loss, state.resid)
        elif mesh is not None:
            reduce(grads, loss, batch_axes(mesh))
        gnorm = adamw.global_norm(grads.values())
        _, opt = adamw.update(grads, state.opt, params, acfg, gnorm)
        for p in params.values():
            p.grad = None          # free the gradients before the next step
        metrics = {"loss": loss, "grad_norm": gnorm}
        return TrainState(params=state.params, opt=opt, resid=state.resid,
                          step=state.step + 1), metrics

    return train_step


def gather_residuals(resid: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Every pod's residuals, ``(n_pods, *shape)`` by name, on every rank
    (a collective over ``pod``; not counted as exchange bytes)."""
    group = mesh.get_group("pod")
    return {n: collectives.all_gather(r[0], group) for n, r in resid.items()}


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


def reference_tree(named: Mapping[str, torch.Tensor], axis: int = 0) -> Attrs:
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
    is none in the reference's tree.  ``axis`` is the ``Stacked`` leaves'
    layer axis (1 for residuals, whose leading axis is the pods').
    """
    tree, stacks = Attrs(), {}
    for name, t in named.items():
        path = name.split(".")
        if path[0] not in STACKED:
            _put(tree, path, t)
            continue
        key = (path[0], *path[2:])
        if key not in stacks:
            stacks[key] = Stacked([], axis)
            _put(tree, list(key), stacks[key])
        stacks[key].parts.append(t)
    for node, fields in STACKED.items():
        if node in tree:
            tree[node] = _ordered(tree[node], fields)
    return _ordered(tree, TOP_FIELDS)


def checkpoint_tree(state: TrainState,
                    resid: Optional[Mapping[str, torch.Tensor]] = None) -> Attrs:
    """The state as the reference's ``TrainState`` tree, for
    ``CheckpointManager.save`` and ``restore`` (leaf paths such as
    ``.params.layers.attn.wq``, ``.params.dec_layers.cross_attn.wq``,
    ``.opt.count`` and ``.resid.layers.attn.wq``).

    ``resid`` (default ``state.resid``) are residuals of every pod,
    ``(n_pods, *shape)`` by name (``gather_residuals`` on a mesh); a
    stacked leaf is ``(n_pods, n_layers, ...)``, its parts stacked on
    axis 1, as the reference's.
    """
    resid = state.resid if resid is None else resid
    return Attrs(params=reference_tree(dict(state.params.named_parameters())),
                 opt=Attrs(mu=reference_tree(state.opt.mu),
                           nu=reference_tree(state.opt.nu),
                           count=state.opt.count),
                 resid=None if resid is None else reference_tree(resid, axis=1),
                 step=state.step)
