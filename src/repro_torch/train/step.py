"""Train-step factory: loss -> grads -> (optionally compressed) exchange -> AdamW.

Port of ``repro.train.step``: ``loss.backward()`` for the reference's
``jax.value_and_grad``.  Without a mesh the step runs on one device.  On a
mesh of torch.distributed ranks (``launch.mesh``) the step installs the
sharding rules (``distributed.sharding``) and places every tensor where the
reference's specs put it, issuing each collective by hand:

* ``pod`` and ``data`` are data parallelism: each rank runs the model on
  its rows of the global batch (``data.pipeline.device_batch``), in the
  order the reference's ``P(("pod", "data"))`` lays them out; the ranks of
  one ``(pod, data)`` coordinate along ``model`` take the same rows;
* ``fsdp`` is ZeRO-3 over ``data``: a rank holds its block of each leaf the
  rule shards (parameters, moments, residuals; ``init_state``,
  ``param_partition``), a layer all-gathers its blocks before use (again
  under remat), and the gather's backward reduce-scatters the gradient;
* ``model`` is tensor and sequence parallelism for every family
  (``models.layers``, ``models.ssm``, ``models.transformer``,
  ``models.encdec``).

Each rank differentiates its own copy of the loss and every collective's
backward is its adjoint (``distributed.collectives``), so each gradient
block is that of the sum of the ranks' losses once a leaf held whole on
several ranks has its copies' gradients summed over those axes (a norm, a
router, an indivisible vocabulary or ``in_proj``, the SSD's per-head
``a_log``, ``dt_bias`` and ``d_skip``; the batch axes for every leaf not
sharded over ``data``).  Dividing by the number of ranks whose losses were
summed gives the reference's mean.  Two gradient paths, as in the
reference:

* plain (``rc.grad_compress_bits`` 0, or one pod): the gradients are
  averaged in f32 over every rank (pods included), which is what GSPMD's
  gradient reduction computes;
* compressed (bits > 0 on several pods): each pod's gradients are those of
  its own mean loss (the rules exclude ``pod``, as the reference's per-pod
  vmap does, so the MoE's capacity is the pod's); each compressible leaf
  ``g`` (decided on the whole leaf, as the reference decides) then goes
  ``x = g + resid``, ``distributed.collectives``' quantize and
  bitplane-pack on this rank's block, ``resid = x - dequant(quant(x))``,
  the exchange of the packed planes and scales between the pods, and the
  pods' dequantized gradients summed in pod order over ``n_pods`` and cast
  to the parameter's dtype (the reference's order, its ``step.py``
  vmapped path); raw leaves are averaged over the pods in pod order and
  their residuals zeroed.  The loss is the mean of the pod losses.  The
  codec's scale is per block of 32 values along the last axis, so a block
  held by one rank quantizes alone wherever its last axis is a multiple
  of 32 (it is, for every leaf of the configs at tp <= 8); a leaf whose
  block is not (the smoke configs' ``wk`` at tp = 4) is exchanged on its
  whole rows, gathered over the axes that shard its last axis.

``TrainState.resid`` holds the error-feedback residuals on the compressed
path: f32, keyed by parameter name, each ``(1, *block)``, this rank's
block of the reference's ``(n_pods, ...)`` leaf.

The step updates the parameters, moments and residuals in place (the
reference's jitted step donates its state): the returned ``TrainState``
holds the same tensors.
"""
from __future__ import annotations

import functools
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


def rules_for(rc: RunConfig, mesh, compress: bool = False) -> Optional[shd.Rules]:
    """The sharding rules of ``rc`` on ``mesh`` (``None`` without one);
    the compressed path excludes ``pod``, as the reference's step does."""
    if mesh is None:
        return None
    return shd.Rules(mesh=mesh, seq_shard=rc.seq_shard, fsdp=rc.fsdp,
                     shard_vocab=rc.shard_vocab,
                     exclude=frozenset({"pod"}) if compress else frozenset())


def full_shapes(api: ModelApi) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's whole shape, by the port's name (fake tensors:
    nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return {n: tuple(p.shape) for n, p in api.init(0).named_parameters()}


def param_partition(api: ModelApi, rc: RunConfig, mesh) -> Dict[str, shd.P]:
    """Each parameter's resolved spec on ``mesh``, by the port's name (a
    per-layer part of a stacked leaf takes the leaf's spec without its
    layer axis)."""
    shapes = full_shapes(api)
    rules = rules_for(rc, mesh)
    out = {}
    names = reference_tree({n: n for n in shapes})
    for (_, ns), (_, log) in zip(flatten(names), flatten(api.param_specs())):
        for n in (ns.parts if isinstance(ns, Stacked) else [ns]):
            out[n] = rules.spec(shapes[n], log[1:] if isinstance(ns, Stacked) else log)
    return out


def init_state(api: ModelApi, rc: RunConfig, seed: int = 0,
               mesh=None) -> TrainState:
    """Fresh parameters from ``api.init(seed)``, zero AdamW moments and, on
    the compressed path, zero residuals (this rank's pod), on the device
    ``api`` was made for (``model_zoo.get_api``, the card by default).  On
    a mesh the whole model is built from the seed and each rank keeps its
    blocks (``param_partition``), so that a sharded model starts from the
    single device's weights."""
    params = api.init(seed)
    if mesh is not None:
        specs = param_partition(api, rc, mesh)
        for n, p in params.named_parameters():
            shd.shard_parameter(p, specs[n], mesh)
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
    """Each tensor replaced by its sum over ``group`` (none: this rank's
    own) divided by ``n``, in f32, in buckets of ``BUCKET`` values, in
    place."""
    div = torch.full((), float(n), dtype=F32, device=tensors[0].device)
    if group is None:
        for t in tensors:
            t.div_(div)
        return
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


def _held_whole(spec, mesh, axes) -> Tuple[str, ...]:
    """The axes among ``axes`` (above 1) along which a leaf of ``spec`` is
    the same block on every rank: its gradient copies are summed over
    them.  ``data`` is left out where the leaf is sharded over it (the
    gather's backward summed it)."""
    sharded = {a for part in spec for a in shd._axes(part)}
    return tuple(a for a in axes if mesh.shape[a] > 1 and a not in sharded)


def _by_name(names_tree: Attrs, tree: Attrs) -> Iterator[Tuple[str, torch.Tensor]]:
    """(parameter name, tensor) over two reference trees of one structure,
    the first holding names."""
    for (_, ns), (_, ts) in zip(flatten(names_tree), flatten(tree)):
        if isinstance(ns, Stacked):
            yield from zip(ns.parts, ts.parts)
        else:
            yield ns, ts


def _check_batch(cfg: ModelConfig, rc: RunConfig, mesh) -> None:
    """The MoE's capacity counts the tokens of every batch rank: each must
    hold its own rows."""
    if cfg.family == "moe" and mesh is not None:
        ranks = math.prod(mesh.shape[a] for a in batch_axes(mesh))
        if rc.global_batch % ranks:
            raise ValueError(f"{cfg.name}: a global batch of {rc.global_batch} "
                             f"does not split over {ranks} batch ranks")


class _Plan(NamedTuple):
    """What the step does with each leaf on a mesh."""
    sums: Dict[str, Tuple[str, ...]]   # axes its gradient copies are summed over
    norm: Dict[str, Any]               # group its squares are summed over
    ranks: int                         # ranks whose losses are summed
    whole: Attrs                       # the reference's whole leaves' shapes
    #: compressible leaves whose block cuts the codec's 32-value blocks: the
    #: axes their last dimension is sharded over (the exchange gathers it)
    rows: Dict[str, Tuple[str, ...]]


def _plan(api: ModelApi, rc: RunConfig, mesh, compress: bool) -> _Plan:
    specs = param_partition(api, rc, mesh)
    shapes = full_shapes(api)
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names
                 and not (a == "pod" and compress))
    sums, norm = {}, {}
    for n, spec in specs.items():
        sums[n] = _held_whole(spec, mesh, axes)
        split = tuple(a for a in ("data", "model") if a in mesh.axis_names
                      and mesh.shape[a] > 1 and a not in sums[n])
        norm[n] = mesh.get_group(split) if split else None
    names = reference_tree({n: n for n in shapes})
    whole = map_tree(lambda leaf: TensorSpec(
        (len(leaf.parts), *shapes[leaf.parts[0]]) if isinstance(leaf, Stacked)
        else shapes[leaf], None), names)
    rows = {}
    for (_, ns), (_, w) in zip(flatten(names), flatten(whole)):
        for n in (ns.parts if isinstance(ns, Stacked) else [ns]):
            last = shd._axes(specs[n][-1])
            if (collectives.compressible(w) and last
                    and shapes[n][-1] // mesh.size(last) % collectives.BLOCK):
                rows[n] = last
    return _Plan(sums, norm, mesh.size(axes), whole, rows)


def make_train_step(api: ModelApi, cfg: ModelConfig, rc: RunConfig, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds this rank's rows (``device_batch(..., mesh=mesh)``) and
    ``state`` this rank's blocks (``init_state(..., mesh)``).  ``metrics``
    holds the f32 ``loss`` (the mean over the global batch) and the
    gradients' ``grad_norm`` (after the exchange, before clipping, over
    every block), as 0-dim tensors on the device.
    """
    compress = _compress(rc, mesh)
    _check_batch(cfg, rc, mesh)
    acfg = adam_config(rc)
    bits, n_pods = rc.grad_compress_bits, _n_pods(mesh)
    rules = rules_for(rc, mesh, compress)
    plan: List[_Plan] = []         # made at the first step (process groups)

    def reduce(grads: Dict[str, torch.Tensor], loss: torch.Tensor) -> None:
        """The gradients summed over the axes each is held whole on and
        divided by the ranks whose losses were summed; the loss averaged
        over the batch ranks (the pod's on the compressed path)."""
        classes: Dict[tuple, list] = {}
        for name, g in grads.items():
            classes.setdefault(plan[0].sums[name], []).append(g)
        for axes, ts in classes.items():
            if axes or plan[0].ranks > 1:
                _average(ts, mesh.get_group(axes) if axes else None,
                         plan[0].ranks)
        laxes = tuple(a for a in batch_axes(mesh) if not (a == "pod" and compress))
        if laxes and mesh.size(laxes) > 1:
            _average([loss], mesh.get_group(laxes), mesh.size(laxes))

    def exchange(params, grads, loss, resid):
        """The compressed path: (grads, loss) averaged over the pods.

        A leaf in ``plan.rows`` (its block cuts the codec's 32-value blocks
        along the last axis) is exchanged on its whole rows: its gradient
        and residual are gathered over the axes that shard the last axis,
        and this rank keeps its block of the new residual and of the mean.
        """
        group = mesh.get_group("pod")
        names = reference_tree({n: n for n in grads})
        rows = plan[0].rows
        res = {n: r[0] for n, r in resid.items()}
        like = dict(params)
        for n, axes in rows.items():
            g = mesh.get_group(axes)
            grads[n], res[n] = (torch.cat(collectives.all_gather(t.contiguous(), g)
                                          .unbind(0), dim=-1)
                                for t in (grads[n], res[n]))
            like[n] = torch.empty(grads[n].shape, dtype=params[n].dtype,
                                  device="meta")
        planes, scales, raw, _ = collectives.quantize_tree(
            reference_tree(grads), reference_tree(res), bits, group,
            plan[0].whole)
        for n, axes in rows.items():
            resid[n][0].copy_(_own_columns(res[n], axes))
        for p in params.values():
            p.grad = None         # the exchange needs the parameters' shapes only
        grads.clear()
        planes, scales = collectives.exchange(planes, scales, group)
        mean = dict(_by_name(names, collectives.dequant_mean_tree(
            reference_tree(like), planes, scales, raw, bits, n_pods)))
        for n, axes in rows.items():
            mean[n] = _own_columns(mean[n], axes)
        _average([loss], group, n_pods)
        return mean, loss

    def _own_columns(t: torch.Tensor, axes) -> torch.Tensor:
        size = t.shape[-1] // mesh.size(axes)
        return t.narrow(-1, mesh.index(axes) * size, size)

    def train_step(state: TrainState, batch) -> tuple:
        params = dict(state.params.named_parameters())
        if mesh is not None and not plan:
            plan.append(_plan(api, rc, mesh, compress))
        for p in params.values():
            p.grad = None
        with shd.use_rules(rules):
            loss = api.loss_fn(state.params, batch)
            loss.backward()
        loss = loss.detach().to(F32)
        grads = {n: p.grad for n, p in params.items()}
        if mesh is not None:
            reduce(grads, loss)
        if compress:
            grads, loss = exchange(params, grads, loss, state.resid)
        groups = None if mesh is None else [plan[0].norm[n] for n in grads]
        gnorm = adamw.global_norm(grads.values(), groups)
        _, opt = adamw.update(grads, state.opt, params, acfg, gnorm)
        for p in params.values():
            p.grad = None          # free the gradients before the next step
        metrics = {"loss": loss, "grad_norm": gnorm}
        return TrainState(params=state.params, opt=opt, resid=state.resid,
                          step=state.step + 1), metrics

    return train_step


def whole_tree(state: TrainState, api: ModelApi, rc: RunConfig,
               mesh) -> Optional[Attrs]:
    """Rank 0: ``checkpoint_tree`` of the whole state on the host, for it
    to write in the reference's layout, each leaf gathered to rank 0 from
    the ranks' blocks (over ``data`` and ``model``, the residuals over
    ``pod``), one leaf at a time; every other rank: ``None``.  A
    collective: every rank takes part."""
    specs = param_partition(api, rc, mesh)

    def whole(named, lead=()):
        out = {}
        for n, t in named.items():
            blocks = collectives.gather_to_first(t.detach())
            out[n] = None if blocks is None else \
                shd.assemble(blocks, shd.P(*lead, *specs[n]), mesh)
        return out

    params = whole(dict(state.params.named_parameters()))
    mu, nu = whole(state.opt.mu), whole(state.opt.nu)
    resid = None if state.resid is None else whole(state.resid, ("pod",))
    if mesh.rank != 0:
        return None
    return Attrs(params=reference_tree(params),
                 opt=Attrs(mu=reference_tree(mu), nu=reference_tree(nu),
                           count=state.opt.count),
                 resid=None if resid is None else reference_tree(resid, axis=1),
                 step=state.step)


def checkpoint_blocks(api: ModelApi, rc: RunConfig, mesh) -> Dict[str, tuple]:
    """``CheckpointManager.restore``'s ``blocks`` for this rank's state on
    ``mesh`` (``init_state(..., mesh)``): each leaf path of its
    ``checkpoint_tree`` -> (the whole leaf's shape, the cut of a whole part
    to this rank's block; the residuals' at this rank's pod).  The restore
    half of the elastic re-mesh: every rank reads the whole leaves on the
    host and copies in only its blocks, on whatever mesh it is on."""
    specs = param_partition(api, rc, mesh)
    names = {n: n for n in specs}
    tree = Attrs(params=reference_tree(names),
                 opt=Attrs(mu=reference_tree(names), nu=reference_tree(names)),
                 resid=reference_tree(names, axis=1) if _compress(rc, mesh) else None)
    whole = dict(flatten(abstract_state(api, rc, mesh)))
    out = {}
    for path, leaf in flatten(tree):
        n = leaf.parts[0] if isinstance(leaf, Stacked) else leaf
        lead = ("pod",) if path.startswith(".resid") else ()
        out[path] = (whole[path].shape, functools.partial(
            shd.local_slice, spec=shd.P(*lead, *specs[n]), mesh=mesh))
    return out


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
    ``(n_pods, *shape)`` by name; a stacked leaf is ``(n_pods, n_layers, ...)``, its parts stacked on
    axis 1, as the reference's.
    """
    resid = state.resid if resid is None else resid
    return Attrs(params=reference_tree(dict(state.params.named_parameters())),
                 opt=Attrs(mu=reference_tree(state.opt.mu),
                           nu=reference_tree(state.opt.nu),
                           count=state.opt.count),
                 resid=None if resid is None else reference_tree(resid, axis=1),
                 step=state.step)
