"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Models name the axes of their tensors *logically*; the rules resolve those
names to mesh axes for the active mesh and run config, exactly as the
reference does:

  batch     -> ('pod', 'data')   data parallelism (pod axis included if present)
  seq       -> 'model'           sequence/context parallelism for activations
  heads     -> 'model'           attention-head tensor parallelism
  ff        -> 'model'           MLP hidden tensor parallelism
  vocab     -> 'model'           embedding/unembedding vocab sharding
  cache_seq -> 'model'           decode KV-cache length sharding
  fsdp      -> 'data'            ZeRO-3 style parameter/optimizer sharding
  experts   -> None

A rule applies only where the dimension's size divides the mesh axis's
size; otherwise the dimension is replicated.  ``Rules``, ``resolve`` and
``spec`` are plain Python over axis names and sizes, so they resolve
against an ``AbstractMesh`` as well as a ``Mesh`` of ranks.

What the port does with a resolved spec.  The reference only names the
axes and GSPMD inserts the collectives; here each tensor is placed where
its spec puts it and each collective is issued by hand (Megatron-style,
``distributed.collectives``' differentiable gather, reduce-scatter and
all-reduce), so that every rank's numbers are the single device's up to
the order of reductions:

* ``pod`` and ``data`` split the batch (``train.step``): each rank holds its
  rows, as the reference's constraint places them;
* ``fsdp`` (ZeRO-3): a parameter keeps its block over ``data``
  (``shard_parameter``), and a layer reads it through ``gathered``, which
  all-gathers it on first use (again in a remat recompute);
* ``model``: every family runs tensor-parallel over heads, ff, vocab and
  the SSD's ``tp`` columns, with the residual stream split over the
  sequence between layers where ``seq_shard`` holds and tp divides S
  (``seq_split``, ``act``), and each contraction over a sharded dimension
  summed by ``tp_out_proj`` / ``reduce_partial``; a parameter or an
  activation whose block does not line up with heads (mamba2's packed
  ``in_proj``, the conv, a head cut mid-way) is gathered whole over
  ``model`` with ``act`` (its backward sums the copies' gradients and keeps
  the block), and a norm over a sharded dimension all-reduces its partial
  squares over ``model_group()``.

The reference's ``collectives.shard_map``, a shim over jax's API drift
between ``jax.shard_map`` and ``jax.experimental.shard_map``, has no
counterpart: torch.distributed has one API.

No global state is touched by importing this module; the caller installs
rules with ``use_rules`` / ``set_rules``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Stacked, flatten, leaf_shape, map_tree

class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or ``None``) a dimension:
    the port's ``jax.sharding.PartitionSpec``, which also holds a
    one-name tuple as the name."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Optional[object] = None
    seq_shard: bool = True
    fsdp: bool = True
    shard_vocab: bool = True
    #: axes handled manually (the exchange's 'pod') -- excluded from
    #: resolution
    exclude: frozenset = frozenset()

    def axis_size(self, name: str) -> int:
        if self.mesh is None or name not in self.mesh.axis_names:
            return 1
        return self.mesh.shape[name]

    def resolve(self, logical: Optional[str], dim: int):
        """Logical name + dim size -> mesh axis (or None)."""
        if self.mesh is None or logical is None:
            return None
        names = tuple(a for a in self.mesh.axis_names if a not in self.exclude)
        if logical == "batch":
            axes = tuple(a for a in ("pod", "data") if a in names)
            total = int(np.prod([self.mesh.shape[a] for a in axes])) if axes else 1
            return axes if axes and dim % total == 0 else None
        if logical == "fsdp":
            if not self.fsdp:
                return None
            return "data" if "data" in names and dim % self.axis_size("data") == 0 else None
        if logical == "seq":
            if not self.seq_shard:
                return None
            return "model" if dim % self.axis_size("model") == 0 else None
        if logical == "vocab" and not self.shard_vocab:
            return None
        if logical in ("heads", "ff", "vocab", "cache_seq", "tp"):
            return "model" if dim % self.axis_size("model") == 0 else None
        if logical == "experts":
            return None
        raise KeyError(f"unknown logical axis {logical!r}")

    def spec(self, shape: Sequence[int], logical: Sequence[Optional[str]]) -> P:
        if len(shape) != len(logical):
            raise ValueError(f"shape {tuple(shape)} against logical axes "
                             f"{tuple(logical)}")
        return P(*(self.resolve(l, d) for l, d in zip(logical, shape)))


_local = threading.local()


def set_rules(rules: Optional[Rules]) -> None:
    _local.rules = rules


def get_rules() -> Optional[Rules]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = get_rules()
    set_rules(rules)
    try:
        yield rules
    finally:
        set_rules(prev)


def _tp(r) -> int:
    """The size of the ``model`` axis the rules act on (1 without one)."""
    if r is None or r.mesh is None or "model" in r.exclude:
        return 1
    return r.axis_size("model")


def model_group():
    """The process group of this rank's ``model`` axis (``None`` where it
    is 1)."""
    r = get_rules()
    return r.mesh.get_group("model") if _tp(r) > 1 else None


def tp_block(logical: str, full: int):
    """``(start, size)`` of this rank's block of a dimension of ``full``
    values named ``logical``, where the rules shard it over a ``model``
    axis above 1; ``None`` where it is whole on every rank."""
    r = get_rules()
    tp = _tp(r)
    if tp == 1 or r.resolve(logical, full) != "model":
        return None
    size = full // tp
    return r.mesh.coords["model"] * size, size


def batch_block(B: int):
    """``(start, size)`` of this rank's rows of a batch of ``B`` where the
    rules split it (the ``batch`` rule: ``pod`` and ``data``, where their
    product divides B and is above 1); ``None`` where every rank holds all
    B rows."""
    r = get_rules()
    if r is None or r.mesh is None:
        return None
    axes = r.resolve("batch", B)
    n = r.mesh.size(axes) if axes else 1
    if n == 1:
        return None
    return r.mesh.index(axes) * (B // n), B // n


def rank_rows(x, B: int):
    """``x``, whose first dimension is a batch of ``B`` rows or already
    this rank's rows of it, as this rank's rows (``batch_block``)."""
    block = batch_block(B)
    return x if block is None or x.shape[0] != B else x.narrow(0, *block)


def whole_batch(x, B: int):
    """``x``, this rank's rows of a batch of ``B`` along its first
    dimension, gathered whole over the batch axes (``batch_block``); ``x``
    itself where the batch is not split."""
    if batch_block(B) is None:
        return x
    from repro_torch.distributed import collectives
    r = get_rules()
    return collectives.gather(x, 0, r.mesh.get_group(r.resolve("batch", B)))


def seq_split(S: int) -> bool:
    """Whether the residual stream of a sequence of ``S`` holds this rank's
    ``S / tp`` block of positions between layers (``("batch", "seq",
    None)``)."""
    return tp_block("seq", S) is not None


def act(x, *logical: Optional[str], src: Sequence[Optional[str]] = (),
        name: Optional[str] = None):
    """``x`` moved from the placement it was made in (``src``, logical
    axes, default: whole over ``model``) to its logical placement.

    Only the ``model`` axis moves: the batch dimension already holds this
    rank's rows (data parallelism).  A dimension that ``src`` shards over
    ``model`` and ``logical`` does not is gathered (its backward sums and
    keeps the block); one that ``logical`` shards and ``src`` does not is
    cut to this rank's block.  Without rules, a mesh or a ``model`` axis
    above 1, ``x`` itself.  ``name`` labels a gather for the
    ``save_collectives`` remat policy.
    """
    r = get_rules()
    if r is None or r.mesh is None:
        return x
    if len(logical) != x.dim() or (src and len(src) != x.dim()):
        raise ValueError(f"shape {tuple(x.shape)} against logical axes "
                         f"{logical} from {tuple(src)}")
    tp = _tp(r)
    if tp == 1:
        return x
    from repro_torch.distributed import collectives
    src = tuple(src) or (None,) * x.dim()
    for dim, (want, have) in enumerate(zip(logical, src)):
        n = x.shape[dim]
        if have is not None and r.resolve(have, n * tp) == "model":
            if r.resolve(want, n * tp) != "model":
                x = collectives.gather(x, dim, model_group(), name)
        elif want is not None and r.resolve(want, n) == "model":
            size = n // tp
            x = x.narrow(dim, r.mesh.coords["model"] * size, size)
    return x


def reduce_partial(partial, seq_dim: int = 1, name: Optional[str] = None):
    """A product whose sum over ``model`` is the activation (each rank's
    share of a contraction over a sharded dimension), in f32: summed over
    ``model`` and, where ``seq_split`` holds for its ``seq_dim``, left as
    this rank's block of the sequence (a reduce-scatter), else whole on
    every rank (an all-reduce)."""
    from repro_torch.distributed import collectives
    group = model_group()
    if seq_split(partial.shape[seq_dim]):
        return collectives.reduce_scatter(partial, seq_dim, group, name)
    return collectives.all_reduce(partial, group, name)


def tp_out_proj(h, w):
    """The reference's hand-scheduled tensor-parallel out-projection.

    ``h``: (B, S, F) activation holding this rank's block of F (heads * hd
    or ff), ``w``: this rank's (F, d) rows.  The partial product is taken in
    f32, summed over ``model`` by a reduce-scatter onto the sequence (with
    ``seq_shard`` and S divisible by tp) or an all-reduce, and cast to h's
    dtype.  Returns ``None`` where it does not apply, as the reference does
    (no rules, no mesh, ``model`` excluded, tp = 1, not a (B, S, F)
    activation): the caller runs the plain matmul.
    """
    if _tp(get_rules()) <= 1 or h.dim() != 3:
        return None
    if w.shape[0] != h.shape[-1]:
        raise ValueError(f"h {tuple(h.shape)} against w {tuple(w.shape)}")
    return reduce_partial(mm_f32(h, w), name="proj_out").to(h.dtype)


def mm_f32(a, w):
    """``a @ w`` with an f32 result (the reference's
    ``preferred_element_type=f32``): ``w`` (K, N) against ``a`` (..., K),
    or a batch of them, (E, K, N) against (E, M, K).  Operands that are not
    f32 stay in their dtype (``_MatmulF32``)."""
    if a.dtype == torch.float32:
        return a @ w
    return _MatmulF32.apply(a, w)


class _MatmulF32(torch.autograd.Function):
    """A product of bf16 / f16 operands with f32 accumulation and an f32
    result: on the card one tensor-core GEMM (``torch.mm`` / ``torch.bmm``
    with ``out_dtype``), on the CPU the same products in f32 (a product of
    two bf16 values is exact in f32).  The backward takes the f32 gradient
    in the operands' dtype, as a plain matmul's backward sees it: exact
    where it is a cast-back bf16 gradient gathered over ``model`` (the
    reduce-scatter's adjoint), rounded where it is a sum."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1]) if w.dim() == 2 else a
        if a.is_cuda:
            mm = torch.mm if w.dim() == 2 else torch.bmm
            out = mm(a2, w, out_dtype=torch.float32)
        else:
            out = a2.float() @ w.float()
        return out.reshape(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        a2, g2 = a, g.to(a.dtype)
        if w.dim() == 2:
            a2, g2 = a.reshape(-1, a.shape[-1]), g2.reshape(-1, g.shape[-1])
        ga = (g2 @ w.transpose(-1, -2)).reshape(a.shape)
        return ga, a2.transpose(-1, -2) @ g2


# ---------------------------------------------------------------------------
# Parameters: a rank's blocks, and ZeRO-3's gather over ``data``
# ---------------------------------------------------------------------------

def _axes(part) -> tuple:
    return () if part is None else (part,) if isinstance(part, str) else tuple(part)


def local_slice(full, spec, mesh):
    """This rank's block of ``full`` under the resolved ``spec``: along each
    sharded dimension the contiguous block at the rank's row-major index
    over that dimension's axes, as a ``NamedSharding`` lays it out."""
    out = full
    for dim, part in enumerate(spec):
        axes = _axes(part)
        if not axes:
            continue
        n = mesh.size(axes)
        size = full.shape[dim] // n
        out = out.narrow(dim, mesh.index(axes) * size, size)
    return out


def assemble(blocks, spec, mesh):
    """The whole tensor (on the host) from every rank's block under the
    resolved ``spec``, ``blocks`` in rank order: ``local_slice``'s
    inverse.  Ranks that hold the same block write the same values."""
    sizes = [mesh.shape[a] for a in mesh.axis_names]
    first = blocks[0]
    out = torch.empty([d * mesh.size(_axes(part)) if _axes(part) else d
                       for d, part in zip(first.shape, spec)]
                      + list(first.shape[len(spec):]), dtype=first.dtype)
    for rank, block in enumerate(blocks):
        coords = dict(zip(mesh.axis_names, np.unravel_index(rank, sizes)))
        view = out
        for dim, part in enumerate(spec):
            axes = _axes(part)
            if axes:
                at = np.ravel_multi_index([coords[a] for a in axes],
                                          [mesh.shape[a] for a in axes])
                view = view.narrow(dim, int(at) * block.shape[dim], block.shape[dim])
        view.copy_(block)
    return out


def fsdp_dim(spec) -> Optional[int]:
    """The dimension a resolved spec shards over ``data`` alone (ZeRO-3),
    or ``None``."""
    for dim, part in enumerate(spec):
        if _axes(part) == ("data",):
            return dim
    return None


def shard_parameter(p, spec, mesh) -> None:
    """Keep this rank's block of parameter ``p`` (in place, a copy) and
    remember what the forward gathers back over ``data``."""
    p.data = local_slice(p.data, spec, mesh).clone()
    d = fsdp_dim(spec)
    p.fsdp = None if d is None or mesh.shape["data"] == 1 else d


class Gathered:
    """A module's parameters as the layer functions read them: each one
    sharded over ``data`` (``shard_parameter``'s ``fsdp``) all-gathered on
    first read (ZeRO-3: the backward reduce-scatters its gradient), the
    others as they are.  Submodules come back as views of their own, and a
    field that is ``None`` stays ``None``."""

    def __init__(self, module, group):
        self._m, self._group, self._cache = module, group, {}

    def __getattr__(self, name):
        cache = self.__dict__["_cache"]
        if name not in cache:
            m = self._m
            if name in m._parameters:
                p = m._parameters[name]
                d = getattr(p, "fsdp", None)
                if p is not None and d is not None:
                    from repro_torch.distributed import collectives
                    p = collectives.gather(p, d, self._group)
                cache[name] = p
            elif name in m._modules:
                sub = m._modules[name]
                cache[name] = None if sub is None else Gathered(sub, self._group)
            else:
                cache[name] = getattr(m, name)
        return cache[name]


def under(rules, fn, *args):
    """``fn(*args)`` under ``rules``: what a remat segment calls, since its
    recompute may run on another thread (CUDA's backward does), where the
    caller's thread-local rules are not set."""
    with use_rules(rules):
        return fn(*args)


def gathered(module):
    """``module`` itself without a ``data`` axis above 1 under the rules,
    else its ``Gathered`` view."""
    r = get_rules()
    if r is None or r.mesh is None or r.axis_size("data") == 1 \
            or "data" in r.exclude:
        return module
    return Gathered(module, r.mesh.get_group("data"))


def _is_logical_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def spec_tree(logicals, shapes):
    """Resolve a tree of logical tuples against a matching tree of tensors,
    ``Stacked`` leaves or shapes."""
    r = get_rules()
    if r is None:
        return map_tree(lambda _: P(), logicals)
    return map_tree(lambda log, shp: r.spec(_shape_of(shp), log),
                    logicals, shapes)


def local_state(whole, tree, logical, mesh, device):
    """A state of zeros holding this rank's block of every leaf: ``whole``
    is the state at its full size (on the ``meta`` device: nothing
    allocated), ``tree`` the same tensors as the reference's tree (a
    per-layer list as a ``Stacked`` leaf), ``logical`` the reference's
    logical axes of that tree.  Each leaf's spec is resolved on its whole
    shape under ``Rules(mesh)`` (a ``Stacked`` leaf's part takes the spec
    without its layer axis) and the leaf cut to ``local_slice``'s block;
    the result has ``whole``'s structure (NamedTuples and lists), its
    tensors on ``device``."""
    from torch.utils._pytree import tree_map

    with use_rules(Rules(mesh=mesh)):
        specs = spec_tree(logical, tree)
    blocks = {}
    for (_, leaf), (_, spec) in zip(flatten(tree), flatten(specs), strict=True):
        parts, spec = ((leaf.parts, P(*spec[1:])) if isinstance(leaf, Stacked)
                       else ([leaf], spec))
        for t in parts:
            blocks[id(t)] = torch.zeros(local_slice(t, spec, mesh).shape,
                                        dtype=t.dtype, device=device)
    return tree_map(lambda t: None if t is None else blocks[id(t)], whole)


def _shape_of(x) -> tuple:
    if isinstance(x, Stacked) or hasattr(x, "shape"):
        return leaf_shape(x)
    return tuple(x)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the port's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P


def named_sharding(spec: P) -> Optional[NamedSharding]:
    r = get_rules()
    if r is None or r.mesh is None:
        return None
    return NamedSharding(r.mesh, spec)
