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

What the port does with a resolved spec: the ``pod`` and ``data`` axes are
data parallelism over torch.distributed ranks (``train.step``), each rank
holding its rows of the batch, which is what the reference's constraint
places there; so ``act`` changes no number on a mesh whose ``model`` axis
is 1.  Parameters are replicated on every rank: an ``fsdp`` spec resolves
as in the reference, but the ZeRO-3 placement over ``data`` comes with the
tensor-parallel slice.  A ``model`` axis above 1 (tensor parallelism,
``tp_out_proj``'s reduce-scatter, the ``save_collectives`` remat policy)
raises ``NotImplementedError`` for the same reason: the flash kernels'
autograd functions would have to run on DTensor shards.

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

from repro_torch.checkpoint.ckpt import Stacked, leaf_shape, map_tree

#: the slice that brings tensor parallelism over the ``model`` axis
TP_SLICE = ("the distributed slice that brings the 'model' axis (tensor "
            "parallelism: flash attention on DTensor shards, tp_out_proj's "
            "reduce-scatter, the save_collectives remat policy), not ported "
            "yet")


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


def check_model_axis(mesh) -> None:
    """Raise on a mesh whose ``model`` axis is above 1."""
    if mesh is not None and "model" in mesh.axis_names and mesh.shape["model"] > 1:
        raise NotImplementedError(
            f"a 'model' axis of {mesh.shape['model']} needs {TP_SLICE}")


def act(x, *logical: Optional[str]):
    """An activation under its logical sharding: each rank already holds
    its rows of the batch, so on a mesh whose ``model`` axis is 1 this is
    ``x`` itself (and without rules or a mesh, as in the reference)."""
    r = get_rules()
    if r is None or r.mesh is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"shape {tuple(x.shape)} against logical axes {logical}")
    check_model_axis(r.mesh)
    return x


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


def tp_out_proj(h, w):
    """The reference's hand-scheduled tensor-parallel out-projection.

    Returns ``None`` where it does not apply, as the reference does (no
    rules, no mesh, ``model`` excluded, tp = 1, not a (B, S, F) activation):
    the caller runs the plain matmul.  At tp > 1 it raises
    ``NotImplementedError``: the reduce-scatter comes with the
    tensor-parallel slice.
    """
    r = get_rules()
    if r is None or r.mesh is None or "model" in r.exclude:
        return None
    tp = r.axis_size("model")
    if h.dim() != 3 or tp <= 1:
        return None
    raise NotImplementedError(f"tp_out_proj at tp = {tp} needs {TP_SLICE}")
