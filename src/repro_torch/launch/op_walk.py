"""PyTorch's own view of a program: the port's counterpart of
``repro.launch.hlo_text`` and ``repro.launch.hlo_walk``.

The reference lowers a function with XLA and reads the optimized HLO
text: its ENTRY parameters and root (``hlo_walk.entry_io_bytes``), the
instructions computed from the parameters (``access._param_derived``), and
dot FLOPs scaled by each ``while`` loop's trip count (``analyze_hlo``).
Neither module has a direct counterpart here, because the port compiles
nothing: it runs eagerly, and no module text exists to parse.  What the
port does have is the dispatcher.  Every aten op a function runs passes
through it with its real inputs and outputs, and ``walk`` records each
one under a ``TorchDispatchMode``:

* ``OpRecord``: the op, and the shape, dtype and strides of each tensor
  it reads and writes, with its other arguments (the counterpart of one
  parsed HLO instruction);
* ``TensorInfo.derived``: whether a tensor an op reads or writes was
  computed from the arguments, directly or through views
  (``_param_derived``);
* ``Walk.read_bytes`` / ``write_bytes``: the bytes of the argument tensors
  handed in and of the tensors returned, each tensor once, plus the bytes
  the ops write in place into the arguments' storage (``entry_io_bytes``,
  where an in-place update of a donated buffer has no separate root);
* ``Walk.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count.
  An eager loop runs each product as often as it iterates, so no trip
  count is needed (``analyze_hlo`` multiplies by ``known_trip_count``).

What has no counterpart: XLA's fusion scopes and their interior traffic
(an eager op reads its inputs and writes its outputs, so ``op_bytes``
sums both over every op: the counterpart of ``traffic_bytes`` before
fusion), replica groups and collective parsing (the port counts the bytes
it hands each collective in ``distributed.collectives``), and a kernel
launched through ``ctypes``, which the dispatcher never sees: on a CUDA
tensor the walk records only what a wrapper does around its launch.

A walk runs on real tensors (CPU or CUDA) or under ``FakeTensorMode``
(``launch.dryrun``), where nothing is allocated.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: ops that copy their input to new memory, on a tensor the arguments
#: reach: a wrapper's own traffic around a kernel launch
COPY_OPS = ("aten.copy_", "aten.clone", "aten._to_copy", "aten.contiguous")


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    stride: Tuple[int, ...]
    derived: bool = False        # computed from the walked function's arguments

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * _itemsize(self.dtype)


@dataclasses.dataclass
class OpRecord:
    """One aten op as the dispatcher ran it."""
    index: int
    op: str                      # overload packet, e.g. "aten.slice"
    overload: str                # e.g. "aten.slice.Tensor"
    inputs: List[TensorInfo]
    outputs: List[TensorInfo]
    params: Dict[str, Any]       # the non-tensor arguments, by schema name
    written: List[int]           # positions in ``inputs`` the op writes

    @property
    def reads_derived(self) -> bool:
        return any(t.derived for t in self.inputs)


@dataclasses.dataclass
class Walk:
    """What a function did under the dispatcher."""
    ops: List[OpRecord]
    read_bytes: int              # argument tensors handed in, each once
    write_bytes: int             # result tensors, each once, + in-place writes
    result_bytes: int
    inplace_write_bytes: int     # bytes the ops wrote into the arguments
    op_bytes: int                # inputs + outputs of every op
    flops: int
    flops_by_op: Dict[str, int]

    def copies(self) -> List[OpRecord]:
        """Copy ops on data the arguments reach (``COPY_OPS``)."""
        return [o for o in self.ops if o.op in COPY_OPS and o.reads_derived]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _info(t: torch.Tensor, derived: bool) -> TensorInfo:
    return TensorInfo(tuple(t.shape), t.dtype, tuple(t.stride()), derived)


def _tensors(tree) -> List[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _unique(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    seen: Set[int] = set()
    out = []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _written_positions(func, flat_args) -> List[int]:
    """Positions (among the tensor arguments) that the op's schema marks
    as written (``Tensor(a!)``)."""
    out, pos = [], 0
    schema_args = func._schema.arguments
    args, kwargs = flat_args
    for i, a in enumerate(schema_args):
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if isinstance(v, torch.Tensor):
            if a.alias_info is not None and a.alias_info.is_write:
                out.append(pos)
            pos += 1
        elif isinstance(v, (list, tuple)):
            pos += sum(isinstance(x, torch.Tensor) for x in v)
    return out


def _params(func, args, kwargs) -> Dict[str, Any]:
    """The op's non-tensor arguments by schema name, defaults filled in."""
    out = {}
    for i, a in enumerate(func._schema.arguments):
        if i < len(args):
            v = args[i]
        elif a.name in kwargs:
            v = kwargs[a.name]
        elif a.has_default_value():
            v = a.default_value
        else:
            continue
        if isinstance(v, torch.Tensor) or (isinstance(v, (list, tuple)) and any(
                isinstance(x, torch.Tensor) for x in v)):
            continue
        out[a.name] = v
    return out


def _index_put_bytes(self_t: torch.Tensor, indices, values: torch.Tensor) -> int:
    """Bytes ``index_put_`` writes: the indexed elements of ``self``."""
    idx = [i for i in indices if i is not None]
    if not idx:
        return self_t.numel() * self_t.element_size()
    shape = torch.broadcast_shapes(*(i.shape for i in idx))
    n = 1
    for d in shape:
        n *= d
    for d in self_t.shape[len(indices):]:
        n *= d
    return n * self_t.element_size()


class _Recorder(TorchDispatchMode):
    def __init__(self, arg_tensors: Sequence[torch.Tensor]):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._keep: List[torch.Tensor] = list(arg_tensors)   # ids stay unique
        self.derived: Set[int] = {id(t) for t in arg_tensors}
        self.arg_alias: Set[int] = {id(t) for t in arg_tensors}
        self.inplace_write_bytes = 0
        self.op_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        derived_in = any(id(t) in self.derived for t in ins)
        aliased_in = any(id(t) in self.arg_alias for t in ins)
        written = _written_positions(func, (args, kwargs))
        for t in outs:
            self._keep.append(t)
            if derived_in:
                self.derived.add(id(t))
        # a view of an argument, or an argument written in place, is still
        # the argument's storage
        view = bool(func._schema.returns) and any(
            r.alias_info is not None for r in func._schema.returns)
        if aliased_in and (view or written):
            for t in outs:
                self.arg_alias.add(id(t))
        for p in written:
            t = ins[p]
            if id(t) not in self.arg_alias:
                continue
            if func._overloadpacket in (torch.ops.aten.index_put_,
                                        torch.ops.aten._index_put_impl_):
                nbytes = _index_put_bytes(t, args[1], args[2])
            else:
                nbytes = t.numel() * t.element_size()
            self.inplace_write_bytes += nbytes
        self.op_bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        self.ops.append(OpRecord(
            index=len(self.ops), op=str(func._overloadpacket),
            overload=str(func),
            inputs=[_info(t, id(t) in self.derived) for t in ins],
            outputs=[_info(t, derived_in) for t in outs],
            params=_params(func, args, kwargs),
            written=written))
        return out


def walk(fn: Callable, *args, exclude: Sequence[int] = (),
         count_flops: bool = True, **kwargs) -> Walk:
    """Run ``fn(*args, **kwargs)`` once under the dispatcher and return what
    it did.  ``exclude`` lists argument positions that are not data read
    (buffers the function only writes into, index operands): their bytes
    are left out of ``read_bytes``.
    """
    from torch.utils.flop_counter import FlopCounterMode

    arg_ts = _unique([t for i, a in enumerate(args) for t in _tensors(a)
                      if i not in exclude])
    all_ts = _unique(_tensors((args, kwargs)))
    rec = _Recorder(all_ts)
    flop_mode = FlopCounterMode(display=False) if count_flops else None
    with flop_mode or contextlib.nullcontext(), rec:
        result = fn(*args, **kwargs)
    res_ts = _unique(_tensors(result))
    result_bytes = sum(t.numel() * t.element_size() for t in res_ts)
    flops_by_op: Dict[str, int] = {}
    if flop_mode is not None:
        for op, n in flop_mode.get_flop_counts().get("Global", {}).items():
            flops_by_op[str(op)] = int(n)
    return Walk(
        ops=rec.ops,
        read_bytes=sum(t.numel() * t.element_size() for t in arg_ts),
        write_bytes=result_bytes + rec.inplace_write_bytes,
        result_bytes=result_bytes,
        inplace_write_bytes=rec.inplace_write_bytes,
        op_bytes=rec.op_bytes,
        flops=(flop_mode.get_total_flops() if flop_mode is not None else 0),
        flops_by_op=flops_by_op)


def entry_io_bytes(fn: Callable, *args, exclude: Sequence[int] = (),
                   **kwargs) -> Tuple[int, int]:
    """(bytes read from the arguments, bytes written to the results and in
    place): the counterpart of ``hlo_walk.entry_io_bytes``."""
    w = walk(fn, *args, exclude=exclude, count_flops=False, **kwargs)
    return w.read_bytes, w.write_bytes


def innermost_dim(dim: int, rank: int) -> bool:
    """Whether ``dim`` (negative counts from the end) is the last of ``rank``."""
    return rank > 0 and dim % rank == rank - 1
