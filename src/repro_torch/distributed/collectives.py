"""Compressed cross-pod gradient exchange (port of ``repro.distributed.collectives``).

Data-parallel gradients that cross the pod boundary (the slow inter-pod
link) are quantized first: each gradient is blocked along its LAST axis in
groups of ``BLOCK`` = 32 values, each block becomes ``bits``
two's-complement codes with one f32 scale, and the codes are
bitplane-packed (the paper's §2.4 packing, ``core.blockcodec``'s torch
ops, which the reference's jnp ``bitplane_pack`` is).  The wire carries
``bits / 8 + 4 / 32`` bytes a parameter instead of 4.  Blocks never cross
the leading axes, so quantizing each per-layer part of a stacked leaf gives
the stacked leaf's planes.  Leaves smaller than ``MIN_COMPRESS_SIZE`` or
whose last axis is not a multiple of 32 go raw, averaged in f32.

Error feedback: each pod carries the quantization error of its gradients
into its next step (``TrainState.resid``), which makes the lossy exchange
unbiased over time.

Trees here are the reference's view of the parameters
(``train.step.reference_tree``): ``Attrs`` nodes whose leaves are tensors
or ``Stacked`` per-layer parts, so that compressibility and the leaf counts
of ``ExchangeStats`` are decided on the reference's stacked leaves.

What crosses between pods is only what ``exchange`` gathers (the packed
planes and scales) and what ``quantize_tree`` gathers for the raw leaves
(f32); ``wire_bytes_sent`` counts both, as this rank's contribution, and
equals ``exchange_stats(...).wire_bytes`` a step.

The module also holds the differentiable collectives that tensor
parallelism and ZeRO-3 issue by hand (``gather``, ``reduce_scatter``,
``all_reduce``; ``collective_bytes`` counts what each is handed) and the
``save_collectives`` remat policy (``SavePolicy``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import Stacked, flatten, leaf_shape, map_tree
from repro_torch.core import blockcodec as bc
from repro_torch.obs import instrument as obs

F32 = torch.float32
BLOCK = 32                 # values per scale block (= one bitplane group)
MIN_COMPRESS_SIZE = 4096   # smaller leaves go raw (scale overhead dominates)
#: values a chunk of rows when the CPU quantizes, so that the bitplane
#: transpose's intermediates stay in cache (a whole leaf of millions of
#: values streams each of its b passes through memory)
CPU_CHUNK = 1 << 18

#: bytes this process has contributed to cross-pod gathers
_sent = [0]


def wire_bytes_sent() -> int:
    return _sent[0]


def reset_wire_bytes() -> None:
    _sent[0] = 0


def _scalar(v: float, device) -> torch.Tensor:
    """A 0-dim f32 divisor: a GPU divides by a host scalar as a multiply by
    its reciprocal, not as IEEE division."""
    return torch.full((), float(v), dtype=F32, device=device)


def _quant_lastdim(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., last) f32 -> (planes uint32 (..., nb, bits), scale (..., nb))."""
    *lead, last = x.shape
    xb = x.reshape(*lead, last // BLOCK, BLOCK)
    qmax = float(2 ** (bits - 1) - 1)
    amax = xb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / _scalar(qmax, x.device),
                        _scalar(1.0, x.device))
    q = torch.clamp(torch.round(xb / scale[..., None]), -qmax, qmax)
    return bc.bitplane_pack(q.to(torch.int32), bits), scale


def _dequant_lastdim(planes: torch.Tensor, scale: torch.Tensor, bits: int,
                     shape) -> torch.Tensor:
    q = bc.bitplane_unpack(planes, bits)
    return (q.to(F32) * scale[..., None]).reshape(shape)


def compressible(g) -> bool:
    """A tensor, a ``Stacked`` leaf or a shape-carrying leaf: 4096 values or
    more, and a last axis that is a multiple of 32."""
    shape = leaf_shape(g)
    return math.prod(shape) >= MIN_COMPRESS_SIZE and shape[-1] % BLOCK == 0


def _parts(leaf) -> List[torch.Tensor]:
    return leaf.parts if isinstance(leaf, Stacked) else [leaf]


def _like(leaf, parts: List[torch.Tensor]):
    return Stacked(parts, leaf.axis) if isinstance(leaf, Stacked) else parts[0]


def _staged(t: torch.Tensor, group) -> bool:
    """Gloo takes no CUDA tensor: such a tensor goes through host memory."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): each member's ``t`` in group-rank order, ``n`` the
    group's size.  Gloo gathers no CUDA tensor, so on a gloo group a CUDA
    ``t`` goes through host memory."""
    if _staged(t, group):
        return all_gather(t.cpu(), group).to(t.device)
    out = torch.empty((dist.get_world_size(group), *t.shape), dtype=t.dtype,
                      device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def gather_to_first(t: torch.Tensor):
    """Every rank's ``t`` (one shape and dtype on all), on rank 0 as a list
    of host tensors in rank order; ``None`` on the other ranks.  A
    collective over the default group (a CUDA ``t`` goes through host
    memory on gloo)."""
    src = t.contiguous()
    if _staged(src, None):
        src = src.cpu()
    if dist.get_rank() != 0:
        dist.gather(src, None, dst=0)
        return None
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.gather(src, out, dst=0)
    return [o.cpu() for o in out]


# ---------------------------------------------------------------------------
# Differentiable collectives over a mesh axis (tensor parallelism, ZeRO-3)
# ---------------------------------------------------------------------------
#
# Each rank differentiates its own copy of the loss, and the gradient the
# step wants is that of the sum of the ranks' losses: every collective's
# backward is the adjoint of its forward under that sum (gather <->
# reduce-scatter, all-reduce <-> all-reduce), a tensor copied on several
# ranks gets the sum of its copies' gradients (``train.step``), and the step
# divides by the number of ranks whose losses were summed.  Reductions run
# in f32 and give every rank the same bits.

#: bytes this process has handed to the differentiable collectives, by kind
#: (a gather counts its own block, a reduction the whole tensor it reduces)
_moved = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
_save = threading.local()


def collective_bytes() -> dict:
    return dict(_moved)


def reset_collective_bytes() -> None:
    for k in _moved:
        _moved[k] = 0


def _reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in f32 (a new tensor, ``t``'s dtype)."""
    buf = t.to(F32, copy=True).contiguous()
    host = buf.cpu() if _staged(buf, group) else buf
    dist.all_reduce(host, op=op, group=group)
    return host.to(device=t.device, dtype=t.dtype)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    _moved["all_gather"] += x.numel() * x.element_size()
    return torch.cat(all_gather(x, group).unbind(0), dim=dim)


def _scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``x`` in f32, this rank's block of it
    along ``dim`` (``x``'s dtype): a reduce-scatter on NCCL; on gloo an
    all-reduce, then the block (gloo's reduce-scatter of host tensors is
    the slower of the two)."""
    _moved["reduce_scatter"] += x.numel() * 4
    n, i = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    if dist.get_backend(group) != "nccl":
        return _reduce(x, group).narrow(dim, i * size, size).contiguous()
    buf = x.to(F32).movedim(dim, 0).contiguous()
    out = torch.empty((size, *buf.shape[1:]), dtype=F32, device=x.device)
    dist.reduce_scatter_tensor(out, buf, group=group)
    return out.movedim(0, dim).to(x.dtype).contiguous()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    _moved["all_reduce"] += x.numel() * 4
    return _reduce(x, group)


def _recorded(name, fn):
    """``fn()``, or under ``save_collectives``' recompute the output this
    call gave in the forward: the collectives named in the policy are not
    run again (``SavePolicy``)."""
    policy = getattr(_save, "policy", None)
    if policy is None or name not in policy.names:
        return fn()
    if policy.replay:
        return policy.store[policy.take()].detach()
    out = fn()
    policy.store.append(out.detach())
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, name):
        ctx.dim, ctx.group = dim, group
        return _recorded(name, lambda: _gather_dim(x, dim, group))

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.group), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, name):
        ctx.dim, ctx.group = dim, group
        return _recorded(name, lambda: _scatter_dim(x, dim, group))

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name):
        ctx.group = group
        return _recorded(name, lambda: _sum(x, group))

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None, None


def _one(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def gather(x: torch.Tensor, dim: int, group, name: str = None) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in group-rank order;
    backward: the gradient summed over the group, this rank's block."""
    return x if _one(group) else _Gather.apply(x, dim, group, name)


def reduce_scatter(x: torch.Tensor, dim: int, group,
                   name: str = None) -> torch.Tensor:
    """The sum of the members' ``x`` (in f32), this rank's block along
    ``dim``; backward: the gradient's blocks gathered."""
    return x if _one(group) else _Scatter.apply(x, dim, group, name)


def all_reduce(x: torch.Tensor, group, name: str = None) -> torch.Tensor:
    """The sum of the members' ``x`` (in f32); backward: the gradient
    summed the same way."""
    return x if _one(group) else _AllReduce.apply(x, group, name)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group, outside autograd."""
    if _one(group):
        return x
    _moved["all_reduce"] += x.numel() * 4
    return _reduce(x.detach(), group, dist.ReduceOp.MAX)


class SavePolicy:
    """The reference's ``save_collectives`` remat policy for
    ``torch.utils.checkpoint``: the outputs of the collectives called with a
    name in ``names`` ("proj_out", "kv_gathered") are kept from the forward
    and handed back, in call order, when backward recomputes the segment;
    everything else is recomputed.  ``context_fn`` gives checkpoint its two
    contexts (forward, recompute) for one segment."""

    def __init__(self, names):
        self.names = frozenset(names)
        self.store: list = []
        self.replay = False
        self._next = 0

    def take(self) -> int:
        self._next += 1
        return self._next - 1

    @contextlib.contextmanager
    def _active(self, replay: bool):
        prev = getattr(_save, "policy", None)
        self.replay, self._next = replay, 0
        _save.policy = self
        try:
            yield
        finally:
            _save.policy = prev

    @classmethod
    def context_fn(cls, names):
        def make():
            policy = cls(names)
            return policy._active(False), policy._active(True)
        return make


def _gather_words(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Gather many 4-byte tensors in one call, counted in
    ``wire_bytes_sent``: each comes back with a leading group dimension, in
    its own dtype."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])
    _sent[0] += flat.numel() * flat.element_size()
    got = all_gather(flat, group)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(got[:, at:at + n].view(t.dtype).reshape(-1, *t.shape))
        at += n
    return out


def _quantize_part(g: torch.Tensor, r: torch.Tensor, bits: int):
    """Planes and scales of ``x = g + r``; ``r`` becomes ``x - dequant``.
    Blocks never cross rows, so the CPU takes the rows in cache-sized
    chunks; a GPU takes the whole tensor."""
    last = g.shape[-1]
    g2, r2 = g.reshape(-1, last), r.view(-1, last)
    rows = g2.shape[0]
    step = max(1, CPU_CHUNK // last) if g.device.type == "cpu" else rows
    nb = last // BLOCK
    planes = torch.empty((rows, nb, bits), dtype=torch.int32, device=g.device)
    scales = torch.empty((rows, nb), dtype=F32, device=g.device)
    for a in range(0, rows, step):
        x = g2[a:a + step].to(F32) + r2[a:a + step]
        p, s = _quant_lastdim(x, bits)
        torch.sub(x, _dequant_lastdim(p, s, bits, x.shape), out=r2[a:a + step])
        planes[a:a + step] = p.view(torch.int32)
        scales[a:a + step] = s
    return (planes.view(torch.uint32).reshape(*g.shape[:-1], nb, bits),
            scales.reshape(*g.shape[:-1], nb))


def quantize_tree(grads, resids, bits: int, group=None, whole=None):
    """The pod-local half of the exchange.

    Compressible leaves (decided on ``whole``'s leaf where given: the
    reference's whole leaf, of which ``grads`` holds this rank's block)
    -> (planes, scale, new residual); the others are
    averaged in f32 over ``group`` (the ranks of the other pods; ``None``:
    this pod alone), in group order, and cast back to their dtype.  The new
    residuals ``x - dequant(quant(x))``, ``x = g + resid`` (zero for a raw
    leaf), are written into ``resids``' tensors.  Returns ``(planes,
    scales, raw_means, new_resids)`` trees, ``None`` where a tree does not
    apply.
    """
    raw = []

    def one(g, r, w=None):
        if not compressible(g if w is None else w):
            for part in _parts(r):
                part.zero_()
            raw.append(g)
            return None, None, None, r
        planes, scales = zip(*(_quantize_part(gp, rp, bits)
                                for gp, rp in zip(_parts(g), _parts(r))))
        return _like(g, list(planes)), _like(g, list(scales)), None, r

    out = map_tree(one, grads, resids, *(() if whole is None else (whole,)))
    means = _raw_means(raw, group)
    pick = lambda i: map_tree(lambda t: t[i], out)  # noqa: E731
    raw_means = map_tree(lambda t, g: means.get(id(g)) if t[0] is None else None,
                         out, grads)
    return pick(0), pick(1), raw_means, pick(3)


def _raw_means(leaves, group) -> dict:
    """id(leaf) -> the leaf averaged over ``group`` in group order."""
    parts = [p for leaf in leaves for p in _parts(leaf)]
    if group is None or dist.get_world_size(group) == 1:
        return {id(leaf): leaf for leaf in leaves}
    gathered = iter(_gather_words([p.to(F32) for p in parts], group))
    means = {}
    for leaf in leaves:
        avg = []
        for p in _parts(leaf):
            avg.append(pod_mean(next(gathered), p.dtype))
        means[id(leaf)] = _like(leaf, avg)
    return means


def pod_mean(pods: torch.Tensor, dtype) -> torch.Tensor:
    """(n_pods, ...) f32 -> their sum in pod order over n_pods, as ``dtype``."""
    total = pods[0]
    for i in range(1, pods.shape[0]):
        total = total + pods[i]
    return (total / _scalar(pods.shape[0], pods.device)).to(dtype)


def exchange(planes, scales, group):
    """Gather every pod's packed planes and scales over ``group``, in one
    call: each tensor comes back with a leading pod dimension.  Nothing else
    crosses the pod boundary for a compressible leaf."""
    flat = [(path, leaf) for tree in (planes, scales)
            for path, leaf in flatten(tree)]
    tensors = [p for _, leaf in flat for p in _parts(leaf)]
    got = iter(_gather_words(tensors, group))
    gathered = {}
    for path, leaf in flat:
        gathered[id(leaf)] = _like(leaf, [next(got) for _ in _parts(leaf)])
    return (map_tree(lambda t: gathered[id(t)], planes),
            map_tree(lambda t: gathered[id(t)], scales))


def dequant_mean_tree(grads_like, planes, scales, raw_means, bits: int,
                      n_pods: int):
    """The other half: planes and scales with a leading pod dimension
    (``exchange``) -> each pod's gradients dequantized, summed in pod
    order, divided by ``n_pods`` and cast to the gradient's dtype; raw
    leaves are ``raw_means``' as they are."""
    def one(g, p, s, raw):
        if raw is not None:
            return raw
        out = []
        for gp, pp, sp in zip(_parts(g), _parts(p), _parts(s)):
            total = None
            for i in range(n_pods):
                d = _dequant_lastdim(pp[i], sp[i], bits, gp.shape)
                total = d if total is None else total + d
            out.append((total / _scalar(n_pods, total.device)).to(gp.dtype))
        return _like(g, out)

    return map_tree(one, grads_like, planes, scales, raw_means)


def init_residuals(params, n_pods: int = 1) -> dict:
    """Error-feedback state: a zero f32 residual of shape ``(n_pods, *p)``
    for each named parameter (a rank holds its own pod's, ``n_pods`` = 1)."""
    return {n: torch.zeros((n_pods, *p.shape), dtype=F32, device=p.device)
            for n, p in params.items()}


def compressed_bytes_per_param(bits: int, block: int = BLOCK) -> float:
    """Wire bytes per parameter for the compressed exchange."""
    return bits / 8 + 4.0 / block


# ---------------------------------------------------------------------------
# Wire-byte accounting (host side, from shapes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExchangeStats:
    """Analytic per-exchange wire accounting for one gradient tree.

    The codec's output sizes are static functions of shape and ``bits``,
    so the accounting is exact from leaf shapes alone; the caller publishes
    it once per exchange, outside any CUDA-graph capture.
    """
    bits: int
    compressed_leaves: int
    raw_leaves: int
    raw_bytes: int          # what an uncompressed f32 exchange would move
    wire_bytes: int         # planes + scales, plus raw leaves verbatim

    @property
    def reduction(self) -> float:
        return self.raw_bytes / self.wire_bytes if self.wire_bytes else 0.0

    def publish(self, **labels) -> None:
        """Emit ``collectives/*`` series (no-op when obs is disabled)."""
        if not obs.enabled():
            return
        lb = dict(labels, bits=self.bits)
        obs.counter_inc("collectives/exchanges", 1, **lb)
        obs.counter_inc("collectives/raw_bytes", self.raw_bytes, **lb)
        obs.counter_inc("collectives/wire_bytes", self.wire_bytes, **lb)
        obs.counter_inc("collectives/leaves", self.compressed_leaves,
                        kind="compressed", **lb)
        obs.counter_inc("collectives/leaves", self.raw_leaves,
                        kind="raw_fallback", **lb)
        obs.gauge_set("collectives/reduction", self.reduction, **lb)


def exchange_stats(tree, bits: int) -> ExchangeStats:
    """Wire accounting for exchanging ``tree`` at ``bits`` (shapes only)."""
    compressed = raw = 0
    raw_bytes = wire_bytes = 0
    for _, g in flatten(tree):
        size = math.prod(leaf_shape(g))
        raw_bytes += size * 4
        if compressible(g):
            compressed += 1
            wire_bytes += size * bits // 8 + size // BLOCK * 4
        else:
            raw += 1
            wire_bytes += size * 4
    return ExchangeStats(bits=bits, compressed_leaves=compressed,
                         raw_leaves=raw, raw_bytes=raw_bytes,
                         wire_bytes=wire_bytes)
