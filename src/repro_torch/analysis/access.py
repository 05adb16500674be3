"""Access-pattern pass: redundancy, contiguity, pack alignment (port of
``repro.analysis.access``).

Mirrors the kernel grid of ``launch.audit.kernel_io_audit`` (same shapes,
same routes) but asks different questions of what the dispatcher saw
(``launch.op_walk``):

* **ACC101 redundant traffic** (error): the walked bytes exceed the
  analytic irredundant charge (``ops.*_io_bytes`` — "read every input
  once, write every output once"); and, on a kernel route, the wrapper
  copies data the arguments reach around its launch (``aten.copy_``,
  ``clone``, ``_to_copy``, ``contiguous``): traffic the kernel's charge
  does not hold.
* **ACC102 non-contiguous innermost access** (warning): a gather or index,
  a ``slice`` with step > 1 on the innermost dimension, a permute or
  transpose that moves the innermost dimension, or a ``flip`` of it,
  applied to data the arguments reach.  Off-chip residents are charged by
  the AXI burst model in ``core/transfer.py``; breaking the innermost
  dimension turns one long burst into per-element bursts, and the message
  quotes the cycle inflation for the shape.
* **ACC103 misaligned pack width** (error): a pack/unpack case whose bit
  width does not tile the 32-bit plane word (``32 % bits != 0``) or whose
  block does not fill whole plane words (``block % 32 != 0``); plus the
  static ``DATA_TYPES`` table check that every container width equals
  ``packing.padded_width(nbits)``.

Routes.  On the CPU the cases run the plain routes (``backend="ref"``),
as the reference lowers ``ref.*`` and not the Pallas kernels.  On a CUDA
device they run the kernel routes (``backend="cuda"``; the Jacobi case
the wrapper ``jacobi_mars.jacobi_chunked``, whose input is the padded
domain ``ops.jacobi1d_tiled`` hands it).  The launch goes through
``ctypes`` and is invisible to the dispatcher, so there the bytes are
those of the tensors handed to the launch and returned by it, and what
the walk can check is that the wrapper adds no traffic of its own.  The
card's grid adds ``kv_quant_store``, the serve path's route for
``kv_quant``, which writes its rows in place into the packed cache, and
``kv_decode_attention``, the serve path's route for ``kv_dequant``, which
reads the packed cache once and attends (its plain route dequantizes the
whole cache to f32 and casts it, traffic the kernel's charge does not
hold, so the CPU grid leaves it out): with every slot valid, and at rows
whose positions leave most of the cache masked, where the kernel reads
only the valid slots and the charge counts those.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.packing import DATA_TYPES, padded_width
from repro_torch.core.transfer import TransferModel
from repro_torch.launch import op_walk

from .findings import Finding

PASS_NAME = "access-pattern"

#: exact tolerance for byte comparisons (float round-off only)
BYTES_RTOL = 1e-9

#: the reference's grid: codes [N_CODES, BLOCK], KV rows [ROWS, D], jacobi
#: on JACOBI_N cells for T_STEPS steps; bits 4 and 8
N_CODES, BLOCK = 256, 32
ROWS, D = 64, 64
JACOBI_N, T_STEPS, JACOBI_WIDTH = 4096, 4, 512
GRID_BITS = (4, 8)
#: the card's kv_quant_store case: one layer of granite-8b's packed cache at
#: serve batch 8, seq 256 (8 KV heads of 128), bf16 rows in
STORE_SHAPE = (8, 256, 8, 128)
#: the decode attention's rows at positions that leave most of
#: STORE_SHAPE's 256 slots masked (a tile's first and last slot, one row
#: whole)
PARTIAL_POS = (0, 63, 64, 100, 127, 128, 200, 255)

#: gather-like ops: each element of the output indexes its own address
_GATHER_OPS = ("aten.gather", "aten.index", "aten.index_select", "aten.take",
               "aten._unsafe_index", "aten.embedding")


@dataclasses.dataclass
class KernelCase:
    """One walked kernel route + its analytic irredundant byte charge.

    ``exclude`` lists the argument positions that carry no data the kernel
    reads (the buffers it writes in place, an index operand), or that it
    reads only in part; ``reads`` gives the bytes a kernel route reads of
    those in part (the slots a position makes valid), ``inplace`` the bytes
    a route writes in place, where the dispatcher cannot see them (a
    kernel launch): on a plain route the walk counts them.
    """
    name: str
    fn: Callable
    args: tuple
    read_bytes: int
    write_bytes: int
    pack_bits: int = 0     # plane-pack bit width (0 = not a packing kernel)
    pack_block: int = 0
    route: str = "ref"     # "ref" (plain) or "cuda" (the kernel)
    exclude: Tuple[int, ...] = ()
    inplace: Optional[Callable[[tuple], int]] = None
    reads: Optional[Callable[[tuple], int]] = None
    _walk: Optional[op_walk.Walk] = dataclasses.field(default=None,
                                                      repr=False)

    def walk(self) -> op_walk.Walk:
        if self._walk is None:
            self._walk = op_walk.walk(self.fn, *self.args,
                                      exclude=self.exclude)
        return self._walk

    def io_bytes(self) -> Tuple[int, int]:
        """(read, write) bytes of the walked route."""
        w = self.walk()
        if self.route != "cuda":
            return w.read_bytes, w.write_bytes
        read = w.read_bytes + (self.reads(self.args) if self.reads else 0)
        if self.inplace is not None:
            return read, w.result_bytes + self.inplace(self.args)
        return read, w.write_bytes


def _route(device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def _store_rows_bytes(args: tuple) -> int:
    """Bytes ``kv_quant_store`` writes in place: one slot row a sequence in
    each of the four destinations (codes and scales of K and V)."""
    return sum(t.numel() // t.shape[1] * t.element_size() for t in args[:4])


def builtin_cases(device="cuda", seed: int = 0) -> List[KernelCase]:
    """The audit kernel grid on ``device``: the plain routes on the CPU,
    the kernel routes (``backend="cuda"``) on a card, where the grid adds
    ``kv_quant_store`` (``store_cases``)."""
    from repro_torch.kernels import jacobi_mars, ops

    dev = torch.device(device)
    route = _route(dev)
    backend = route
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases: List[KernelCase] = []
    for bits in GRID_BITS:
        q = t(rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                           size=(N_CODES, BLOCK), dtype=np.int32))
        r, w = ops.pack_io_bytes(N_CODES, BLOCK, bits)
        cases.append(KernelCase(
            f"kernel/pack/bits{bits}",
            lambda q, b=bits: ops.pack_codes(q, b, backend=backend), (q,),
            r, w, pack_bits=bits, pack_block=BLOCK, route=route))
        planes = t(rng.integers(0, 1 << 32, size=(N_CODES, BLOCK // 32 * bits),
                                dtype=np.uint64).astype(np.uint32))
        r, w = ops.unpack_io_bytes(N_CODES, BLOCK, bits)
        cases.append(KernelCase(
            f"kernel/unpack/bits{bits}",
            lambda p, b=bits: ops.unpack_codes(p, b, BLOCK, backend=backend),
            (planes,), r, w, pack_bits=bits, pack_block=BLOCK, route=route))
        x = t(rng.standard_normal((ROWS, D), dtype=np.float32))
        r, w = ops.kv_quant_io_bytes(ROWS, D, bits)
        cases.append(KernelCase(
            f"kernel/kv_quant/bits{bits}",
            lambda x, b=bits: ops.kv_quant(x, b, backend=backend), (x,),
            r, w, route=route))
        cd = D if bits == 8 else D // 2
        codes = t(rng.integers(-128, 128, size=(ROWS, cd), dtype=np.int8))
        scales = t(rng.uniform(0.01, 1.0, size=(ROWS, 1)).astype(np.float32))
        r, w = ops.kv_dequant_io_bytes(ROWS, D, bits)
        cases.append(KernelCase(
            f"kernel/kv_dequant/bits{bits}",
            lambda c, s, b=bits: ops.kv_dequant(c, s, b, backend=backend),
            (codes, scales), r, w, route=route))
    x = t(np.cumsum(rng.uniform(-0.01, 0.01, JACOBI_N)).astype(np.float32))
    r, w = ops.jacobi_io_bytes(JACOBI_N)
    if route == "cuda":
        fn = lambda x: jacobi_mars.jacobi_chunked(x, T_STEPS, JACOBI_WIDTH)  # noqa: E731
    else:
        fn = lambda x: ops.jacobi1d_tiled(x, T_STEPS, JACOBI_WIDTH,  # noqa: E731
                                          backend=backend)
    cases.append(KernelCase("kernel/jacobi1d", fn, (x,), r, w, route=route))
    if route == "cuda":
        cases.extend(store_cases(dev, rng, route))
        cases.extend(decode_attention_cases(dev, rng))
    return cases


def store_cases(dev, rng, route: str) -> List[KernelCase]:
    """``kv_quant_store`` at ``STORE_SHAPE``, bits 4 and 8, bf16 rows in,
    the slots a seeded mix of positions in the cache."""
    from repro_torch.kernels import ops

    B, S, KV, Dh = STORE_SHAPE
    cases = []
    for bits in GRID_BITS:
        cd = Dh if bits == 8 else Dh // 2

        def t(a, dtype=None):
            out = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return out if dtype is None else out.to(dtype)

        args = (t(rng.integers(-128, 128, size=(B, S, KV, cd), dtype=np.int8)),
                t(rng.integers(-128, 128, size=(B, S, KV, cd), dtype=np.int8)),
                t(rng.uniform(0.01, 1, (B, S, KV, 1)).astype(np.float32)),
                t(rng.uniform(0.01, 1, (B, S, KV, 1)).astype(np.float32)),
                t(rng.standard_normal((B, 1, KV, Dh), dtype=np.float32),
                  torch.bfloat16),
                t(rng.standard_normal((B, 1, KV, Dh), dtype=np.float32),
                  torch.bfloat16),
                t(rng.integers(0, S, size=(B,), dtype=np.int32)))
        r, w = ops.kv_quant_store_io_bytes(B, KV, Dh, bits, itemsize=2)
        backend = route
        cases.append(KernelCase(
            f"kernel/kv_quant_store/bits{bits}",
            lambda *a, b=bits: ops.kv_quant_store(*a, bits=b, backend=backend),
            args, r, w, route=route, exclude=(0, 1, 2, 3, 6),
            inplace=_store_rows_bytes))
    return cases


def _valid_rows_bytes(args: tuple) -> int:
    """Bytes of the cache rows (codes and scales, K and V, every KV head)
    of the slots ``valid_slots`` admits for each row's position, every slot
    of a row with none: what ``kv_decode_attention`` reads of the cache."""
    from repro_torch.kernels import decode_attention as dattn

    _, k, v, ks, vs, pos = args
    S = k.shape[1]
    valid = dattn.valid_slots(pos.cpu(), S, 0, S, 0, False)
    slots = int(torch.where(valid.any(1), valid.sum(1), S).sum())
    return slots * sum(t[0, 0].numel() * t.element_size() for t in (k, v, ks, vs))


def decode_attention_cases(dev, rng) -> List[KernelCase]:
    """``kv_decode_attention`` at ``STORE_SHAPE``'s cache (one granite-8b
    layer at serve batch 8, seq 256), 32 bf16 query heads of G = 4, bits 4
    and 8: every slot valid, then at ``PARTIAL_POS``, where the charge
    counts the slots read (``decode_attention.slots_read``) and the walk the
    cache rows ``valid_slots`` admits."""
    from repro_torch.kernels import decode_attention as dattn
    from repro_torch.kernels import ops

    B, S, KV, Dh = STORE_SHAPE
    G = 4
    cases = []
    for bits in GRID_BITS:
        cd = Dh if bits == 8 else Dh // 2

        def t(a, dtype=None):
            out = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return out if dtype is None else out.to(dtype)

        args = (t(rng.standard_normal((B, 1, KV * G, Dh), dtype=np.float32),
                  torch.bfloat16),
                t(rng.integers(-128, 128, size=(B, S, KV, cd), dtype=np.int8)),
                t(rng.integers(-128, 128, size=(B, S, KV, cd), dtype=np.int8)),
                t(rng.uniform(0.01, 0.05, (B, S, KV, 1)).astype(np.float32)),
                t(rng.uniform(0.01, 0.05, (B, S, KV, 1)).astype(np.float32)),
                t(np.full((B,), S - 1, dtype=np.int32)))
        r, w = ops.kv_decode_attention_io_bytes(B, S, KV, Dh, KV * G, bits)
        fn = (lambda q, k, v, ks, vs, pos, b=bits: ops.kv_decode_attention(
            q, (k, v, ks, vs), pos, b, 0, G, backend="cuda"))
        cases.append(KernelCase(f"kernel/kv_decode_attention/bits{bits}", fn,
                                args, r, w, route="cuda"))
        pos = torch.tensor(PARTIAL_POS, dtype=torch.int32)
        r, w = ops.kv_decode_attention_io_bytes(
            B, S, KV, Dh, KV * G, bits, slots=dattn.slots_read(pos, S, 0, S, 0, False))
        cases.append(KernelCase(
            f"kernel/kv_decode_attention/bits{bits}/partial", fn,
            args[:5] + (pos.to(dev),), r, w, route="cuda", exclude=(1, 2, 3, 4),
            reads=_valid_rows_bytes))
    return cases


# ---------------------------------------------------------------------------
# ACC101: redundant traffic
# ---------------------------------------------------------------------------

def check_redundancy(case: KernelCase) -> List[Finding]:
    got_r, got_w = case.io_bytes()
    findings = []
    for kind, got, want in (("read", got_r, case.read_bytes),
                            ("write", got_w, case.write_bytes)):
        if got > want * (1 + BYTES_RTOL):
            findings.append(Finding(
                rule="ACC101", severity="error",
                location=case.name,
                message=(f"walked {kind}s {got} B but the "
                         f"irredundant model charges {want} B "
                         f"(+{got - want} B redundant {kind} traffic)"),
                pass_name=PASS_NAME))
        elif got < want * (1 - BYTES_RTOL):
            findings.append(Finding(
                rule="ACC101", severity="info",
                location=case.name,
                message=(f"walked {kind}s {got} B, below the "
                         f"analytic charge {want} B — model overcharges"),
                pass_name=PASS_NAME))
    if case.route == "cuda":
        for op in case.walk().copies():
            nbytes = sum(t.nbytes for t in op.outputs)
            findings.append(Finding(
                rule="ACC101", severity="error",
                location=f"{case.name}/wrapper",
                message=(f"{op.overload} #{op.index} copies data the "
                         f"arguments reach around the kernel launch "
                         f"(+{nbytes} B the kernel's charge does not hold)"),
                pass_name=PASS_NAME))
    return findings


# ---------------------------------------------------------------------------
# ACC102: non-contiguous innermost access on off-chip residents
# ---------------------------------------------------------------------------

def _innermost_violation(op: op_walk.OpRecord) -> str:
    """Reason this op breaks innermost contiguity, or ''."""
    if op.op in _GATHER_OPS:
        return f"{op.op[5:]} indexes off-chip data element-wise"
    if not op.inputs:
        return ""
    rank = len(op.inputs[0].shape)
    p = op.params
    if op.op == "aten.slice":
        step = int(p.get("step", 1) or 1)
        if step > 1 and op_walk.innermost_dim(int(p.get("dim", 0)), rank):
            return f"innermost slice stride {step}"
        return ""
    if op.op == "aten.permute":
        dims = [int(d) % rank for d in p.get("dims", ())] if rank else []
        if dims and dims[-1] != rank - 1:
            return f"permute moves innermost dim (permutation {dims})"
        return ""
    if op.op == "aten.transpose":
        d0, d1 = (int(p.get("dim0", 0)), int(p.get("dim1", 0)))
        if rank and d0 % rank != d1 % rank and (
                op_walk.innermost_dim(d0, rank) or op_walk.innermost_dim(d1, rank)):
            return f"transpose moves innermost dim (dims {d0}, {d1})"
        return ""
    if op.op == "aten.t" and rank == 2:
        return "transpose moves innermost dim (permutation [1, 0])"
    if op.op == "aten.flip":
        if any(op_walk.innermost_dim(int(d), rank) for d in p.get("dims", ())):
            return "flip walks the innermost dim backwards"
    return ""


def _burst_quote(op: op_walk.OpRecord, model: TransferModel) -> str:
    """Cycle inflation of per-element bursts vs one contiguous run."""
    if not op.outputs:
        return ""
    out = op.outputs[0]
    elems = 1
    for d in out.shape:
        elems *= d
    ebits = 8 * out.nbytes // max(elems, 1) if elems else 32
    contig = model.transaction_cycles(elems * ebits)
    scattered = elems * model.transaction_cycles(ebits)
    return (f"; burst model: {contig} cycles contiguous vs "
            f"{scattered} scattered ({scattered / max(contig, 1):.1f}x)")


def check_contiguity(case: KernelCase,
                     model: TransferModel = None) -> List[Finding]:
    model = model or TransferModel()
    findings = []
    for op in case.walk().ops:
        if not op.reads_derived:
            continue  # an on-chip temporary, not an off-chip stream
        reason = _innermost_violation(op)
        if reason:
            findings.append(Finding(
                rule="ACC102", severity="warning",
                location=f"{case.name}/entry",
                message=(f"non-contiguous innermost access: {op.op} #"
                         f"{op.index} — {reason}{_burst_quote(op, model)}"),
                pass_name=PASS_NAME))
    return findings


# ---------------------------------------------------------------------------
# ACC103: pack-width alignment
# ---------------------------------------------------------------------------

def check_pack_alignment(case: KernelCase) -> List[Finding]:
    findings = []
    bits, block = case.pack_bits, case.pack_block
    if bits:
        if 32 % bits != 0:
            findings.append(Finding(
                rule="ACC103", severity="error", location=case.name,
                message=(f"pack width {bits} does not tile the 32-bit "
                         "plane word — codes straddle word boundaries"),
                pass_name=PASS_NAME))
        if block and block % 32 != 0:
            findings.append(Finding(
                rule="ACC103", severity="error", location=case.name,
                message=(f"block {block} does not fill whole 32-bit plane "
                         "words (block % 32 != 0)"),
                pass_name=PASS_NAME))
    return findings


def check_data_types() -> List[Finding]:
    """Static ``DATA_TYPES`` container-width consistency (no walk)."""
    findings = []
    for name, (nbits, width) in sorted(DATA_TYPES.items()):
        want = padded_width(nbits)
        if width != want:
            findings.append(Finding(
                rule="ACC103", severity="error",
                location=f"core/packing.py:DATA_TYPES[{name}]",
                message=(f"container width {width} != padded_width({nbits})"
                         f" == {want}"),
                pass_name=PASS_NAME))
        if nbits > width:
            findings.append(Finding(
                rule="ACC103", severity="error",
                location=f"core/packing.py:DATA_TYPES[{name}]",
                message=f"nbits {nbits} exceeds container width {width}",
                pass_name=PASS_NAME))
    return findings


# ---------------------------------------------------------------------------
# pass driver
# ---------------------------------------------------------------------------

def run_pass(cases: Sequence[KernelCase] = None,
             device="cuda") -> List[Finding]:
    if cases is None:
        cases = builtin_cases(device)
    findings: List[Finding] = check_data_types()
    for case in cases:
        findings.extend(check_redundancy(case))
        findings.extend(check_contiguity(case))
        findings.extend(check_pack_alignment(case))
    return findings
