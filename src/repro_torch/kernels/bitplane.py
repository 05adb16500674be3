"""Delta + bitplane pack / unpack: CUDA kernels and their plain versions.

``pack`` / ``unpack`` launch the hand-written kernels of ``csrc/bitplane.cu``
(which replace the Pallas kernels ``repro/kernels/bitplane.py::_pack_kernel``
and ``::_unpack_kernel``) on a CUDA tensor, and run the plain PyTorch
versions ``pack_plain`` / ``unpack_plain`` on a CPU tensor.  A CUDA tensor
never takes the plain version: the kernel runs or the call raises.

Each wrapper counts its kernel launches in ``pack.launches`` /
``unpack.launches``; the plain versions count nothing.

``launch_plan`` computes how the kernels cut the work: blocks of 256
threads, one 32-word group a thread, a tile of up to 256 consecutive groups
(whole rows, or a 256-group chunk of a longer row), a persistent grid of a
few blocks per SM, and the dynamic shared memory of the double buffer.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.core.blockcodec import GROUP

from . import _build, ref

#: plain PyTorch versions: the same function, used on the CPU and as the
#: oracle the kernels are held against on the card
pack_plain = ref.pack_ref
unpack_plain = ref.unpack_ref

#: 32-word groups of a tile: a block of 256 threads, one group a thread
TILE_GROUPS = 256
#: shared memory of an SM, and what a block may take (H100: 228 / 227 KB);
#: the launchers ask the card for what the plan gives a block
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233472, 232448, 1024
#: resident blocks an SM, as the kernels' ``__launch_bounds__`` promise
BLOCKS_PER_SM = 2
KINDS = ("pack", "unpack")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one pack or unpack launch cuts ``n`` rows of ``groups`` groups.

    A unit is ``rows_per_tile`` whole rows in one tile (``chunks == 1``) or
    one row longer than a tile, taken in ``chunks`` tiles of ``chunk``
    groups in order.  Block b of ``grid`` takes units b, b + grid, ...
    """
    n: int
    groups: int
    bits: int
    rows_per_tile: int
    chunk: int
    chunks: int
    units: int
    grid: int
    smem: int

    def tiles(self) -> Iterator[Tuple[int, int, int, int]]:
        """(block, first group, groups, chunk) of every tile, in the order
        each block takes them; groups are counted over the whole array, as
        the kernel's ``tile_of`` counts them."""
        for b in range(self.grid):
            for u in range(b, self.units, self.grid):
                if self.chunks == 1:
                    r0 = u * self.rows_per_tile
                    rows = min(self.rows_per_tile, self.n - r0)
                    yield b, r0 * self.groups, rows * self.groups, 0
                    continue
                for c in range(self.chunks):
                    g = c * self.chunk
                    yield (b, u * self.groups + g,
                           min(self.chunk, self.groups - g), c)


def smem_bytes(kind: str, bits: int) -> int:
    """Dynamic shared memory of a block: two input tiles and the staged
    output (pack: codes in, planes out, 4 words of alignment slack; unpack:
    planes in, codes out, and the scan's 268 words)."""
    codes = TILE_GROUPS * GROUP
    planes = TILE_GROUPS * bits + 4
    if kind == "pack":
        return 4 * (2 * codes + planes)
    return 4 * (2 * planes + codes + TILE_GROUPS + 12)


@functools.lru_cache(maxsize=256)
def launch_plan(kind: str, n: int, block: int, bits: int, sms: int) -> LaunchPlan:
    """The launch of ``kind`` ("pack" or "unpack") on [n, block] codes on a
    card of ``sms`` SMs."""
    _check_args(bits, block)
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if n < 1 or sms < 1:
        raise ValueError(f"bad plan request: n={n}, sms={sms}")
    groups = block // GROUP
    if groups <= TILE_GROUPS:
        rows, chunk, chunks = TILE_GROUPS // groups, groups, 1
        units = math.ceil(n / rows)
    else:
        rows, chunk, chunks = 1, TILE_GROUPS, math.ceil(groups / TILE_GROUPS)
        units = n
    smem = smem_bytes(kind, bits)
    fit = SMEM_PER_SM // (smem + SMEM_RESERVED)
    per_sm = max(1, min(BLOCKS_PER_SM, fit))
    return LaunchPlan(n, groups, bits, rows, chunk, chunks, units,
                      min(units, per_sm * sms), smem)


_SMS: Dict[int, int] = {}


def _sms(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bitplane")
    for fn in (lib.bitplane_pack_launch, lib.bitplane_unpack_launch):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check_args(bits: int, block: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in 1..32, got {bits}")
    if block <= 0 or block % GROUP:
        raise ValueError(f"block must be a positive multiple of {GROUP}, "
                         f"got {block}")


def _launch(kind: str, src: torch.Tensor, out: torch.Tensor, block: int,
            bits: int) -> None:
    """Launch ``kind``'s kernel on ``src`` -> ``out`` (contiguous, on one
    card, shaped as ``pack`` / ``unpack`` make them) on the current stream,
    as ``launch_plan`` cuts it; raise on a CUDA error."""
    dev, n = src.device, src.shape[0]
    if dev.type != "cuda" or out.device != dev:
        raise ValueError(f"launch wants both tensors on one card, got {dev} "
                         f"and {out.device}")
    lib = _lib()
    plan = launch_plan(kind, n, block, bits, _sms(dev.index))
    launcher = (lib.bitplane_pack_launch if kind == "pack"
                else lib.bitplane_unpack_launch)
    err = launcher(src.data_ptr(), out.data_ptr(), n, block, bits,
                   plan.rows_per_tile, plan.chunk, plan.chunks, plan.units,
                   plan.grid, plan.smem, dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"bitplane.{kind}")


def _device_ok(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for others."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 codes [N, block] -> uint32 planes [N, block//32*bits]."""
    if q.dim() != 2 or q.dtype != torch.int32:
        raise ValueError(f"pack wants int32 [N, block], got {q.dtype} "
                         f"{tuple(q.shape)}")
    n, block = q.shape
    _check_args(bits, block)
    if not _device_ok(q):
        return pack_plain(q, bits)
    q = q.contiguous()
    out = torch.empty((n, block // GROUP * bits), dtype=torch.uint32,
                      device=q.device)
    if n:
        _launch("pack", q, out, block, bits)
        pack.launches += 1
    return out


def unpack(planes: torch.Tensor, bits: int, block: int) -> torch.Tensor:
    """uint32 (or int32-viewed) planes [N, block//32*bits] -> int32 [N, block]."""
    _check_args(bits, block)
    if (planes.dim() != 2 or planes.dtype not in (torch.uint32, torch.int32)
            or planes.shape[1] != block // GROUP * bits):
        raise ValueError(f"unpack wants uint32 [N, {block // GROUP * bits}], "
                         f"got {planes.dtype} {tuple(planes.shape)}")
    if not _device_ok(planes):
        return unpack_plain(planes, bits, block)
    p = planes.contiguous()
    n = p.shape[0]
    out = torch.empty((n, block), dtype=torch.int32, device=p.device)
    if n:
        _launch("unpack", p, out, block, bits)
        unpack.launches += 1
    return out


pack.launches = 0
unpack.launches = 0
