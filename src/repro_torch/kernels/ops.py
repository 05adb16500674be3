"""Public entry points of the port's kernels (port of ``repro.kernels.ops``).

``backend`` chooses the implementation:

* ``"auto"`` (default): the CUDA kernel for a CUDA tensor and nothing else
  (a failed build or launch raises); the plain PyTorch version for a CPU
  tensor;
* ``"cuda"``: the CUDA kernel; raises for a tensor that is not on a GPU;
* ``"ref"``: the plain PyTorch version, on the tensor's own device.

Every entry point is a host-side wrapper that publishes per-kernel
``repro_torch.obs`` series under the reference's names:
``kernels/hbm_bytes{kernel=,dir=}`` and ``kernels/beats{kernel=,dir=}``
computed analytically from the operand shapes (read every input once,
write every output once), ``kernels/calls`` counting invocations, and a
``kernels/<name>`` span around the dispatch (host time: the launch is
asynchronous).  The ``mode`` label is ``cuda`` or ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.obs import instrument as obs

from . import bitplane, jacobi_mars

#: analytic HBM transaction beat, bytes (256-bit bus word) — the logical
#: unit ``kernels/beats`` counts; deterministic, not a measured quantity
BEAT_BYTES = 32

BACKENDS = ("auto", "cuda", "ref")

#: the kernel wrappers, whose ``launches`` counts show what a run launched
KERNELS = {
    "bitplane.pack": bitplane.pack,
    "bitplane.unpack": bitplane.unpack,
    "jacobi_mars.jacobi_chunked": jacobi_mars.jacobi_chunked,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# Analytic I/O models (read every input once, write every output once),
# copies of the reference's.
# ---------------------------------------------------------------------------

def pack_io_bytes(n: int, block: int, bits: int):
    """(read, write) bytes for pack_codes: s32 codes -> u32 bitplanes."""
    return n * block * 4, n * (block // 32 * bits) * 4


def unpack_io_bytes(n: int, block: int, bits: int):
    """(read, write) bytes for unpack_codes (pack's mirror)."""
    w, r = pack_io_bytes(n, block, bits)
    return r, w


def jacobi_io_bytes(n: int):
    """(read, write) bytes for jacobi1d: each f32 cell read/written once."""
    return n * 4, n * 4


def _mode(backend: str, t: torch.Tensor) -> str:
    """'cuda' or 'ref' for this backend and tensor; raises where none fits."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "ref":
        return "ref"
    if t.device.type == "cuda":
        return "cuda"
    if backend == "cuda":
        raise RuntimeError(f"backend='cuda' needs a CUDA tensor, got one on "
                           f"{t.device}")
    return "ref"


def _record(kernel: str, mode: str, read_bytes: int, write_bytes: int,
            **labels) -> None:
    """Publish the analytic traffic of one kernel dispatch (host side)."""
    if not obs.enabled():
        return
    obs.counter_inc("kernels/calls", 1, kernel=kernel, mode=mode, **labels)
    for d, nbytes in (("read", read_bytes), ("write", write_bytes)):
        obs.counter_inc("kernels/hbm_bytes", int(nbytes), kernel=kernel,
                        mode=mode, dir=d, **labels)
        obs.counter_inc("kernels/beats", -(-int(nbytes) // BEAT_BYTES),
                        kernel=kernel, mode=mode, dir=d, **labels)


# ---------------------------------------------------------------------------
# delta+bitplane codec
# ---------------------------------------------------------------------------

def pack_codes(q: torch.Tensor, bits: int, backend: str = "auto") -> torch.Tensor:
    """int32 codes [N, block] -> uint32 planes [N, block//32*bits]."""
    n, block = q.shape
    m = _mode(backend, q)
    with obs.span("kernels/pack", mode=m, bits=bits):
        if m == "ref":
            out = bitplane.pack_plain(q, bits)
        else:
            out = bitplane.pack(q, bits)
    _record("pack", m, *pack_io_bytes(n, block, bits), bits=bits)
    return out


def unpack_codes(planes: torch.Tensor, bits: int, block: int,
                 backend: str = "auto") -> torch.Tensor:
    """uint32 planes [N, block//32*bits] -> int32 codes [N, block]."""
    m = _mode(backend, planes)
    with obs.span("kernels/unpack", mode=m, bits=bits):
        if m == "ref":
            out = bitplane.unpack_plain(planes, bits, block)
        else:
            out = bitplane.unpack(planes, bits, block)
    _record("unpack", m, *unpack_io_bytes(planes.shape[0], block, bits),
            bits=bits)
    return out


# ---------------------------------------------------------------------------
# Chunked jacobi (stencil macro-pipeline)
# ---------------------------------------------------------------------------

def pad_chunked(x: torch.Tensor, t_steps: int, width: int) -> torch.Tensor:
    """The padded f32 domain the chunked pass of jacobi1d_tiled runs over."""
    if not t_steps < width - 2:
        raise ValueError(f"carry depth must fit one chunk: "
                         f"t_steps={t_steps}, width={width}")
    pad_right = (-(x.shape[0] + width + t_steps)) % width + t_steps
    xf = x.to(torch.float32)
    return torch.cat([xf[:1].expand(width), xf, xf[-1:].expand(pad_right)])


def jacobi1d_tiled(x: torch.Tensor, t_steps: int, width: int = 512,
                   backend: str = "auto") -> torch.Tensor:
    """T jacobi steps (edge-padded open-boundary contract), chunked execution.

    The chunked pass runs over a padded domain: one full ghost chunk of x[0]
    on the left (so the first real chunk's carry is exact — the frozen
    far-left carry sits > width-T cells from any real cell) and edge padding
    of x[-1] on the right.  Output block c of the skewed buffer holds cells
    [cW - T, (c+1)W - T) of the padded domain; real cell m lives at
    ybuf[m + width + T].  Both backends take this same pad -> chunked ->
    unskew path; only the chunked pass differs.

    HBM accounting charges the irredundant scheme: each cell is read once
    and written once per pass regardless of T, the carry riding in shared
    memory.
    """
    m = _mode(backend, x)
    n = x.shape[0]
    with obs.span("kernels/jacobi1d", mode=m, t_steps=t_steps, width=width):
        xp = pad_chunked(x, t_steps, width)
        if m == "ref":
            ybuf = jacobi_mars.jacobi_chunked_plain(xp, t_steps, width)
        else:
            ybuf = jacobi_mars.jacobi_chunked(xp, t_steps, width)
        out = ybuf[width + t_steps: width + t_steps + n]
    _record("jacobi1d", m, *jacobi_io_bytes(n), t_steps=t_steps)
    return out
