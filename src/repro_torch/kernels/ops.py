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

from . import bitplane, decode_attention, flash_attention, jacobi_mars, kvpack

#: analytic HBM transaction beat, bytes (256-bit bus word) — the logical
#: unit ``kernels/beats`` counts; deterministic, not a measured quantity
BEAT_BYTES = 32

BACKENDS = ("auto", "cuda", "ref")

#: the kernel wrappers, whose ``launches`` counts show what a run launched
KERNELS = {
    "bitplane.pack": bitplane.pack,
    "bitplane.unpack": bitplane.unpack,
    "jacobi_mars.jacobi_chunked": jacobi_mars.jacobi_chunked,
    "kvpack.kv_quant": kvpack.kv_quant,
    "kvpack.kv_dequant": kvpack.kv_dequant,
    "kvpack.kv_quant_store": kvpack.kv_quant_store,
    "decode_attention.kv_decode_attention": decode_attention.kv_decode_attention,
    "flash_attention.flash_fwd": flash_attention.flash_fwd,
    "flash_attention.flash_bwd_dkv": flash_attention.flash_bwd_dkv,
    "flash_attention.flash_bwd_dq": flash_attention.flash_bwd_dq,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def take_back_launches(before: dict) -> dict:
    """The launches each wrapper counted since ``before`` (a
    ``launch_counts()``), its count set back to ``before``'s: what a CUDA
    graph's capture recorded, for ``add_launches`` at each replay (the
    capture itself launches nothing)."""
    counted = {name: n - before[name] for name, n in launch_counts().items()
               if n != before[name]}
    for name in counted:
        KERNELS[name].launches = before[name]
    return counted


def add_launches(counts: dict) -> None:
    """Each wrapper's ``launches`` raised by ``counts[name]`` (a replay)."""
    for name, n in counts.items():
        KERNELS[name].launches += n


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


def kv_quant_io_bytes(rows: int, d: int, bits: int, itemsize: int = 4):
    """(read, write) bytes for kv_quant: x -> (packed codes, f32 scales)."""
    cd = d if bits == 8 else d // 2
    return rows * d * itemsize, rows * cd + rows * 4


def kv_dequant_io_bytes(rows: int, d: int, bits: int):
    """(read, write) bytes for kv_dequant: (codes, scales) -> f32 values."""
    r, w = kv_quant_io_bytes(rows, d, bits)
    return w, rows * d * 4


def kv_quant_store_io_bytes(batch: int, kv_heads: int, d: int, bits: int,
                            itemsize: int = 4):
    """(read, write) bytes for kv_quant_store: the 2 B KV new K and V rows
    in, their codes and f32 scales written into the cache slot."""
    return kv_quant_io_bytes(2 * batch * kv_heads, d, bits, itemsize)


def kv_decode_attention_io_bytes(batch: int, s_cache: int, kv_heads: int,
                                 hd: int, heads: int, bits: int,
                                 q_itemsize: int = 2, cache_itemsize: int = 2,
                                 slots=None):
    """(read, write) bytes for kv_decode_attention: q (batch, heads, hd), the
    codes and f32 scales (or, at bits 16, the values) of the slots read of
    the ``kv_heads`` KV heads, K and V, and the int32 positions in; o
    (batch, heads, hd) f32 out.  ``slots``: the slots read summed over the
    rows (``decode_attention.slots_read``, which needs the positions on the
    host); by default every slot of every row, the most the kernel reads."""
    row = {8: hd, 4: hd // 2}.get(bits, hd * cache_itemsize)
    rows = 2 * kv_heads * (batch * s_cache if slots is None else slots)
    read = (batch * heads * hd * q_itemsize + rows * row
            + (rows * 4 if bits != 16 else 0) + batch * 4)
    return read, batch * heads * hd * 4


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
# KV block packing
# ---------------------------------------------------------------------------

def kv_quant(x: torch.Tensor, bits: int = 8, backend: str = "auto"):
    """[rows, d] f32/bf16 -> (codes int8 [rows, d or d/2], scales f32 [rows, 1])."""
    m = _mode(backend, x)
    with obs.span("kernels/kv_quant", mode=m, bits=bits):
        if m == "ref":
            out = kvpack.kv_quant_plain(x, bits)
        else:
            out = kvpack.kv_quant(x, bits)
    rows, d = x.shape
    _record("kv_quant", m, *kv_quant_io_bytes(rows, d, bits, x.element_size()),
            bits=bits)
    return out


def kv_dequant(codes: torch.Tensor, scales: torch.Tensor, bits: int = 8,
               backend: str = "auto") -> torch.Tensor:
    """(codes int8 [rows, cd], scales f32 [rows, 1]) -> f32 [rows, d]."""
    m = _mode(backend, codes)
    with obs.span("kernels/kv_dequant", mode=m, bits=bits):
        if m == "ref":
            out = kvpack.kv_dequant_plain(codes, scales, bits)
        else:
            out = kvpack.kv_dequant(codes, scales, bits)
    _record("kv_dequant", m,
            *kv_dequant_io_bytes(codes.shape[0], out.shape[-1], bits), bits=bits)
    return out


def kv_quant_store(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor, slot: torch.Tensor,
                   bits: int = 8, backend: str = "auto") -> None:
    """One decode step's write into the packed cache, in place: k_new, v_new
    (B, 1, KV, D) quantized per row and stored, codes and scales, at
    [b, clamp(slot[b], 0, S - 1)] of cache_k, cache_v (B, S, KV, D or D/2)
    and k_scale, v_scale (B, S, KV, 1).  The reference computes the same in
    ``repro.models.layers.update_cache`` (``_quant_rows``, then
    ``dynamic_update_slice``), which XLA fuses under jit."""
    m = _mode(backend, k_new)
    with obs.span("kernels/kv_quant_store", mode=m, bits=bits):
        if m == "ref":
            kvpack.kv_quant_store_plain(cache_k, cache_v, k_scale, v_scale,
                                        k_new, v_new, slot, bits)
        else:
            kvpack.kv_quant_store(cache_k, cache_v, k_scale, v_scale, k_new,
                                  v_new, slot, bits)
    B, _, KV, D = k_new.shape
    _record("kv_quant_store", m,
            *kv_quant_store_io_bytes(B, KV, D, bits, k_new.element_size()),
            bits=bits)


def kv_decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, bits: int,
                        q0: int, G: int, lo: int = 0, s_all=None, window: int = 0,
                        ring: bool = False, round_p: bool = True, dtype=None,
                        backend: str = "auto") -> torch.Tensor:
    """One decode step's attention over the cache (k, v, k_scale, v_scale):
    q (B, 1, n, hd), the query heads from ``q0``, ``G`` a KV head, against
    every slot valid for ``pos`` -> o (B, 1, n * hd) f32.  The reference
    computes it in ``repro.models.layers.decode_attention`` (the dequant,
    then the decode softmax), whose region it deploys as one fused kernel.
    The bytes charged are those of every slot of the KV heads the query
    heads read (the positions stay on the device).  Inside an
    ``obs.device_marks`` scope (obs on at a graph's capture) the kernel adds
    the tiles it walks into the scope's device counter
    ``kernels/kv_decode_attention/tiles_walked``, and the wrapper counts
    ``.../tiles_allocated``, the tiles of every slot, beside it."""
    m = _mode(backend, q)
    B, _, n, hd = q.shape
    kv_heads = (q0 + n - 1) // G - q0 // G + 1
    walked = None
    if m == "cuda":
        walked = obs.device_counter("kernels/kv_decode_attention/tiles_walked",
                                    q.device, bits=bits)
    with obs.span("kernels/kv_decode_attention", mode=m, bits=bits):
        if m == "ref":
            out = decode_attention.kv_decode_attention_plain(
                q, cache, pos, bits, q0, G, lo, s_all, window, ring, round_p, dtype)
        else:
            out = decode_attention.kv_decode_attention(
                q, cache, pos, bits, q0, G, lo, s_all, window, ring, round_p, dtype,
                walked)
    if walked is not None:
        obs.counter_inc("kernels/kv_decode_attention/tiles_allocated",
                        decode_attention.tiles_allocated(B, cache[0].shape[1],
                                                         kv_heads), bits=bits)
    _record("kv_decode_attention", m,
            *kv_decode_attention_io_bytes(
                B, cache[0].shape[1], kv_heads, hd, n, bits, q.element_size(),
                cache[0].element_size()), bits=bits)
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
    and written once per pass regardless of T; the kernel's carry (2 x T
    floats a tile) rides in shared memory, and in L2 between tiles.
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
