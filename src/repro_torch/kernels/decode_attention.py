"""One decode step's attention over the KV cache: the CUDA kernel and its plain version.

``kv_decode_attention`` launches the hand-written kernel of
``csrc/decode_attention.cu`` on CUDA tensors: it reads the packed cache's
codes and scales (or a bf16 / f32 cache's values) once, dequantizes them on
chip and attends, one launch a layer and step.  It is the redesign of the
kvpack dequant kernel (``repro/kernels/kvpack.py::_dequant_kernel``, ported
as ``kvpack.kv_dequant``) for the reference's decode softmax
(``repro.models.layers.decode_attention``), whose region the reference
deploys as the dequant fused into flash-decode.  On CPU tensors it runs the
plain version, ``kv_decode_attention_plain``: the dequant, the cast to the
compute dtype and the attention op by op (``attend_plain``), as the
single-device decode did before the kernel.  A CUDA tensor never takes the
plain version: the kernel runs or the call raises.

The function, for the query heads ``[q0, q0 + n)`` (head h reads KV head
h // G): K and V dequantized and rounded to the compute dtype (the cache's
own dtype at bits 16), q rounded to it, the scores ``q . k * hd ** -0.5``
in f32, masked to ``NEG_INF`` where a slot is not valid for ``pos``
(``valid_slots``), the softmax over every slot, its probabilities rounded to
the compute dtype where ``round_p``, and ``P . V`` in f32.  The kernel sums
in another order than the plain version (f32 within ~1e-6 of the largest
value, bf16 within the rounding of the tensor cores' sums).

The slots valid for a row's position form one interval (``valid_interval``),
and the kernel loads and walks only the tiles of ``TILE`` slots that meet it
(``walked_tiles``): a masked slot adds 0 to the softmax's sums and to P.V, so
the output is the one a walk of every slot gives, bit for bit.  A row with
no valid slot walks every slot, whose average both versions take.

Launches are counted in ``kv_decode_attention.launches``; the plain version
counts nothing.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from . import _build, kvpack

F32 = torch.float32
#: the reference's finite mask value
NEG_INF = -1e30
#: the kernel's head sizes and largest query group (the mma's 16 rows)
HEAD_DIMS, MAX_GROUP = (32, 64, 128), 16
#: slots a tile of the kernel's walk
TILE = 64

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
#: the launcher's argument types (``kv_decode_attention_launch``)
ARGTYPES = [_P, _I64, _I64] + [_P] * 6 + [_I] * 14 + [_F, _I, _P, _P, _P]


def _lib(bf16: bool) -> ctypes.CDLL:
    """The bf16 library (``decode_attention``: the tensor cores) or the f32
    one (``decode_attention_f32``), its launcher's argument types set."""
    lib = _build.load("decode_attention" if bf16 else "decode_attention_f32")
    lib.kv_decode_attention_launch.argtypes = ARGTYPES
    lib.kv_decode_attention_launch.restype = _I
    return lib


def valid_slots(pos: torch.Tensor, S: int, lo: int, s_all: int, window: int,
                ring: bool) -> torch.Tensor:
    """(B, S) the slots ``[lo, lo + S)`` of a cache of ``s_all`` slots that
    each row may read at its position ``pos`` (B,): causal, within the
    window, or, on a ring cache, the slots whose key position
    ``pos - ((pos - j) mod s_all)`` is not negative."""
    j = lo + torch.arange(S, device=pos.device)[None, :]    # (1, S)
    if ring:
        k_pos = pos[:, None] - torch.remainder(pos[:, None] - j, s_all)
        return k_pos >= 0
    valid = j <= pos[:, None]
    if window > 0:
        valid &= (pos[:, None] - j) < window
    return valid


def valid_interval(pos: torch.Tensor, S: int, lo: int, s_all: int, window: int,
                   ring: bool) -> tuple:
    """(a, b), each (B,) int64: the slots ``[a, b)`` of the block ``[lo, lo +
    S)`` (slot s is the cache's ``lo + s``) that ``valid_slots`` admits for
    each row's ``pos``, an interval for every mask: causal ``[0, pos]``,
    within the window ``[pos - window + 1, pos]``, on a ring of ``s_all``
    slots ``[0, min(pos, s_all - 1)]`` (a ring's block inside ``[0,
    s_all)``); ``a >= b`` where none is.  The kernel's ``valid_interval``
    (``csrc/decode_attention.cuh``) computes the same."""
    p = pos.long()
    if ring:
        g0, g1 = torch.zeros_like(p), p.clamp(max=s_all - 1)
    else:
        g0 = p - window + 1 if window > 0 else torch.full_like(p, lo)
        g1 = p
    return (g0 - lo).clamp(0, S), (g1 - lo + 1).clamp(0, S)


def read_interval(pos: torch.Tensor, S: int, lo: int, s_all: int, window: int,
                  ring: bool) -> tuple:
    """(a, b): the slots the kernel reads for each row, ``valid_interval``'s,
    or every slot ``[0, S)`` for a row with no valid slot (whose softmax
    averages them all)."""
    a, b = valid_interval(pos, S, lo, s_all, window, ring)
    empty = a >= b
    return a.masked_fill(empty, 0), b.masked_fill(empty, S)


def slots_read(pos: torch.Tensor, S: int, lo: int, s_all: int, window: int,
               ring: bool) -> int:
    """The slots whose codes and scales the kernel loads, summed over the
    rows, a KV head's (``ops.kv_decode_attention_io_bytes``'s ``slots``)."""
    a, b = read_interval(pos, S, lo, s_all, window, ring)
    return int((b - a).sum())


def walked_tiles(pos: torch.Tensor, S: int, lo: int, s_all: int, window: int,
                 ring: bool, slots_per_cta: int) -> int:
    """The tiles the kernel walks, summed over the rows and the CTAs of a
    KV head's split (``plan``'s ``slots_per_cta``, a multiple of ``TILE``):
    in each CTA the tiles that meet the rows read (``read_interval``)."""
    a, b = read_interval(pos, S, lo, s_all, window, ring)
    total = 0
    for s_begin in range(0, S, slots_per_cta):
        nloc = min(S, s_begin + slots_per_cta) - s_begin
        ca, cb = (a - s_begin).clamp(min=0), (b - s_begin).clamp(max=nloc)
        t = (cb + TILE - 1) // TILE - ca // TILE
        total += int(torch.where(ca < cb, t, torch.zeros_like(t)).sum())
    return total


def tiles_allocated(batch: int, S: int, kv_heads: int) -> int:
    """The tiles of every slot the kernel's CTAs hold in one launch: the
    most it walks."""
    return batch * kv_heads * -(-S // TILE)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
                 G: int, valid: Optional[torch.Tensor] = None,
                 round_p: bool = True,
                 all_max: Optional[Callable] = None,
                 all_sum: Optional[Callable] = None) -> torch.Tensor:
    """One query a row against cached keys: q (B, 1, n, hd) the query heads
    ``[q0, q0 + n)`` of ``G`` a KV head, k and v (B, S, KV, hd) every KV
    head, ``valid`` (B, S) the slots each row may read (``None``: all).

    The reference's decode softmax: the scores in f32, the probabilities
    rounded to the cache's dtype before P·V where ``round_p``.  With
    ``all_max`` and ``all_sum`` (each rank holding a block of the slots) the
    softmax is taken over the slots of every rank: the scores' max and the
    sum of their exponentials combined by them before the probabilities are
    formed, and P·V's partial sums by ``all_sum``.  -> o (B, 1, n * hd) f32.
    """
    B, _, n, hd = q.shape
    k0, k1 = q0 // G, (q0 + n - 1) // G + 1
    if (q0 % G == 0 and n % G == 0) or k1 - k0 == 1:
        k, v = k[:, :, k0:k1], v[:, :, k0:k1]
    else:   # a head cut between KV heads' groups: one KV head a query head
        idx = torch.tensor([h // G for h in range(q0, q0 + n)], device=q.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    qg = q.reshape(B, 1, k.shape[2], -1, hd).to(k.dtype)   # (B,1,KV,G,D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(F32), k.to(F32)) * (hd ** -0.5)
    if valid is not None:
        s = torch.where(valid[:, None, None, None, :], s,
                        torch.full_like(s, NEG_INF))
    if all_max is None:
        p_attn = torch.softmax(s, dim=-1)
    else:
        m = all_max(s.amax(dim=-1, keepdim=True))
        e = torch.exp(s - m)
        p_attn = e / all_sum(e.sum(dim=-1, keepdim=True))
    if round_p:
        p_attn = p_attn.to(k.dtype)
    o = torch.einsum("bkgqs,bskd->bkgqd", p_attn.to(F32), v.to(F32))
    if all_sum is not None:
        o = all_sum(o)
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, n * hd)  # (B,KV,G,1,D) ->


def dequant_rows(codes: torch.Tensor, scale: torch.Tensor, bits: int,
                 dequant: Callable = kvpack.kv_dequant_plain) -> torch.Tensor:
    """A packed cache (B, S, KV, cd) with its scales as f32 (B, S, KV, hd),
    row by row through ``dequant`` (the plain version, or a wrapper)."""
    out = dequant(codes.reshape(-1, codes.shape[-1]), scale.reshape(-1, 1), bits)
    return out.reshape(*codes.shape[:-1], out.shape[-1])


def kv_decode_attention_plain(q: torch.Tensor, cache: Sequence, pos: torch.Tensor,
                              bits: int, q0: int, G: int, lo: int = 0,
                              s_all: Optional[int] = None, window: int = 0,
                              ring: bool = False, round_p: bool = True,
                              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain ``kv_decode_attention``: the cache dequantized (``kv_dequant``'s
    plain version) and cast to ``dtype`` (the cache's own values at bits
    16), the validity mask of ``pos``, then ``attend_plain``."""
    ck, cv, ks, vs = cache
    dtype = q.dtype if dtype is None else dtype
    if bits == 16:
        k, v = ck, cv
    else:
        k = dequant_rows(ck, ks, bits).to(dtype)
        v = dequant_rows(cv, vs, bits).to(dtype)
    S = ck.shape[1]
    valid = valid_slots(pos, S, lo, S if s_all is None else s_all, window, ring)
    return attend_plain(q, k, v, q0, G, valid, round_p)


def compute_dtype(cache: Sequence, bits: int,
                  dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype K, V, q and (where rounded) P take: the cache's own at bits
    16, else ``dtype``."""
    return cache[0].dtype if bits == 16 else dtype


def _check(q, cache, pos, bits, q0, G, dtype) -> None:
    if bits not in (16, 8, 4):
        raise ValueError(f"bits must be 16, 8 or 4, got {bits}")
    if q.dim() != 4 or q.shape[1] != 1 or 0 in q.shape:
        raise ValueError(f"kv_decode_attention wants q (B, 1, n, hd), got "
                         f"{tuple(q.shape)}")
    B, _, n, hd = q.shape
    ck, cv, ks, vs = cache
    if ck.dim() != 4 or cv.shape != ck.shape or ck.shape[0] != B or ck.shape[1] == 0:
        raise ValueError(f"kv_decode_attention wants k, v (B={B}, S > 0, KV, cd), "
                         f"got {tuple(ck.shape)}, {tuple(cv.shape)}")
    _, S, KV, cd = ck.shape
    want_cd = hd if bits in (16, 8) else hd // 2
    if cd != want_cd or (bits == 4 and hd % 2):
        raise ValueError(f"a bits-{bits} cache of hd {hd} has rows of {want_cd}, "
                         f"got {cd}")
    if bits == 16:
        if ck.dtype not in (F32, torch.bfloat16) or cv.dtype != ck.dtype:
            raise ValueError(f"a bits-16 cache is f32 or bf16, got {ck.dtype}, "
                             f"{cv.dtype}")
    else:
        if ck.dtype != torch.int8 or cv.dtype != torch.int8:
            raise ValueError(f"a packed cache holds int8 codes, got {ck.dtype}, "
                             f"{cv.dtype}")
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            if t is None or t.dtype != F32 or tuple(t.shape) != (B, S, KV, 1):
                raise ValueError(f"kv_decode_attention wants {name} f32 "
                                 f"{(B, S, KV, 1)}, got "
                                 f"{None if t is None else (t.dtype, tuple(t.shape))}")
        if dtype not in (F32, torch.bfloat16):
            raise ValueError(f"the compute dtype is f32 or bf16, got {dtype}")
    if q.dtype not in (F32, torch.bfloat16):
        raise ValueError(f"q is f32 or bf16, got {q.dtype}")
    if pos.dim() != 1 or pos.shape[0] != B or pos.dtype not in (torch.int32,
                                                                torch.int64):
        raise ValueError(f"kv_decode_attention wants integer pos ({B},), got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if G < 1 or q0 < 0 or q0 + n > KV * G:
        raise ValueError(f"query heads [{q0}, {q0 + n}) at G = {G} read KV heads "
                         f"past the cache's {KV}")
    devices = {t.device for t in (q, pos, *[t for t in cache if t is not None])}
    if len(devices) != 1:
        raise ValueError(f"kv_decode_attention got tensors on "
                         f"{sorted(map(str, devices))}")


def _check_kernel(q, cache, pos, bits, G, ct, round_p, lo=0, s_all=None,
                  ring=False) -> None:
    """What the kernel takes beyond the function's own checks."""
    hd = q.shape[3]
    S = cache[0].shape[1]
    if ring and (lo < 0 or lo + S > (S if s_all is None else s_all)):
        raise ValueError(f"the decode attention kernel reads a ring's slots "
                         f"[{lo}, {lo + S}) inside its {s_all}: there the valid "
                         f"slots form one interval")
    if ct == torch.bfloat16 and not round_p:
        raise ValueError("the decode attention kernel keeps probabilities in "
                         "f32 (round_p=False) in f32 only: bf16 runs on the "
                         "tensor cores, which take P in bf16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the decode attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if min(G, q.shape[2]) > MAX_GROUP:
        raise ValueError(f"the decode attention kernel serves at most "
                         f"{MAX_GROUP} query heads a KV head, got G = {G}")
    if pos.dtype != torch.int32:
        raise ValueError(f"the decode attention kernel reads int32 pos, got "
                         f"{pos.dtype}")
    if q.stride(3) != 1:
        raise ValueError("the decode attention kernel reads q with hd contiguous")
    for t in cache:
        if t is not None and not t.is_contiguous():
            raise ValueError("the decode attention kernel reads a contiguous cache")
    if cache[0].data_ptr() % 16 or cache[1].data_ptr() % 16:
        raise ValueError("the decode attention kernel's cache rows must start "
                         "on a 16-byte boundary (cp.async of 16 bytes)")


def _call(q, cache, pos, bits, q0, G, lo, s_all, window, ring, round_p, ct,
          out, tiles_walked=None) -> list:
    """The launcher's call (``out`` None: the plan only) -> [split, shared
    memory bytes, slots a CTA]; raises on a refused launch."""
    B, _, n, hd = q.shape
    ck, cv, ks, vs = cache
    S, KV = ck.shape[1], ck.shape[2]
    code = {8: 0, 4: 1}.get(bits, 2 if ck.dtype == torch.bfloat16 else 3)
    plan = (ctypes.c_int * 3)()
    lib = _lib(ct == torch.bfloat16)
    err = lib.kv_decode_attention_launch(
        q.data_ptr(), q.stride(0), q.stride(2), ck.data_ptr(), cv.data_ptr(),
        0 if ks is None else ks.data_ptr(), 0 if vs is None else vs.data_ptr(),
        pos.data_ptr(), None if out is None else out.data_ptr(), code,
        int(ct == torch.bfloat16), int(round_p), B, S, KV, G, hd, q0, n, lo,
        s_all, window, int(ring), hd ** -0.5, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.addressof(plan),
        None if tiles_walked is None else tiles_walked.data_ptr())
    if err == -1:
        raise ValueError(f"kv_decode_attention: the scores of {min(G, n)} query "
                         f"heads over {S} slots do not fit a cluster of 8 CTAs")
    _build.check(lib, err, "decode_attention.kv_decode_attention")
    return list(plan)


def plan(q, cache, pos, bits, q0, G, round_p=True, dtype=None) -> dict:
    """The kernel's launch plan for these inputs (CUDA tensors): the CTAs a
    (row, KV head) splits its slots over, their shared memory and slots."""
    ct = compute_dtype(cache, bits, q.dtype if dtype is None else dtype)
    S = cache[0].shape[1]
    split, smem, sc = _call(q, cache, pos, bits, q0, G, 0, S, 0, False,
                            round_p, ct, None)
    return {"split": split, "smem_bytes": smem, "slots_per_cta": sc}


def kv_decode_attention(q: torch.Tensor, cache: Sequence, pos: torch.Tensor,
                        bits: int, q0: int, G: int, lo: int = 0,
                        s_all: Optional[int] = None, window: int = 0,
                        ring: bool = False, round_p: bool = True,
                        dtype: Optional[torch.dtype] = None,
                        tiles_walked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, 1, n, hd), the query heads ``[q0, q0 + n)`` of ``G`` a KV head,
    against ``cache`` = (k, v, k_scale, v_scale): at bits 16 the f32 / bf16
    values (B, S, KV, hd) and no scales, at bits 8 / 4 int8 codes (B, S, KV,
    hd or hd / 2) and f32 scales (B, S, KV, 1); ``pos`` (B,) each row's
    position, the cache's slots ``[lo, lo + S)`` of ``s_all`` (default S),
    ``window`` and ``ring`` as in ``valid_slots``; ``dtype`` the compute
    dtype of a packed cache (default q's); ``tiles_walked`` (an int64 (1,)
    tensor on q's card, or None) gets the tiles the kernel walks added.
    -> o (B, 1, n * hd) f32."""
    dtype = q.dtype if dtype is None else dtype
    _check(q, cache, pos, bits, q0, G, dtype)
    s_all = cache[0].shape[1] if s_all is None else s_all
    if q.device.type == "cpu":
        return kv_decode_attention_plain(q, cache, pos, bits, q0, G, lo, s_all,
                                         window, ring, round_p, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    ct = compute_dtype(cache, bits, dtype)
    _check_kernel(q, cache, pos, bits, G, ct, round_p, lo, s_all, ring)
    if tiles_walked is not None and (tiles_walked.dtype != torch.int64
                                     or tiles_walked.device != q.device):
        raise ValueError(f"tiles_walked is an int64 tensor on {q.device}, got "
                         f"{tiles_walked.dtype} on {tiles_walked.device}")
    q = q.to(ct)
    B, _, n, hd = q.shape
    out = torch.empty((B, 1, n, hd), dtype=F32, device=q.device)
    _call(q, cache, pos, bits, q0, G, lo, s_all, window, ring, round_p, ct, out,
          tiles_walked)
    kv_decode_attention.launches += 1
    return out.reshape(B, 1, n * hd)


kv_decode_attention.launches = 0
