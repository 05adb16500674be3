"""GQA flash attention, forward and backward: the CUDA kernels and their plain versions.

Three wrappers, each replacing a Pallas kernel of
``repro/kernels/flash_attention.py``:

* ``flash_fwd`` (``_fwd_kernel``) -> (o, lse);
* ``flash_bwd_dkv`` (``_bwd_dkv_kernel``) -> (dk, dv);
* ``flash_bwd_dq`` (``_bwd_dq_kernel``) -> dq.

On CUDA tensors each launches a kernel chosen by dtype: bf16 runs on the
tensor cores (``csrc/flash_attention_sm90.cu``: wgmma fed by a TMA ring),
f32 on the CUDA cores (``csrc/flash_attention.cu``).  This is a dispatch,
not a fallback: a failed build or launch raises.  On CPU tensors each runs
the plain PyTorch version (``flash_attention_plain``, ``flash_bwd_plain``),
and a CUDA tensor never takes it.  Launches are counted in
``<wrapper>.launches``, whatever kernel ran.  The wrappers are not
differentiable themselves: ``FlashAttentionFn`` (the port of the
reference's ``jax.custom_vjp``) runs ``flash_fwd`` forward and
``flash_bwd`` (both backward kernels) backward, and ``flash_attention``
routes an input that requires grad through it.

Layout as in the reference: q ``(B, S, KV, G, D)`` (grouped GQA, no repeated
kv heads), k / v ``(B, Sk, KV, D)``; o in q's dtype, lse f32
``(B, KV, G, S)``.  Masks: causal and sliding window, positions counted from
0 on both sides.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: the finite mask value of the reference: -inf would turn the softmax of a
#: fully masked key block into NaN
NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib(bf16: bool = False) -> ctypes.CDLL:
    """The f32 library (``flash_attention``), or with ``bf16`` the tensor-core
    one (``flash_attention_sm90``); each launcher's argument types set."""
    if bf16:
        lib = _build.load("flash_attention_sm90")
        lib.flash_fwd_sm90_launch.argtypes = [_P] * 5 + [_I] * 8 + [_F, _I, _P]
        lib.flash_bwd_dkv_sm90_launch.argtypes = [_P] * 8 + [_I] * 8 + [_F, _I, _P]
        lib.flash_bwd_dq_sm90_launch.argtypes = [_P] * 7 + [_I] * 8 + [_F, _I, _P]
        lib.flash_fwd_sm90_launch.restype = lib.flash_bwd_dkv_sm90_launch.restype = _I
        lib.flash_bwd_dq_sm90_launch.restype = _I
        return lib
    lib = _build.load("flash_attention")
    lib.flash_fwd_launch.argtypes = [_P] * 5 + [_I] * 8 + [_F, _I, _P]
    lib.flash_bwd_dkv_launch.argtypes = [_P] * 8 + [_I] * 8 + [_F, _I, _P]
    lib.flash_bwd_dq_launch.argtypes = [_P] * 7 + [_I] * 8 + [_F, _I, _P]
    lib.flash_fwd_launch.restype = lib.flash_bwd_dkv_launch.restype = _I
    lib.flash_bwd_dq_launch.restype = _I
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention wants q (B,S,KV,G,D) and k, v "
                         f"(B,Sk,KV,D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, KV, G, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, KV, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share f32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    if min(S, k.shape[1], B, KV, G, D) < 1:
        raise ValueError(f"empty attention problem: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def _check_kernel(q: torch.Tensor, k: torch.Tensor) -> None:
    """The limits of the CUDA kernels' grids and tiles; bf16 rows are read by
    TMA, whose row strides must be multiples of 16 bytes (D % 8 == 0)."""
    B, S, KV, G, D = q.shape
    if D > 128 or max(-(-S // 64), -(-k.shape[1] // 64)) > 65535 or \
            B * KV * G >= 2 ** 31:
        raise ValueError(f"flash kernels take D <= 128, S, Sk <= 65535 * 64 "
                         f"and B*KV*G < 2^31; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype == torch.bfloat16 and D % 8:
        raise ValueError(f"bf16 flash kernels take D % 8 == 0, got D = {D}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA's rule): a view at
    an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mask(S: int, Sk: int, causal: bool, window: int,
          device: torch.device) -> torch.Tensor:
    """(S, Sk) bool, True where query s may attend to key t."""
    s = torch.arange(S, device=device)[:, None]
    t = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= s >= t
    if window > 0:
        m &= (s - t) < window
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0):
    """Plain version: a direct f32 masked softmax -> (o, lse).

    Masked scores are the finite ``NEG_INF``, so a row with no key left
    averages v uniformly, as the reference's online softmax does.
    """
    _check(q, k, v)
    D = q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * D ** -0.5
    allowed = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / l[..., None]
    return o.permute(0, 3, 1, 2, 4).to(q.dtype), m + torch.log(l)


def _bwd_plain(q, k, v, do, lse, delta, causal: bool, window: int):
    """The backward by formula, in f32, from ``delta`` (B, KV, G, S)."""
    D = q.shape[-1]
    scale = D ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    allowed = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    p = torch.where(allowed, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """sum(o * do) over D, f32 (B, KV, G, S), as the reference computes it
    outside its kernels (flash_attention.py:205-206)."""
    if o.shape != do.shape or o.dim() != 5:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"both be (B, S, KV, G, D)")
    return (o.float() * do.float()).sum(-1).permute(0, 2, 3, 1).contiguous()


def _bwd_args(q, k, v, do, lse, delta):
    """Checked, contiguous backward operands; do in q's dtype (the kernels
    read one element type)."""
    _check(q, k, v)
    B, S, KV, G, _ = q.shape
    if do.shape != q.shape or tuple(lse.shape) != (B, KV, G, S) or \
            tuple(delta.shape) != (B, KV, G, S):
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)} do not match q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"lse and delta must be f32, got {lse.dtype}, "
                         f"{delta.dtype}")
    if not (do.device == lse.device == delta.device == q.device):
        raise ValueError(f"q, do, lse, delta on {q.device}, {do.device}, "
                         f"{lse.device}, {delta.device}")
    return (q.contiguous(), k.contiguous(), v.contiguous(),
            do.to(q.dtype).contiguous(), lse.contiguous(), delta.contiguous())


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool = True, window: int = 0):
    """Plain version of the backward: (dq, dk, dv) written out by formula.

    p is recomputed from the forward's lse and is 0 where the mask is
    False, so a query row with no allowed key gets a zero gradient, as in
    the reference's ``where(mask, ..., 0)``.  All arithmetic in f32; each
    gradient comes back in its input's dtype.
    """
    with torch.no_grad():
        return _bwd_plain(*_bwd_args(q, k, v, do, lse, bwd_delta(o, do)),
                          causal, window)


def _launch(what: str, bf16: bool, *args) -> None:
    """Call ``<what>_launch`` of the f32 library, or ``<what>_sm90_launch``
    of the tensor-core one when ``bf16``; raise on a CUDA error."""
    lib = _lib(bf16)
    name = f"{what}_sm90" if bf16 else what
    _build.check(lib, getattr(lib, f"{name}_launch")(*args),
                 f"flash_attention.{name}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0, bq: int = 128,
              bk: int = 128):
    """q (B,S,KV,G,D), k/v (B,Sk,KV,D) -> (o like q, lse f32 (B,KV,G,S)).

    ``bq`` and ``bk`` are the reference's block sizes; they are checked and
    otherwise not used: the kernels tile by their own sizes (f32: 64 queries
    by 64 keys; bf16: 128 by 128) and mask a ragged last tile themselves.
    The outputs carry no autograd graph (``FlashAttentionFn`` differentiates).
    """
    _check(q, k, v)
    if bq < 1 or bk < 1:
        raise ValueError(f"block sizes must be positive, got bq={bq}, bk={bk}")
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_plain(q, k, v, causal, window)
    _check_kernel(q, k)
    B, S, KV, G, D = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.dtype == torch.bfloat16,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, k.shape[1], KV, G, D, int(bool(causal)),
            int(window), D ** -0.5, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = True, window: int = 0):
    """-> (dk, dv) like k: one kernel launch on CUDA tensors.

    ``lse`` is the forward's, ``delta`` = sum(o * do) over D, both f32
    (B, KV, G, S).
    """
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        with torch.no_grad():
            return _bwd_plain(q, k, v, do, lse, delta, causal, window)[1:]
    _check_kernel(q, k)
    B, S, KV, G, D = q.shape
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", q.dtype == torch.bfloat16,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, k.shape[1], KV, G, D, int(bool(causal)), int(window),
            D ** -0.5, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """-> dq like q: one kernel launch on CUDA tensors (arguments as
    ``flash_bwd_dkv``)."""
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        with torch.no_grad():
            return _bwd_plain(q, k, v, do, lse, delta, causal, window)[0]
    _check_kernel(q, k)
    B, S, KV, G, D = q.shape
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q.dtype == torch.bfloat16,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, k.shape[1],
            KV, G, D, int(bool(causal)), int(window), D ** -0.5,
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True, window: int = 0):
    """The backward of ``flash_fwd``: (dq, dk, dv), each like its input.

    ``delta`` = sum(o * do) is computed here with plain torch ops, as the
    reference computes it outside Pallas; then the dK/dV kernel and the dQ
    kernel run (their plain versions on CPU tensors).
    """
    delta = bwd_delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, window)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, window)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """o = attention(q, k, v): ``flash_fwd`` forward, ``flash_bwd`` backward.

    The port of the reference's ``jax.custom_vjp`` (flash_attention.py:265-286):
    the forward saves (q, k, v, o, lse), the backward recomputes p from lse.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q (B,S,KV,G,D); k, v (B,Sk,KV,D) -> o (B,S,KV,G,D).

    Differentiable: with grad enabled and an input that requires grad, the
    call goes through ``FlashAttentionFn`` (the backward kernels run in
    ``backward``); otherwise it is ``flash_fwd``'s o.
    """
    if bq < 1 or bk < 1:
        raise ValueError(f"block sizes must be positive, got bq={bq}, bk={bk}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window))
    return flash_fwd(q, k, v, causal, window)[0]
