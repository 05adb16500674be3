"""GQA flash attention, forward: the CUDA kernel and its plain version.

``flash_fwd`` launches the hand-written kernel of ``csrc/flash_attention.cu``
(which replaces the Pallas kernel
``repro/kernels/flash_attention.py::_fwd_kernel``) on CUDA tensors and runs
the plain PyTorch version ``flash_attention_plain`` on CPU tensors.  A CUDA
tensor never takes the plain version: the kernel runs or the call raises.
Launches are counted in ``flash_fwd.launches``.

Layout as in the reference: q ``(B, S, KV, G, D)`` (grouped GQA, no repeated
kv heads), k / v ``(B, Sk, KV, D)``; o in q's dtype, lse f32
``(B, KV, G, S)``.  Masks: causal and sliding window, positions counted from
0 on both sides.  Forward only: the backward kernels and the
``torch.autograd.Function`` that wraps all three come with the training
slice, so an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: the finite mask value of the reference: -inf would turn the softmax of a
#: fully masked key block into NaN
NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_fwd_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _F, _I, _P]
    lib.flash_fwd_launch.restype = _I
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
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash attention is forward only in this port: its "
                           "backward kernels come with the training slice")


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


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0, bq: int = 128,
              bk: int = 128):
    """q (B,S,KV,G,D), k/v (B,Sk,KV,D) -> (o like q, lse f32 (B,KV,G,S)).

    ``bq`` and ``bk`` are the reference's block sizes; they are checked and
    otherwise not used: the kernel tiles by 64 queries and 64 keys and masks
    a ragged last tile itself.
    """
    _check(q, k, v)
    if bq < 1 or bk < 1:
        raise ValueError(f"block sizes must be positive, got bq={bq}, bk={bk}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    B, S, KV, G, D = q.shape
    if D > 128 or -(-S // 64) > 65535 or B * KV * G >= 2 ** 31:
        raise ValueError(f"flash kernel takes D <= 128, S <= 65535 * 64 and "
                         f"B*KV*G < 2^31; got q {tuple(q.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), B, S, k.shape[1], KV, G, D,
        int(bool(causal)), int(window), D ** -0.5, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention.flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q (B,S,KV,G,D); k, v (B,Sk,KV,D) -> o (B,S,KV,G,D)."""
    return flash_fwd(q, k, v, causal, window, bq, bk)[0]
