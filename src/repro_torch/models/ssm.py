"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060).

Port of ``repro.models.ssm``.  Chunked SSD: within a chunk of Q positions
the recurrence is computed in its dual quadratic (attention-like) form;
across chunks a compact f32 state (B, H, N, P) is carried.  The reference
scans the chunks with ``lax.scan``; here a Python loop walks the S // Q
chunks.  The (B, S, H, P) tensors stay in the activation dtype and are
upcast to f32 only inside a chunk, as in the reference.

Shapes: d_inner = expand * d_model, P = ssm_head, H = d_inner / P,
N = ssm_state.  B and C are shared across heads (one group).  A is a decay
per head; dt per head through softplus.  ``a_log``, ``dt_bias`` and
``d_skip`` are f32 whatever the model's dtype.  The reference has no
Pallas kernel for the scan or the causal conv; these are torch ops.

Under rules whose mesh has a ``model`` axis above 1 (``train.step``) the
reference's ``"tp"`` rules cut ``in_proj``'s packed ``[z | x | B | C |
dt]`` columns, the conv's channels and ``gate_norm`` / ``out_proj``'s di
rows, each where tp divides it and without regard to heads.
``ssd_forward`` then divides the work by heads (``_ssd_heads``): the
``in_proj`` product on the rank's columns is gathered whole over
``model`` (a whole ``in_proj`` is used as it is), the conv's weights are
gathered, and the rank runs the conv and the chunked scan on the heads
that cover its block of di rows (all of B and C, its heads' x and dt),
cuts the output back to its rows, takes the gated norm's mean over the
whole di through an all-reduce of its partial sums of squares over
``model`` and sums the out-projection's partial products with
``shd.tp_out_proj``, so that the output lands where the residual stream
lives.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.checkpoint.ckpt import Attrs
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from . import layers as L

F32 = torch.float32


class SsmParams(nn.Module):
    """in_proj (d, 2 di + 2 N + H), conv_w (K, di + 2 N), conv_b (di + 2 N,),
    a_log / dt_bias / d_skip (H,) f32, gate_norm (di,), out_proj (di, d)."""

    def __init__(self, in_proj, conv_w, conv_b, a_log, dt_bias, d_skip,
                 gate_norm, out_proj):
        super().__init__()
        for name, t in (("in_proj", in_proj), ("conv_w", conv_w),
                        ("conv_b", conv_b), ("a_log", a_log),
                        ("dt_bias", dt_bias), ("d_skip", d_skip),
                        ("gate_norm", gate_norm), ("out_proj", out_proj)):
            setattr(self, name, L._param(t))


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype) -> SsmParams:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv
    dev = gen.device

    def full(n, value, dt):
        return torch.full((n,), value, dtype=dt, device=dev)

    return SsmParams(
        in_proj=L._normal(gen, (d, 2 * di + 2 * N + H), d ** -0.5, dtype),
        conv_w=L._normal(gen, (K, di + 2 * N), K ** -0.5, dtype),
        conv_b=full(di + 2 * N, 0.0, dtype),
        a_log=torch.log(torch.linspace(1.0, 16.0, H, dtype=F32, device=dev)),
        dt_bias=full(H, -4.6, F32),            # softplus^-1(0.01)
        d_skip=full(H, 1.0, F32),
        gate_norm=full(di, 1.0, dtype),
        out_proj=L._normal(gen, (di, d), di ** -0.5, dtype),
    )


def ssm_specs() -> Attrs:
    return Attrs(in_proj=("fsdp", "tp"), conv_w=(None, "tp"), conv_b=("tp",),
                 a_log=(None,), dt_bias=(None,), d_skip=(None,),
                 gate_norm=("tp",), out_proj=("tp", "fsdp"))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|)),
    with no threshold, unlike ``torch.nn.functional.softplus``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + N], zxbcdt[..., 2 * di + N:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def _conv_sum(xp: torch.Tensor, w: torch.Tensor, S: int) -> torch.Tensor:
    """sum_i xp[:, i:i+S] * w[i], added in the order i = 0, 1, ... in the
    activation dtype, as the reference's Python ``sum`` (not ``conv1d``)."""
    y = xp[:, 0:S] * w[0]
    for i in range(1, w.shape[0]):
        y = y + xp[:, i:i + S] * w[i]
    return y


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S.  x: (B, S, C); w: (K, C).

    Returns (silu(y + b), new_state), where the state holds the last K - 1
    inputs (None when K = 1).
    """
    K, S = w.shape[0], x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return L.silu(_conv_sum(xp, w, S) + b), new_state


class _SsdHeads(NamedTuple):
    """Which SSD heads this rank runs."""
    rows: Optional[Tuple[int, int]]  # gate_norm / out_proj rows held (None: all)
    heads: Tuple[int, int]           # heads [start, stop) covering the rows


def _ssd_heads(cfg: ModelConfig) -> _SsdHeads:
    """This rank's share of the SSD under the rules: the heads that cover
    its block of ``gate_norm`` / ``out_proj``'s di rows (a head cut between
    two ranks is run on both), or every head where the rows are whole."""
    P = cfg.ssm_head
    rows = shd.tp_block("tp", cfg.d_inner)
    if rows is None:
        return _SsdHeads(None, (0, cfg.ssm_heads))
    return _SsdHeads(rows, (rows[0] // P, -(-(rows[0] + rows[1]) // P)))


def _whole(t: torch.Tensor, full: int, dim: int) -> torch.Tensor:
    """``t`` whole along ``dim`` (of ``full`` values): gathered over
    ``model`` where the ``"tp"`` rule cut it (the backward sums the ranks'
    gradients and keeps this rank's block), else itself."""
    if shd.tp_block("tp", full) is None:
        return t
    src = tuple("tp" if i == dim % t.dim() else None for i in range(t.dim()))
    return shd.act(t, *(None,) * t.dim(), src=src)


def _gated_norm(y: torch.Tensor, w: torch.Tensor, eps: float,
                full: int) -> torch.Tensor:
    """``layers.rmsnorm`` over the whole di from this rank's block of it:
    the f32 sum of squares all-reduced over ``model`` (a partial mean
    summed in another order than one device's: ~1e-7 relative in f32)."""
    yf = y.to(F32)
    ss = collectives.all_reduce(torch.sum(yf * yf, dim=-1, keepdim=True),
                                shd.model_group())
    return (yf * torch.rsqrt(ss / full + eps)).to(y.dtype) * w


def ssd_forward(params: SsmParams, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Training / prefill SSD.  x: (B, S, d), whole over ``model`` ->
    (B, S, d), where the residual stream lives (on one device: whole)."""
    B, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"SSD takes S a multiple of the chunk: S={S}, Q={Q}")
    plan = _ssd_heads(cfg)
    h0, h1 = plan.heads
    nh = h1 - h0

    z, xin, b, c, dt_raw = _split(_whole(x @ params.in_proj,
                                         2 * di + 2 * N + H, -1), cfg)
    conv_w = _whole(params.conv_w, di + 2 * N, 1)
    conv_b = _whole(params.conv_b, di + 2 * N, 0)
    dt_bias, a_log, d_skip = params.dt_bias, params.a_log, params.d_skip
    if nh < H:
        # this rank's heads: their x channels and dt, all of B and C
        xin, dt_raw = xin[..., h0 * P:h1 * P], dt_raw[..., h0:h1]
        conv_w = torch.cat([conv_w[:, h0 * P:h1 * P], conv_w[:, di:]], dim=-1)
        conv_b = torch.cat([conv_b[h0 * P:h1 * P], conv_b[di:]])
        dt_bias, a_log, d_skip = dt_bias[h0:h1], a_log[h0:h1], d_skip[h0:h1]
    xbc, _ = _causal_conv(torch.cat([xin, b, c], dim=-1), conv_w, conv_b)
    nx = nh * P
    xin, b, c = xbc[..., :nx], xbc[..., nx:nx + N], xbc[..., nx + N:]

    dt = softplus(dt_raw.to(F32) + dt_bias)                      # (B,S,nh)
    da = dt * -torch.exp(a_log)                                  # (B,S,nh) < 0
    adt = x.dtype
    xh = xin.reshape(B, S, nh, P)
    xdt = xh * dt[..., None].to(adt)

    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = torch.zeros((B, nh, N, P), dtype=F32, device=x.device)
    ys = []
    for lo in range(0, S, Q):
        da_n = da[:, lo:lo + Q]
        b_n, c_n = b[:, lo:lo + Q].to(F32), c[:, lo:lo + Q].to(F32)
        xdt_n = xdt[:, lo:lo + Q].to(F32)
        cs = torch.cumsum(da_n, dim=1)                           # (B,Q,nh)
        cb = torch.einsum("bim,bjm->bij", c_n, b_n)              # (B,Q,Q)
        # the exponent masked before exp: the reference takes exp of the
        # whole square and masks after, the same values, but its upper
        # triangle exp(cs_i - cs_j), i < j, overflows to inf once a chunk's
        # decay passes ~88, and the backward then multiplies 0 by inf (NaN
        # gradients: hymba-1.5b training on 4096-token sequences)
        decay = torch.exp(torch.where(tri[None, :, :, None],
                                      cs[:, :, None, :] - cs[:, None, :, :],
                                      -torch.inf))                # (B,Q,Q,nh)
        att = cb[..., None] * decay
        y_intra = torch.einsum("bijh,bjhp->bihp", att, xdt_n)
        y_inter = torch.einsum("bim,bhmp->bihp", c_n, h) * torch.exp(cs)[..., None]
        seg = torch.exp(cs[:, -1:, :] - cs)                      # (B,Q,nh)
        s_chunk = torch.einsum("bjm,bjhp->bhmp", b_n, xdt_n * seg[..., None])
        h = torch.exp(cs[:, -1, :])[:, :, None, None] * h + s_chunk
        ys.append((y_intra + y_inter).to(adt))
    y = torch.cat(ys, dim=1)                                     # (B,S,nh,P)
    y = y + d_skip.to(adt)[None, None, :, None] * xh
    y = y.reshape(B, S, nx).to(x.dtype)

    if plan.rows is None:
        y = L.rmsnorm(y * L.silu(z), params.gate_norm, cfg.norm_eps)
        return shd.act(y @ params.out_proj, "batch", "seq", None)
    r0, nr = plan.rows
    y = y[..., r0 - h0 * P:r0 - h0 * P + nr] * L.silu(z[..., r0:r0 + nr])
    y = _gated_norm(y, params.gate_norm, cfg.norm_eps, di)
    return shd.tp_out_proj(y, params.out_proj)


# ---------------------------------------------------------------------------
# Decode (recurrent form, O(1) per token)
# ---------------------------------------------------------------------------

class SsmState(NamedTuple):
    h: torch.Tensor       # (B, H, N, P) f32
    conv: torch.Tensor    # (B, K-1, di + 2N) f32


def init_ssm_state(cfg: ModelConfig, batch: int, device="cuda") -> SsmState:
    return SsmState(
        h=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head),
                      dtype=F32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_state), dtype=F32,
                         device=device))


def ssm_state_specs() -> Attrs:
    """Logical axes of an ``SsmState``, the reference's tree: split over
    the batch only, whole over ``model``."""
    return Attrs(h=("batch", None, None, None), conv=("batch", None, None))


def ssd_decode(params: SsmParams, x: torch.Tensor, state: SsmState,
               cfg: ModelConfig) -> Tuple[torch.Tensor, SsmState]:
    """x: (B, 1, d) -> (y (B, 1, d), new state in new tensors).

    The state is whole over ``model`` (``ssm_state_specs``), so on a
    ``model`` axis above 1 every rank runs the step on every head, as one
    device does: the ``in_proj`` product, the conv's weights and
    ``gate_norm`` gathered whole (``_whole``), and every rank ends the step
    with the same ``h`` and ``conv``; the out-projection then sums this
    rank's rows of ``out_proj`` with ``shd.tp_out_proj``."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head
    z, xin, b, c, dt_raw = _split(_whole(x @ params.in_proj,
                                         2 * di + 2 * N + H, -1), cfg)
    xbc = torch.cat([xin, b, c], dim=-1)                         # (B,1,di+2N)
    conv_in = torch.cat([state.conv.to(x.dtype), xbc], dim=1)
    conv_w = _whole(params.conv_w, di + 2 * N, 1)
    conv_b = _whole(params.conv_b, di + 2 * N, 0)
    xbc_out = L.silu(_conv_sum(conv_in, conv_w, 1) + conv_b)
    new_conv = conv_in[:, 1:, :].to(F32)
    xin, b, c = xbc_out[..., :di], xbc_out[..., di:di + N], xbc_out[..., di + N:]

    dt = softplus(dt_raw[:, 0].to(F32) + params.dt_bias)         # (B,H)
    da = torch.exp(dt * -torch.exp(params.a_log))                # (B,H)
    xh = xin[:, 0].reshape(B, H, P).to(F32)
    bx = torch.einsum("bm,bhp->bhmp", b[:, 0].to(F32), xh * dt[..., None])
    h = da[:, :, None, None] * state.h + bx
    yh = torch.einsum("bm,bhmp->bhp", c[:, 0].to(F32), h)
    yh = yh + params.d_skip[None, :, None] * xh
    y = yh.reshape(B, 1, di).to(x.dtype) * L.silu(z)
    y = L.rmsnorm(y, _whole(params.gate_norm, di, 0), cfg.norm_eps)
    rows = shd.tp_block("tp", di)
    if rows is None:
        return y @ params.out_proj, SsmState(h=h, conv=new_conv)
    y = y[..., rows[0]:rows[0] + rows[1]]
    return shd.tp_out_proj(y, params.out_proj), SsmState(h=h, conv=new_conv)
