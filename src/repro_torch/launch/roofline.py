"""Roofline terms on one NVIDIA H100 (port of ``repro.launch.roofline``).

Terms, from the card's data sheet (NVIDIA H100 80GB HBM3, SXM, 700.00 W):
  compute    = FLOPs_per_device            / 989e12  FLOP/s (bf16 dense)
  memory     = bytes_accessed_per_device   / 3.35e12 B/s (HBM3)
  collective = collective_bytes_per_device / 450e9   B/s (NVLink 4, a
                                                          direction)

``Roofline``, ``analyze``, ``kernelized_io_bytes`` and ``model_flops_for``
are the reference's, line for line; only the constants are the card's.
``model_flops_for`` reads ``cfg.active_param_count()``, the reference's
formula, which undercounts hymba-1.5b, mamba2-130m and whisper-tiny; it is
kept identical so that a share read here means what it means there.

``collective_bytes`` has no HLO to parse: it sums the bytes this process
has handed each collective of ``distributed.collectives`` (the
differentiable gather / reduce-scatter / all-reduce, and the compressed
exchange's gathers), by the reference's op names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

#: NVIDIA H100 80GB HBM3, 700.00 W: dense bf16 on the tensor cores
PEAK_FLOPS = 989e12       # FLOP/s / card
#: NVIDIA H100 80GB HBM3, 700.00 W: HBM3 bandwidth
HBM_BW = 3.35e12          # B/s / card
#: NVIDIA H100 80GB HBM3, 700.00 W: NVLink 4, 900 GB/s both ways
LINK_BW = 450e9           # B/s / direction


def collective_bytes() -> Dict[str, int]:
    """Bytes this process has handed each kind of collective so far."""
    from repro_torch.distributed import collectives

    moved = collectives.collective_bytes()
    return {"all-gather": moved["all_gather"] + collectives.wire_bytes_sent(),
            "reduce-scatter": moved["reduce_scatter"],
            "all-reduce": moved["all_reduce"]}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float = 0.0       # 6*N*D (or 6*N_active*D)
    chips: int = 1

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_seconds(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / HLO_FLOPS (global): how much compiled compute is useful."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else None

    @property
    def mfu_bound(self) -> Optional[float]:
        """Achievable MFU if the dominant term were perfectly overlapped:
        useful model FLOPs / (chips * peak * bound_seconds)."""
        if not self.bound_seconds:
            return None
        return (self.model_flops
                / (self.chips * PEAK_FLOPS * self.bound_seconds))


def analyze(flops_per_device: float, bytes_per_device: float,
            coll: Dict[str, int], chips: int,
            model_flops: float = 0.0) -> Roofline:
    cb = float(sum(coll.values()))
    return Roofline(
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=cb / LINK_BW,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=cb,
        model_flops=model_flops,
        chips=chips,
    )


def kernelized_io_bytes(cfg, rc, chips: int) -> float:
    """Per-device q/k/v/o (and SSD in/out) I/O of the fused kernels (the
    reference's formula, kept identical).

    When the scoped interiors run as fused kernels, their HBM traffic is the
    kernel I/O: attention reads q,k,v and writes o once per layer per pass;
    SSD reads x,B,C,dt and writes y.  passes: train fwd + remat fwd + bwd
    reads ~= 4; prefill/decode 1.
    """
    passes = 4.0 if rc.kind == "train" else 1.0
    B, S = rc.global_batch, rc.seq_len
    if rc.kind == "decode":
        # fused dequant-attention kernel: reads the packed cache (codes +
        # scale markers) once per step per layer; SSM state reads are
        # unscoped (left in the general traffic count)
        if not cfg.n_heads:
            return 0.0
        s_cache = S if not cfg.sliding_window else min(S, cfg.sliding_window)
        bits = rc.kv_cache_bits
        per_pos = cfg.n_kv_heads * (cfg.hd * bits // 8
                                    + (4 if bits != 16 else 0))
        return cfg.n_layers * 2.0 * B * s_cache * per_pos / chips
    total = 0.0
    hd = cfg.hd if cfg.n_heads else 0
    attn_layers = 0
    if cfg.family in ("dense", "vlm", "moe", "hybrid"):
        attn_layers = cfg.n_layers
    elif cfg.family == "encdec":
        attn_layers = cfg.n_layers * 2 + cfg.enc_layers  # self+cross+enc
    if attn_layers and cfg.n_heads:
        qo = 2 * B * S * cfg.n_heads * hd
        kv = 2 * B * S * cfg.n_kv_heads * hd
        total += attn_layers * (qo + kv) * 2.0  # bf16
    if cfg.family in ("ssm", "hybrid"):
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        io = B * S * (2 * di + 2 * N + 2 * H) * 4.0
        total += cfg.n_layers * io
    return passes * total / chips


def model_flops_for(cfg, rc) -> float:
    """6*N*D per step (dense) / 6*N_active*D (MoE); decode: D = batch tokens."""
    n = cfg.active_param_count()
    if rc.kind == "train":
        tokens = rc.global_batch * rc.seq_len
        return 6.0 * n * tokens
    if rc.kind == "prefill":
        tokens = rc.global_batch * rc.seq_len
        return 2.0 * n * tokens          # forward only
    tokens = rc.global_batch              # one token per sequence
    return 2.0 * n * tokens
