"""Config system: model architecture + run (shape/parallelism/feature) configs.

The port's own copy of ``repro.configs.base`` (it imports nothing of
``repro``).  ``RunConfig.torch_dtype`` stands in for the reference's
``jdtype``; the parallelism fields are carried over unchanged and are not
read yet.

Every assigned architecture has a module ``configs/<id>.py`` exposing
``CONFIG: ModelConfig`` with the exact published hyper-parameters plus
``smoke()`` returning a reduced same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False       # qwen1.5
    mlp_act: str = "swiglu"      # swiglu | gelu
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- attention variants ---
    sliding_window: int = 0      # 0 = full causal
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0             # fixed encoder length (frames), frontend stub
    # --- VLM ---
    n_vis_tokens: int = 0        # stub patch-embedding prefix length

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d if H else 0
        mlp = 3 * d * ff if self.mlp_act == "swiglu" else 2 * d * ff
        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn + mlp + 2 * d
        elif self.family == "moe":
            per_layer = attn + self.n_experts * mlp + d * self.n_experts + 2 * d
        elif self.family == "ssm":
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = d * (2 * di + 2 * N + Hs) + di * d + 2 * d
        elif self.family == "hybrid":
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * N + Hs) + di * d
            per_layer = attn + ssm + mlp + 2 * d
        elif self.family == "encdec":
            per_layer = attn + mlp + 2 * d  # decoder layer; encoder added below
        n = L * per_layer + V * d * (1 if self.tie_embeddings else 2) + d
        if self.family == "encdec":
            n += self.enc_layers * (attn + mlp + 2 * d) + L * (attn + d)  # cross-attn
        if self.family == "vlm":
            n += self.n_vis_tokens  # stub frontend is excluded by design
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: topk experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        mlp = 3 * d * ff
        per_layer = attn + self.topk * mlp + d * self.n_experts + 2 * d
        return L * per_layer + self.vocab * d * 2 + d


#: shape_id -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution configuration for one (arch x shape x mesh) cell."""
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    # parallelism
    fsdp: bool = True              # shard params/opt over the data axis
    seq_shard: bool = True         # shard activations' seq dim over 'model'
    pipeline_stages: int = 1       # >1: GPipe over the pod axis
    microbatches: int = 1
    # numerics / memory
    param_dtype: str = "bfloat16"
    opt_dtype: str = "float32"     # bfloat16 for the largest archs
    remat: bool = True
    # 'full' recomputes everything; 'save_collectives' saves tensors whose
    # recomputation would replay collectives (attn/mlp outs, gathered kv)
    remat_policy: str = "full"
    # attention blocking
    q_block: int = 512
    kv_block: int = 1024
    # §Perf: hand-scheduled reduce-scatter TP out-projections (shard_map)
    # instead of SPMD-chosen all-reduce+all-gather pairs
    tp_scatter: bool = False
    # vocab-dim sharding of embed/unembed
    shard_vocab: bool = True
    # paper-technique features
    grad_compress_bits: int = 0    # 0 = off; 8 = cross-pod compressed grads
    kv_cache_bits: int = 16        # 16 = bf16; 8/4 = packed (paper packing)
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.param_dtype == "bfloat16" else torch.float32


ARCH_IDS = (
    "tinyllama-1.1b", "qwen1.5-110b", "yi-9b", "granite-8b", "mamba2-130m",
    "grok-1-314b", "mixtral-8x7b", "internvl2-76b", "whisper-tiny",
    "hymba-1.5b",
)


def _module(arch_id: str):
    """The config module ``repro_torch.configs.<id>`` of one architecture."""
    from . import (granite_8b, grok_1_314b, hymba_1_5b, internvl2_76b,
                   mamba2_130m, mixtral_8x7b, qwen1_5_110b, tinyllama_1_1b,
                   whisper_tiny, yi_9b)
    mods = {m.__name__.rsplit(".", 1)[1]: m for m in (
        granite_8b, grok_1_314b, hymba_1_5b, internvl2_76b, mamba2_130m,
        mixtral_8x7b, qwen1_5_110b, tinyllama_1_1b, whisper_tiny, yi_9b)}
    return mods[arch_id.replace("-", "_").replace(".", "_")]


def load_arch(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def load_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


def run_config_for(shape_id: str, cfg: ModelConfig, **overrides) -> RunConfig:
    seq, batch, kind = SHAPES[shape_id]
    big = cfg.param_count() > 50e9
    defaults = dict(
        seq_len=seq, global_batch=batch, kind=kind,
        opt_dtype="bfloat16" if big else "float32",
    )
    defaults.update(overrides)
    return RunConfig(**defaults)
