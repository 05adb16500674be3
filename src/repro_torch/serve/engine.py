"""Batched serving engine with packed (paper-layout) KV cache.

Port of ``repro.serve.engine``.  Prompts of different lengths decode in
lockstep: each sequence tracks its own position; while a sequence is still
inside its prompt the engine feeds the next prompt token (teacher forcing),
afterwards it feeds the model's argmax.  There is no prefill: prompts go
through ``decode_step`` one token at a time, as in the reference.  The KV
cache layout is ``RunConfig.kv_cache_bits``: 16 = the model dtype (padded
words, the paper's baseline), 8/4 = packed int blocks with per-row scale
markers, written and read through the kvpack kernels on a GPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model_zoo, transformer
from repro_torch.obs import instrument as obs


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    rc: RunConfig
    params: Optional[object] = None
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        self.api = model_zoo.get_api(self.cfg, self.rc, self.device)
        if self.params is None:
            self.params = self.api.init(self.seed)
        self._kv_bytes: dict = {}

    def kv_cache_bytes(self, batch: int) -> int:
        """Bytes of the decode state's caches for ``batch`` sequences.

        Counted on PyTorch's meta device: shapes and dtypes, no allocation.
        """
        cached = self._kv_bytes.get(batch)
        if cached is None:
            state = transformer.init_decode_state(self.cfg, self.rc, batch,
                                                  device="meta")
            cached = sum(t.numel() * t.element_size()
                         for layer in state.caches for t in layer
                         if t is not None)
            self._kv_bytes[batch] = cached
        return cached

    def generate(self, prompts: List[List[int]], max_new: int = 16,
                 greedy: bool = True) -> List[List[int]]:
        """Batched generation; returns generated token lists per prompt."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts])
        total = int(lens.max() + max_new)
        if total > self.rc.seq_len:
            raise ValueError(f"longest prompt + max_new = {total} exceeds "
                             f"seq_len {self.rc.seq_len}")
        prompt_buf = np.zeros((B, int(lens.max())), np.int32)
        for i, p in enumerate(prompts):
            prompt_buf[i, :len(p)] = p

        if obs.enabled():
            obs.gauge_set("serve/kv_bytes", int(self.kv_cache_bytes(B)),
                          arch=self.cfg.name,
                          kv_bits=self.rc.kv_cache_bits)
        t_start = time.perf_counter()
        with obs.span("serve/generate", arch=self.cfg.name, batch=B,
                      max_new=max_new):
            state = self.api.init_decode_state(B)
            out_tokens = [[] for _ in range(B)]
            cur = prompt_buf[:, 0].copy()
            for t in range(total - 1):
                logits, state = self.api.decode_step(
                    self.params, state,
                    torch.as_tensor(cur, dtype=torch.int64, device=self.device))
                nxt_model = torch.argmax(logits, dim=-1).cpu().numpy()
                nxt = np.zeros((B,), np.int32)
                for i in range(B):
                    if t + 1 < lens[i]:
                        nxt[i] = prompt_buf[i, t + 1]   # still in prompt
                    else:
                        nxt[i] = nxt_model[i]
                        if len(out_tokens[i]) < max_new:
                            out_tokens[i].append(int(nxt_model[i]))
                cur = nxt
        if obs.enabled():
            n_gen = sum(len(t) for t in out_tokens)
            obs.counter_inc("serve/generated_tokens", n_gen,
                            arch=self.cfg.name)
            obs.counter_inc("serve/decode_steps", total - 1,
                            arch=self.cfg.name)
            obs.hist_observe("serve/generate_ms",
                             (time.perf_counter() - t_start) * 1e3,
                             arch=self.cfg.name)
        return out_tokens
