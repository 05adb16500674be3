"""Batched serving engine with packed (paper-layout) KV cache.

Port of ``repro.serve.engine``.  Prompts of different lengths decode in
lockstep: each sequence tracks its own position; while a sequence is still
inside its prompt the engine feeds the next prompt token (teacher forcing),
afterwards it feeds the model's argmax.  There is no prefill: prompts go
through ``decode_step`` one token at a time, as in the reference.  The KV
cache layout is ``RunConfig.kv_cache_bits``: 16 = the model dtype (padded
words, the paper's baseline), 8/4 = packed int blocks with per-row scale
markers, written and read through the kvpack kernels on a GPU.

The reference jits ``decode_step``.  The port's counterpart on a GPU is a
CUDA graph: the step is captured once per batch size
(``GraphedDecodeStep``) and every step of every ``generate`` replays it,
with no Python between its ~3,600 launches.  On the CPU the step runs op by
op, as the reference's jit would run there.  A failed capture or replay
raises; there is no fallback to the eager loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.obs import instrument as obs


class GraphedDecodeStep:
    """``decode_step`` for one batch size, captured as a CUDA graph.

    The static buffers live as long as the object: the tokens (B,) int64,
    the model's decode state (kv caches, SSM state (h, conv) or the
    encoder-decoder's cross K/V, and ``pos``), which the graph advances in
    place, the logits (B, V) and their argmax.  The weights are read in
    place, so an in-place update of them shows in the next replay.

    Capture records the kernel wrappers' Python once, so each wrapper's
    ``launches`` counts the kernels it put in the graph once more at every
    replay, and not at capture.  ``kernels/*`` obs series are published at
    capture only, as the reference publishes them when jit traces.
    """

    def __init__(self, api: model_zoo.ModelApi, params, batch: int, device):
        dev = torch.device(device)
        self.params = params
        self._reset_state = api.reset_decode_state
        with torch.cuda.device(dev):
            self.tokens = torch.zeros((batch,), dtype=torch.int64, device=dev)
            self.state = api.init_decode_state(batch)

            def run():
                logits, new = api.decode_step(params, self.state, self.tokens)
                self.state.pos.copy_(new.pos)
                return logits, torch.argmax(logits, dim=-1)

            # warm-up before capture, on a side stream: builds the kernels'
            # libraries and settles the allocator
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), obs.disabled_scope():
                run()
            torch.cuda.current_stream(dev).wait_stream(side)

            before = ops.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits, self.next_tokens = run()
            self.launches = ops.take_back_launches(before)
        self.reset()

    def reset(self) -> None:
        """Back to a fresh ``init_decode_state``, in place."""
        self._reset_state(self.state)

    def __call__(self, tokens: torch.Tensor):
        """One step on (B,) tokens: the static (logits, argmax) buffers."""
        self.tokens.copy_(tokens)
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.logits, self.next_tokens


class _EagerDecodeStep:
    """``decode_step`` run op by op on a fresh state (the CPU path)."""

    def __init__(self, api: model_zoo.ModelApi, params, batch: int, device):
        self.api, self.params, self.device = api, params, device
        self.state = api.init_decode_state(batch)

    def __call__(self, tokens: torch.Tensor):
        logits, self.state = self.api.decode_step(
            self.params, self.state, tokens.to(self.device))
        return logits, torch.argmax(logits, dim=-1)


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
        self._graphs: dict = {}

    def kv_cache_bytes(self, batch: int, mesh=None) -> int:
        """Bytes of the decode state's caches for ``batch`` sequences: every
        leaf, the kv caches and their scales, the SSM state (h, conv), the
        encoder-decoder's cross K/V (two tensors).  With ``mesh``, the
        blocks this rank holds (``init_decode_state(batch, mesh=)``).

        Counted on PyTorch's meta device: shapes and dtypes, no allocation.
        """
        key = (batch, None if mesh is None else (tuple(mesh.shape.items()),
                                                  tuple(mesh.coords.items())))
        cached = self._kv_bytes.get(key)
        if cached is None:
            api = model_zoo.get_api(self.cfg, self.rc, "meta")
            state = api.init_decode_state(batch, mesh=mesh)
            cached = sum(t.numel() * t.element_size()
                         for t in api.cache_leaves(state))
            self._kv_bytes[key] = cached
        return cached

    def graphed_step(self, batch: int) -> GraphedDecodeStep:
        """The captured decode step for ``batch`` sequences on the engine's
        GPU, built on first use (and again if ``params`` was replaced)."""
        if torch.device(self.device).type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the engine "
                             f"runs on {self.device}")
        step = self._graphs.get(batch)
        if step is None or step.params is not self.params:
            step = self._graphs[batch] = GraphedDecodeStep(
                self.api, self.params, batch, self.device)
        return step

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
            if torch.device(self.device).type == "cuda":
                step = self.graphed_step(B)
                step.reset()
            else:
                step = _EagerDecodeStep(self.api, self.params, B, self.device)
            out_tokens = [[] for _ in range(B)]
            cur = prompt_buf[:, 0].copy()
            for t in range(total - 1):
                _, nxt_dev = step(torch.from_numpy(cur.astype(np.int64)))
                nxt_model = nxt_dev.cpu().numpy()
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
