"""The system under test: ``repro_torch``'s serving engine, driven step by step.

With the architectures' bridges (``bridges/<arch>.py``) the only modules
of the benchmark that import the program.  It hands the program the
benchmark's inputs (the weights through ``ServeEngine(cfg, rc,
params=...)``, a session's history into the engine's decode state), each
through the configuration's bridge, and takes back the timed path's step:
``ServeEngine.graphed_step(B)``, the captured ``decode_step`` replayed once a
step, with the token copy in and the argmax copy back as ``generate`` does.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.serve import engine as E

#: the decode attention kernel's name in a device trace
ATTN_KERNEL = r"decode_attention_kernel"


def model_config(cfg: dict) -> ModelConfig:
    """The program's ``ModelConfig`` of a configuration file: its fields,
    taken by name."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in fields})


def run_config(cfg: dict, traffic) -> RunConfig:
    return RunConfig(seq_len=traffic.seq_len, global_batch=traffic.B, kind="decode",
                     param_dtype=cfg["dtype"], kv_cache_bits=traffic.kv_bits)


class EagerStep:
    """``decode_step`` op by op on a fresh state: what the graph replays,
    for a run without a card (the harness's tests)."""

    def __init__(self, engine: E.ServeEngine, batch: int):
        self.api, self.params = engine.api, engine.params
        self.state = engine.api.init_decode_state(batch)
        self.launches: dict = {}

    def reset(self) -> None:
        self.api.reset_decode_state(self.state)

    def __call__(self, tokens: torch.Tensor):
        dev = self.state.pos.device
        logits, new = self.api.decode_step(self.params, self.state, tokens.to(dev))
        self.state.pos.copy_(new.pos)
        return logits, torch.argmax(logits, dim=-1)


class Server:
    """One engine at the traffic's batch: its decode state, the step, and
    what a batch of the schedule needs done to the state first.  ``bridge``
    is the configuration's ``bridges/<arch>.py``."""

    def __init__(self, bridge, cfg: dict, traffic, weights: Dict[str, torch.Tensor],
                 device: str):
        self.bridge, self.cfg, self.traffic, self.device = bridge, cfg, traffic, device
        self.mcfg = model_config(cfg)
        self.rc = run_config(cfg, traffic)
        self.engine = E.ServeEngine(self.mcfg, self.rc,
                                  params=bridge.program_params(cfg, weights),
                                  device=device)
        B = traffic.B
        if torch.device(device).type == "cuda":
            self.step = self.engine.graphed_step(B)
        else:
            self.step = EagerStep(self.engine, B)
        self.start_pos = torch.from_numpy(
            traffic.start_positions().astype(np.int32)).to(device)
        self.annotate = False

    @property
    def state(self):
        return self.step.state

    def fill_history(self, history_fn) -> None:
        """Write each layer's history (``history_fn(layer)`` -> bf16 K, V
        (B, slots, KV, hd)) into the decode state, as the bridge does."""
        self.bridge.fill_history(self.state, history_fn, self.traffic.kv_bits)

    def begin_batch(self) -> None:
        """A fresh batch (``reset``, as ``generate`` does) or a new turn of
        the same sessions (each row's position set back)."""
        if self.traffic.fresh:
            self.step.reset()
        else:
            self.state.pos.copy_(self.start_pos)

    def __call__(self, cur: np.ndarray) -> np.ndarray:
        """One step: the tokens in, the replay, the argmax back on the host."""
        rf = torch.profiler.record_function if self.annotate else (lambda _: nullcontext())
        with rf("bench.replay"):
            _, nxt = self.step(torch.from_numpy(cur))
        with rf("bench.argmax_to_host"):
            return nxt.cpu().numpy()

    def free(self) -> None:
        """Drop the program's state (cache, graph, pool) before the reference."""
        self.step = None
        self.engine = None


def kernel_launches() -> dict:
    return ops.launch_counts()


def replay_record() -> dict:
    """The program's record of every replay of a captured decode step
    (``engine.replay_record``)."""
    return E.replay_record()
