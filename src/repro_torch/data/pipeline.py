"""Deterministic synthetic data pipeline (checkpointable).

Port of ``repro.data.pipeline``; the generator is a numpy copy of the
reference's, so one (seed, step) gives bit-identical batches on both sides.
Tokens are a stateless hash of (seed, step, position), so any step can be
regenerated: the pipeline's state is its step counter, stored in the
checkpoint's extra dict.  The stream has local n-gram structure (a small
hash-mixed Markov walk), so cross-entropy is learnable.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model_zoo
from repro_torch.obs import instrument as obs


def _hash2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         ^ b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9))
    x ^= x >> np.uint64(31)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(29)
    return x


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: ModelConfig
    rc: RunConfig
    seed: int = 0
    step: int = 0

    def state(self) -> Dict[str, int]:
        return {"data_step": self.step, "data_seed": self.seed}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state.get("data_step", 0))
        self.seed = int(state.get("data_seed", self.seed))

    def _tokens(self, step: int, batch: int, seq: int) -> np.ndarray:
        """Markov-ish walk: next token mixes previous token and position hash."""
        v = self.cfg.vocab
        rows = np.arange(batch, dtype=np.uint64)[:, None]
        cols = np.arange(seq + 1, dtype=np.uint64)[None, :]
        base = _hash2(rows + np.uint64(step * 131071 + self.seed), cols)
        # local structure: token depends mostly on coarse position bucket
        walk = (base >> np.uint64(8)) % np.uint64(max(v // 16, 2))
        drift = (cols // np.uint64(17)) % np.uint64(max(v // 16, 2))
        toks = (walk + drift * np.uint64(16)) % np.uint64(v)
        return toks.astype(np.int32)

    def next(self) -> Dict[str, Any]:
        if not obs.enabled():
            return self._next()
        t0 = time.perf_counter()
        batch = self._next()
        obs.hist_observe("data/batch_ms", (time.perf_counter() - t0) * 1e3,
                         arch=self.cfg.name)
        obs.counter_inc("data/batches", 1, arch=self.cfg.name)
        obs.counter_inc("data/bytes",
                        sum(np.asarray(v).nbytes for v in batch.values()),
                        arch=self.cfg.name)
        return batch

    def _next(self) -> Dict[str, Any]:
        cfg, rc = self.cfg, self.rc
        B, S = rc.global_batch, rc.seq_len
        if cfg.family == "vlm":
            S_text = S - cfg.n_vis_tokens
            toks = self._tokens(self.step, B, S_text)
            batch = {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
                "vis_embeds": self._embeds(B, cfg.n_vis_tokens),
            }
        elif cfg.family == "encdec":
            toks = self._tokens(self.step, B, S)
            batch = {
                "frames": self._embeds(B, cfg.enc_seq),
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
            }
        else:
            toks = self._tokens(self.step, B, S)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        self.step += 1
        return batch

    def _embeds(self, batch: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 7919 + self.step)
        x = rng.standard_normal((batch, n, self.cfg.d_model)) * 0.02
        return x.astype(np.float32)


def batch_rows(B: int, mesh) -> slice:
    """This rank's rows of a global batch of ``B`` on ``mesh`` (see
    ``device_batch``)."""
    for axes in (("pod", "data"), ("pod",)):
        axes = tuple(a for a in axes if a in mesh.axis_names)
        n = mesh.size(axes)
        if axes and B % n == 0:
            i = mesh.index(axes)
            return slice(i * B // n, (i + 1) * B // n)
    return slice(None)


def device_batch(batch: Dict[str, Any], cfg: ModelConfig, rc: RunConfig,
                 device="cuda", mesh=None) -> Dict[str, torch.Tensor]:
    """Cast to the cell's input dtypes (``model_zoo.input_specs``) on ``device``.

    On a ``mesh`` each rank takes its rows of the global batch: the batch
    axis split over ``("pod", "data")`` row-major, as the reference's
    ``P(("pod", "data"))`` lays it out, so that pod ``i`` holds the rows the
    reference's per-pod split gives it.  The ranks along ``model`` of one
    ``(pod, data)`` coordinate take the same rows (the batch is not split
    over ``model``).  A batch the split does not divide is split over the
    pods alone, or else stays whole on every rank, as the reference's rules
    replicate it.
    """
    specs = model_zoo.input_specs(cfg, rc)
    B = len(next(iter(batch.values())))
    rows = slice(None) if mesh is None else batch_rows(B, mesh)
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
                device=device, dtype=specs[k].dtype)
            for k, v in batch.items()}
