"""The general generator of serving traffic: sessions served in lockstep batches.

A mix file (``traffic/<mix>.json``) gives the batch, the cache length
(``seq_len``), the cache's bits, the distributions of a request's prompt
and response lengths and, for long sessions, the range of each row's
history.  Every seed gets the same multiset of sizes: a batch's prompt
lengths and its response lengths are the quantiles ``(j + 0.5) / B`` of
their distributions, paired once by a fixed stream that no seed
changes, and the rows' histories are the quantiles of their range.  Only the
order of the rows and the tokens come from the seed.  So two seeds, and
two batches of one seed, do the same work and differ in which row does
what.

A length distribution is ``uniform`` (``min``, ``max``) or ``lognormal``
given by its ``mean`` and standard deviation ``sd`` (as a trace's
published statistics state them), each cut to [``min``, ``max``].

``turns``: ``"fresh"``, every batch new requests from position 0 (the
engine's decode state reset, as ``ServeEngine.generate`` does);
``"same_sessions"``, every batch a new turn of the same B sessions, each
row's position set back to its history's length.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List, Optional

import numpy as np

#: tags that keep the seed's streams apart
_PROMPT, _ORDER, _HISTORY, _PAIRING = 1, 2, 3, 4


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """The n lengths at the quantiles (j + 0.5) / n of ``dist``, rounded and
    cut to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"])
    elif dist["dist"] == "lognormal":
        var = math.log1p((dist["sd"] / dist["mean"]) ** 2)
        mu = math.log(dist["mean"]) - var / 2
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = np.exp(mu + math.sqrt(var) * z)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A stream of the seed (any whole number) for one use."""
    return np.random.default_rng([int(seed) % 2**64, *tags])


@dataclass
class Batch:
    prompts: List[np.ndarray]   # B prompts, int64 token ids
    new_tokens: np.ndarray      # (B,) tokens each request generates


class Sessions:
    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.B = int(mix["batch"])
        self.seq_len = int(mix["seq_len"])
        self.kv_bits = int(mix["kv_bits"])
        if mix["turns"] not in ("fresh", "same_sessions"):
            raise ValueError(f"unknown turns {mix['turns']!r}")
        self.fresh = mix["turns"] == "fresh"
        self.lengths = quantile_lengths(mix["prompt"], self.B)
        pair = rng(0, _PAIRING).permutation(self.B)
        self.responses = quantile_lengths(mix["response"], self.B)[pair]
        h = mix.get("history")
        self.histories: Optional[np.ndarray] = None
        if h is not None:
            grid = quantile_lengths({"dist": "uniform", "min": h["min"],
                                     "max": h["max"]}, self.B)
            self.histories = rng(seed, _HISTORY).permutation(grid)
        longest = int((self.lengths + self.responses).max())
        top = 0 if self.histories is None else int(self.histories.max())
        if top + longest > self.seq_len:
            raise ValueError(f"history {top} + prompt and response {longest} "
                             f"exceed seq_len {self.seq_len}")

    def start_positions(self) -> np.ndarray:
        """Each row's position at the start of a batch."""
        if self.histories is None:
            return np.zeros(self.B, np.int64)
        return self.histories.copy()

    def batch(self, index: int) -> Batch:
        """The requests of the ``index``-th batch: the mix's (prompt,
        response) pairs in the seed's order for this batch, tokens uniform
        over the vocabulary."""
        order = rng(self.seed, _ORDER, index).permutation(self.B)
        r = rng(self.seed, _PROMPT, index)
        prompts = [r.integers(0, self.vocab, int(n), dtype=np.int64)
                   for n in self.lengths[order]]
        return Batch(prompts, self.responses[order].copy())


def make(mix: dict, vocab: int, seed: int) -> Sessions:
    return Sessions(mix, vocab, seed)
