"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed and always holding
the longest, is run through the plain reference (``reference.py``): each
request's prompt and served tokens, teacher-forced from its history.  At
every served token the gap by which its reference logit lies below the
reference's best is read.  The numbers compared, each against its limit in
``limits/<cell>.json``:

* ``gap_max``: the widest gap over every served token of the sample;
* ``gap_mean``: the mean gap over them.

The sample takes one request from each of ``check_requests`` blocks of the
batch's rows, so a fault in any part of the batch is read.

A run is correct when the sample is not empty, every sampled request was
served in full with tokens of the vocabulary, and each number the cell's
limits name is at or under its limit.

Nothing here imports the program.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from . import inputs, reference

NUMBERS = ("gap_max", "gap_mean")
_SAMPLE = 21


def sample(requests: list, n: int, seed: int) -> list:
    """``n`` finished requests drawn from the seed: one from each of ``n``
    equal blocks of the batch's rows (so every part of the batch is read),
    the longest (history, prompt and served tokens) standing for its block.
    """
    done = [r for r in requests if r.finished]
    if not done:
        return []
    rows = max(r.row for r in requests) + 1
    size = [r.history + len(r.prompt) + len(r.served) for r in done]
    longest = done[int(np.argmax(size))]
    rng = np.random.default_rng([int(seed) % 2**64, _SAMPLE])
    out = []
    for k in range(min(n, rows)):
        lo, hi = k * rows // n, (k + 1) * rows // n
        if lo <= longest.row < hi:
            out.append(longest)
            continue
        block = [r for r in done if lo <= r.row < hi]
        if block:
            out.append(block[int(rng.integers(len(block)))])
    return out


def turn(r, device) -> reference.Turn:
    """The reference's input for a served request: its prompt and every
    served token but the last, from its history."""
    toks = np.concatenate([r.prompt, np.asarray(r.served[:-1], np.int64)])
    return reference.Turn(torch.from_numpy(toks).to(device), r.history, r.row)


def history_fn(cfg: dict, traffic, seed: int, device):
    """The reference's own draw of every session's history, layer by layer."""
    h = traffic.mix.get("history")
    if h is None:
        return None
    return lambda layer: inputs.history_kv(cfg, h, seed, layer, traffic.B,
                                           traffic.seq_len, device)


def reference_logits(cfg: dict, arch, weights: dict, reqs: list, traffic, seed: int,
                     device, margins=None) -> List[torch.Tensor]:
    return reference.logits(cfg, arch, weights, [turn(r, device) for r in reqs],
                            traffic.kv_bits, history_fn(cfg, traffic, seed, device),
                            margins)


def gaps(logits: List[torch.Tensor], reqs: list, tokens: List[List[int]]) -> np.ndarray:
    """Every gap of ``tokens[i]`` (one a served position of request i)."""
    out = [reference.served_gaps(lg, t, len(r.prompt) - 1).cpu().numpy()
           for lg, r, t in zip(logits, reqs, tokens)]
    return np.concatenate(out) if out else np.zeros(0)


def numbers(g: np.ndarray) -> Dict[str, float]:
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean())}


def compare(cfg: dict, arch, weights: dict, requests: list, traffic, seed: int,
            device) -> dict:
    """The run's comparison -> the numbers, the sample's size, whether every
    sampled request was served in full with valid tokens."""
    reqs = sample(requests, int(traffic.mix["check_requests"]), seed)
    whole = all(r.finished and all(0 <= t < cfg["vocab"] for t in r.served)
                for r in reqs)
    if not reqs or not whole:
        return {"numbers": {}, "requests": len(reqs), "tokens": 0, "whole": whole}
    lg = reference_logits(cfg, arch, weights, reqs, traffic, seed, device)
    g = gaps(lg, reqs, [r.served for r in reqs])
    return {"numbers": numbers(g), "requests": len(reqs), "tokens": int(g.size),
            "whole": True}


def judge(result: dict, limits: dict) -> tuple:
    """-> (correct, {name: {value, limit}}) against ``limits["numbers"]``:
    the numbers the cell compares (a number with no limit there separates
    no control from the program, and is not compared)."""
    lim = limits["numbers"]
    shown = {n: {"value": result["numbers"].get(n), "limit": lim[n]["limit"]}
             for n in NUMBERS if n in lim}
    ok = (result["whole"] and result["tokens"] > 0
          and all(v["value"] is not None and v["value"] <= v["limit"]
                  for v in shown.values()))
    return bool(ok), shown


def print_numbers(shown: dict, result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    print(f"check: {result['requests']} requests, {result['tokens']} served "
          f"tokens compared", file=sys.stderr)
    for n, v in shown.items():
        print(f"check {n} = {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
