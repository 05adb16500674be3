"""The schedule the window drives: ``ServeEngine.generate``'s lockstep, copied.

Each row of a batch is one request.  While a row is inside its prompt its
next prompt token is fed (teacher forcing, one a step); then the argmax of
its last step is fed back, and counted as generated until the request has
its own ``new_tokens``.  The argmax comes back to the host at every step.
A batch runs until its last request is done, ``max(prompt + new_tokens) -
1`` steps, as ``generate`` runs to its longest prompt and ``max_new``; the
next batch starts when it ends (``server.begin_batch``).  The
bookkeeping is numpy over the rows where ``generate`` loops in Python; what
it feeds and counts is the same.

A step's time is taken on the host's clock from before its token copy to
after its bookkeeping (the first step of a batch includes the state's
reset), so the steps tile the window.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Request:
    row: int
    history: int            # the row's position when the batch starts
    prompt: np.ndarray
    served: List[int] = field(default_factory=list)
    t_start: float = 0.0    # the batch's start, host clock
    t_first: Optional[float] = None   # first generated token on the host
    new_tokens: int = 0

    @property
    def finished(self) -> bool:
        return len(self.served) == self.new_tokens


@dataclass
class BatchRun:
    start_pos: np.ndarray   # (B,) positions at the batch's first step
    t_start: float
    steps: int = 0          # steps run so far
    generated: int = 0


class Lockstep:
    """Batches of ``traffic`` served through ``server`` in lockstep."""

    def __init__(self, server: Callable, traffic, clock=time.perf_counter):
        self.server, self.traffic, self.clock = server, traffic, clock
        self.requests: List[Request] = []
        self.batches: List[BatchRun] = []
        self._batch = None      # the batch in progress: (BatchRun, state)

    def _start(self) -> None:
        index = len(self.batches)
        b = self.traffic.batch(index)
        B = len(b.prompts)
        lens = np.array([len(p) for p in b.prompts])
        prompts = np.zeros((B, int(lens.max())), np.int64)
        for i, p in enumerate(b.prompts):
            prompts[i, :len(p)] = p
        t0 = self.clock()
        self.server.begin_batch()
        start = self.traffic.start_positions()
        run = BatchRun(start, t0)
        new = np.asarray(b.new_tokens, np.int64)
        reqs = [Request(i, int(start[i]), b.prompts[i], t_start=t0,
                        new_tokens=int(new[i])) for i in range(B)]
        self.batches.append(run)
        self.requests.extend(reqs)
        self._batch = dict(run=run, reqs=reqs, lens=lens, prompts=prompts,
                           total=int((lens + new).max()) - 1,
                           count=np.zeros(B, np.int64), new=new,
                           cur=prompts[:, 0].copy(), t=0)

    def step(self) -> float:
        """One step of the schedule (a new batch begun first where the last
        one ended) -> its host seconds."""
        t0 = self.clock()
        if self._batch is None:
            self._start()
        s = self._batch
        t = s["t"]
        model = self.server(s["cur"])
        lens, count, new = s["lens"], s["count"], s["new"]
        in_prompt = t + 1 < lens
        gen = ~in_prompt & (count < new)
        rows = np.flatnonzero(gen)
        t1 = self.clock()
        for i in rows:
            r = s["reqs"][i]
            r.served.append(int(model[i]))
            if r.t_first is None:
                r.t_first = t1
        count[rows] += 1
        nxt = s["prompts"][:, min(t + 1, s["prompts"].shape[1] - 1)]
        s["cur"] = np.where(in_prompt, nxt, model).astype(np.int64)
        run = s["run"]
        run.steps += 1
        run.generated += len(rows)
        s["t"] = t + 1
        if s["t"] == s["total"]:
            self._batch = None
        return self.clock() - t0

    @property
    def in_batch(self) -> bool:
        """A batch is in progress (begun, not yet at its last step)."""
        return self._batch is not None

    def next_positions(self) -> np.ndarray:
        """(B,) each row's decode position at the next step."""
        if self._batch is None:
            return self.traffic.start_positions()
        return self._batch["run"].start_pos + self._batch["t"]

    def run_until(self, deadline: float) -> List[float]:
        """Whole batches until one ends at or after ``deadline`` -> the
        seconds of every step."""
        out = []
        while True:
            out.append(self.step())
            if not self.in_batch and self.clock() >= deadline:
                return out

    def run_into_batch(self, share: float) -> None:
        """Steps until ``share`` of the batch in progress (or of the next
        one) has run: where a traced stretch stands for the batch's
        middle, not its first steps."""
        if self._batch is None:
            self.step()
        s = self._batch
        while s is not None and s["t"] < int(share * s["total"]):
            self.step()
            s = self._batch

    def run_steps(self, n: int) -> List[float]:
        return [self.step() for _ in range(n)]

    def positions(self, batch: BatchRun) -> np.ndarray:
        """(steps, B) each row's decode position at each step it ran."""
        return batch.start_pos[None, :] + np.arange(batch.steps)[:, None]
