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

Every replay times itself on the device: a pair of CUDA events around the
token copy and the replay, read once they have completed (``query``; a
wait only where the step's ring of pairs would overwrite one not yet read),
into a record of the process's replays (``replay_record``).  With obs on at capture, the graph
also holds the ``obs.device_mark`` events of ``decode_step`` and zeroes its
``obs.device_counter``s, and each replay publishes its span table and adds
the counters (the decode attention's tiles walked).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from time import perf_counter_ns
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.obs import instrument as obs
from repro_torch.obs.metrics import parse_series_key

#: the replays the record holds: the last this many, by ordinal
RECORD_BOUND = 65536
#: the timing-event pairs a step keeps, so that reading one never waits
RING = 8


class _Replay(NamedTuple):
    """A replay whose events may not have completed yet."""
    ordinal: int
    start: object           # timing event before the token copy
    end: object             # ... after the replay
    prev_end: object        # the previous replay's end on this device, or None
    registry: object        # obs's registry at the call, None with obs off
    labels: dict
    marks: object           # the graph's obs.DeviceMarks, or None


class ReplayRecord:
    """Each replay's device, gap and host milliseconds, by ordinal since
    the process started (or the last ``reset``), the last ``bound`` kept.

    ``device_ms``: the replay's start event to its end event (the token
    copy and the graph); ``gap_ms``: the previous replay's end event (on
    the same device) to this one's start, the device waiting on the host;
    ``host_ms``: the time inside the step's call.  A replay is resolved
    once its end event has completed: ``resolve`` queries, and waits only
    where a step is about to record again into an event that a replay not
    yet resolved still needs (``release``)."""

    def __init__(self, bound: int = RECORD_BOUND):
        self.bound = bound
        self.device_ms = np.full(bound, np.nan)
        self.gap_ms = np.full(bound, np.nan)
        self.host_ms = np.full(bound, np.nan)
        self.next = 0                       # the next replay's ordinal
        self._pending: collections.deque = collections.deque()
        self._last_end: dict = {}           # device -> the last end event

    def add(self, device, start, end, host_ms: float, registry=None,
            labels: Optional[dict] = None, marks=None) -> int:
        """Enter a replay just enqueued -> its ordinal."""
        n, self.next = self.next, self.next + 1
        labels = labels or {}
        self.host_ms[n % self.bound] = host_ms
        self.device_ms[n % self.bound] = self.gap_ms[n % self.bound] = np.nan
        self._pending.append(_Replay(n, start, end, self._last_end.get(device),
                                     registry, labels, marks))
        self._last_end[device] = end
        if registry is not None:
            registry.histogram("serve/step_host_ms", **labels).observe(host_ms)
        return n

    def resolve(self) -> None:
        """Read every pending replay, in order, whose end has completed."""
        while self._pending and self._pending[0].end.query():
            self._read(self._pending.popleft())

    def release(self, *objs) -> None:
        """Before ``objs`` (events, a ``DeviceMarks``) are recorded again:
        wait for the last pending replay that reads any of them, and read
        it and every one before it."""
        objs = [o for o in objs if o is not None]
        last = None
        for i, r in enumerate(self._pending):
            if any(o is r.start or o is r.end or o is r.prev_end
                   or o is r.marks for o in objs):
                last = i
        if last is None:
            return
        self._pending[last].end.synchronize()
        for _ in range(last + 1):
            self._read(self._pending.popleft())

    def _read(self, r: _Replay) -> None:
        i = r.ordinal % self.bound
        device = r.start.elapsed_time(r.end)
        gap = np.nan if r.prev_end is None else r.prev_end.elapsed_time(r.start)
        if r.ordinal >= self.next - self.bound:
            self.device_ms[i], self.gap_ms[i] = device, gap
        if r.registry is None:
            return
        r.registry.histogram("serve/replay_ms", **r.labels).observe(device)
        if r.prev_end is not None:
            r.registry.histogram("serve/replay_gap_ms", **r.labels).observe(gap)
        if r.marks is not None:
            for name, ms in r.marks.table().items():
                r.registry.histogram("decode/span_ms", span=name,
                                     **r.labels).observe(ms)
            for (name, labels), n in r.marks.counts().items():
                r.registry.counter(name, **dict(labels)).inc(n)

    def view(self) -> dict:
        """The replays held, oldest first: ``first`` (the ordinal of the
        first) and ``device_ms``, ``gap_ms``, ``host_ms`` (copies; NaN where
        not resolved yet)."""
        lo = max(0, self.next - self.bound)
        idx = np.arange(lo, self.next) % self.bound
        return {"first": lo, "device_ms": self.device_ms[idx],
                "gap_ms": self.gap_ms[idx], "host_ms": self.host_ms[idx]}

    def reset(self) -> None:
        """Forget every replay: the next is ordinal 0, with no gap."""
        self.__init__(self.bound)


#: the process's record, which outlives the steps (as ``ops.launch_counts``)
_RECORD = ReplayRecord()


def replay_record() -> dict:
    """Every replay of a captured decode step in this process, resolved as
    far as the device has completed them: ``ReplayRecord.view``."""
    _RECORD.resolve()
    return _RECORD.view()


def reset_replay_record() -> None:
    _RECORD.reset()


class GraphedDecodeStep:
    """``decode_step`` for one batch size, captured as a CUDA graph.

    The static buffers live as long as the object: the tokens (B,) int64,
    the model's decode state (kv caches, SSM state (h, conv) or the
    encoder-decoder's cross K/V, and ``pos``), which the graph advances in
    place, the logits (B, V) and their argmax.  The weights are read in
    place, so an in-place update of them shows in the next replay.

    Capture records the kernel wrappers' Python once, so each wrapper's
    ``launches`` counts the kernels it put in the graph once more at every
    replay, and not at capture.  The capture's ``kernels/*`` counters go to
    a private registry and are added to obs's at every replay while obs is
    on (the capture's spans are dropped).  With obs on at capture, the
    graph also records ``decode_step``'s ``obs.device_mark`` events and
    zeroes its ``obs.device_counter``s, and each replay publishes
    ``decode/span_ms{span=}`` and adds the counters.  Every replay enters
    ``replay_record``; with obs on also ``serve/replay_ms``,
    ``serve/replay_gap_ms``, ``serve/step_host_ms`` and a ``serve/step`` span.
    """

    def __init__(self, api: model_zoo.ModelApi, params, batch: int, device,
                 arch: str = ""):
        dev = torch.device(device)
        self.params = params
        self._reset_state = api.reset_decode_state
        self._labels = {"arch": arch, "batch": batch}
        self._device = dev
        with torch.cuda.device(dev):
            self.tokens = torch.zeros((batch,), dtype=torch.int64, device=dev)
            self.state = api.init_decode_state(batch)

            def run():
                logits, new = api.decode_step(params, self.state, self.tokens)
                obs.device_mark("argmax")
                self.state.pos.copy_(new.pos)
                return logits, torch.argmax(logits, dim=-1)

            # warm-up before capture, on a side stream: builds the kernels'
            # libraries and settles the allocator
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), obs.disabled_scope():
                run()
            torch.cuda.current_stream(dev).wait_stream(side)

            marking = obs.enabled()
            self.marks = None
            before = ops.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with obs.enabled_scope() as (captured, _), \
                    torch.cuda.graph(self.graph):
                if marking:
                    with obs.device_marks() as self.marks:
                        self.logits, self.next_tokens = run()
                else:
                    self.logits, self.next_tokens = run()
            self.launches = ops.take_back_launches(before)
            self.kernel_counts = [(*parse_series_key(k), v) for k, v in
                                  captured.snapshot().counters.items()]
            self._ring = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for _ in range(RING)]
            self._turn = 0
        self.reset()

    def reset(self) -> None:
        """Back to a fresh ``init_decode_state``, in place."""
        self._reset_state(self.state)

    def __call__(self, tokens: torch.Tensor):
        """One step on (B,) tokens: the static (logits, argmax) buffers."""
        t0 = perf_counter_ns()
        reg = obs.registry() if obs.enabled() else None
        with obs.span("serve/step", **self._labels):
            start, end = self._ring[self._turn]
            self._turn = (self._turn + 1) % RING
            _RECORD.resolve()
            _RECORD.release(start, end, self.marks)
            start.record()
            self.tokens.copy_(tokens)
            self.graph.replay()
            end.record()
            ops.add_launches(self.launches)
            if reg is not None:
                for name, labels, n in self.kernel_counts:
                    reg.counter(name, **labels).inc(n)
        _RECORD.add(self._device, start, end,
                    (perf_counter_ns() - t0) / 1e6, reg, self._labels,
                    self.marks)
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
                self.api, self.params, batch, self.device, self.cfg.name)
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
