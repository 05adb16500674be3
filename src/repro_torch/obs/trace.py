"""Nested trace spans with wall-clock *and* logical-cycle attribution.

The PyTorch port's own copy of ``repro.obs.trace``.

``span("tile_io", tile=t)`` opens a nested region; closing it records one
Chrome-trace "complete" event (``ph="X"``) with microsecond ``ts``/``dur``.
A span times the host: around an asynchronous CUDA launch it measures the
enqueue, not the kernel (kernel times come from CUDA events).
Spans also carry a logical-cycle tally: the reference's transfer model
measures I/O in bus cycles, not seconds, so a span
can be charged cycles via :meth:`Span.add_cycles` and the trace shows both
time bases side by side — exactly how the paper pairs wall-clock runs with
on-FPGA cycle counters (§5).

Export with :meth:`Tracer.chrome_trace`; the result loads directly into
``chrome://tracing`` / Perfetto (``{"traceEvents": [...]}``).

Spans are stamped on the wall clock (``time.time_ns``), the clock
``torch.profiler`` converts its host events to (its results'
``trace_start_ns`` is Unix time), and ``chrome_trace`` writes ``ts`` from
the base ``torch.profiler.export_chrome_trace`` subtracts (the Unix
second rounded down to a multiple of ``TRACE_BASE_S``, named in the
export as ``baseTimeNanoseconds``).  So the program's spans and a
profiler export of the same process load into Perfetto as one timeline.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

#: the period ``torch.profiler``'s chrome export rounds its base time down
#: to (Kineto's, seconds): its ``ts`` are microseconds since that base
TRACE_BASE_S = 7889238


def trace_base_ns() -> int:
    """The base (Unix ns) of a ``torch.profiler.export_chrome_trace`` made
    now."""
    now_s = time.time_ns() // 1_000_000_000
    return now_s // TRACE_BASE_S * TRACE_BASE_S * 1_000_000_000


@dataclasses.dataclass
class SpanRecord:
    """One closed span (Chrome trace "X" event)."""
    name: str
    ts_us: float           # start, microseconds since tracer epoch
    dur_us: float
    depth: int             # nesting depth at open time (0 = root)
    args: Dict[str, object]
    cycles: int = 0        # logical I/O cycles charged to this span

    def to_chrome(self, pid: int = 0, tid: int = 0) -> dict:
        args = dict(self.args)
        if self.cycles:
            args["cycles"] = self.cycles
        return {"name": self.name, "ph": "X", "ts": self.ts_us,
                "dur": self.dur_us, "pid": pid, "tid": tid, "args": args}


class Span:
    """Live (open) span handle yielded by :meth:`Tracer.span`."""
    __slots__ = ("name", "args", "cycles", "_t0", "_depth")

    def __init__(self, name: str, args: Dict[str, object], depth: int,
                 t0: int):
        self.name = name
        self.args = args
        self.cycles = 0
        self._t0 = t0
        self._depth = depth

    def add_cycles(self, n: int) -> None:
        self.cycles += int(n)

    def set(self, **kwargs) -> None:
        self.args.update(kwargs)


class Tracer:
    """Collects closed spans; thread-local nesting stacks."""

    def __init__(self) -> None:
        self._epoch = time.time_ns()
        self._local = threading.local()
        self._lock = threading.Lock()
        self.records: List[SpanRecord] = []

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @property
    def depth(self) -> int:
        return len(self._stack())

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    @contextmanager
    def span(self, name: str, **args) -> Iterator[Span]:
        st = self._stack()
        sp = Span(name, args, depth=len(st), t0=time.time_ns())
        st.append(sp)
        try:
            yield sp
        finally:
            st.pop()
            t1 = time.time_ns()
            rec = SpanRecord(
                name=sp.name,
                ts_us=(sp._t0 - self._epoch) / 1e3,
                dur_us=(t1 - sp._t0) / 1e3,
                depth=sp._depth,
                args=sp.args,
                cycles=sp.cycles,
            )
            with self._lock:
                self.records.append(rec)
            # roll logical cycles up into the parent so root spans carry
            # the subtree total, like a sampling profiler's inclusive time
            parent = self.current()
            if parent is not None:
                parent.cycles += sp.cycles

    def chrome_trace(self, pid: int = 0, base_ns: Optional[int] = None) -> dict:
        """The spans as a Chrome trace, ``ts`` in microseconds since
        ``base_ns`` (Unix ns): by default the base a profiler export made
        now would take; pass an export's ``baseTimeNanoseconds`` to align
        with it across a change of base."""
        base = trace_base_ns() if base_ns is None else base_ns
        shift_us = (self._epoch - base) / 1e3
        with self._lock:
            events = [r.to_chrome(pid=pid, tid=r.depth)
                      for r in sorted(self.records, key=lambda r: r.ts_us)]
        for e in events:
            e["ts"] += shift_us
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": base}

    def reset(self) -> None:
        with self._lock:
            self.records.clear()
        self._local = threading.local()
        self._epoch = time.time_ns()


#: Process-wide default tracer (mirrors ``metrics.REGISTRY``).
TRACER = Tracer()
