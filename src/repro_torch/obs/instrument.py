"""Enable-gated instrumentation facade — the only obs API hot paths touch.

The PyTorch port's own copy of ``repro.obs.instrument``.

Design rule: *zero cost when disabled*.  Every helper starts with a single
module-flag test and returns immediately when obs is off; the disabled
``span()`` returns a shared null context (no allocation, no clock read).
Instrumentation sits in host-side wrappers *around* kernel launches, never
inside code captured by ``torch.compile`` or a CUDA graph: captured code
replays without running its Python side effects, so a counter there would
fire once per capture, not once per call.

The one exception is :func:`device_mark`, the call meant for captured
code: inside a :func:`device_marks` scope it records a timing event on the
current stream, which a CUDA graph's capture turns into an event-record
node that fires at every replay.  Consecutive marks bound named intervals
of the device's work (``DeviceMarks.table``).  Outside such a scope it is
one flag test.

Enable globally with ``REPRO_OBS=1`` in the environment, or per-scope::

    from repro_torch import obs
    with obs.enabled_scope() as (registry, tracer):
        ...  # instrumented code publishes into this private pair

or imperatively with :func:`enable` / :func:`disable`.
"""
from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from . import metrics as _metrics
from . import trace as _trace

_enabled: bool = os.environ.get("REPRO_OBS", "").lower() in ("1", "true", "on")
_registry: _metrics.Registry = _metrics.REGISTRY
_tracer: _trace.Tracer = _trace.TRACER
_marks: Optional["DeviceMarks"] = None


def enabled() -> bool:
    return _enabled


def registry() -> _metrics.Registry:
    """The registry instrumentation currently publishes into."""
    return _registry


def tracer() -> _trace.Tracer:
    return _tracer


def enable(registry: Optional[_metrics.Registry] = None,
           tracer: Optional[_trace.Tracer] = None) -> None:
    """Turn instrumentation on, optionally onto private sinks."""
    global _enabled, _registry, _tracer
    if registry is not None:
        _registry = registry
    if tracer is not None:
        _tracer = tracer
    _enabled = True


def disable() -> None:
    """Turn instrumentation off and restore the default global sinks."""
    global _enabled, _registry, _tracer
    _enabled = False
    _registry = _metrics.REGISTRY
    _tracer = _trace.TRACER


@contextmanager
def disabled_scope() -> Iterator[None]:
    """Suppress recording inside the block; restore prior state on exit."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


@contextmanager
def enabled_scope(registry: Optional[_metrics.Registry] = None,
                  tracer: Optional[_trace.Tracer] = None
                  ) -> Iterator[Tuple[_metrics.Registry, _trace.Tracer]]:
    """Enable onto fresh (or given) sinks; restore prior state on exit."""
    global _enabled, _registry, _tracer
    prev = (_enabled, _registry, _tracer)
    reg = registry if registry is not None else _metrics.Registry()
    trc = tracer if tracer is not None else _trace.Tracer()
    enable(reg, trc)
    try:
        yield reg, trc
    finally:
        _enabled, _registry, _tracer = prev


# ---------------------------------------------------------------------------
# Recording helpers (no-ops when disabled)
# ---------------------------------------------------------------------------

def counter_inc(name: str, amount: float = 1, **labels) -> None:
    if not _enabled:
        return
    _registry.counter(name, **labels).inc(amount)


def gauge_set(name: str, value: float, **labels) -> None:
    if not _enabled:
        return
    _registry.gauge(name, **labels).set(value)


def hist_observe(name: str, value: float, **labels) -> None:
    if not _enabled:
        return
    _registry.histogram(name, **labels).observe(value)


class _NullSpan:
    """Inert stand-in yielded by the disabled ``span()``."""
    __slots__ = ()
    cycles = 0

    def add_cycles(self, n: int) -> None:
        pass

    def set(self, **kwargs) -> None:
        pass


class _NullCtx:
    __slots__ = ()
    _span = _NullSpan()

    def __enter__(self) -> _NullSpan:
        return self._span

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullCtx()


def span(name: str, **args):
    """Context manager: live tracer span when enabled, shared no-op if not."""
    if not _enabled:
        return _NULL_CTX
    return _tracer.span(name, **args)


def instrumented(name: Optional[str] = None, **labels
                 ) -> Callable[[Callable], Callable]:
    """Decorator: wrap calls in a span + ``<name>_ms`` latency histogram.

    The wrapper costs one flag test per call when disabled.  Apply to
    *host-side* functions only — never to code that ``torch.compile`` or a
    CUDA graph captures (see module docstring).  The latency is host time:
    it includes the device work only if the function synchronises.
    """
    def deco(fn: Callable) -> Callable:
        metric = name if name is not None else fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            with _tracer.span(metric, **labels):
                out = fn(*a, **kw)
            _registry.histogram(f"{metric}_ms", **labels).observe(
                (time.perf_counter() - t0) * 1e3)
            return out

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# Device marks: named intervals of the device's work, inside captured code
# ---------------------------------------------------------------------------

def _timing_event():
    import torch
    # ``external``: under capture the record becomes a graph node that fires
    # at each replay, not a dependency between the capture's streams
    return torch.cuda.Event(enable_timing=True, external=True)


def span_table(names: Sequence[str], interval_ms: Sequence[float]
               ) -> Dict[str, float]:
    """Each name's milliseconds: ``interval_ms[i]`` runs from mark ``i``
    (named ``names[i]``) to mark ``i + 1``, and a name's intervals add up
    (the same mark in every layer)."""
    if len(interval_ms) != len(names):
        raise ValueError(f"{len(names)} marks open {len(interval_ms)} "
                         f"intervals")
    out: Dict[str, float] = {}
    for name, ms in zip(names, interval_ms):
        out[name] = out.get(name, 0.0) + ms
    return out


class DeviceMarks:
    """The marks recorded in one :func:`device_marks` scope, in order, and
    the closing event the scope records last.

    Each mark's event is recorded once (at capture, in a graph) and holds
    the time of its latest firing; ``table`` reads the intervals once the
    closing event has completed."""

    def __init__(self, event: Callable = _timing_event):
        self._event = event
        self.names: List[str] = []
        self.events: list = []
        self.end = None

    def mark(self, name: str) -> None:
        ev = self._event()
        ev.record()
        self.names.append(name)
        self.events.append(ev)

    def close(self) -> None:
        self.end = self._event()
        self.end.record()

    def table(self) -> Dict[str, float]:
        """Each mark name's device milliseconds, to the next mark."""
        evs = self.events + [self.end]
        return span_table(self.names, [a.elapsed_time(b)
                                       for a, b in zip(evs, evs[1:])])


@contextmanager
def device_marks(event: Callable = _timing_event) -> Iterator[DeviceMarks]:
    """Record every :func:`device_mark` inside the block (then a closing
    event) into a fresh :class:`DeviceMarks`; ``event`` makes one timing
    event (a CUDA one by default)."""
    global _marks
    prev, rec = _marks, DeviceMarks(event)
    _marks = rec
    try:
        yield rec
        rec.close()
    finally:
        _marks = prev


def device_mark(name: str) -> None:
    """Open the interval ``name`` of the device's work here: the one obs
    call meant for code a CUDA graph captures (see the module docstring).
    A no-op outside a :func:`device_marks` scope."""
    if _marks is None:
        return
    _marks.mark(name)
