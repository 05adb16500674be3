"""Enable-gated instrumentation facade — the only obs API hot paths touch.

The PyTorch port's own copy of ``repro.obs.instrument``.

Design rule: *zero cost when disabled*.  Every helper starts with a single
module-flag test and returns immediately when obs is off; the disabled
``span()`` returns a shared null context (no allocation, no clock read).
Instrumentation sits in host-side wrappers *around* kernel launches, never
inside code captured by ``torch.compile`` or a CUDA graph: captured code
replays without running its Python side effects, so a counter there would
fire once per capture, not once per call.

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
from typing import Callable, Iterator, Optional, Tuple

from . import metrics as _metrics
from . import trace as _trace

_enabled: bool = os.environ.get("REPRO_OBS", "").lower() in ("1", "true", "on")
_registry: _metrics.Registry = _metrics.REGISTRY
_tracer: _trace.Tracer = _trace.TRACER


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
