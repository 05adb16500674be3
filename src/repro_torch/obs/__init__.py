"""``repro_torch.obs`` — metrics and trace spans for the PyTorch port.

Copies of ``repro.obs.{metrics,trace,instrument}`` (the port imports
nothing of ``repro``), with the same series names, so a run of the port
and a run of the reference publish comparable registries.  The
``sink``/``report``/``regress`` exporters are not ported yet.

Typical use::

    from repro_torch import obs

    with obs.enabled_scope() as (registry, tracer):
        ...  # e.g. repro_torch.kernels.ops.pack_codes(q, 8)
        registry.snapshot().counters

Disabled (the default unless ``REPRO_OBS=1``), every helper is a single
flag test — see ``instrument``.
"""
from . import instrument, metrics, trace
from .instrument import (counter_inc, disable, disabled_scope, enable,
                         enabled, enabled_scope, gauge_set, hist_observe,
                         instrumented, registry, span, tracer)
from .metrics import Counter, Gauge, Histogram, Registry, Snapshot, series_key
from .trace import Span, SpanRecord, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Snapshot", "Span",
    "SpanRecord", "Tracer", "counter_inc", "disable", "disabled_scope",
    "enable", "enabled", "enabled_scope", "gauge_set", "hist_observe",
    "instrument", "instrumented", "metrics", "registry", "series_key",
    "span", "trace", "tracer",
]
