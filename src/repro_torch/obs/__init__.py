"""``repro_torch.obs`` — metrics and trace spans for the PyTorch port.

Copies of ``repro.obs`` (the port imports nothing of ``repro``), with the
same series names, so a run of the port and a run of the reference publish
comparable registries.  Ported so far: all of it — the registry
(``metrics``), spans (``trace``), the enable-gated facade
(``instrument``), the exporters (``sink``: summary, JSONL, the
``BENCH_obs.json`` sidecar), the table CLI ``python -m
repro_torch.obs.report <dir>`` and the regression gate ``python -m
repro_torch.obs.regress <run> --baseline <b>``.

Typical use::

    from repro_torch import obs

    with obs.enabled_scope() as (registry, tracer):
        ...  # e.g. repro_torch.kernels.ops.pack_codes(q, 8)
        doc = obs.summary(registry, tracer)

Disabled (the default unless ``REPRO_OBS=1``), every helper is a single
flag test — see ``instrument``.  ``device_mark`` is the one call meant for
code a CUDA graph captures: it times named parts of the replayed step.
"""
# NOTE: ``regress`` is deliberately not imported here — it is a ``-m``
# entry point (importing it from the package __init__ would make runpy
# warn about double execution); use ``from repro_torch.obs import regress``.
from . import instrument, metrics, sink, trace
from .instrument import (DeviceMarks, counter_inc, device_mark,
                         device_marks, disable, disabled_scope, enable,
                         enabled, enabled_scope, gauge_set, hist_observe,
                         instrumented, registry, span, span_table, tracer)
from .metrics import Counter, Gauge, Histogram, Registry, Snapshot, series_key
from .sink import read_summary, run_metadata, summary, write_jsonl, write_sidecar
from .trace import Span, SpanRecord, Tracer

__all__ = [
    "Counter", "DeviceMarks", "Gauge", "Histogram", "Registry", "Snapshot",
    "Span", "SpanRecord", "Tracer", "counter_inc", "device_mark",
    "device_marks", "disable", "disabled_scope",
    "enable", "enabled", "enabled_scope", "gauge_set", "hist_observe",
    "instrument", "instrumented", "metrics", "read_summary", "registry",
    "run_metadata", "series_key", "sink", "span", "span_table", "summary",
    "trace",
    "tracer", "write_jsonl", "write_sidecar",
]
