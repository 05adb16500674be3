"""Lightweight metrics registry: counters, gauges, histograms with labels.

The paper's figure of merit is *measured* (§5: on-FPGA I/O-cycle counters),
so the reproduction keeps the same discipline in software: every hot-path
quantity — transfer cycles per access pattern, compressed vs padded bits,
executor tile counts, train step latency, serve KV bytes — is published
into a registry that benchmarks and tests can snapshot and assert against.

This is the PyTorch port's own copy of ``repro.obs.metrics`` (the port
imports nothing of ``repro``); series names and snapshot layout are the
same, so the two packages' runs compare series for series.

Naming conventions (shared with ``src/repro/obs/README.md``):

* metric names are ``<subsystem>/<quantity>`` (``transfer/cycles``,
  ``compression/ratio``, ``train/step_ms``);
* labels qualify a series (``pattern=mars_comp``, ``dtype=fixed18``); every
  distinct label set is an independent series;
* counters are monotonically accumulated ints/floats, gauges hold the last
  value, histograms keep count/sum/min/max plus power-of-two bucket counts.

The registry is pure Python with no third-party deps, and cheap enough
that the *enabled* path costs a dict lookup + add.  The *disabled* path
never reaches this module — see ``repro_torch.obs.instrument``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

LabelSet = Tuple[Tuple[str, str], ...]


def _labelset(labels: Dict[str, object]) -> LabelSet:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def series_key(name: str, labels: Dict[str, object] | LabelSet | None) -> str:
    """Canonical ``name{k=v,...}`` series identifier (sorted label order)."""
    if not labels:
        return name
    if isinstance(labels, dict):
        labels = _labelset(labels)
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`series_key`."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    rest = rest.rstrip("}")
    labels = dict(item.split("=", 1) for item in rest.split(",") if item)
    return name, labels


class Counter:
    """Monotonic accumulator."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelSet):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} decremented by {amount}")
        self.value += amount


class Gauge:
    """Last-value holder."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelSet):
        self.name = name
        self.labels = labels
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Count/sum/min/max + power-of-two bucket counts.

    Buckets are implicit: observation ``v`` lands in bucket
    ``ceil(log2(v))`` for ``v > 0`` (bucket upper bound ``2**b``), with a
    dedicated ``<=0`` bucket.  This is exact enough for cycle counts and
    millisecond latencies while keeping the series O(64) in size.
    """
    __slots__ = ("name", "labels", "count", "sum", "min", "max", "buckets")

    def __init__(self, name: str, labels: LabelSet):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: Dict[int, int] = {}

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        b = -1 if value <= 0 else max(0, math.ceil(math.log2(value)))
        self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None


@dataclasses.dataclass
class Snapshot:
    """Frozen, JSON-serializable view of a registry."""
    counters: Dict[str, float]
    gauges: Dict[str, Optional[float]]
    histograms: Dict[str, dict]

    def to_dict(self) -> dict:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: dict(v) for k, v in self.histograms.items()}}


class Registry:
    """Holds all metric series; thread-safe; snapshot/reset semantics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- series accessors ---------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = series_key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(name, _labelset(labels))
            return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = series_key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge(name, _labelset(labels))
            return g

    def histogram(self, name: str, **labels) -> Histogram:
        key = series_key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(name, _labelset(labels))
            return h

    # -- queries ------------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        c = self._counters.get(series_key(name, labels))
        return 0 if c is None else c.value

    def series(self, name: str) -> List[str]:
        """All series keys (any kind) for a metric name."""
        out = []
        for store in (self._counters, self._gauges, self._histograms):
            out.extend(k for k in store if parse_series_key(k)[0] == name)
        return sorted(out)

    def snapshot(self) -> Snapshot:
        with self._lock:
            return Snapshot(
                counters={k: c.value for k, c in self._counters.items()},
                gauges={k: g.value for k, g in self._gauges.items()},
                histograms={
                    k: {"count": h.count, "sum": h.sum, "min": h.min,
                        "max": h.max, "mean": h.mean,
                        "buckets": {str(b): n
                                    for b, n in sorted(h.buckets.items())}}
                    for k, h in self._histograms.items()},
            )

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def __len__(self) -> int:
        return (len(self._counters) + len(self._gauges)
                + len(self._histograms))


#: Process-wide default registry; ``repro_torch.obs.instrument`` publishes
#: here unless :func:`repro_torch.obs.instrument.enable` installed a
#: private one.
REGISTRY = Registry()
