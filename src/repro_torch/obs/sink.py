"""Exporters: JSONL event stream, summary dict, and BENCH_obs.json sidecar.

The PyTorch port's own copy of ``repro.obs.sink``: the same files in the
same shapes, so the reference's tools read what the port writes.

Three consumers, three shapes:

* **tests / ``chip_smoke.py``** assert against :func:`summary` — a plain dict
  (``{"meta": ..., "metrics": <Snapshot.to_dict()>, "spans": [...]}``);
* **perf-trajectory tooling** tails the JSONL stream written by
  :func:`write_jsonl` — one self-describing JSON object per line
  (``{"kind": "counter"|"gauge"|"histogram"|"span"|"meta", ...}``);
* **humans** run ``python -m repro_torch.obs.report <outdir>`` over the
  ``BENCH_obs.json`` sidecar dropped by :func:`write_sidecar`.

All writers are pure stdlib.  They raise normally on I/O errors — callers
that want best-effort persistence wrap them; only :func:`run_metadata` is
deliberately best-effort (a missing git binary must not kill a benchmark).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import List, Optional

from . import instrument
from .metrics import Registry, parse_series_key
from .trace import Tracer

SIDECAR_NAME = "BENCH_obs.json"


def _jsonable(obj):
    """json.dump default= hook: numpy scalars/arrays, tuples-as-keys, etc."""
    if hasattr(obj, "item"):        # numpy scalar
        return obj.item()
    if hasattr(obj, "tolist"):      # numpy array
        return obj.tolist()
    return str(obj)


def run_metadata(**extra) -> dict:
    """Reproducibility stamp: git SHA, interpreter, argv, plus ``extra``.

    Every value is best-effort — a missing git binary or a non-repo cwd
    yields ``git_sha=None`` rather than an exception, so runs can stamp
    their outputs unconditionally.  The repository root is four
    ``dirname``s above this file (``src/repro_torch/obs/sink.py``).
    """
    sha = None
    dirty = None
    try:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=10).stdout.strip() or None
        if sha:
            dirty = bool(subprocess.run(
                ["git", "status", "--porcelain"], cwd=root,
                capture_output=True, text=True, timeout=10).stdout.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    meta = {
        "git_sha": sha,
        "git_dirty": dirty,
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
    }
    meta.update(extra)
    return meta


def _span_dicts(tracer: Tracer) -> List[dict]:
    return [{"name": r.name, "ts_us": r.ts_us, "dur_us": r.dur_us,
             "depth": r.depth, "cycles": r.cycles, "args": dict(r.args)}
            for r in tracer.records]


def summary(registry: Optional[Registry] = None,
            tracer: Optional[Tracer] = None,
            meta: Optional[dict] = None) -> dict:
    """Single JSON-serializable dict for the whole run."""
    registry = registry if registry is not None else instrument.registry()
    tracer = tracer if tracer is not None else instrument.tracer()
    return {
        "meta": meta or {},
        "metrics": registry.snapshot().to_dict(),
        "spans": _span_dicts(tracer),
    }


def write_jsonl(path: str, registry: Optional[Registry] = None,
                tracer: Optional[Tracer] = None,
                meta: Optional[dict] = None) -> str:
    """One JSON object per line; first line is the run metadata."""
    registry = registry if registry is not None else instrument.registry()
    tracer = tracer if tracer is not None else instrument.tracer()
    snap = registry.snapshot()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", **(meta or {})},
                            default=_jsonable) + "\n")
        for key, v in snap.counters.items():
            name, labels = parse_series_key(key)
            f.write(json.dumps({"kind": "counter", "name": name,
                                "labels": labels, "value": v},
                               default=_jsonable) + "\n")
        for key, v in snap.gauges.items():
            name, labels = parse_series_key(key)
            f.write(json.dumps({"kind": "gauge", "name": name,
                                "labels": labels, "value": v},
                               default=_jsonable) + "\n")
        for key, h in snap.histograms.items():
            name, labels = parse_series_key(key)
            f.write(json.dumps({"kind": "histogram", "name": name,
                                "labels": labels, **h},
                               default=_jsonable) + "\n")
        for s in _span_dicts(tracer):
            f.write(json.dumps({"kind": "span", **s},
                                default=_jsonable) + "\n")
    return path


def write_sidecar(outdir: str, registry: Optional[Registry] = None,
                  tracer: Optional[Tracer] = None,
                  meta: Optional[dict] = None,
                  name: str = SIDECAR_NAME) -> str:
    """Write ``<outdir>/BENCH_obs.json`` (+ Chrome trace when spans exist)."""
    os.makedirs(outdir, exist_ok=True)
    tracer = tracer if tracer is not None else instrument.tracer()
    path = os.path.join(outdir, name)
    with open(path, "w") as f:
        json.dump(summary(registry, tracer, meta), f, indent=1,
                  sort_keys=True, default=_jsonable)
        f.write("\n")
    if tracer.records:
        with open(os.path.join(outdir, "trace.json"), "w") as f:
            json.dump(tracer.chrome_trace(), f, default=_jsonable)
    return path


def read_summary(path: str) -> dict:
    """Load a summary written by :func:`write_sidecar` (file or outdir)."""
    if os.path.isdir(path):
        path = os.path.join(path, SIDECAR_NAME)
    with open(path) as f:
        return json.load(f)
