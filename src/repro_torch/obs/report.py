"""Render a run's obs sidecar as tables: ``python -m repro_torch.obs.report <outdir>``.

The PyTorch port's own copy of ``repro.obs.report``.  Reads the
``BENCH_obs.json`` written by any :func:`repro_torch.obs.sink.write_sidecar`
caller (``chip_smoke.py``'s paper phase writes one) and prints:

* per-pattern transfer-cycle counters (the paper's Fig. 10 axis:
  minimal / bbox / mars / mars_pack / mars_comp), grouped by benchmark,
  tile, and dtype;
* compression-ratio and bit-size histograms (Fig. 11 axis);
* every remaining counter / gauge / histogram series;
* a span rollup (count, wall-clock total, logical-cycle total per name).

Sections a run did not exercise render as ``n/a`` placeholders rather than
raising — a smoke run without the beyond-paper benches must still report.
``--format=json`` emits the :func:`repro_torch.obs.regress.flatten_series` view
instead, so the regression gate and humans read the same numbers.

Formatting reuses the markdown-table and duration helpers from
``repro_torch.launch.report``, as the reference's report does.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict, Tuple

from repro_torch.core.transfer import MODES as TRANSFER_PATTERNS
from repro_torch.launch.report import fmt_s, md_table

from .metrics import parse_series_key
from .regress import flatten_series
from .sink import read_summary


def _fmt_val(v) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.4g}"
    try:
        return str(int(v))
    except (TypeError, ValueError):
        return str(v)


def transfer_cycles_table(counters: Dict[str, float]) -> str:
    """Pivot ``transfer/cycles{...}`` counters: one column per pattern."""
    cells: Dict[Tuple[str, str, str], Dict[str, float]] = defaultdict(dict)
    for key, v in counters.items():
        name, labels = parse_series_key(key)
        if name != "transfer/cycles":
            continue
        row = (labels.get("bench", "?"), labels.get("tile", "?"),
               labels.get("dtype", "?"))
        cells[row][labels.get("pattern", "?")] = v
    if not cells:
        return "(n/a — no transfer/cycles counters in this run)"
    rows = []
    for (bench, tile, dtype), by_pat in sorted(cells.items()):
        rows.append((bench, tile, dtype,
                     *[_fmt_val(by_pat.get(p)) for p in TRANSFER_PATTERNS]))
    return md_table(("bench", "tile", "dtype", *TRANSFER_PATTERNS), rows)


def histogram_table(histograms: Dict[str, dict], prefix: str = "") -> str:
    rows = []
    for key, h in sorted(histograms.items()):
        if not key.startswith(prefix):
            continue
        h = h or {}
        rows.append((key, _fmt_val(h.get("count")), _fmt_val(h.get("min")),
                     _fmt_val(h.get("mean")), _fmt_val(h.get("max")),
                     _fmt_val(h.get("sum"))))
    if not rows:
        return f"(n/a — no {prefix or 'histogram'}* series in this run)"
    return md_table(("series", "count", "min", "mean", "max", "sum"), rows)


def scalar_table(series: Dict[str, float], kind: str) -> str:
    rows = [(k, _fmt_val(v)) for k, v in sorted(series.items())]
    if not rows:
        return f"(n/a — no {kind}s in this run)"
    return md_table(("series", "value"), rows)


def span_table(spans) -> str:
    agg: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0])
    for s in spans or []:
        a = agg[s.get("name", "?")]
        a[0] += 1
        a[1] += s.get("dur_us", 0.0) or 0.0
        a[2] += s.get("cycles", 0) or 0
    if not agg:
        return "(n/a — no spans in this run)"
    rows = [(name, n, fmt_s(us / 1e6), _fmt_val(cyc))
            for name, (n, us, cyc) in sorted(agg.items())]
    return md_table(("span", "count", "wall total", "cycles total"), rows)


def render(doc: dict) -> str:
    meta = doc.get("meta", {}) or {}
    m = doc.get("metrics", {}) or {}
    counters = m.get("counters", {}) or {}
    histograms = m.get("histograms", {}) or {}
    out = []
    stamp = ", ".join(f"{k}={v}" for k, v in sorted(meta.items())
                      if k in ("git_sha", "config", "seed", "smoke")
                      and v is not None)
    out.append(f"# obs report ({stamp})" if stamp else "# obs report")
    out.append("\n## Transfer cycles by access pattern\n")
    out.append(transfer_cycles_table(counters))
    out.append("\n## Compression histograms\n")
    out.append(histogram_table(histograms, prefix="compression/"))
    out.append("\n## Counters\n")
    out.append(scalar_table(counters, "counter"))
    out.append("\n## Gauges\n")
    out.append(scalar_table(m.get("gauges", {}) or {}, "gauge"))
    out.append("\n## Other histograms\n")
    out.append(histogram_table(
        {k: v for k, v in histograms.items()
         if not k.startswith("compression/")}))
    out.append("\n## Spans\n")
    out.append(span_table(doc.get("spans", [])))
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Render BENCH_obs.json metrics as markdown tables.")
    ap.add_argument("path", help="run output dir (or sidecar file) to report")
    ap.add_argument("--format", choices=("md", "json"), default="md",
                    help="json prints the flat series view the regression "
                         "gate compares (repro_torch.obs.regress.flatten_series)")
    args = ap.parse_args(argv)
    try:
        doc = read_summary(args.path)
    except FileNotFoundError as e:
        ap.error(f"no obs sidecar at {e.filename!r} — write one with "
                 "repro_torch.obs.sink.write_sidecar first")
    if args.format == "json":
        print(json.dumps({"meta": doc.get("meta", {}) or {},
                          "series": flatten_series(doc)},
                         indent=1, sort_keys=True))
    else:
        print(render(doc))


if __name__ == "__main__":
    main()
