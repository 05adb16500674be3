"""Bandwidth regression gate: ``python -m repro_torch.obs.regress <run> --baseline <b>``.

The PyTorch port's own copy of ``repro.obs.regress``: the same gates,
tolerances and exit codes over the sidecars ``repro_torch.obs.sink``
writes.

The paper's claim is a *measured* one (up to 7x fewer I/O cycles), and the
companion literature (Ferry et al. burst-friendly layouts; Zohouri &
Matsuoka's memory-controller wall) shows how silently such wins erode.
This module is the enforcement half of the obs layer: it diffs the
``BENCH_obs.json`` sidecar of a fresh run against a baseline sidecar
and exits nonzero when a load-bearing series
regressed, so CI fails the PR that spent the cycles.

Tolerance policy (``GATES``):

* **logical** cycle/byte/beat counters (``transfer/cycles``,
  ``kernels/hbm_bytes``, ``collectives/wire_bytes``, ...) are deterministic
  functions of seeded data and analytic models — they are compared
  **exactly** (float epsilon only).  Any drift in the bad direction fails;
  drift in the good direction is reported as ``improved`` with a reminder
  to refresh the baseline.
* **wall-clock** series (``ckpt/save_ms``, ``train/step_ms``, ...) get a
  **percentage band** (``--wall-tol``, default allow 3x over baseline)
  because absolute times vary machine to machine; the band only catches
  order-of-magnitude pathology, the logical counters are the real gate.
* everything else is tracked in the table but never fails the run.

A series present in only one side is a warning, not a failure: smoke grids
legitimately grow and shrink, and a stale baseline must say "refresh me"
rather than block unrelated PRs.

A baseline is any earlier run's sidecar (``sink.write_sidecar``): refresh
it by copying the new run's ``BENCH_obs.json`` over it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

from .metrics import parse_series_key
from .sink import read_summary

#: relative epsilon forgiving float round-off on "exact" comparisons
EXACT_EPS = 1e-6

#: default allowed fractional slowdown for wall-clock series (3.0 = 4x)
DEFAULT_WALL_TOL = 3.0

EXACT, WALL = "exact", "wall"

#: (metric-name prefix, better direction, tolerance kind) — first match wins.
GATES: List[Tuple[str, str, str]] = [
    ("transfer/cycles", "lower", EXACT),
    ("transfer/bits", "lower", EXACT),
    ("transfer/transactions", "lower", EXACT),
    ("burst/beats", "lower", EXACT),
    ("compression/ratio_padded", "higher", EXACT),
    ("compression/ratio", "higher", EXACT),
    ("codec/bits", "lower", EXACT),
    ("codec/words", "lower", EXACT),
    ("exec/compressed_bits", "lower", EXACT),
    ("exec/uncompressed_bits", "lower", EXACT),
    ("exec/full_tiles", "lower", EXACT),
    ("exec/host_tiles", "lower", EXACT),
    ("exec/mars_read", "lower", EXACT),
    ("exec/mars_written", "lower", EXACT),
    ("codec/bench_ms", "lower", WALL),
    ("codec/words_per_s", "higher", WALL),
    ("exec/tiles_per_s", "higher", WALL),
    ("kernels/hbm_bytes", "lower", EXACT),
    ("kernels/beats", "lower", EXACT),
    ("collectives/wire_bytes", "lower", EXACT),
    ("audit/divergences", "lower", EXACT),
    ("audit/hlo_bytes", "lower", EXACT),
    ("audit/analytic_bytes", "lower", EXACT),
    ("ckpt/bytes_written", "lower", EXACT),
    ("ckpt/bytes_read", "lower", EXACT),
    ("ckpt/save_ms", "lower", WALL),
    ("ckpt/restore_ms", "lower", WALL),
    ("train/step_ms", "lower", WALL),
    ("serve/generate_ms", "lower", WALL),
    ("data/batch_ms", "lower", WALL),
    ("analysis/findings", "lower", EXACT),
    ("analysis/new_findings", "lower", EXACT),
    ("analysis/pass_findings", "lower", EXACT),
]


def gate_for(metric_name: str) -> Optional[Tuple[str, str]]:
    """(direction, kind) for a metric name, or None if ungated."""
    for prefix, direction, kind in GATES:
        if metric_name == prefix or metric_name.startswith(prefix + "{"):
            return direction, kind
    return None


def flatten_series(doc: dict) -> Dict[str, dict]:
    """Sidecar -> flat ``{series_key: {kind, value[, count]}}``.

    The one number the gate compares per series: counters and gauges use
    their value, histograms their mean (``count`` is carried along so grid
    changes are visible).  This is the same view ``repro_torch.obs.report
    --format=json`` prints — the gate and humans read identical numbers.
    """
    m = doc.get("metrics", {}) or {}
    out: Dict[str, dict] = {}
    for k, v in (m.get("counters", {}) or {}).items():
        out[k] = {"kind": "counter", "value": v}
    for k, v in (m.get("gauges", {}) or {}).items():
        out[k] = {"kind": "gauge", "value": v}
    for k, h in (m.get("histograms", {}) or {}).items():
        out[k] = {"kind": "histogram", "value": (h or {}).get("mean"),
                  "count": (h or {}).get("count")}
    return out


@dataclasses.dataclass
class Delta:
    """One compared series (or one side-only series)."""
    key: str
    status: str                    # ok | REGRESSION | improved | new |
    #                              # missing | untracked
    baseline: Optional[float] = None
    current: Optional[float] = None
    note: str = ""

    @property
    def failed(self) -> bool:
        return self.status == "REGRESSION"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _rel(base: Optional[float], cur: Optional[float]) -> Optional[float]:
    """Signed relative change cur vs base; None when undefined."""
    if base is None or cur is None:
        return None
    if base == 0:
        return None if cur == 0 else float("inf") * (1 if cur > 0 else -1)
    return (cur - base) / abs(base)


def compare(baseline: Dict[str, dict], current: Dict[str, dict],
            wall_tol: float = DEFAULT_WALL_TOL) -> List[Delta]:
    """Diff two flattened series maps under the ``GATES`` policy."""
    deltas: List[Delta] = []
    for key in sorted(set(baseline) | set(current)):
        name, _ = parse_series_key(key)
        gate = gate_for(name)
        b = baseline.get(key)
        c = current.get(key)
        if b is None:
            deltas.append(Delta(key, "new", None,
                                c.get("value"),
                                "no baseline series — refresh baseline"
                                if gate else ""))
            continue
        if c is None:
            deltas.append(Delta(key, "missing", b.get("value"), None,
                                "series vanished from run — refresh baseline"
                                if gate else ""))
            continue
        bv, cv = b.get("value"), c.get("value")
        d = Delta(key, "untracked", bv, cv)
        note = []
        if b.get("count") is not None and b.get("count") != c.get("count"):
            note.append(f"count {b['count']}->{c['count']}")
        if gate is None:
            d.note = "; ".join(note)
            deltas.append(d)
            continue
        direction, kind = gate
        rel = _rel(bv, cv)
        if bv is None or cv is None:
            d.status = "missing" if cv is None else "ok"
            d.note = "empty value"
        elif rel is None:
            d.status = "ok"
        else:
            worse = rel if direction == "lower" else -rel
            tol = wall_tol if kind == WALL else EXACT_EPS
            if worse > tol:
                d.status = "REGRESSION"
                note.append(f"{'+' if rel >= 0 else ''}{rel:.1%} vs "
                            f"{'exact' if kind == EXACT else 'wall'} "
                            f"tolerance {tol:.2g}")
            elif kind == EXACT and -worse > EXACT_EPS:
                d.status = "improved"
                note.append("refresh baseline to lock in the win")
            else:
                d.status = "ok"
        d.note = "; ".join(note)
        deltas.append(d)
    return deltas


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, float) and not float(v).is_integer():
        return f"{v:.4g}"
    return str(int(v))


def render_table(deltas: List[Delta], verbose: bool = False) -> str:
    """Markdown delta table; quiet mode hides untracked/unchanged rows."""
    from repro_torch.launch.report import md_table
    rows = []
    for d in deltas:
        if not verbose and d.status in ("untracked", "ok") and not d.note:
            continue
        rel = _rel(d.baseline, d.current)
        rows.append((d.key, _fmt(d.baseline), _fmt(d.current),
                     "n/a" if rel is None else f"{rel:+.2%}",
                     d.status, d.note))
    if not rows:
        return "(all tracked series unchanged)"
    return md_table(("series", "baseline", "current", "delta", "status",
                     "note"), rows)


def run_gate(run_path: str, baseline_path: str,
             wall_tol: float = DEFAULT_WALL_TOL) -> Tuple[List[Delta], dict]:
    """Load both sidecars, compare, and summarize. Returns (deltas, stats)."""
    base_doc = read_summary(baseline_path)
    cur_doc = read_summary(run_path)
    deltas = compare(flatten_series(base_doc), flatten_series(cur_doc),
                     wall_tol=wall_tol)
    stats = {
        "run": run_path,
        "baseline": baseline_path,
        "baseline_sha": (base_doc.get("meta") or {}).get("git_sha"),
        "run_sha": (cur_doc.get("meta") or {}).get("git_sha"),
        "compared": sum(d.status in ("ok", "REGRESSION", "improved")
                        for d in deltas),
        "regressions": sum(d.failed for d in deltas),
        "improved": sum(d.status == "improved" for d in deltas),
        "new": sum(d.status == "new" for d in deltas),
        "missing": sum(d.status == "missing" for d in deltas),
    }
    return deltas, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Diff a run's BENCH_obs.json against a baseline and "
                    "fail on bandwidth/latency regressions.")
    ap.add_argument("run", help="run output dir (or sidecar file)")
    ap.add_argument("--baseline", required=True,
                    help="baseline sidecar (or dir) of an earlier run")
    ap.add_argument("--wall-tol", type=float, default=DEFAULT_WALL_TOL,
                    help="allowed fractional slowdown for wall-clock series "
                         "(default %(default)s, i.e. fail beyond "
                         "(1+tol)x baseline)")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    ap.add_argument("--verbose", action="store_true",
                    help="also print unchanged/untracked rows")
    args = ap.parse_args(argv)

    try:
        deltas, stats = run_gate(args.run, args.baseline,
                                 wall_tol=args.wall_tol)
    except FileNotFoundError as e:
        ap.error(f"missing sidecar: {e.filename!r} — write one with "
                 "repro_torch.obs.sink.write_sidecar first")

    code = 1 if stats["regressions"] else 0
    if args.format == "json":
        print(json.dumps({"stats": stats, "exit_code": code,
                          "deltas": [d.to_dict() for d in deltas]},
                         indent=1, sort_keys=True))
        return code

    print(f"# obs regression gate\n\nbaseline: {args.baseline} "
          f"(sha {stats['baseline_sha'] or 'n/a'})\n"
          f"run:      {args.run} (sha {stats['run_sha'] or 'n/a'})\n")
    print(render_table(deltas, verbose=args.verbose))
    print(f"\n{stats['compared']} gated series compared — "
          f"{stats['regressions']} regression(s), "
          f"{stats['improved']} improved, {stats['new']} new, "
          f"{stats['missing']} missing")
    if stats["regressions"]:
        print("\nFAIL: bandwidth/latency regression vs baseline. If the "
              "change is intentional, refresh the baseline sidecar.")
    elif stats["improved"]:
        print("\nOK (improvements detected — refresh the baseline sidecar "
              "to lock them in).")
    return code


if __name__ == "__main__":
    sys.exit(main())
