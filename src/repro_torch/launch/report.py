"""Render the port's dry-run records into roofline and dry-run tables (port
of ``repro.launch.report``).

``python -m repro_torch.launch.report [--out benchmarks/out/dryrun_torch]
[--table roofline|dryrun|both] [--mesh single] [--tag T]``

The records are ``launch.dryrun``'s, one JSON file a cell
(``<arch>__<shape>__<mesh>[__<tag>].json``).  The port walks one rank's
step under ``FakeTensorMode`` on the fake process group instead of
lowering it through XLA, so its records hold the rank's collective bytes,
its argument bytes, ``walk_s`` and its parameter and optimizer bytes, and
no ``lower_s``, ``compile_s`` or XLA's temporary bytes: each table keeps
the reference's columns, renders ``-`` for a field the record lacks, and
adds the port's own after them.  ``fmt_s``, ``pct`` and
``md_table`` are shared with ``repro_torch.obs.report`` and
``repro_torch.obs.regress``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import cells


def fmt_s(x):
    """Human seconds: ``1.23s`` / ``4.5ms`` / ``-`` for missing."""
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def pct(x):
    return "-" if x is None else f"{100 * x:.1f}%"


def md_table(header, rows):
    """Markdown table from a header tuple + row tuples (all stringified)."""
    lines = ["| " + " | ".join(str(h) for h in header) + " |",
             "|" + "---|" * len(header)]
    lines.extend("| " + " | ".join(str(c) for c in row) + " |"
                 for row in rows)
    return "\n".join(lines)


def _gb(n):
    return "-" if n is None else f"{n / 1e9:.2f}GB"


def _secs(x):
    return "-" if x is None else f"{x}s"


def load(outdir, tag=""):
    """The records under ``outdir`` by (arch, shape, mesh): those without a
    tag, or with ``tag`` only."""
    recs = {}
    for p in sorted(glob.glob(os.path.join(outdir, "*.json"))):
        name = os.path.basename(p)[:-5]
        parts = name.split("__")
        if len(parts) == 3 + (1 if tag else 0):
            if tag and parts[-1] != tag:
                continue
            if not tag and len(parts) != 3:
                continue
            with open(p) as f:
                recs[tuple(parts[:3])] = json.load(f)
    return recs


def roofline_table(recs, mesh="single"):
    """Each cell of ``mesh``: the roofline terms of its walked step (compute,
    memory of the walked ops and of the kernelized IO, collectives), the
    dominant term, the model FLOPs over the walked FLOPs and the MFU bound;
    then the skipped cells."""
    lines = [
        "| arch | shape | kind | compute | memory (lowered / kernelized) | "
        "collective | dominant | MF/walked | MFU bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (a, s, m), r in sorted(recs.items()):
        if m != mesh:
            continue
        if not r.get("ok"):
            lines.append(f"| {a} | {s} | - | FAILED: {r.get('error', '?')} | "
                         "| | | | |")
            continue
        rl = r["roofline"]
        ratio = rl.get("model_flops_ratio")
        lines.append(
            f"| {a} | {s} | {r['kind']} | {fmt_s(rl['compute_s'])} | "
            f"{fmt_s(rl['memory_s'])} / {fmt_s(rl.get('memory_s_kernelized'))} | "
            f"{fmt_s(rl.get('collective_s'))} | {rl['dominant']} -> "
            f"{rl.get('dominant_kernelized', rl['dominant'])} | "
            f"{'-' if ratio is None else f'{ratio:.2f}'} | "
            f"{pct(rl.get('mfu_bound_kernelized'))} |")
    for (a, s), why in sorted(cells.SKIPS.items()):
        lines.append(f"| {a} | {s} | skip | — | — | — | — | — | — |")
    return "\n".join(lines)


def dryrun_table(recs):
    """Each cell: the reference's columns (lowering and compile seconds,
    XLA's argument and temporary bytes a device, the top collectives by
    bytes), then the port's (seconds to walk the step, ops walked, the
    parameter and optimizer bytes a rank holds on the cell's mesh)."""
    lines = [
        "| arch | shape | mesh | lower | compile | args/dev | temp/dev | "
        "collective bytes/dev (top ops) | walk | ops | params+opt/rank |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (a, s, m), r in sorted(recs.items()):
        if not r.get("ok"):
            lines.append(f"| {a} | {s} | {m} | FAILED | "
                         f"{r.get('error', '?')[:60]} | | | | | | |")
            continue
        coll = r.get("collectives")
        top = "-" if coll is None else ", ".join(
            f"{k}:{v / 1e9:.2f}GB"
            for k, v in sorted(coll.items(), key=lambda kv: -kv[1])[:3])
        held = None
        if "param_bytes_per_rank" in r:
            held = r["param_bytes_per_rank"] + r.get("opt_bytes_per_rank", 0)
        lines.append(
            f"| {a} | {s} | {m} | {_secs(r.get('lower_s'))} | "
            f"{_secs(r.get('compile_s'))} | "
            f"{_gb(r.get('argument_size_in_bytes'))} | "
            f"{_gb(r.get('temp_size_in_bytes'))} | {top} | "
            f"{_secs(r.get('walk_s'))} | {r.get('ops', '-')} | {_gb(held)} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from repro_torch.launch.dryrun import OUT_DIR
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "dryrun", "both"])
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    recs = load(args.out, args.tag)
    if args.table in ("roofline", "both"):
        print(roofline_table(recs, args.mesh))
    if args.table in ("dryrun", "both"):
        print()
        print(dryrun_table(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
