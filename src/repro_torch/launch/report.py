"""Markdown-table and duration helpers shared by the port's reports.

The port's copy of ``fmt_s``, ``pct`` and ``md_table`` from
``repro.launch.report``, which ``repro_torch.obs.report`` and
``repro_torch.obs.regress`` render with.  The rest of the reference module
(``load``, ``roofline_table``, ``dryrun_table`` and the ``cells`` grid) reads
the XLA dry-run grid and is not ported: it waits for the port's own
roofline tooling (ROADMAP Queue 1, tooling).
"""
from __future__ import annotations


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
