"""Findings model + suppression baseline for ``repro_torch.analysis``.

A *finding* is one rule violation: rule id, severity, location, message.
Findings are value objects so passes stay pure (emit, never print) and the
runner owns presentation, exit codes and the suppression baseline.

The baseline file (default ``src/repro_torch/analysis/baseline.json``) holds
fingerprints of known findings; the CLI fails only on findings *not* in
the baseline, so a violation can be suppressed explicitly (reviewed,
committed, visible in diffs) instead of silently tolerated.  The repo's
own baseline is empty — the tree is kept clean — and the workflow for a
deliberate suppression is documented in the package README.

Fingerprints hash (rule, location-without-line, message) so a finding does
not escape its suppression by drifting a few lines.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

#: severity order, most severe first
SEVERITIES = ("error", "warning", "info")


def severity_rank(severity: str) -> int:
    return SEVERITIES.index(severity)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation discovered by a pass."""
    rule: str          # catalog id, e.g. "ACC101"
    severity: str      # error | warning | info
    location: str      # "path/to/file.py:123" or "stencil:jacobi-1d@6x6"
    message: str
    pass_name: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def fingerprint(self) -> str:
        loc = self.location.rsplit(":", 1)
        base = loc[0] if len(loc) == 2 and loc[1].isdigit() else self.location
        h = hashlib.sha256(
            f"{self.rule}|{base}|{self.message}".encode()).hexdigest()
        return h[:16]

    def to_dict(self) -> Dict[str, str]:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def render(self) -> str:
        return (f"{self.severity.upper():7s} {self.rule} "
                f"{self.location}: {self.message}")


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (severity_rank(f.severity),
                                           f.rule, f.location, f.message))


# ---------------------------------------------------------------------------
# Suppression baseline
# ---------------------------------------------------------------------------

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str = DEFAULT_BASELINE) -> Dict[str, dict]:
    """fingerprint -> recorded entry; missing file == empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    return {e["fingerprint"]: e for e in doc.get("suppressions", [])}

def write_baseline(findings: Sequence[Finding],
                   path: str = DEFAULT_BASELINE) -> None:
    """Record every given finding as suppressed (explicit refresh only)."""
    entries = [{"fingerprint": f.fingerprint, "rule": f.rule,
                "location": f.location, "message": f.message}
               for f in sort_findings(findings)]
    with open(path, "w") as f:
        json.dump({"suppressions": entries}, f, indent=1, sort_keys=True)
        f.write("\n")


def split_by_baseline(findings: Sequence[Finding],
                      baseline: Dict[str, dict]
                      ) -> Tuple[List[Finding], List[Finding]]:
    """(new findings, suppressed findings) under a loaded baseline."""
    new, suppressed = [], []
    for f in findings:
        (suppressed if f.fingerprint in baseline else new).append(f)
    return new, suppressed
