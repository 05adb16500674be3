"""Multi-pass orchestration for ``repro_torch.analysis`` (port of
``repro.analysis.runner``).

``run_all`` executes the three pass families, applies the suppression
baseline, and returns a report dict (same JSON-serializable shape idiom
as ``launch.audit``).  ``publish_report`` emits ``analysis/*`` series so
``repro_torch.obs.regress`` gates finding counts, and ``selftest``
injects one violation per rule family and verifies each pass actually
fires — the analyzer equivalent of audit's ``--perturb-analytic``.  The
reference injects hand-written HLO; the port's injections are torch
functions walked like the kernel routes.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import access, layout_invariants, obs_discipline
from .findings import (Finding, load_baseline, sort_findings,
                       split_by_baseline)

#: source tree the obs-discipline pass walks by default
DEFAULT_ROOT = "src/repro_torch"


def run_all(root: str = DEFAULT_ROOT,
            baseline_path: Optional[str] = None,
            with_access: bool = True, device="cuda") -> dict:
    """Run every pass; split findings against the suppression baseline.

    ``with_access=False`` skips the access-pattern walk of the kernel
    routes for fast host-only checks; ``device`` chooses the routes it
    walks (the plain ones on the CPU, the kernels on a card).
    """
    per_pass: Dict[str, List[Finding]] = {}
    if with_access:
        per_pass[access.PASS_NAME] = access.run_pass(device=device)
    else:
        per_pass[access.PASS_NAME] = access.check_data_types()
    per_pass[obs_discipline.PASS_NAME] = obs_discipline.analyze_tree(root)
    per_pass[layout_invariants.PASS_NAME] = layout_invariants.run_pass()

    findings = sort_findings(
        [f for fs in per_pass.values() for f in fs])
    baseline = load_baseline(baseline_path) if baseline_path else (
        load_baseline())
    new, suppressed = split_by_baseline(findings, baseline)
    return {
        "findings": [f.to_dict() for f in findings],
        "new": [f.to_dict() for f in new],
        "suppressed": [f.to_dict() for f in suppressed],
        "per_pass": {k: len(v) for k, v in per_pass.items()},
        "n_findings": len(findings),
        "n_new": len(new),
        "n_suppressed": len(suppressed),
    }


def worst_new_severity(report: dict) -> Optional[str]:
    sevs = [f["severity"] for f in report["new"]]
    for s in ("error", "warning", "info"):
        if s in sevs:
            return s
    return None


def render_report(report: dict) -> str:
    lines = []
    for f in report["new"]:
        lines.append(f"{f['severity'].upper():7s} {f['rule']} "
                     f"{f['location']}: {f['message']}")
    for f in report["suppressed"]:
        lines.append(f"suppressed {f['rule']} {f['location']} "
                     f"[{f['fingerprint']}]")
    per = ", ".join(f"{k}={v}" for k, v in sorted(
        report["per_pass"].items()))
    lines.append(f"analysis: {report['n_new']} new, "
                 f"{report['n_suppressed']} suppressed ({per})")
    return "\n".join(lines)


def publish_report(report: dict) -> None:
    """Emit ``analysis/*`` series (no-op when obs is disabled).

    ``analysis/new_findings`` must stay at its baseline of 0 — the
    regression gate compares it exactly, so a change that introduces a
    violation fails the gate even if nobody ran the CLI.
    """
    from repro_torch.obs import instrument as obs
    if not obs.enabled():
        return
    obs.counter_inc("analysis/findings", report["n_findings"])
    obs.counter_inc("analysis/new_findings", report["n_new"])
    obs.counter_inc("analysis/suppressed", report["n_suppressed"])
    for pass_name, n in sorted(report["per_pass"].items()):
        obs.counter_inc("analysis/pass_findings", n, pass_name=pass_name)


# ---------------------------------------------------------------------------
# Selftest: one injected violation per rule family
# ---------------------------------------------------------------------------

def redundant_fixture(x: torch.Tensor) -> torch.Tensor:
    """Reads an f32[1024] argument and writes it twice (concatenated with
    itself): 8192 B of writes against a 4096 B analytic charge."""
    return torch.cat([x, x])


def strided_fixture(x: torch.Tensor) -> torch.Tensor:
    """A stride-2 innermost slice of an off-chip argument."""
    return x[:, ::2]


#: source fixture: obs recording reachable through a compiled helper
OBS_UNDER_COMPILE_SRC = """\
import torch
from repro_torch.obs import instrument as obs

def helper(x):
    obs.counter_inc("bad/inside_trace", 1)
    return x

@torch.compile
def kernel(x):
    return helper(x)
"""

#: source fixture: obs recording inside a checkpointed (replayed) layer
OBS_UNDER_CHECKPOINT_SRC = """\
import torch
from torch.utils.checkpoint import checkpoint
from repro_torch.obs import instrument as obs

def layer(x):
    obs.gauge_set("bad/inside_remat", 1.0)
    return x * 2

def forward(x):
    return checkpoint(layer, x, use_reentrant=False)
"""


def selftest() -> dict:
    """Inject one violation per rule family; report which passes fired.

    Returns ``{"ok": bool, "fired": {injection: bool}}`` — ``ok`` only
    when every injected violation was caught.  This is the proof that a
    green analyzer run means "checked and clean", not "checked nothing".
    """
    import dataclasses

    from repro_torch.core import layout, mars, stencil

    fired: Dict[str, bool] = {}
    vec = torch.arange(1024, dtype=torch.float32)
    mat = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)

    # 1. redundant transfer (ACC101)
    case = access.KernelCase("selftest/redundant", redundant_fixture, (vec,),
                             read_bytes=4096, write_bytes=4096)
    fs = access.check_redundancy(case)
    fired["redundant-transfer"] = any(
        f.rule == "ACC101" and f.severity == "error" for f in fs)

    # 2. strided innermost access (ACC102)
    case = access.KernelCase("selftest/strided", strided_fixture, (mat,),
                             read_bytes=16384, write_bytes=8192)
    fs = access.check_contiguity(case)
    fired["strided-access"] = any(f.rule == "ACC102" for f in fs)

    # 3. misaligned pack width (ACC103): 5 bits does not tile 32
    case = access.KernelCase("selftest/misaligned", redundant_fixture, (vec,),
                             read_bytes=8192, write_bytes=8192,
                             pack_bits=5, pack_block=48)
    fs = access.check_pack_alignment(case)
    fired["misaligned-pack"] = sum(f.rule == "ACC103" for f in fs) == 2

    # 4. obs recording under torch.compile and under checkpoint (OBS201)
    for name, src in (("obs-under-compile", OBS_UNDER_COMPILE_SRC),
                      ("obs-under-checkpoint", OBS_UNDER_CHECKPOINT_SRC)):
        nodes = obs_discipline.scan_source(src, f"selftest_{name}.py")
        fs = obs_discipline.run_pass(nodes)
        fired[name] = any(f.rule == "OBS201" for f in fs)

    # 5. invalid layout permutation (LAY301): duplicate an index
    a = mars.analyze(stencil.SPECS["jacobi-1d"]((6, 6)))
    good = layout.layout_for_analysis(a)
    bad_order = list(good.order)
    bad_order[0] = bad_order[1]
    bad = dataclasses.replace(good, order=tuple(bad_order))
    fs = layout_invariants.check_layout("jacobi-1d", (6, 6), a, result=bad)
    fired["invalid-permutation"] = any(f.rule == "LAY301" for f in fs)

    # 6. burst-count lie (LAY302)
    lied = dataclasses.replace(good, read_bursts=good.read_bursts + 1)
    fs = layout_invariants.check_layout("jacobi-1d", (6, 6), a, result=lied)
    fired["burst-miscount"] = any(f.rule == "LAY302" for f in fs)

    return {"ok": all(fired.values()), "fired": fired}
