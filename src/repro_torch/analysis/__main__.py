"""CLI: ``python -m repro_torch.analysis`` — run the linter, gate on findings
(port of ``repro.analysis.__main__``).

Exit codes: 0 clean (or all new findings below ``--fail-on``), 1 new
findings at/above the threshold, 2 selftest failure.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import runner
from .findings import (DEFAULT_BASELINE, Finding, severity_rank,
                       write_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static layout/access-pattern/obs-discipline linter: "
                    "proves irredundancy, contiguity and obs discipline "
                    "before anything runs.")
    ap.add_argument("--root", default=runner.DEFAULT_ROOT,
                    help="source tree for the obs-discipline pass")
    ap.add_argument("--fail-on", choices=("error", "warning", "info"),
                    default="warning",
                    help="exit nonzero when a NEW finding at/above this "
                         "severity exists (default: warning)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="suppression baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current findings as suppressed and exit 0")
    ap.add_argument("--no-access", action="store_true",
                    help="skip the walk of the kernel routes (host-only "
                         "table checks still run)")
    ap.add_argument("--device", default="cuda",
                    help="where the access pass walks the kernel routes: "
                         "'cuda' (default) the kernels on the card; 'cpu' "
                         "the plain routes, as the reference lowers ref.*")
    ap.add_argument("--json", help="also write the report as JSON")
    ap.add_argument("--selftest", action="store_true",
                    help="inject one violation per rule family and verify "
                         "every pass fires")
    args = ap.parse_args(argv)

    if args.selftest:
        st = runner.selftest()
        for name, ok in sorted(st["fired"].items()):
            print(f"selftest {name}: {'fired' if ok else 'MISSED'}")
        print(f"selftest: {'ok' if st['ok'] else 'FAILED'}")
        return 0 if st["ok"] else 2

    report = runner.run_all(root=args.root, baseline_path=args.baseline,
                            with_access=not args.no_access,
                            device=args.device)
    print(runner.render_report(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")
    if args.write_baseline:
        findings = [Finding(**{k: f[k] for k in
                               ("rule", "severity", "location", "message",
                                "pass_name")})
                    for f in report["findings"]]
        write_baseline(findings, args.baseline)
        print(f"wrote {len(findings)} suppression(s) to {args.baseline}")
        return 0

    threshold = severity_rank(args.fail_on)
    gating = [f for f in report["new"]
              if severity_rank(f["severity"]) <= threshold]
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
