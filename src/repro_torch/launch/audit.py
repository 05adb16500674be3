"""Walked-vs-analytic audit: prove the byte/FLOP models against what the
port runs (port of ``repro.launch.audit``).

The port carries the reference's three *analytic* bandwidth models:

  * ``distributed/collectives.ExchangeStats`` — wire bytes of the
    compressed cross-pod gradient exchange (planes + scale markers),
  * ``kernels/ops.py`` ``*_io_bytes`` — per-kernel HBM traffic ("read
    every input once, write every output once"),
  * ``launch/roofline.py`` — FLOPs and bytes against the card's peaks.

This module checks that those models describe what runs.  The reference
compiles a canonical program and walks its HLO; the port has no compiled
module, so each check runs the program and counts what it does:

  * **kernel IO**: each case of ``analysis.access.builtin_cases`` walked
    by ``launch.op_walk`` — on the CPU the plain routes, on a card the
    kernel routes, where the bytes are those of the tensors handed to the
    launch and returned by it (``kv_quant_store``'s rows written in place
    into the cache) — against its ``ops.*_io_bytes`` charge;
  * **flops**: ``FlopCounterMode`` over a loop of k = 10 products of
    (128, 128) f32 matrices against ``k * 2 n^3``;
  * **wire**: the compressed exchange (quantize pod-locally, gather the
    packed planes and scales, dequantize the pods' mean; raw leaves
    gathered in f32) on two gloo ranks: the bytes each rank hands the
    gathers (``collectives.wire_bytes_sent``) against
    ``ExchangeStats.wire_bytes``.

``python -m repro_torch.launch.audit`` prints the divergence report and
exits nonzero when any check diverges; ``--perturb-analytic X`` multiplies
the analytic side (the self-test that the gate fires).  Every comparison
is exact (relative tolerance 1e-9, float round-off only): eager code runs
each op as written, so there is no fusion slack to allow for.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

import torch

#: exact tolerance for byte and FLOP checks (float round-off only)
BYTES_RTOL = 1e-9
FLOPS_RTOL = 1e-9

#: default audit grid — the reference's
SIZES = [1 << 16]
BITS = [4, 8]

N_PODS = 2


@dataclasses.dataclass
class AuditCheck:
    """One walked vs analytic comparison."""
    name: str
    walked_value: float
    analytic_value: float
    rel_tol: float = BYTES_RTOL
    unit: str = "bytes"
    detail: str = ""

    @property
    def rel_error(self) -> float:
        ref = max(abs(self.analytic_value), 1.0)
        return abs(self.walked_value - self.analytic_value) / ref

    @property
    def diverged(self) -> bool:
        return self.rel_error > self.rel_tol

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["rel_error"] = self.rel_error
        d["diverged"] = self.diverged
        return d


def summarize(checks: List[AuditCheck],
              programs: Optional[List[dict]] = None) -> dict:
    """Report dict (JSON-serializable) for a list of checks."""
    return {
        "checks": [c.to_dict() for c in checks],
        "programs": programs or [],
        "n_checks": len(checks),
        "divergences": sum(c.diverged for c in checks),
        "ok": not any(c.diverged for c in checks),
    }


def perturb_analytic(checks: List[AuditCheck], factor: float) -> List[AuditCheck]:
    """Scale the analytic side of every check (gate self-test)."""
    return [dataclasses.replace(c, analytic_value=c.analytic_value * factor)
            for c in checks]


def render_report(report: dict) -> str:
    from repro_torch.launch.report import md_table
    rows = []
    for c in report["checks"]:
        rows.append((c["name"], c["unit"],
                     f"{c['walked_value']:.6g}", f"{c['analytic_value']:.6g}",
                     f"{c['rel_error']:.2e}",
                     "DIVERGED" if c["diverged"] else "ok"))
    table = md_table(("check", "unit", "walked", "analytic", "rel_err",
                      "status"), rows)
    tail = (f"\n{report['n_checks']} checks — "
            f"{report['divergences']} divergence(s)")
    return "# walked-vs-analytic audit\n\n" + table + tail


def publish_report(report: dict) -> None:
    """Emit ``audit/*`` series (no-op when obs is disabled).

    ``audit/walked_<unit>``/``audit/analytic_<unit>`` are deterministic
    functions of the code and the analytic models, so the regression gate
    compares them exactly; ``audit/divergences`` must stay at 0.
    """
    from repro_torch.obs import instrument as obs
    if not obs.enabled():
        return
    obs.counter_inc("audit/checks", report["n_checks"])
    obs.counter_inc("audit/divergences", report["divergences"])
    for c in report["checks"]:
        obs.gauge_set(f"audit/walked_{c['unit']}", c["walked_value"],
                      check=c["name"])
        obs.gauge_set(f"audit/analytic_{c['unit']}", c["analytic_value"],
                      check=c["name"])
        obs.gauge_set("audit/rel_error", c["rel_error"], check=c["name"])


# ---------------------------------------------------------------------------
# Canonical programs
# ---------------------------------------------------------------------------

def grad_tree(n: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's canonical exchanged tree (``_grad_tree_abstract``),
    filled with seeded values: one compressible leaf and one raw one."""
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((n // 128, 128), generator=g),
            "norm_scale": torch.randn((7,), generator=g)}


def _wire_rank(rank: int, world: int, store: str, n: int, bits: int,
               tmp: str) -> None:
    """One pod of the exchange: its own gradients (seeded by rank), the
    whole exchange over the pod group, the bytes it handed the gathers."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((world,), ("pod",), "cpu")
        group = mesh.get_group("pod")
        grads = grad_tree(n, seed=rank)
        resids = {k: torch.zeros_like(v) for k, v in grads.items()}
        collectives.reset_wire_bytes()
        planes, scales, raw, _ = collectives.quantize_tree(grads, resids,
                                                           bits, group)
        gp, gs = collectives.exchange(planes, scales, group)
        mean = collectives.dequant_mean_tree(grads, gp, gs, raw, bits, world)
        torch.save({"sent": collectives.wire_bytes_sent(),
                    "finite": all(bool(torch.isfinite(v).all())
                                  for v in mean.values())},
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def wire_audit(n: int, bits: int):
    """Exchange wire bytes on two gloo ranks vs ``ExchangeStats``."""
    import torch.multiprocessing as mp

    from repro_torch.distributed import collectives

    stats = collectives.exchange_stats(grad_tree(n), bits)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_wire_rank, args=(
            N_PODS, os.path.join(tmp, "store"), n, bits, tmp),
            nprocs=N_PODS, start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(N_PODS)]
    checks = [AuditCheck(
        name=f"wire/n{n}/bits{bits}/rank{r}",
        walked_value=float(got["sent"]),
        analytic_value=float(stats.wire_bytes),
        detail=f"{stats.compressed_leaves} compressed + {stats.raw_leaves} "
               f"raw leaves; mean finite: {got['finite']}")
        for r, got in enumerate(ranks)]
    prog = {"name": f"exchange/n{n}/bits{bits}", "ranks": N_PODS,
            "wire_bytes_sent": [got["sent"] for got in ranks],
            "raw_bytes": stats.raw_bytes,
            "reduction": stats.reduction}
    return checks, prog


def kernel_io_audit(device="cuda") -> List[AuditCheck]:
    """Walked argument/result bytes of each kernel route vs ``ops``."""
    from repro_torch.analysis import access

    checks = []
    for case in access.builtin_cases(device):
        got_r, got_w = case.io_bytes()
        for kind, got, want in (("read", got_r, case.read_bytes),
                                ("write", got_w, case.write_bytes)):
            checks.append(AuditCheck(
                name=f"{case.name}/{kind}", walked_value=float(got),
                analytic_value=float(want),
                detail=f"route {case.route}"))
    return checks


def flops_audit(device="cuda") -> AuditCheck:
    """FLOPs of a loop of matrix products vs ``k * 2 n^3``."""
    from repro_torch.launch import op_walk

    n, k = 128, 10
    g = torch.Generator().manual_seed(0)
    x = torch.randn((n, n), generator=g).to(device)
    w = torch.randn((n, n), generator=g).to(device)

    def f(c, w):
        for _ in range(k):
            c = c @ w
        return c

    walked = op_walk.walk(f, x, w).flops
    return AuditCheck(name=f"flops/loop_matmul/n{n}/k{k}",
                      walked_value=float(walked),
                      analytic_value=float(k * 2 * n ** 3),
                      rel_tol=FLOPS_RTOL, unit="flops",
                      detail=f"FlopCounterMode on {torch.device(device).type}")


def build_report(sizes: List[int], bits_grid: List[int],
                 perturb: float = 1.0, device="cuda") -> dict:
    checks: List[AuditCheck] = []
    programs: List[dict] = []
    for n in sizes:
        for bits in bits_grid:
            cs, prog = wire_audit(n, bits)
            checks.extend(cs)
            programs.append(prog)
    checks.extend(kernel_io_audit(device))
    checks.append(flops_audit(device))
    if perturb != 1.0:
        checks = perturb_analytic(checks, perturb)
    return summarize(checks, programs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.audit",
        description="Cross-validate walked bytes/FLOPs against the "
                    "analytic collective/kernel/roofline models.")
    ap.add_argument("--sizes", type=int, nargs="*", default=SIZES,
                    help="exchanged tree sizes (none: skip the wire check)")
    ap.add_argument("--bits", type=int, nargs="+", default=BITS)
    ap.add_argument("--device", default="cuda",
                    help="where the kernel-IO and flops checks run: 'cuda' "
                         "(default) walks the kernels, 'cpu' the plain routes")
    ap.add_argument("--json", help="also write the report as JSON")
    ap.add_argument("--perturb-analytic", type=float, default=1.0,
                    help="multiply analytic values (self-test: any value "
                         "!= 1.0 must make the audit exit nonzero)")
    args = ap.parse_args(argv)

    report = build_report(args.sizes, args.bits,
                          perturb=args.perturb_analytic, device=args.device)
    print(render_report(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"\nwrote {args.json}")
    if not report["ok"]:
        print("\nFAIL: walked traffic diverged from the analytic model — "
              "fix the model (or the walk) before trusting the "
              "roofline/bandwidth numbers.")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
