"""repro_torch.launch.audit: the pure half, the walker's byte accounting,
and the checks end to end (the port's counterpart of tests/test_audit.py).

Every comparison is exact: bytes and FLOPs walked from what runs equal
the analytic models (relative tolerance 1e-9, float round-off only).  The
wire check runs the compressed exchange on two gloo ranks (spawned
processes) through the CLI's ``main``.
"""
import json

import pytest
import torch

from repro_torch.distributed import collectives
from repro_torch.launch import audit, op_walk, roofline

# ---------------------------------------------------------------------------
# pure half
# ---------------------------------------------------------------------------

def test_check_divergence_flags():
    ok = audit.AuditCheck("a", 100.0, 100.0)
    assert not ok.diverged and ok.rel_error == 0.0
    bad = audit.AuditCheck("b", 100.0, 90.0)
    assert bad.diverged
    loose = audit.AuditCheck("c", 110.0, 100.0, rel_tol=0.25, unit="flops")
    assert not loose.diverged


def test_summarize_and_perturb():
    checks = [audit.AuditCheck("a", 10.0, 10.0),
              audit.AuditCheck("b", 20.0, 20.0)]
    rep = audit.summarize(checks)
    assert rep["ok"] and rep["divergences"] == 0 and rep["n_checks"] == 2
    rep2 = audit.summarize(audit.perturb_analytic(checks, 1.01))
    assert not rep2["ok"] and rep2["divergences"] == 2


def test_collective_bytes_by_the_references_op_names(monkeypatch):
    """The counterpart of the HLO collective parser: the bytes handed to
    each collective, the exchange's gathers counted as all-gather."""
    monkeypatch.setitem(collectives._moved, "all_gather", 100)
    monkeypatch.setitem(collectives._moved, "reduce_scatter", 30)
    monkeypatch.setitem(collectives._moved, "all_reduce", 7)
    monkeypatch.setattr(collectives, "_sent", [11])
    assert roofline.collective_bytes() == {
        "all-gather": 111, "reduce-scatter": 30, "all-reduce": 7}
    rl = roofline.analyze(0.0, 0.0, roofline.collective_bytes(), 1)
    assert rl.collective_s == 148 / roofline.LINK_BW


def test_entry_io_bytes_handwritten():
    # the arguments handed in and the results returned, each once, as
    # hlo_walk.entry_io_bytes counts an ENTRY's parameters and root
    p0 = torch.zeros((128, 4), dtype=torch.float32)
    p1 = torch.zeros((16,), dtype=torch.int32)
    params, roots = op_walk.entry_io_bytes(lambda a, b: (a, b, a), p0, p1)
    assert params == 128 * 4 * 4 + 16 * 4
    assert roots == 128 * 4 * 4 + 16 * 4
    params, roots = op_walk.entry_io_bytes(lambda a, b: -a, p0, p1, exclude=(1,))
    assert (params, roots) == (128 * 4 * 4, 128 * 4 * 4)


def test_walker_in_place_writes_handwritten():
    """Writes into an argument's storage (through views and indexing) count
    as written bytes; writes into temporaries do not."""
    def store(cache, rows, idx):
        cache[idx] = rows                       # index_put_: 3 rows of 8
        cache[0, :4].zero_()                    # a view of the argument
        tmp = torch.zeros_like(rows)
        tmp.add_(1)                             # a temporary: not counted
        return None

    cache = torch.ones((10, 8), dtype=torch.float32)
    rows = torch.ones((3, 8), dtype=torch.float32)
    idx = torch.tensor([1, 5, 7])
    w = op_walk.walk(store, cache, rows, idx, exclude=(0, 2))
    assert w.read_bytes == 3 * 8 * 4
    assert w.inplace_write_bytes == 3 * 8 * 4 + 4 * 4
    assert w.write_bytes == w.inplace_write_bytes and w.result_bytes == 0


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def test_kernel_io_checks_are_exact_on_the_plain_routes():
    checks = audit.kernel_io_audit("cpu")
    assert len(checks) == 18                  # 9 grid cases x (read, write)
    for c in checks:
        assert c.walked_value == c.analytic_value, c
        assert c.detail == "route ref"


def test_flops_check_is_exact():
    c = audit.flops_audit("cpu")
    assert c.walked_value == c.analytic_value == 10 * 2 * 128 ** 3
    assert not c.diverged


def test_cli_wire_check_is_byte_exact(tmp_path):
    out = tmp_path / "report.json"
    assert audit.main(["--json", str(out), "--sizes", "16384", "--bits", "8",
                       "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["divergences"] == 0
    wire = [c for c in report["checks"] if c["name"].startswith("wire/")]
    assert len(wire) == 2                      # one check a rank
    want = collectives.exchange_stats(audit.grad_tree(16384), 8).wire_bytes
    for c in wire:
        # the bytes each rank handed the gathers equal ExchangeStats
        assert c["walked_value"] == c["analytic_value"] == want, c
        assert "mean finite: True" in c["detail"]


@pytest.mark.parametrize("factor", [1.5, 1.05])
def test_cli_perturbed_analytic_exits_nonzero(factor, capsys):
    assert audit.main(["--sizes", "--perturb-analytic", str(factor),
                       "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "DIVERGED" in out and "FAIL" in out
