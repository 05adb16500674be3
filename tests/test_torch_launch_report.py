"""``repro_torch.launch.report`` against ``repro.launch.report`` (CPU).

The same synthetic dry-run records, written in the reference's shape (XLA's
lowering and compile seconds, memory analysis and collective bytes), are
loaded and rendered by both modules: the roofline rows are equal, and each
dry-run row's cells are the reference's up to the port's added columns
(walk seconds, ops walked, bytes a rank holds).  Records of the port's own
dry run (``repro_torch.launch.dryrun``: one rank's step of smoke cells on
the production meshes) render through ``python -m
repro_torch.launch.report``'s ``main`` with the collective term, args/dev
and the top collectives filled and ``-`` where the port has no value
(XLA's lowering and compile seconds and temporary bytes), and both modules
render them alike in every column both fill.
"""
import json

import pytest

from repro.launch import report as jreport
from repro_torch.launch import dryrun, report


def _record(arch, shape, mesh, ok=True, **kw):
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                "error": "RuntimeError: " + "x" * 80}
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "kind": "train",
           "ok": True, "lower_s": 1.25, "compile_s": 12.5,
           "argument_size_in_bytes": 3.5e9, "temp_size_in_bytes": 7.25e9,
           "collectives": {"all-reduce": 4e9, "all-gather": 9e9,
                           "reduce-scatter": 1e8, "all-to-all": 2e7},
           "roofline": {"compute_s": 0.25, "memory_s": 0.0123,
                        "memory_s_kernelized": 0.0042, "collective_s": 1.5,
                        "dominant": "compute", "dominant_kernelized": "collective",
                        "model_flops_ratio": 0.8765,
                        "mfu_bound_kernelized": 0.4321}}
    rec.update(kw)
    return rec


RECORDS = [_record("tinyllama-1.1b", "train_4k", "single"),
           _record("tinyllama-1.1b", "train_4k", "multi", lower_s=0.5),
           _record("granite-8b", "decode_32k", "single", kind="decode",
                   roofline={"compute_s": 2.0, "memory_s": 0.5, "collective_s": 0.001,
                             "dominant": "compute", "model_flops_ratio": 1.0}),
           _record("yi-9b", "prefill_32k", "single", ok=False),
           _record("mamba2-130m", "long_500k", "single", kind="prefill",
                   collectives={})]


@pytest.fixture()
def outdir(tmp_path):
    for r in RECORDS:
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(
            json.dumps(r))
    tagged = _record("yi-9b", "train_4k", "single", compile_s=99.0)
    (tmp_path / "yi-9b__train_4k__single__v2.json").write_text(json.dumps(tagged))
    return str(tmp_path)


def _rows(table):
    return [[c.strip() for c in ln.strip("|").split("|")]
            for ln in table.splitlines()[2:]]


@pytest.mark.parametrize("tag", ["", "v2"])
def test_load_matches_reference(outdir, tag):
    assert report.load(outdir, tag) == jreport.load(outdir, tag)
    assert len(report.load(outdir, tag)) == (1 if tag else len(RECORDS))


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_roofline_rows_match_reference(outdir, mesh):
    recs = report.load(outdir)
    got, want = report.roofline_table(recs, mesh), jreport.roofline_table(recs, mesh)
    assert _rows(got) == _rows(want)
    assert len(_rows(got)) > len(report.cells.SKIPS)


@pytest.mark.parametrize("tag", ["", "v2"])
def test_dryrun_rows_match_reference_where_the_fields_agree(outdir, tag):
    recs = report.load(outdir, tag)
    got, want = _rows(report.dryrun_table(recs)), _rows(jreport.dryrun_table(recs))
    assert len(got) == len(want) == len(recs)
    for g, w in zip(got, want):
        assert len(g) == len(w) + 3
        assert g[:len(w)] == w
        assert g[len(w):] in (["-", "-", "-"], ["", "", ""])


def test_helpers_match_reference():
    for x in (None, 0.0, 1e-4, 0.5, 1.0, 12.345):
        assert report.fmt_s(x) == jreport.fmt_s(x)
    for x in (None, 0.0, 0.1234, 1.0):
        assert report.pct(x) == jreport.pct(x)
    rows = [(1, "a", None), (2.5, "b", "-")]
    assert report.md_table(("x", "y", "z"), rows) == jreport.md_table(("x", "y", "z"), rows)


def test_main_renders_a_port_dry_run_record(tmp_path, capsys):
    rec = dryrun.run_and_write("tinyllama-1.1b", "train_4k", "multi",
                               str(tmp_path), {"seq_len": 128, "global_batch": 2},
                               smoke=True)
    assert rec["ok"], rec.get("error")
    assert report.main(["--out", str(tmp_path), "--table", "both",
                        "--mesh", "multi"]) == 0
    out = capsys.readouterr().out
    roof, dry = out.split("\n\n")
    row = next(r for r in _rows(roof) if r[:2] == ["tinyllama-1.1b", "train_4k"])
    rl = rec["roofline"]
    assert row[2] == "train" and row[3] == report.fmt_s(rl["compute_s"])
    assert row[4] == (f"{report.fmt_s(rl['memory_s'])} / "
                      f"{report.fmt_s(rl['memory_s_kernelized'])}")
    assert row[5] == report.fmt_s(rl["collective_s"]) != "-"   # the walked bytes
    assert row[8] == report.pct(rl["mfu_bound_kernelized"])
    (drow,) = _rows(dry)
    held = (rec["param_bytes_per_rank"] + rec["opt_bytes_per_rank"]) / 1e9
    top = ", ".join(f"{k}:{v / 1e9:.2f}GB" for k, v in sorted(
        rec["collectives"].items(), key=lambda kv: -kv[1]))
    assert drow[:8] == ["tinyllama-1.1b", "train_4k", "multi", "-", "-",
                        f"{rec['argument_size_in_bytes'] / 1e9:.2f}GB", "-", top]
    assert drow[8:] == [f"{rec['walk_s']}s", str(rec["ops"]), f"{held:.2f}GB"]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_port_records_render_as_the_reference_renders_them(tmp_path, mesh):
    """A train, a prefill and a decode cell of the port's dry run: the
    roofline rows equal to the reference's, and each dry-run row equal in
    every column both fill (all but lower, compile and temp/dev, which the
    port renders ``-`` and the reference ``-s`` / ``0.00GB``)."""
    over = {"seq_len": 128, "global_batch": 64}
    for arch, shape in (("tinyllama-1.1b", "train_4k"),
                        ("granite-8b", "prefill_32k"), ("granite-8b", "decode_32k")):
        rec = dryrun.run_and_write(arch, shape, mesh, str(tmp_path), dict(over),
                                   smoke=True)
        assert rec["ok"], rec.get("error")
    recs = report.load(str(tmp_path))
    got = _rows(report.roofline_table(recs, mesh))
    assert got == _rows(jreport.roofline_table(recs, mesh))
    assert all(r[5] != "-" for r in got[:3])
    got, want = _rows(report.dryrun_table(recs)), _rows(jreport.dryrun_table(recs))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[3:5] == ["-", "-"] and w[3:5] == ["-s", "-s"] and g[6] == "-"
        assert g[:3] + g[5:6] + g[7:8] == w[:3] + w[5:6] + w[7:8]
        assert g[7].startswith("all-") or g[7].startswith("reduce-")
