"""The port's obs exporters (``sink``, ``regress``, ``report``) and the series
its host analysis publishes, against the JAX package's.

The same pipeline (the transfer model over every access pattern, the MARS
codec, the executor) runs through each package, each in its own fresh
``enabled_scope``: their counters and histograms, read through
``flatten_series``, must be equal, and so must their span trees but for
wall time.  The port's exporters then behave as ``tests/test_obs.py`` and
``tests/test_obs_regress.py`` show for the reference.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import compression as jcomp
from repro.core import executor as jexecutor
from repro.core import layout as jlayout
from repro.core import mars as jmars
from repro.core import stencil as jstencil
from repro.core import transfer as jtransfer
from repro.obs import regress as jregress
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.core import compression, executor, layout, mars, stencil, transfer
from repro_torch.obs import regress, report

ROOT = Path(__file__).resolve().parents[1]
PORT = types.SimpleNamespace(obs=obs, comp=compression, executor=executor,
                             layout=layout, mars=mars, stencil=stencil,
                             transfer=transfer)
REF = types.SimpleNamespace(obs=jobs, comp=jcomp, executor=jexecutor,
                            layout=jlayout, mars=jmars, stencil=jstencil,
                            transfer=jtransfer)
PATTERNS = [("minimal", 700), ("bbox", 300), ("mars", 200), ("mars_pack", 150),
            ("mars_comp", 100)]


def _pipeline(pk):
    """Fig. 10's transfer cases, Fig. 11's codec and the executor, with obs
    on: (summary, registry, tracer)."""
    init = np.cumsum(np.random.default_rng(1).uniform(-0.01, 0.01, 250)) + 1.0
    with pk.obs.enabled_scope() as (reg, tr):
        with pk.obs.span("bench/fig10"):
            spec = pk.stencil.jacobi1d_spec((64, 64))
            a = pk.mars.analyze(spec)
            rep = tuple(int(x) for x in spec.tile_of(np.array([[100, 100]]))[0])
            m = pk.transfer.TileIOModel(spec, a, pk.layout.layout_for_analysis(a),
                                        rep_tile=rep)
            hist = pk.stencil.jacobi1d_reference(init, 160)
            for dtype in ("fixed18", "float"):
                for mode in pk.transfer.MODES:
                    with pk.obs.span("tile_io", dtype=dtype, mode=mode):
                        m.tile_io(dtype, mode, hist=hist)
        with pk.obs.span("bench/fig11"):
            for dtype in ("fixed12", "fixed24", "double"):
                blocks = [pk.comp.words_for(hist[t, 10:10 + k], dtype)
                          for t, k in ((5, 30), (80, 7), (150, 64))]
                pk.comp.compress_mars_stream([w for w, _ in blocks], blocks[0][1])
        ex = pk.executor.Jacobi1dMarsExecutor(pk.stencil.jacobi1d_spec((6, 6)),
                                              60, 24, dtype="fixed18")
        ex.run(init[:60])
        doc = pk.obs.summary(reg, tr, meta={"config": "parity"})
    return doc, reg, tr


@pytest.fixture(scope="module")
def docs():
    return _pipeline(PORT), _pipeline(REF)


def _spans(doc):
    return [(s["name"], s["depth"], s["cycles"], s["args"]) for s in doc["spans"]]


def test_series_equal(docs):
    (doc, _, _), (jdoc, _, _) = docs
    series = regress.flatten_series(doc)
    assert series == jregress.flatten_series(jdoc)
    assert doc["metrics"] == jdoc["metrics"]
    names = {k.split("{")[0] for k in series}
    assert {"transfer/cycles", "transfer/bits", "transfer/transactions",
            "burst/beats", "compression/mars_bits", "compression/markers",
            "compression/ratio", "exec/full_tiles", "exec/compressed_bits"} <= names


def test_spans_equal_but_wall_time(docs):
    (doc, _, _), (jdoc, _, _) = docs
    assert _spans(doc) == _spans(jdoc)
    names = [s[0] for s in _spans(doc)]
    assert names.count("tile_io") == 10 and "executor/run" in names


def test_transfer_counters_equal_direct_tile_io(docs):
    (doc, _, _), _ = docs
    spec = stencil.jacobi1d_spec((64, 64))
    a = mars.analyze(spec)
    init = np.cumsum(np.random.default_rng(1).uniform(-0.01, 0.01, 250)) + 1.0
    hist = stencil.jacobi1d_reference(init, 160)
    rep = tuple(int(x) for x in spec.tile_of(np.array([[100, 100]]))[0])
    m = transfer.TileIOModel(spec, a, layout.layout_for_analysis(a), rep_tile=rep)
    counters = doc["metrics"]["counters"]
    for dtype in ("fixed18", "float"):
        for mode in transfer.MODES:
            key = obs.series_key("transfer/cycles", dict(
                bench="jacobi-1d", tile="64x64", dtype=dtype, pattern=mode))
            assert counters[key] == m.tile_io(dtype, mode, hist=hist).total_cycles


def test_sidecars_pass_either_gate(docs, tmp_path):
    """The port's sidecar against the reference's, through both gates:
    every gated series compared, none new, missing or regressed."""
    (_, reg, tr), (_, jreg, jtr) = docs
    port_dir = obs.write_sidecar(str(tmp_path / "port"), reg, tr)
    ref_dir = jobs.write_sidecar(str(tmp_path / "ref"), jreg, jtr)
    for gate in (regress, jregress):
        deltas, stats = gate.run_gate(port_dir, ref_dir)
        assert stats["regressions"] == stats["new"] == stats["missing"] == 0
        assert stats["compared"] > 40
        assert all(d.status in ("ok", "untracked") for d in deltas)


def _no_wall_time(doc):
    return {**doc, "spans": [{**s, "ts_us": 0.0, "dur_us": 0.0} for s in doc["spans"]]}


def test_report_renders_as_reference(docs):
    (doc, _, _), (jdoc, _, _) = docs
    assert report.render(_no_wall_time(doc)) == jreport.render(_no_wall_time(jdoc))
    table = report.transfer_cycles_table(doc["metrics"]["counters"])
    assert table == jreport.transfer_cycles_table(jdoc["metrics"]["counters"])
    rows = [r for r in table.splitlines() if r.startswith("| jacobi-1d")]
    assert len(rows) == 2                                   # fixed18, float


# -- the port's sink, as tests/test_obs.py shows for the reference ------------

def test_sink_summary_jsonl_sidecar_roundtrip(tmp_path):
    with obs.enabled_scope() as (reg, tr):
        obs.counter_inc("transfer/cycles", 42, pattern="mars_comp",
                        bench="jacobi-1d", tile="6x6", dtype="fixed18")
        obs.hist_observe("compression/ratio", 5.0, dtype="fixed18")
        with obs.span("bench/fig10"):
            pass
        doc = obs.summary(reg, tr, meta={"config": "test"})
        jl = obs.write_jsonl(str(tmp_path / "obs.jsonl"), reg, tr,
                             meta={"config": "test"})
        sc = obs.write_sidecar(str(tmp_path), reg, tr, meta={"config": "test"})
    assert doc["meta"]["config"] == "test"
    key = "transfer/cycles{bench=jacobi-1d,dtype=fixed18,pattern=mars_comp,tile=6x6}"
    assert doc["metrics"]["counters"][key] == 42
    assert doc["spans"][0]["name"] == "bench/fig10"
    lines = [json.loads(line) for line in open(jl)]
    assert {"meta", "counter", "histogram", "span"} <= {x["kind"] for x in lines}
    ctr = next(x for x in lines if x["kind"] == "counter")
    assert ctr["name"] == "transfer/cycles"
    assert ctr["labels"]["pattern"] == "mars_comp" and ctr["value"] == 42
    loaded = obs.read_summary(str(tmp_path))
    assert loaded == json.load(open(sc))
    assert jobs.read_summary(str(tmp_path)) == loaded           # same format
    chrome = json.load(open(tmp_path / "trace.json"))
    assert chrome["traceEvents"][0]["name"] == "bench/fig10"


def test_run_metadata_matches_reference():
    meta, jmeta = obs.run_metadata(config="x", seed=7), jobs.run_metadata(config="x", seed=7)
    assert meta["config"] == "x" and meta["seed"] == 7
    # the same repository root, four dirnames above each sink.py
    assert meta["git_sha"] == jmeta["git_sha"]
    assert meta["git_sha"] is None or len(meta["git_sha"]) == 40
    assert meta["python"] == jmeta["python"]


def _sidecar(tmp_path, name, mutate=None):
    """tests/test_obs_regress.py's fixture sidecar, written by the port."""
    with obs.enabled_scope() as (reg, tr):
        for pat, cyc in PATTERNS:
            obs.counter_inc("transfer/cycles", cyc, pattern=pat,
                            bench="jacobi-1d", tile="6x6", dtype="fixed18")
        obs.counter_inc("kernels/hbm_bytes", 4096, kernel="pack", dir="read")
        obs.counter_inc("collectives/wire_bytes", 9216, bits=8)
        obs.hist_observe("compression/ratio", 5.0, dtype="fixed18")
        obs.hist_observe("ckpt/save_ms", 10.0)
        obs.gauge_set("train/loss", 3.0, arch="t")
        path = obs.write_sidecar(str(tmp_path / name), reg, tr,
                                 meta={"config": "fixture"})
    if mutate is not None:
        doc = json.load(open(path))
        mutate(doc)
        json.dump(doc, open(path, "w"))
    return str(tmp_path / name)


def _inflate_comp(doc):
    c = doc["metrics"]["counters"]
    k = next(k for k in c if k.startswith("transfer/cycles") and "mars_comp" in k)
    c[k] *= 2


def _halve_cycles(doc):
    c = doc["metrics"]["counters"]
    k = next(k for k in c if k.startswith("transfer/cycles"))
    c[k] //= 2


def _drop_ratio(doc):
    h = doc["metrics"]["histograms"]
    k = next(k for k in h if k.startswith("compression/ratio"))
    h[k]["mean"] *= 0.5


def _slower_save(doc):
    doc["metrics"]["histograms"]["ckpt/save_ms"]["mean"] = 25.0     # 2.5x


def _new_series(doc):
    doc["metrics"]["counters"]["kernels/hbm_bytes{kernel=new}"] = 1


#: (run's mutation, extra args, exit code, words the output must hold)
GATE_CASES = {
    "identical": (None, [], 0, ["0 regression(s)"]),
    "inflated_cycles": (_inflate_comp, [], 1, ["REGRESSION", "mars_comp"]),
    "ratio_drop": (_drop_ratio, [], 1, ["REGRESSION", "compression/ratio"]),
    "wall_within_band": (_slower_save, [], 0, ["0 regression(s)"]),
    "wall_beyond_band": (_slower_save, ["--wall-tol", "0.5"], 1, ["ckpt/save_ms"]),
    "new_series": (_new_series, [], 0, ["1 new", "no baseline series"]),
    "improved": (_halve_cycles, [], 0, ["improved", "refresh"]),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate(tmp_path, capsys, case):
    mutate, args, code, words = GATE_CASES[case]
    base = _sidecar(tmp_path, "base")
    run = _sidecar(tmp_path, "run", mutate=mutate)
    assert regress.main([run, "--baseline", base, *args]) == code
    out = capsys.readouterr().out
    assert all(w in out for w in words), out
    # the reference's gate reads the port's sidecars to the same verdict
    assert jregress.main([run, "--baseline", base, *args]) == code


def test_gate_vanished_series_and_json(tmp_path, capsys):
    base = _sidecar(tmp_path, "base", mutate=lambda d: d["metrics"]["counters"]
                    .update({"kernels/hbm_bytes{kernel=old}": 7}))
    run = _sidecar(tmp_path, "run")
    assert regress.main([run, "--baseline", base]) == 0
    assert "1 missing" in capsys.readouterr().out
    assert regress.main([run, "--baseline", run, "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["exit_code"] == 0 and doc["stats"]["regressions"] == 0
    assert any(d["key"].startswith("transfer/cycles") for d in doc["deltas"])


def test_compare_policy_and_gates_equal():
    assert regress.GATES == jregress.GATES
    assert (regress.EXACT_EPS, regress.DEFAULT_WALL_TOL) == \
        (jregress.EXACT_EPS, jregress.DEFAULT_WALL_TOL)
    base = {"transfer/cycles{p=a}": {"kind": "counter", "value": 100},
            "misc/thing": {"kind": "counter", "value": 5}}
    cur = {"transfer/cycles{p=a}": {"kind": "counter", "value": 100},
           "misc/thing": {"kind": "counter", "value": 50}}
    got = [d.to_dict() for d in regress.compare(base, cur)]
    assert got == [d.to_dict() for d in jregress.compare(base, cur)]
    by_key = {d["key"]: d for d in got}
    assert by_key["transfer/cycles{p=a}"]["status"] == "ok"
    assert by_key["misc/thing"]["status"] == "untracked"
    for name in ("transfer/cycles", "exec/full_tiles{dtype=x}", "codec/bench_ms",
                 "nothing/here"):
        assert regress.gate_for(name) == jregress.gate_for(name)


def test_report_cli_renders_patterns(tmp_path, capsys):
    with obs.enabled_scope() as (reg, tr):
        for pat, cyc in PATTERNS:
            obs.counter_inc("transfer/cycles", cyc, pattern=pat,
                            bench="jacobi-1d", tile="6x6", dtype="fixed18")
        obs.hist_observe("compression/ratio", 5.0, dtype="fixed18")
        obs.write_sidecar(str(tmp_path), reg, tr, meta={"config": "t"})
    report.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert all(pat in out for pat in transfer.MODES) and "compression/ratio" in out
    row = next(line for line in out.splitlines() if "jacobi-1d" in line)
    assert [c.strip() for c in row.split("|")[4:9]] == ["700", "300", "200", "150", "100"]
    report.main([str(tmp_path), "--format", "json"])
    assert json.loads(capsys.readouterr().out)["series"] == \
        regress.flatten_series(obs.read_summary(str(tmp_path)))


def test_module_entry_points(tmp_path):
    """``python -m repro_torch.obs.report <dir>`` and ``... .regress``."""
    run = _sidecar(tmp_path, "run")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    rep = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", run],
                         capture_output=True, text=True, env=env, timeout=300)
    assert rep.returncode == 0, rep.stderr
    assert "# obs report (config=fixture" in rep.stdout and "mars_comp" in rep.stdout
    gate = subprocess.run([sys.executable, "-m", "repro_torch.obs.regress", run,
                           "--baseline", run], capture_output=True, text=True,
                          env=env, timeout=300)
    assert gate.returncode == 0, gate.stderr
    assert "0 regression(s)" in gate.stdout
