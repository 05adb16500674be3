"""repro_torch.analysis against the reference's analyzer (repro.analysis).

The first part mirrors tests/test_analysis.py rule for rule on the port:
each injected violation fires, host-side code stays clean, the port's tree
is clean, and the CLI's exit codes and baseline workflow hold.  The second
part holds the port to the reference: the same findings carry the same
fingerprints, the layout pass returns the same findings over the whole
zoo and on injected bad layouts, the data-type table check agrees, and
every grid case's walked bytes equal the bytes of the reference's lowered
``ref.*`` (``hlo_walk.entry_io_bytes``) and its ``ops.*_io_bytes`` charge.
Every comparison is exact.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import access as jaccess
from repro.analysis import findings as jfindings
from repro.analysis import layout_invariants as jlayout
from repro.core import layout as jlay
from repro.core import mars as jmars
from repro.core import stencil as jstencil
from repro_torch.analysis import (__main__ as cli, access, layout_invariants,
                                  obs_discipline, runner)
from repro_torch.analysis.findings import (Finding, load_baseline,
                                           sort_findings, split_by_baseline,
                                           write_baseline)
from repro_torch.core import layout, mars, stencil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=cwd)


def _vec():
    import torch
    return torch.arange(1024, dtype=torch.float32)


def _mat():
    import torch
    return torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)


# ---------------------------------------------------------------------------
# findings model
# ---------------------------------------------------------------------------

def test_finding_fingerprint_stable_across_line_drift():
    a = Finding("OBS201", "error", "repro_torch/x.py:10", "msg")
    b = Finding("OBS201", "error", "repro_torch/x.py:99", "msg")
    c = Finding("OBS201", "error", "repro_torch/y.py:10", "msg")
    assert a.fingerprint == b.fingerprint
    assert a.fingerprint != c.fingerprint


def test_finding_rejects_unknown_severity():
    with pytest.raises(ValueError):
        Finding("X", "fatal", "loc", "msg")


def test_baseline_roundtrip(tmp_path):
    f1 = Finding("ACC101", "error", "k/a", "m1")
    f2 = Finding("ACC102", "warning", "k/b", "m2")
    path = str(tmp_path / "baseline.json")
    write_baseline([f1], path)
    base = load_baseline(path)
    new, suppressed = split_by_baseline([f1, f2], base)
    assert suppressed == [f1] and new == [f2]
    assert sort_findings([f2, f1])[0] is f1  # error sorts before warning


def test_committed_baseline_is_empty():
    with open(os.path.join(REPO, "src", "repro_torch", "analysis",
                           "baseline.json")) as f:
        assert json.load(f) == {"suppressions": []}


# ---------------------------------------------------------------------------
# injected-violation fixtures
# ---------------------------------------------------------------------------

def test_redundant_transfer_fixture_fires():
    case = access.KernelCase("fx/redundant", runner.redundant_fixture,
                             (_vec(),), read_bytes=4096, write_bytes=4096)
    fs = access.check_redundancy(case)
    assert any(f.rule == "ACC101" and f.severity == "error" for f in fs)
    # honest charge: clean
    ok = access.KernelCase("fx/ok", runner.redundant_fixture, (_vec(),),
                           read_bytes=4096, write_bytes=8192)
    assert access.check_redundancy(ok) == []


def test_wrapper_copy_around_a_launch_fires():
    """On a kernel route, a copy of argument data around the launch is
    redundant traffic even where the bytes in and out match the charge."""
    def copies(x):
        return x.clone()
    case = access.KernelCase("fx/copy", copies, (_vec(),), 4096, 4096,
                             route="cuda")
    fs = access.check_redundancy(case)
    assert [f.location for f in fs] == ["fx/copy/wrapper"]
    assert "aten.clone" in fs[0].message
    # the plain route may convert and copy: that is its arithmetic
    assert access.check_redundancy(dataclasses.replace(
        case, route="ref", _walk=None)) == []


def test_strided_access_fixture_fires():
    case = access.KernelCase("fx/strided", runner.strided_fixture, (_mat(),),
                             read_bytes=16384, write_bytes=8192)
    fs = access.check_contiguity(case)
    assert any(f.rule == "ACC102" for f in fs)
    assert "stride 2" in fs[0].message
    assert "cycles" in fs[0].message  # burst-model quote present


@pytest.mark.parametrize("fn,what", [
    (lambda x: x.t(), "transpose moves innermost"),
    (lambda x: x.permute(1, 0), "permute moves innermost"),
    (lambda x: x.flip(-1), "flip walks the innermost"),
    (lambda x: x[:, [3, 1, 2]], "index indexes"),
])
def test_noncontiguous_ops_fire(fn, what):
    case = access.KernelCase("fx/nc", fn, (_mat(),), 16384, 16384)
    fs = access.check_contiguity(case)
    assert any(what in f.message for f in fs), [f.message for f in fs]


def test_contiguity_ignores_onchip_temporaries():
    # the strided slice reads a temporary, not data the argument reaches
    def onchip(x):
        import torch
        return torch.ones(64, 64)[:, ::2] + x[:, :32]
    case = access.KernelCase("fx/onchip", onchip, (_mat(),), 16384, 8192)
    assert access.check_contiguity(case) == []


def test_misaligned_pack_fixture_fires():
    case = access.KernelCase("fx/misaligned", runner.redundant_fixture,
                             (_vec(),), read_bytes=8192, write_bytes=8192,
                             pack_bits=5, pack_block=48)
    fs = access.check_pack_alignment(case)
    assert sum(f.rule == "ACC103" for f in fs) == 2  # width + block
    ok = access.KernelCase("fx/aligned", runner.redundant_fixture, (_vec(),),
                           8192, 8192, pack_bits=4, pack_block=32)
    assert access.check_pack_alignment(ok) == []


def test_obs_under_compile_fixture_fires():
    nodes = obs_discipline.scan_source(runner.OBS_UNDER_COMPILE_SRC, "fx.py")
    fs = obs_discipline.run_pass(nodes)
    assert len(fs) == 1
    assert fs[0].rule == "OBS201" and fs[0].severity == "error"
    assert "counter_inc" in fs[0].message and "fx.py::kernel" in fs[0].message
    assert "torch.compile" in fs[0].message


def test_obs_host_side_recording_is_clean():
    src = textwrap.dedent("""\
        import torch
        from repro_torch.obs import instrument as obs

        @torch.compile
        def kernel(x):
            return x * 2

        def host(x):
            with obs.span("host/step"):
                obs.counter_inc("host/calls", 1)
                return kernel(x)

        def capture(graph, x):
            obs.counter_inc("host/captures", 1)
            with torch.cuda.graph(graph):
                y = kernel(x)
            obs.counter_inc("host/captured", 1)
            return y
    """)
    assert obs_discipline.run_pass(obs_discipline.scan_source(src, "h.py")) \
        == []


def test_obs_pass_catches_checkpoint_body_and_lambda():
    src = textwrap.dedent("""\
        import torch
        from torch.utils.checkpoint import checkpoint
        from repro_torch.obs import instrument as obs

        def layer(x):
            obs.gauge_set("bad/inner", 1.0)
            return x

        def run(x):
            return checkpoint(layer, x, use_reentrant=False)

        def helper(x):
            obs.hist_observe("bad/lambda", 1.0)
            return x

        def compiled():
            return torch.compile(lambda x: helper(x))
    """)
    fs = obs_discipline.run_pass(obs_discipline.scan_source(src, "s.py"))
    assert len(fs) == 2
    assert any("passed to checkpoint" in f.message and "gauge_set" in f.message
               for f in fs)
    assert any("passed to torch.compile" in f.message and "<lambda@" in f.message
               for f in fs)


@pytest.mark.parametrize("src,via", [
    ("""\
import torch
from repro_torch import obs

def step(x):
    obs.counter_inc("bad/captured", 1)
    return x

def capture(graph, x):
    with torch.cuda.graph(graph):
        return step(x)
""", "captured by torch.cuda.graph"),
    ("""\
import torch.utils.checkpoint
from repro_torch.obs import instrument

def block(x):
    instrument.counter_inc("bad/remat", 1)
    return x

def fwd(x):
    return torch.utils.checkpoint.checkpoint(block, x)
""", "passed to torch.utils.checkpoint.checkpoint"),
    ("""\
import torch
from repro_torch.obs import instrument as obs

@torch.jit.script
def scripted(x):
    obs.span("bad/scripted")
    return x
""", "decorated with torch.jit.script"),
    ("""\
import torch
from repro_torch.obs import instrument as obs

def inner(x):
    obs.counter_inc("bad/graphed", 1)
    return x

def make():
    return torch.cuda.make_graphed_callables(inner, (torch.zeros(1),))
""", "passed to torch.cuda.make_graphed_callables"),
])
def test_obs_pass_fires_on_each_torch_tracer(src, via):
    fs = obs_discipline.run_pass(obs_discipline.scan_source(src, "t.py"))
    assert len(fs) == 1 and via in fs[0].message, [f.message for f in fs]


def test_invalid_layout_permutation_fixture_fires():
    a = mars.analyze(stencil.SPECS["jacobi-1d"]((6, 6)))
    good = layout.layout_for_analysis(a)
    bad = dataclasses.replace(
        good, order=tuple([good.order[1]] + list(good.order[1:])))
    fs = layout_invariants.check_layout("jacobi-1d", (6, 6), a, result=bad)
    assert any(f.rule == "LAY301" for f in fs)

    lied = dataclasses.replace(good, read_bursts=good.read_bursts + 1)
    fs = layout_invariants.check_layout("jacobi-1d", (6, 6), a, result=lied)
    assert any(f.rule == "LAY302" for f in fs)


# ---------------------------------------------------------------------------
# clean-tree runs
# ---------------------------------------------------------------------------

def test_obs_discipline_clean_on_tree():
    fs = obs_discipline.analyze_tree(os.path.join(REPO, "src", "repro_torch"))
    assert fs == []


def test_obs_discipline_sees_the_ports_traced_roots():
    """The clean run is not a blind one: the checkpointed layers and the
    CUDA-graph capture of the decode step are traced roots."""
    nodes = obs_discipline.scan_tree(os.path.join(REPO, "src", "repro_torch"))
    roots = {k[0] for k, n in nodes.items() if n.traced_reason}
    assert {"repro_torch/models/transformer.py", "repro_torch/models/encdec.py",
            "repro_torch/serve/engine.py"} <= roots


def test_data_types_table_clean():
    assert access.check_data_types() == []


def test_access_pass_clean_on_the_plain_routes():
    assert access.run_pass(device="cpu") == []


def test_selftest_all_rules_fire():
    st = runner.selftest()
    assert st["ok"], st["fired"]
    assert set(st["fired"]) >= {"redundant-transfer", "strided-access",
                                "misaligned-pack", "obs-under-compile",
                                "obs-under-checkpoint", "invalid-permutation",
                                "burst-miscount"}


# ---------------------------------------------------------------------------
# CLI: exit codes and baseline workflow
# ---------------------------------------------------------------------------

def test_cli_clean_tree_exits_zero(tmp_path):
    out = str(tmp_path / "report.json")
    r = _cli(["--fail-on=warning", "--device", "cpu", "--json", out])
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        report = json.load(f)
    assert report["n_new"] == 0 and report["n_findings"] == 0
    assert set(report["per_pass"]) == {"access-pattern", "obs-discipline",
                                       "layout-invariants"}


def test_cli_violation_exits_nonzero_until_suppressed(tmp_path, monkeypatch,
                                                      capsys):
    """The CLI's main in this process (the clean run above starts it as
    ``python -m``); the layout pass, held above, is left out for time."""
    monkeypatch.setattr(layout_invariants, "run_pass", lambda: [])
    badroot = tmp_path / "badpkg"
    badroot.mkdir()
    (badroot / "bad.py").write_text(runner.OBS_UNDER_COMPILE_SRC)
    assert cli.main(["--no-access", "--root", str(badroot)]) == 1
    assert "OBS201" in capsys.readouterr().out
    # the same tree repaired: clean
    (badroot / "bad.py").write_text("x = 1\n")
    assert cli.main(["--no-access", "--root", str(badroot)]) == 0
    (badroot / "bad.py").write_text(runner.OBS_UNDER_COMPILE_SRC)

    # suppression workflow: record the baseline, rerun -> green
    base = str(tmp_path / "baseline.json")
    assert cli.main(["--no-access", "--root", str(badroot),
                     "--baseline", base, "--write-baseline"]) == 0
    capsys.readouterr()
    assert cli.main(["--no-access", "--root", str(badroot),
                     "--baseline", base]) == 0
    assert "suppressed OBS201" in capsys.readouterr().out


def test_cli_selftest_exit_codes(monkeypatch, capsys):
    assert cli.main(["--selftest"]) == 0
    assert "selftest: ok" in capsys.readouterr().out
    monkeypatch.setattr(runner, "selftest", lambda: {
        "ok": False, "fired": {"redundant-transfer": False}})
    assert cli.main(["--selftest"]) == 2
    assert "redundant-transfer: MISSED" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

_FIELDS = ("rule", "severity", "location", "message", "pass_name")


def _dicts(fs):
    return [f.to_dict() for f in fs]


@pytest.mark.parametrize("rule,location,message", [
    ("OBS201", "repro/x.py:10", "obs.counter_inc reachable"),
    ("ACC101", "kernel/pack/bits4", "walked writes 8192 B"),
    ("LAY302", "stencil:jacobi-1d@6x6", "solver reports 4 read bursts"),
])
def test_fingerprints_equal_the_reference(rule, location, message):
    for sev in ("error", "warning", "info"):
        mine = Finding(rule, sev, location, message, "p")
        theirs = jfindings.Finding(rule, sev, location, message, "p")
        assert mine.fingerprint == theirs.fingerprint
        assert mine.to_dict() == theirs.to_dict()
        assert mine.render() == theirs.render()


def test_layout_findings_equal_the_reference_over_the_zoo():
    mine, theirs = layout_invariants.run_pass(), jlayout.run_pass()
    assert _dicts(mine) == _dicts(theirs) == []
    assert stencil.ZOO == jstencil.ZOO


def _injections(lr):
    """Bad layouts: a duplicated index, a dropped one, a read-burst lie, a
    write-burst lie, and the optimum's order reversed with its count kept."""
    order = list(lr.order)
    return {
        "duplicate": dataclasses.replace(lr, order=tuple([order[1]] + order[1:])),
        "dropped": dataclasses.replace(lr, order=tuple(order[:-1])),
        "read_lie": dataclasses.replace(lr, read_bursts=lr.read_bursts + 1),
        "write_lie": dataclasses.replace(lr, write_bursts=2),
        "reversed": dataclasses.replace(lr, order=tuple(reversed(order))),
    }


@pytest.mark.parametrize("name,tiles", [("jacobi-1d", (6, 6)),
                                        ("jacobi-2d", (4, 5, 7))])
def test_layout_findings_equal_the_reference_on_bad_layouts(name, tiles):
    a = mars.analyze(stencil.SPECS[name](tiles))
    ja = jmars.analyze(jstencil.SPECS[name](tiles))
    mine = _injections(layout.layout_for_analysis(a))
    theirs = _injections(jlay.layout_for_analysis(ja))
    fired = 0
    for k in mine:
        fm = layout_invariants.check_layout(name, tiles, a, result=mine[k])
        ft = jlayout.check_layout(name, tiles, ja, result=theirs[k])
        assert _dicts(fm) == _dicts(ft), k
        fired += bool(fm)
    assert fired >= 4
    assert _dicts(layout_invariants.check_partition(name, tiles, a)) == \
        _dicts(jlayout.check_partition(name, tiles, ja)) == []


def test_data_types_findings_equal_the_reference(monkeypatch):
    assert _dicts(access.check_data_types()) == _dicts(jaccess.check_data_types())
    bad = {"fixed12": (12, 32), "wide": (40, 32)}
    monkeypatch.setattr(access, "DATA_TYPES", bad)
    monkeypatch.setattr(jaccess, "DATA_TYPES", bad)
    mine, theirs = access.check_data_types(), jaccess.check_data_types()
    assert len(mine) == 3 and _dicts(mine) == _dicts(theirs)


@pytest.fixture(scope="module")
def reference_hlo_bytes():
    from repro.launch import hlo_walk
    return {c.name: hlo_walk.entry_io_bytes(c.hlo) + (c.read_bytes, c.write_bytes)
            for c in jaccess.builtin_cases()}


def test_walked_bytes_equal_the_reference_hlo_and_the_model(reference_hlo_bytes):
    cases = access.builtin_cases("cpu")
    assert sorted(c.name for c in cases) == sorted(reference_hlo_bytes)
    for c in cases:
        got_r, got_w, want_r, want_w = reference_hlo_bytes[c.name]
        assert c.io_bytes() == (got_r, got_w) == (want_r, want_w), c.name
        assert (c.read_bytes, c.write_bytes) == (want_r, want_w), c.name
        assert c.route == "ref"


def test_the_cards_store_case_walks_its_in_place_writes():
    """``kv_quant_store`` (the card's grid): the plain route's in-place
    writes into the cache, seen by the dispatcher, equal the slot rows the
    kernel route charges and ``ops.kv_quant_store_io_bytes``."""
    for case in access.store_cases(torch.device("cpu"),
                                   np.random.default_rng(0), "ref"):
        w = case.walk()
        assert w.inplace_write_bytes == access._store_rows_bytes(case.args)
        assert case.io_bytes() == (case.read_bytes, case.write_bytes)
        assert access.check_redundancy(case) == []
        assert access.check_contiguity(case) == []
