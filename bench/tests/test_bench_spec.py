"""BENCHMARK.json and the files each cell resolves to, by name."""
import json
import re

from _tiny import ROOT
from bench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_every_cell_resolves_to_its_files():
    for w in BENCH["workloads"]:
        cell = spec.resolve(w["name"], ROOT)
        assert cell.chips == 1
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.generator, "make")
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}
        assert all(hasattr(r, "read") for r in cell.readers.values())
        lim = cell.limits["numbers"]
        assert lim and set(lim) <= {"gap_max", "gap_mean"}
        for v in lim.values():     # above the program's readings, below the control's
            assert v["lower"] < v["limit"] < v["upper"] and v["upper"] >= 3 * v["lower"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "tokens_per_s"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"


def test_configs_state_what_was_reduced():
    for c in BENCH["configs"]:
        cfg = spec.load_json(ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key, value in cfg["published"].items():
            if key in cfg and key not in c["reduced"]:
                assert cfg[key] == value, (c["name"], key)


def test_names_units_and_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(spec.NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    ttft = next(m for m in BENCH["end_to_end"] if m["name"] == "ttft_ms_p95")
    assert ttft["workloads"] == ["granite-8b.chat.int8"]
    for m in BENCH["per_layer"]:
        assert m["moves"] == "tokens_per_s"
    roof = [m for m in BENCH["per_layer"] if m["name"].endswith("_roofline")
            or "mfu" in m["name"]]
    assert roof and all(m["unit"] == "%" for m in roof)
