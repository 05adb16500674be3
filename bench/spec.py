"""Resolve a cell of ``BENCHMARK.json`` to the files that make it, by name.

A cell ``<config>.<traffic>`` names its configuration and its traffic mix;
each piece lives in a file of its own under ``bench/``:

* ``configs/<config>.json``: the model's sizes as run, its source, what was
  reduced and assumed, and its ``"arch"``;
* ``arch/<arch>.py``: the architecture, plain (no program): its weights'
  layout, the reference's layer, the slots each layer reads, its weight
  bytes and FLOPs, whether its FFN routes;
* ``bridges/<arch>.py``: the same architecture's side of the program: its
  parameter modules, a history written into its decode state, the kernel
  wrappers a layer launches;
* ``traffic/<traffic>.json``: the mix's parameters, read by the generator it
  names (``traffic/<generator>.py``);
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from.

A later change adds a cell by adding such files and entries; nothing here
needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    arch: ModuleType        # arch/<arch>.py
    bridge: ModuleType      # bridges/<arch>.py
    traffic: dict           # traffic/<traffic>.json
    generator: ModuleType   # traffic/<generator>.py
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]   # ... with --trace 1
    readers: Dict[str, ModuleType]  # metrics/<name>.py by per-layer name
    limits: dict            # limits/<cell>.json


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The module of one file, loaded by path (no package import)."""
    spec = importlib.util.spec_from_file_location(f"bench_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def architecture(name: str, base: Path = BENCH) -> Tuple[ModuleType, ModuleType]:
    """The architecture ``name``'s plain file and its bridge to the program."""
    key = _named("arch", name).replace(".", "_")
    return (load_module(base / "arch" / f"{name}.py", f"arch_{key}"),
            load_module(base / "bridges" / f"{name}.py", f"bridge_{key}"))


def applies(metric: dict, cell: str) -> bool:
    """A metric is reported in a cell its ``workloads`` list, or in every
    cell where it has none."""
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every file it needs."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    base = root / "bench"
    config = load_json(root / cfg_entry["file"])
    arch, bridge = architecture(config["arch"], base)
    traffic = load_json(base / "traffic" / f"{_named('traffic', w['traffic'])}.json")
    gen = _named("generator", traffic["generator"])
    generator = load_module(base / "traffic" / f"{gen}.py", f"traffic_{gen}")
    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    readers = {m["name"]: load_module(base / "metrics" / f"{_named('metric', m['name'])}.py",
                                      f"metric_{m['name']}".replace(".", "_"))
               for m in per_layer}
    return Cell(name=name, chips=int(w["chips"]), config=config, arch=arch,
                bridge=bridge, traffic=traffic, generator=generator,
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=per_layer, readers=readers,
                limits=load_json(base / "limits" / f"{_named('cell', name)}.json"))
