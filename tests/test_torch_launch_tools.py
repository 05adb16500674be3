"""The port's launch tools against the reference's (repro.launch).

``cells`` (the 40-cell grid, its skips, each cell's RunConfig) and the
roofline formulas ``model_flops_for`` / ``kernelized_io_bytes`` must equal
the reference's exactly; the roofline's constants must be the H100's data
sheet, never the TPU's; the dry run walks one rank's step of smoke-config
cells on the production meshes (the fake process group, the fake device)
with the reference's parameter count: ``chips`` the mesh's size, fewer
FLOPs than the step on one device, the parameter bytes the rank holds
equal to ``rank_bytes``' from the rules, the decode state's bytes a rank
equal to ``ServeEngine.kv_cache_bytes`` on that rank, and the bytes handed
to each collective equal to ``chip_smoke.tp_bytes``' formula for the train
cells it covers.  Every comparison is exact.
"""
import dataclasses
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.launch import cells as jcells
from repro.launch import roofline as jroofline
from repro.models import model_zoo as jzoo
import chip_smoke
from repro_torch.configs import base
from repro_torch.launch import cells, dryrun, roofline
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]

#: the dry run at a size the CPU walks in seconds: (arch, shape, mesh) of
#: the smoke configs, with the cell's length and batch cut
DRY_CELLS = (("tinyllama-1.1b", "train_4k", "single"),
             ("granite-8b", "decode_32k", "multi"),
             ("mixtral-8x7b", "prefill_32k", "single"))
DRY_OVERRIDES = {"seq_len": 128, "global_batch": 2}
#: a global batch that splits over multi's 32 batch ranks (pod x data)
RANK_OVERRIDES = {"seq_len": 128, "global_batch": 64}


def test_the_grid_equals_the_references():
    assert cells.all_cells() == jcells.all_cells()
    assert len(cells.all_cells()) == 40
    assert cells.SKIPS == jcells.SKIPS
    assert cells.runnable_cells() == jcells.runnable_cells()
    assert cells.LONG_OK == jcells.LONG_OK


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_run_configs_equal_the_references(arch):
    for shape in base.SHAPES:
        mine = dataclasses.asdict(cells.resolve_run_config(arch, shape))
        theirs = dataclasses.asdict(jcells.resolve_run_config(arch, shape))
        assert mine == theirs, (arch, shape)
    over = dict(kv_cache_bits=8, remat=False)
    assert dataclasses.asdict(cells.resolve_run_config(arch, "decode_32k", **over)) \
        == dataclasses.asdict(jcells.resolve_run_config(arch, "decode_32k", **over))


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_roofline_formulas_equal_the_references(arch):
    cfg, jcfg = base.load_arch(arch), jbase.load_arch(arch)
    for shape in base.SHAPES:
        rc = cells.resolve_run_config(arch, shape)
        jrc = jcells.resolve_run_config(arch, shape)
        assert roofline.model_flops_for(cfg, rc) == jroofline.model_flops_for(jcfg, jrc)
        for chips in (1, 256, 512):
            assert roofline.kernelized_io_bytes(cfg, rc, chips) == \
                jroofline.kernelized_io_bytes(jcfg, jrc, chips), (shape, chips)
        for bits in (8, 4):
            rc8 = dataclasses.replace(rc, kv_cache_bits=bits)
            jrc8 = dataclasses.replace(jrc, kv_cache_bits=bits)
            assert roofline.kernelized_io_bytes(cfg, rc8, 1) == \
                jroofline.kernelized_io_bytes(jcfg, jrc8, 1)


def test_roofline_terms_follow_the_references_arithmetic():
    coll = {"all-gather": 3e9, "all-reduce": 1e9}
    mine = roofline.analyze(2e15, 4e12, coll, 4, 6e15)
    theirs = jroofline.analyze(2e15, 4e12, coll, 4, 6e15)
    assert mine.flops_per_device == theirs.flops_per_device
    assert mine.model_flops_ratio == theirs.model_flops_ratio
    # the same terms over the card's constants instead of the TPU's
    assert mine.compute_s == 2e15 / 989e12
    assert mine.memory_s == 4e12 / 3.35e12
    assert mine.collective_s == 4e9 / 450e9
    assert mine.dominant == "compute" and mine.bound_seconds == mine.compute_s
    assert mine.mfu_bound == 6e15 / (4 * 989e12 * mine.compute_s)


_TPU = re.compile(r"(?<![\w.])(197e12|819e9|50e9)(?![\w.])")


def test_the_ports_constants_are_the_cards():
    """The card's data sheet, named beside the card; the TPU's rates appear
    nowhere a rate could be read (``configs/base.py``'s ``50e9`` is the
    reference's 50-billion-parameter threshold, not a link rate)."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    src = (ROOT / "src" / "repro_torch" / "launch" / "roofline.py").read_text()
    assert src.count("NVIDIA H100 80GB HBM3, 700.00 W") >= 3
    pkg = ROOT / "src" / "repro_torch"
    for p in [*(pkg / "launch").rglob("*.py"), *(pkg / "analysis").rglob("*.py"),
              *(pkg / "kernels").rglob("*.py"), *ROOT.glob("examples/torch_*.py"),
              ROOT / "chip_smoke.py"]:
        assert not _TPU.search(p.read_text()), p


def _reference_param_count(arch: str, rc) -> int:
    cfg = jbase.load_smoke(arch)
    jrc = jbase.RunConfig(**dataclasses.asdict(rc))
    tree = jzoo.get_api(cfg, jrc).abstract_params()
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch,shape,mesh", DRY_CELLS)
def test_dryrun_on_smoke_cells(arch, shape, mesh, tmp_path):
    rec = dryrun.run_and_write(arch, shape, mesh, str(tmp_path),
                               dict(DRY_OVERRIDES), smoke=True)
    assert rec["ok"], rec.get("error")
    saved = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
    assert saved["ok"] and saved["overrides"] == DRY_OVERRIDES
    rc = cells.resolve_run_config(arch, shape, **DRY_OVERRIDES)
    assert rec["params"] == _reference_param_count(arch, rc)
    assert rec["param_bytes"] == rec["params"] * 2          # bf16 weights
    assert rec["opt_bytes"] == (2 * rec["params"] * 4 if rc.kind == "train" else 0)
    assert rec["flops_per_device"] > 0 and rec["ops"] > 0
    cfg = base.load_smoke(arch)
    chips = {"single": 256, "multi": 512}[mesh]
    assert rec["chips"] == rec["mesh_chips"] == chips
    assert rec["mesh_shape"] == list(dryrun.MESHES[mesh][0])
    assert rec["model_flops"] == roofline.model_flops_for(cfg, rc)
    assert rec["kernelized_io_bytes"] == roofline.kernelized_io_bytes(cfg, rc, chips)
    assert rec["roofline"]["compute_s"] == rec["flops_per_device"] / 989e12
    assert rec["roofline"]["memory_s"] == rec["bytes_per_device"] / 3.35e12
    assert rec["roofline"]["collective_s"] == sum(rec["collectives"].values()) / 450e9
    assert set(rec["collectives"]) == {"all-gather", "reduce-scatter", "all-reduce"}
    assert 0 < rec["params_per_rank"] <= rec["params"]
    assert rec["param_bytes_per_rank"] == rec["params_per_rank"] * 2
    assert rec["param_bytes_held"] == rec["param_bytes_per_rank"]


def test_dryrun_names_a_cell_that_fails_to_trace(tmp_path, monkeypatch):
    from repro_torch.models import model_zoo

    def broken(*a, **k):
        raise RuntimeError("op needs data on the fake device")
    monkeypatch.setattr(model_zoo, "get_api", broken)
    assert dryrun.main(["--arch", "yi-9b", "--shape", "prefill_32k", "--smoke",
                        "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "yi-9b__prefill_32k__single.json").read_text())
    assert not rec["ok"] and (rec["arch"], rec["shape"]) == ("yi-9b", "prefill_32k")
    assert "op needs data on the fake device" in rec["error"]


#: a train, a prefill and a decode cell of the smoke configs on ``multi``
RANK_CELLS = (("tinyllama-1.1b", "train_4k"), ("granite-8b", "prefill_32k"),
              ("granite-8b", "decode_32k"), ("hymba-1.5b", "decode_32k"))


@pytest.mark.parametrize("arch,shape", RANK_CELLS)
def test_dryrun_walks_one_rank_of_multi(arch, shape, tmp_path):
    rec = dryrun.run_and_write(arch, shape, "multi", str(tmp_path),
                               dict(RANK_OVERRIDES), smoke=True)
    assert rec["ok"], rec.get("error")
    assert rec["chips"] == 512
    cfg = base.load_smoke(arch)
    rc = cells.resolve_run_config(arch, shape, **RANK_OVERRIDES)
    one = dryrun.walk_step(cfg, rc)            # the whole step on one device
    assert one["chips"] == 1
    assert 0 < rec["flops_per_device"] < one["flops_per_device"]
    assert rec["param_bytes_held"] == rec["param_bytes_per_rank"] == \
        dryrun.rank_bytes(cfg, rc, (2, 16, 16), ("pod", "data", "model"))[
            "param_bytes_per_rank"] < rec["param_bytes"]
    assert sum(rec["collectives"].values()) > 0
    assert rec["argument_size_in_bytes"] < one["argument_size_in_bytes"]
    if rc.kind == "decode":
        with dryrun.fake_mesh((2, 16, 16), ("pod", "data", "model")) as mesh:
            engine = ServeEngine(cfg, rc, params=object(), device="meta")
            held = engine.kv_cache_bytes(rc.global_batch, mesh)
        assert rec["decode_state_bytes_per_rank"] == held
        assert held < one["decode_state_bytes_per_rank"] == \
            engine.kv_cache_bytes(rc.global_batch)


@pytest.mark.parametrize("arch,mesh", [
    ("tinyllama-1.1b", "single"), ("tinyllama-1.1b", "multi"),
    ("mamba2-130m", "multi"), ("hymba-1.5b", "multi"), ("whisper-tiny", "multi")])
def test_dryrun_collectives_equal_the_formula(arch, mesh, tmp_path):
    """A train cell's bytes a rank hands each collective a step, walked on
    the fake process group, against ``chip_smoke.tp_bytes``."""
    rec = dryrun.run_cell(arch, "train_4k", mesh, dict(RANK_OVERRIDES), smoke=True)
    rc = cells.resolve_run_config(arch, "train_4k", **RANK_OVERRIDES)
    want = chip_smoke.tp_bytes(base.load_smoke(arch), rc, *dryrun.MESHES[mesh])
    assert rec["collectives"] == {"all-gather": want["all_gather"],
                                  "reduce-scatter": want["reduce_scatter"],
                                  "all-reduce": want["all_reduce"]}


def test_dryrun_refuses_an_existing_process_group():
    with dryrun.fake_mesh((2, 2), ("data", "model")):
        with pytest.raises(RuntimeError, match="process group already exists"):
            dryrun.walk_rank(base.load_smoke("tinyllama-1.1b"),
                             cells.resolve_run_config("tinyllama-1.1b", "decode_32k"),
                             (2, 2), ("data", "model"))
