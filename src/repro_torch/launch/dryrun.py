"""Dry run of every (arch x shape x mesh) cell without hardware (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's step with explicit in / out
shardings on 512 host devices and reads XLA's per-device analyses.  The
port walks one rank's step instead.  It starts the fake process group
that torch ships (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once, nothing crosses a wire) as rank 0 of the
production mesh's size, builds the mesh (``launch.mesh.make_mesh``:
``single`` (16, 16) over ``data, model``, ``multi`` (2, 16, 16) over
``pod, data, model``), installs the rules (``train.step.rules_for``) and,
under ``FakeTensorMode`` (tensors with ``meta`` storage: nothing is
allocated, and the kernel wrappers take their plain routes, as on a CPU
tensor), builds what the rank holds: its blocks of the train state
(``train.step.init_state(..., mesh)``), or of the parameters
(``param_partition``) and the decode state
(``init_decode_state(batch, mesh=)``), and its rows of the batch.  It runs
the step (``make_train_step(..., mesh)``, ``prefill`` or ``decode_step``)
once under ``launch.op_walk`` and records, for that rank:

  * ``chips`` (the mesh's size), the FLOPs (``FlopCounterMode``) and the
    inputs + outputs of every op (``op_bytes``, traffic before any fusion);
  * ``collectives``: the bytes the step handed each collective
    (``roofline.collective_bytes``, by the reference's op names);
  * ``argument_size_in_bytes``: the step's arguments (the state, or the
    parameters and the decode state, and the batch block), and
    ``decode_state_bytes_per_rank`` (its caches, as
    ``ServeEngine.kv_cache_bytes`` counts them);
  * the parameter and optimizer bytes the rank holds, walked
    (``param_bytes_held``) and from the rules (``rank_bytes``), which must
    agree; the whole model's count and bytes;
  * ``roofline.kernelized_io_bytes`` and ``model_flops_for``, and the
    roofline terms with the card's constants, the collective term
    included.

The fake group's backend is neither NCCL nor gloo.  The walk models NCCL,
the production route: ``distributed.collectives`` issues a reduce-scatter
(not gloo's all-reduce and slice) on it.  XLA's ``lower_s``,
``compile_s`` and ``temp_size_in_bytes`` have no counterpart.  A rank's
walk is every rank's up to its coordinates: the blocks divide evenly.

An op that fails on the fake device (one that needs data, such as a
data-dependent shape) fails the cell: its record holds the error and names
the cell, and ``--all`` lists it among the failed cells.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k --mesh multi
  python -m repro_torch.launch.dryrun --all [--smoke]
Results land in benchmarks/out/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "benchmarks", "out", "dryrun_torch")

#: the reference's production meshes: one pod of 16 x 16, and 2 of them
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rank_bytes(cfg, rc, shape, names) -> dict:
    """Parameter and optimizer bytes a rank holds on a mesh of ``shape``
    over ``names`` under the port's rules: each leaf's block is its whole
    size over the sizes of the axes its resolved spec names, in the leaf's
    own dtype (the SSD's ``a_log``, ``dt_bias`` and ``d_skip`` are f32
    whatever the model's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import step as train_step

    api = model_zoo.get_api(cfg, rc, "cpu")
    sizes = dict(zip(names, shape))
    specs = train_step.param_partition(api, rc, abstract_mesh(shape, names))
    with FakeTensorMode():
        params = dict(api.init(0).named_parameters())
    held = nbytes = 0
    for n, p in params.items():
        div = int(np.prod([sizes[a] for part in specs[n]
                           for a in ((part,) if isinstance(part, str)
                                     else part or ())]))
        held += p.numel() // div
        nbytes += p.numel() // div * p.element_size()
    o_item = 2 if rc.opt_dtype == "bfloat16" else 4
    return {"params_per_rank": held, "param_bytes_per_rank": nbytes,
            "opt_bytes_per_rank": (2 * held * o_item
                                   if rc.kind == "train" else 0)}


def walk_step(cfg, rc, mesh=None) -> dict:
    """One rank's step of ``cfg`` under ``rc`` on ``mesh`` (a
    ``launch.mesh.Mesh`` of the initialized process group; ``None``: the
    whole step on one device), built and walked under ``FakeTensorMode``:
    the record's step fields (see the module's docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.pipeline import batch_rows
    from repro_torch.distributed import collectives, sharding as shd
    from repro_torch.launch import op_walk, roofline
    from repro_torch.models import model_zoo
    from repro_torch.train import step as train_step

    rec = {"chips": 1 if mesh is None else int(np.prod(list(mesh.shape.values())))}
    rules = train_step.rules_for(rc, mesh)
    with FakeTensorMode():
        api = model_zoo.get_api(cfg, rc, "cpu")
        B = rc.global_batch
        batch = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in model_zoo.input_specs(cfg, rc).items()}
        if mesh is not None and rc.kind != "decode":
            rows = batch_rows(B, mesh)
            batch = {k: v[rows] for k, v in batch.items()}
        t0 = time.time()
        dstate = None
        if rc.kind == "train":
            state = train_step.init_state(api, rc, 0, mesh)
            params = dict(state.params.named_parameters())
            opt = list(state.opt.mu.values()) + list(state.opt.nu.values())
            args = train_step.state_tensors(state)
            fn = train_step.make_train_step(api, cfg, rc, mesh)
            walked = (state, batch)
        else:
            model = api.init(0)
            if mesh is not None:
                specs = train_step.param_partition(api, rc, mesh)
                for n, p in model.named_parameters():
                    shd.shard_parameter(p, specs[n], mesh)
            params = dict(model.named_parameters())
            opt, args = [], list(params.values())
            if rc.kind == "prefill":
                step, walked = api.prefill, (model, batch)
            else:
                dstate = api.init_decode_state(B, mesh=mesh)
                with shd.use_rules(rules):     # the rows the state holds
                    tokens = shd.rank_rows(batch["tokens"], B)
                batch = {"tokens": tokens}
                args += list(api.cache_leaves(dstate)) + [dstate.pos]
                step, walked = api.decode_step, (model, dstate, tokens)

            def fn(*a):
                with shd.use_rules(rules):
                    return step(*a)
        args += list(batch.values())
        rec["init_s"] = round(time.time() - t0, 2)
        rec["param_bytes_held"] = _nbytes(params.values())
        rec["opt_bytes_held"] = _nbytes(opt)
        rec["argument_size_in_bytes"] = _nbytes(args)
        if dstate is not None:
            rec["decode_state_bytes_per_rank"] = _nbytes(api.cache_leaves(dstate))
        collectives.reset_collective_bytes()
        collectives.reset_wire_bytes()
        t0 = time.time()
        w = op_walk.walk(fn, *walked)
        rec["walk_s"] = round(time.time() - t0, 2)
        rec["collectives"] = roofline.collective_bytes()
    rec["ops"] = len(w.ops)
    rec["flops_per_device"] = float(w.flops)
    rec["flops_by_op"] = w.flops_by_op
    rec["bytes_per_device"] = float(w.op_bytes)
    return rec


@contextlib.contextmanager
def fake_mesh(shape, names, rank: int = 0):
    """A ``launch.mesh.Mesh`` of ``shape`` over ``names`` whose process
    group is the fake one, this process its rank ``rank``: started here
    (refused if a default process group exists) and destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group: a "
                           "default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=int(np.prod(shape)))
    try:
        yield make_mesh(shape, names, device="cpu")
    finally:
        dist.destroy_process_group()


def walk_rank(cfg, rc, shape, names, rank: int = 0) -> dict:
    """``walk_step`` of rank ``rank`` on a mesh of ``shape`` over
    ``names``, over the fake process group (``fake_mesh``)."""
    with fake_mesh(shape, names, rank) as mesh:
        return walk_step(cfg, rc, mesh)


def run_cell(arch: str, shape: str, mesh_kind: str = "single",
             overrides=None, smoke: bool = False) -> dict:
    from repro_torch.configs import base
    from repro_torch.launch import cells, roofline

    t_start = time.time()
    overrides = dict(overrides or {})
    cfg_over = {k[4:]: overrides.pop(k) for k in list(overrides)
                if k.startswith("cfg.")}
    cfg = base.load_smoke(arch) if smoke else base.load_arch(arch)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    rc = cells.resolve_run_config(arch, shape, **overrides)
    mshape, names = MESHES[mesh_kind]
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "kind": rc.kind,
           "smoke": smoke, "ok": False}
    rec.update(walk_rank(cfg, rc, mshape, names))
    chips = rec["chips"]
    whole = rank_bytes(cfg, rc, (1, 1), ("data", "model"))
    rec["params"], rec["param_bytes"] = (whole["params_per_rank"],
                                         whole["param_bytes_per_rank"])
    rec["opt_bytes"] = (2 * rec["params"] * (2 if rc.opt_dtype == "bfloat16" else 4)
                        if rc.kind == "train" else 0)
    kio = roofline.kernelized_io_bytes(cfg, rc, chips)
    rec["kernelized_io_bytes"] = kio
    rec["model_flops"] = roofline.model_flops_for(cfg, rc)
    rl = roofline.analyze(rec["flops_per_device"], rec["bytes_per_device"],
                          rec["collectives"], chips, rec["model_flops"])
    rlk = roofline.analyze(rec["flops_per_device"], kio, rec["collectives"],
                           chips, rec["model_flops"])
    rec["roofline"] = {
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "memory_s_kernelized": rlk.memory_s, "collective_s": rl.collective_s,
        "dominant": rl.dominant, "dominant_kernelized": rlk.dominant,
        "model_flops_ratio": rl.model_flops_ratio,
        "mfu_bound": rl.mfu_bound, "mfu_bound_kernelized": rlk.mfu_bound,
        "peak_flops": roofline.PEAK_FLOPS, "hbm_bw": roofline.HBM_BW,
        "link_bw": roofline.LINK_BW}
    rec["mesh_shape"] = list(mshape)
    rec["mesh_chips"] = chips
    rec.update(rank_bytes(cfg, rc, mshape, names))
    if rec["param_bytes_held"] != rec["param_bytes_per_rank"]:
        raise RuntimeError(f"the walked rank holds {rec['param_bytes_held']} "
                           f"parameter bytes, the rules give "
                           f"{rec['param_bytes_per_rank']}")
    rec["ok"] = True
    rec["total_s"] = round(time.time() - t_start, 2)
    return rec


def cell_path(outdir, arch, shape, mesh_kind, tag=""):
    suffix = f"__{tag}" if tag else ""
    return os.path.join(outdir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def run_and_write(arch, shape, mesh_kind, out, overrides=None, smoke=False,
                  tag="") -> dict:
    """``run_cell``, its record (or the error that stopped it, naming the
    cell) written to ``out``."""
    path = cell_path(out, arch, shape, mesh_kind, tag)
    try:
        rec = run_cell(arch, shape, mesh_kind, overrides, smoke)
    except Exception as e:  # the cell failed to trace: record it, by name
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "ok": False,
               "smoke": smoke, "error": f"{type(e).__name__}: {e}"[:2000],
               "traceback": traceback.format_exc()[-4000:]}
    if overrides:
        rec["overrides"] = overrides
    os.makedirs(out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs instead of the published ones")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="RunConfig overrides key=value (e.g. kv_cache_bits=8)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    from repro_torch.launch import cells
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s) for (a, s) in cells.runnable_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    failed = []
    for a, s in todo:
        for m in meshes:
            rec = run_and_write(a, s, m, args.out, dict(overrides),
                                args.smoke, args.tag)
            status = "ok" if rec["ok"] else f"FAILED: {rec['error']}"
            print(f"{a} {s} {m}: {status}", flush=True)
            if not rec["ok"]:
                failed.append((a, s, m))
    print("FAILED CELLS:", failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
