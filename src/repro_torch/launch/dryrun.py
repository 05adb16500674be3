"""Dry run of every (arch x shape x mesh) cell without hardware (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's step against abstract
inputs on 512 host devices and reads XLA's analyses.  The port builds the
cell's model under ``FakeTensorMode`` — tensors with ``meta`` storage that
report the device they would live on, so nothing is allocated and the
kernel wrappers take their plain routes, as on a CPU tensor — and runs the
step (``train.step.make_train_step``, ``prefill`` or ``decode_step``) once
under ``launch.op_walk``.  It records

  * the FLOPs (``FlopCounterMode``) and the inputs + outputs of every op
    (``op_bytes``, traffic before any fusion), per device;
  * parameter and optimizer bytes;
  * ``roofline.kernelized_io_bytes`` and ``model_flops_for``, and the
    roofline terms with the card's constants;
  * for the ``multi`` mesh (2 pods x 16 x 16 over ``pod``, ``data``,
    ``model``), each rank's parameter and optimizer bytes from the port's
    sharding rules (``train.step.param_partition``), without running a
    collective; the step itself is walked once on one device.

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
    size over the sizes of the axes its resolved spec names."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import step as train_step

    api = model_zoo.get_api(cfg, rc, "cpu")
    sizes = dict(zip(names, shape))
    specs = train_step.param_partition(api, rc, abstract_mesh(shape, names))
    held = 0
    for n, full in train_step.full_shapes(api).items():
        div = int(np.prod([sizes[a] for part in specs[n]
                           for a in ((part,) if isinstance(part, str)
                                     else part or ())]))
        held += int(np.prod(full)) // div
    p_item = torch.empty((), dtype=rc.torch_dtype).element_size()
    o_item = 2 if rc.opt_dtype == "bfloat16" else 4
    return {"params_per_rank": held,
            "param_bytes_per_rank": held * p_item,
            "opt_bytes_per_rank": (2 * held * o_item
                                   if rc.kind == "train" else 0)}


def run_cell(arch: str, shape: str, mesh_kind: str = "single",
             overrides=None, smoke: bool = False) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import base
    from repro_torch.launch import cells, op_walk, roofline
    from repro_torch.models import model_zoo
    from repro_torch.train import step as train_step

    t_start = time.time()
    overrides = dict(overrides or {})
    cfg_over = {k[4:]: overrides.pop(k) for k in list(overrides)
                if k.startswith("cfg.")}
    cfg = base.load_smoke(arch) if smoke else base.load_arch(arch)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    rc = cells.resolve_run_config(arch, shape, **overrides)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "kind": rc.kind,
           "smoke": smoke, "chips": 1, "ok": False}

    with FakeTensorMode():
        api = model_zoo.get_api(cfg, rc, "cpu")
        batch = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in model_zoo.input_specs(cfg, rc).items()}
        t0 = time.time()
        if rc.kind == "train":
            state = train_step.init_state(api, rc, 0)
            params = dict(state.params.named_parameters())
            opt = list(state.opt.mu.values()) + list(state.opt.nu.values())
            step = train_step.make_train_step(api, cfg, rc)
            fn, args = step, (state, batch)
        else:
            model = api.init(0)
            params = dict(model.named_parameters())
            opt = []
            if rc.kind == "prefill":
                fn, args = api.prefill, (model, batch)
            else:
                dstate = api.init_decode_state(rc.global_batch)
                fn, args = api.decode_step, (model, dstate, batch["tokens"])
        rec["init_s"] = round(time.time() - t0, 2)
        rec["params"] = sum(p.numel() for p in params.values())
        rec["param_bytes"] = _nbytes(params.values())
        rec["opt_bytes"] = _nbytes(opt)
        t0 = time.time()
        w = op_walk.walk(fn, *args)
        rec["walk_s"] = round(time.time() - t0, 2)
    rec["ops"] = len(w.ops)
    rec["flops_per_device"] = float(w.flops)
    rec["flops_by_op"] = w.flops_by_op
    rec["bytes_per_device"] = float(w.op_bytes)
    kio = roofline.kernelized_io_bytes(cfg, rc, 1)
    rec["kernelized_io_bytes"] = kio
    rec["model_flops"] = roofline.model_flops_for(cfg, rc)
    rl = roofline.analyze(rec["flops_per_device"], rec["bytes_per_device"],
                          {}, 1, rec["model_flops"])
    rlk = roofline.analyze(rec["flops_per_device"], kio, {}, 1,
                           rec["model_flops"])
    rec["roofline"] = {
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "memory_s_kernelized": rlk.memory_s,
        "dominant": rl.dominant, "dominant_kernelized": rlk.dominant,
        "model_flops_ratio": rl.model_flops_ratio,
        "mfu_bound": rl.mfu_bound, "mfu_bound_kernelized": rlk.mfu_bound,
        "peak_flops": roofline.PEAK_FLOPS, "hbm_bw": roofline.HBM_BW}
    if mesh_kind in MESHES:
        mshape, names = MESHES[mesh_kind]
        rec["mesh_shape"] = list(mshape)
        rec["mesh_chips"] = int(np.prod(mshape))
        rec.update(rank_bytes(cfg, rc, mshape, names))
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
