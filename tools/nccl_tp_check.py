"""The differentiable collectives, a tensor-parallel train step and its CUDA
graph over NCCL, one rank a card.

``chip_smoke.py`` runs its ranks on one card over gloo (NCCL refuses two
ranks on one GPU), so the NCCL side of ``distributed.collectives`` (the
reduce-scatter, the all-reduce and the gathers on device memory) and the
mesh step captured as a CUDA graph (``train.step.GraphedTrainStep(...,
mesh)``) are held here, on a host with four cards:

    python3 tools/nccl_tp_check.py            # 4 ranks, NCCL, cuda:0..3
    python3 tools/nccl_tp_check.py --cpu      # the same on 4 gloo CPU ranks

Checks, on every rank:

* ``gather``, ``reduce_scatter`` and ``all_reduce`` (f32 and bf16, along
  dims 0 and 1), forward and backward, against the sums and concatenations
  of every rank's seeded inputs (gathers exact; sums within one rounding
  of the operand dtype);
* ``train.step.whole_tree`` on the (2, 2) data x model mesh: rank 0 alone
  gets the whole state, equal to the single device's initial parameters;
* 3 steps of tinyllama-1.1b's, mamba2-130m's and hymba-1.5b's smoke
  configs on that mesh and of whisper-tiny's on (1, 4), bf16, remat,
  ``fsdp`` and ``seq_shard``: every rank's losses within 5e-3 of one
  process's steps on one card from the same weights and batches (the SSD
  on a rank's heads, hymba's KV heads and whisper's query heads cut
  mid-head at tp = 4, whisper's stream whole over ``model``).

Over NCCL only (gloo stages a CUDA tensor's collectives through host
memory, which no graph captures, so ``--cpu`` runs the steps eagerly):

* the graph against the eager step (``GRAPH_CASES``): the four smoke
  configs above on their meshes, tinyllama's smoke config on (2, 2, 1)
  pod x data x model at bits 8 (the compressed exchange) and on (2, 2)
  under ``remat_policy="save_collectives"`` (the remat's recompute takes
  the forward's collective outputs, kept in the graph's pool) and
  tinyllama-1.1b at full size on (2, 2) (bf16, remat, 4096 tokens, a
  global batch of ``FULL_B``, cut from train_4k's 256); each runs STEPS
  eager steps twice and STEPS replays from the seed on the same batches:
  losses, grad norms, parameters, moments, residuals and counters
  bit-equal to the first eager run, or no further from it than the second
  eager run is, part by part; every replay counts the eager step's
  launches and bytes (``collectives.byte_counts``);
* ``train.loop.train`` on the (2, 2) mesh replays the graph, and with a
  failure injected after its first checkpoint restores into the graph's
  state and resumes with the uninterrupted run's losses (within 1e-5).

Rank 0 prints one JSON line of what it measured (step ms eager and
graphed, median; capture ms; peak GiB a rank above the run's start); the
exit code is 0 when every check held.
"""
import dataclasses
import json
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline, device_batch  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402

WORLD = 4
SHAPE, NAMES = (2, 2), ("data", "model")
STEPS = 3
ARCH = "tinyllama-1.1b"
#: each family's smoke config and its mesh over NAMES
FAMILIES = {ARCH: SHAPE, "mamba2-130m": SHAPE, "hymba-1.5b": SHAPE,
            "whisper-tiny": (1, 4)}
#: the full-size case's global batch (train_4k's 256, cut by time)
FULL_B = 4
#: graphed against eager: name -> (arch, mesh, axis names, run config
#: fields over ``run_config()``'s, full size)
GRAPH_CASES = {
    **{arch: (arch, shape, NAMES, {}, False) for arch, shape in FAMILIES.items()},
    f"{ARCH} pods bits 8": (ARCH, (2, 2, 1), ("pod", "data", "model"),
                            {"grad_compress_bits": 8}, False),
    f"{ARCH} save_collectives": (ARCH, SHAPE, NAMES, {
        "remat_policy": "save_collectives", "tp_scatter": True}, False),
    f"{ARCH} full": (ARCH, SHAPE, NAMES, {}, True),
}
#: ``train()`` through a restart: steps, checkpoint interval, failed step
LOOP_STEPS, LOOP_CKPT, LOOP_FAIL = 6, 2, 3


def run_config():
    return configs.RunConfig(seq_len=256, global_batch=8, kind="train",
                             remat=True, q_block=64, kv_block=64, lr=1e-3)


def _inputs(shape, dtype, dev, seed):
    """Every rank's seeded input, made alike on every rank."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(WORLD)]


def _close(got, want, dtype) -> bool:
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    return bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))


def check_collectives(rank: int, dev) -> dict:
    """Each collective, forward and backward, on the world group."""
    group, out = dist.group.WORLD, {}
    for dtype in (torch.float32, torch.bfloat16):
        for dim in (0, 1):
            shape = (2 * WORLD, 3 * WORLD, 16)
            xs = _inputs(shape, dtype, dev, 10 + dim)
            gs = _inputs(shape, dtype, dev, 20 + dim)
            size = shape[dim] // WORLD
            total = sum(x.float() for x in xs)
            name = f"{str(dtype).split('.')[-1]}_dim{dim}"

            x = xs[rank].clone().requires_grad_()
            y = collectives.reduce_scatter(x, dim, group)
            y.backward(gs[rank].narrow(dim, rank * size, size))
            out[f"reduce_scatter_{name}"] = (
                y.dtype == dtype
                and _close(y, total.narrow(dim, rank * size, size), dtype)
                and torch.equal(x.grad, torch.cat(
                    [g.narrow(dim, r * size, size) for r, g in enumerate(gs)], dim)))

            x = xs[rank].narrow(dim, rank * size, size).clone().requires_grad_()
            y = collectives.gather(x, dim, group)
            y.backward(gs[rank])
            g_sum = sum(g.float() for g in gs).narrow(dim, rank * size, size)
            out[f"gather_{name}"] = (
                torch.equal(y, torch.cat([t.narrow(dim, r * size, size)
                                          for r, t in enumerate(xs)], dim))
                and _close(x.grad, g_sum, dtype))

            x = xs[rank].clone().requires_grad_()
            y = collectives.all_reduce(x, group)
            y.backward(gs[rank])
            out[f"all_reduce_{name}"] = (
                _close(y, total, dtype)
                and _close(x.grad, sum(g.float() for g in gs), dtype))
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_steps(api, cfg, rc, mesh, batches, dev, graphed: bool) -> dict:
    """A fresh state from seed 0 on ``mesh``, then one step a batch, eager
    or replayed: losses, grad norms, the state's tensors, what each step
    counted (launches, bytes), step ms, capture ms, peak memory above the
    run's start."""
    cuda = dev.type == "cuda"
    _sync(dev)
    if cuda:
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    state = train_step.init_state(api, rc, 0, mesh)
    t0 = time.perf_counter()
    step = (train_step.GraphedTrainStep(api, cfg, rc, state, mesh) if graphed
            else train_step.make_train_step(api, cfg, rc, mesh))
    _sync(dev)
    capture_ms = (time.perf_counter() - t0) * 1e3
    losses, gnorms, times, counted = [], [], [], []
    for b in batches:
        launches, moved = ops.launch_counts(), collectives.byte_counts()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"].clone())
        gnorms.append(m["grad_norm"].clone())
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        counted.append({
            "launches": {k: n - launches[k] for k, n in ops.launch_counts().items()
                         if n != launches[k]},
            "bytes": {k: n - moved[k] for k, n in collectives.byte_counts().items()
                      if n != moved[k]}})
    return {"loss": torch.stack(losses), "grad_norm": torch.stack(gnorms),
            "tensors": train_step.state_tensors(state),
            "n_params": sum(1 for _ in state.params.parameters()),
            "counted": counted, "step_ms": times,
            "capture_ms": capture_ms if graphed else None,
            "peak_GiB": ((torch.cuda.max_memory_allocated(dev) - start) / 2**30
                         if cuda else None)}


def trajectory_diff(a: dict, b: dict) -> dict:
    """Max abs difference of two runs by part (0.0 only where bit-equal):
    losses, grad norms, parameters, moments, residuals, counters."""
    n, ts = a["n_params"], len(a["tensors"])
    parts = {"params": range(n), "mu": range(n, 2 * n), "nu": range(2 * n, 3 * n),
             "resid": range(3 * n + 1, ts - 1), "counters": (3 * n, ts - 1)}
    pairs = {"loss": [(a["loss"], b["loss"])],
             "grad_norm": [(a["grad_norm"], b["grad_norm"])],
             **{k: [(a["tensors"][i], b["tensors"][i]) for i in idx]
                for k, idx in parts.items()}}
    out = {}
    for part, ps in pairs.items():
        if all(torch.equal(x, y) for x, y in ps):
            out[part] = 0.0
        else:
            out[part] = max(float((x.float() - y.float()).abs().max())
                            for x, y in ps) or float("nan")
    return out


def graph_case(name: str, dev) -> dict:
    """``name``'s STEPS steps eager twice, then replayed, from the seed on
    the same batches: the graph against the eager spread, the counts a
    step, times and memory; the eager losses (held to one card's)."""
    arch, shape, names, fields, full = GRAPH_CASES[name]
    mesh = make_mesh(shape, names, dev)
    cfg = configs.load_arch(arch) if full else configs.load_smoke(arch)
    rc = (configs.run_config_for("train_4k", cfg, global_batch=FULL_B) if full
          else dataclasses.replace(run_config(), **fields))
    api = model_zoo.get_api(cfg, rc, dev)
    pipe = SyntheticPipeline(cfg, rc, seed=3)
    batches = [device_batch(pipe.next(), cfg, rc, dev, mesh) for _ in range(STEPS)]
    eager = run_steps(api, cfg, rc, mesh, batches, dev, False)
    out = {"loss": eager["loss"].tolist(), "eager_step_ms": eager["step_ms"]}
    if dev.type != "cuda":
        return out
    again = run_steps(api, cfg, rc, mesh, batches, dev, False)
    graph = run_steps(api, cfg, rc, mesh, batches, dev, True)
    spread, diff = trajectory_diff(eager, again), trajectory_diff(eager, graph)
    counts = eager["counted"] + again["counted"] + graph["counted"]
    out.update(
        graph_loss=graph["loss"].tolist(), graph_vs_eager=diff, eager_vs_eager=spread,
        bit_equal=not any(diff.values()),
        within_spread=all(diff[k] <= spread[k] for k in diff),
        counts_equal=all(c == counts[0] for c in counts), per_step=counts[0],
        graphed_step_ms=graph["step_ms"],
        eager_ms_median=statistics.median(eager["step_ms"] + again["step_ms"]),
        graphed_ms_median=statistics.median(graph["step_ms"]),
        capture_ms=graph["capture_ms"],
        peak_GiB={"eager": eager["peak_GiB"], "graphed": graph["peak_GiB"]},
        batch=rc.global_batch, seq=rc.seq_len, layers=cfg.n_layers)
    if full:
        out["reduced"] = {"global_batch": [256, FULL_B]}
    return out


def loop_case(dev, workdir: str) -> dict:
    """``train()`` on the (2, 2) mesh at tinyllama's smoke config, each step
    counted as a replay of its graph, uninterrupted and with a failure
    injected at LOOP_FAIL (after the first checkpoint)."""
    mesh = make_mesh(SHAPE, NAMES, dev)
    cfg, rc = configs.load_smoke(ARCH), run_config()
    replays = []

    class Counted(train_step.GraphedTrainStep):
        def __call__(self, state, batch):
            replays.append(1)
            return super().__call__(state, batch)

    fired = []

    def hook(step):
        if step == LOOP_FAIL and not fired:
            fired.append(1)
            raise RuntimeError("injected node failure")

    plain = train_step.GraphedTrainStep
    train_step.GraphedTrainStep = Counted
    try:
        ref = train(cfg, rc, LoopConfig(total_steps=LOOP_STEPS, ckpt_every=LOOP_CKPT,
                                        ckpt_dir=f"{workdir}/loop_a"),
                    mesh=mesh, device=str(dev), log_every=0)
        first = len(replays)
        got = train(cfg, rc, LoopConfig(total_steps=LOOP_STEPS, ckpt_every=LOOP_CKPT,
                                        ckpt_dir=f"{workdir}/loop_b"),
                    mesh=mesh, device=str(dev), failure_hook=hook, log_every=0)
    finally:
        train_step.GraphedTrainStep = plain
    n = LOOP_STEPS - LOOP_FAIL // LOOP_CKPT * LOOP_CKPT     # from the checkpoint on
    again = LOOP_STEPS + LOOP_FAIL % LOOP_CKPT                # steps the second run ran
    err = max(abs(a - b) for a, b in zip(ref["loss"][-n:], got["loss"][-n:]))
    return {"loss": ref["loss"], "resumed_loss": got["loss"],
            "restarts": [ref["restarts"], got["restarts"]],
            "replays": [first, len(replays) - first], "resumed_max_abs_err": err,
            "ok": (ref["restarts"] == 0 and got["restarts"] == 1
                   and first == LOOP_STEPS and len(replays) - first == again
                   and len(got["loss"]) == again and err <= 1e-5)}


def single_device(cfg, rc, dev) -> tuple:
    """One process's initial parameters and STEPS losses on one card."""
    api = model_zoo.get_api(cfg, rc, dev)
    state = train_step.init_state(api, rc, 0)
    init = {n: p.detach().cpu().clone() for n, p in state.params.named_parameters()}
    step = train_step.make_train_step(api, cfg, rc)
    pipe = SyntheticPipeline(cfg, rc, seed=3)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, device_batch(pipe.next(), cfg, rc, dev))
        losses.append(float(m["loss"]))
    return init, losses


def rank_main(rank: int, init_method: str, backend: str, workdir: str) -> None:
    dev = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=WORLD)
    try:
        res = {"rank": rank, "backend": backend}
        res["collectives"] = check_collectives(rank, dev)
        mesh = make_mesh(SHAPE, NAMES, dev)
        cfg, rc = configs.load_smoke(ARCH), run_config()
        api = model_zoo.get_api(cfg, rc, dev)
        state = train_step.init_state(api, rc, 0, mesh)
        whole = train_step.whole_tree(state, api, rc, mesh)
        res["whole_on_rank0_only"] = (whole is not None) == (rank == 0)
        del state
        cases = GRAPH_CASES if dev.type == "cuda" else FAMILIES
        res["graph"] = {}
        for name in cases:
            t0 = time.perf_counter()
            res["graph"][name] = graph_case(name, dev)
            res["graph"][name]["seconds"] = time.perf_counter() - t0
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        res["loss"] = {a: res["graph"][a]["loss"] for a in FAMILIES}
        res["step_ms"] = {a: res["graph"][a]["eager_step_ms"] for a in FAMILIES}
        if dev.type == "cuda":
            res["loop"] = loop_case(dev, workdir)
        if rank == 0:
            from repro_torch.checkpoint.ckpt import flatten
            init, _ = single_device(cfg, rc, dev)
            named = train_step.reference_tree(init)
            res["single_loss"] = {a: single_device(configs.load_smoke(a), rc, dev)[1]
                                  for a in FAMILIES}
            got, want = flatten(map_parts(whole["params"])), flatten(map_parts(named))
            res["whole_equals_init"] = [p for p, _ in got] == [p for p, _ in want] \
                and all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
        Path(workdir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def map_parts(tree):
    """A reference tree with each ``Stacked`` leaf stacked into one tensor."""
    from repro_torch.checkpoint.ckpt import Stacked, map_tree
    return map_tree(lambda t: torch.stack(t.parts, t.axis)
                    if isinstance(t, Stacked) else t, tree)


def main(argv) -> int:
    cpu = "--cpu" in argv
    if not cpu:
        if torch.cuda.device_count() < WORLD:
            print(f"needs {WORLD} cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        from repro_torch.kernels import _build
        _build.build()          # once, before the ranks load the libraries
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nccl_tp_check_") as d:
        mp.start_processes(rank_main, args=(f"tcp://localhost:{port}",
                                            "gloo" if cpu else "nccl", d),
                           nprocs=WORLD, start_method="spawn")
        ranks = [json.loads(Path(d, f"rank{r}.json").read_text())
                 for r in range(WORLD)]
    single = ranks[0]["single_loss"]
    checks = {"collectives": all(v for r in ranks for v in r["collectives"].values()),
              "whole_on_rank0_only": all(r["whole_on_rank0_only"] for r in ranks),
              "whole_equals_init": ranks[0]["whole_equals_init"],
              "losses": all(abs(a - b) <= 5e-3 for r in ranks for arch in FAMILIES
                            for a, b in zip(r["loss"][arch], single[arch]))}
    graph = {}
    if not cpu:
        checks["graph_within_eager_spread"] = all(
            g["within_spread"] for r in ranks for g in r["graph"].values())
        checks["graph_counts_equal_eager"] = all(
            g["counts_equal"] for r in ranks for g in r["graph"].values())
        checks["train_loop_replays_and_resumes"] = all(r["loop"]["ok"] for r in ranks)
        keys = ("bit_equal", "graph_vs_eager", "eager_vs_eager", "per_step",
                "eager_ms_median", "graphed_ms_median", "capture_ms", "peak_GiB",
                "batch", "seq", "layers", "seconds", "reduced")
        graph = {name: [{k: r["graph"][name].get(k) for k in keys} for r in ranks]
                 for name in GRAPH_CASES}
    smi = "" if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"ok": all(checks.values()), "checks": checks,
                      "failed_collectives": sorted(
                          {k for r in ranks for k, v in r["collectives"].items() if not v}),
                      "loss": [r["loss"] for r in ranks], "single_loss": single,
                      "step_ms": [r["step_ms"] for r in ranks], "graph": graph,
                      "loop": [r.get("loop") for r in ranks],
                      "seconds": time.perf_counter() - t0, "cards": smi}))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
