"""The differentiable collectives and a tensor-parallel train step over NCCL,
one rank a card.

``chip_smoke.py`` runs its ranks on one card over gloo (NCCL refuses two
ranks on one GPU), so the NCCL side of ``distributed.collectives`` (the
reduce-scatter, the all-reduce and the gathers on device memory) is held
here, on a host with four cards:

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

Rank 0 prints one JSON line of what it measured; the exit code is 0 when
every check held.
"""
import json
import socket
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
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402

WORLD = 4
SHAPE, NAMES = (2, 2), ("data", "model")
STEPS = 3
ARCH = "tinyllama-1.1b"
#: each family's smoke config and its mesh over NAMES
FAMILIES = {ARCH: SHAPE, "mamba2-130m": SHAPE, "hymba-1.5b": SHAPE,
            "whisper-tiny": (1, 4)}


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


def mesh_losses(arch: str, rc, dev) -> tuple:
    """STEPS losses and step ms of ``arch``'s smoke config on its mesh."""
    mesh = make_mesh(FAMILIES[arch], NAMES, dev)
    cfg = configs.load_smoke(arch)
    api = model_zoo.get_api(cfg, rc, dev)
    state = train_step.init_state(api, rc, 0, mesh)
    step = train_step.make_train_step(api, cfg, rc, mesh)
    pipe = SyntheticPipeline(cfg, rc, seed=3)
    losses, times = [], []
    for _ in range(STEPS):
        batch = device_batch(pipe.next(), cfg, rc, dev, mesh)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, times


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
        res["loss"], res["step_ms"] = {}, {}
        for arch in FAMILIES:
            res["loss"][arch], res["step_ms"][arch] = mesh_losses(arch, rc, dev)
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
    smi = "" if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"ok": all(checks.values()), "checks": checks,
                      "failed_collectives": sorted(
                          {k for r in ranks for k, v in r["collectives"].items() if not v}),
                      "loss": [r["loss"] for r in ranks], "single_loss": single,
                      "step_ms": [r["step_ms"] for r in ranks],
                      "seconds": time.perf_counter() - t0, "cards": smi}))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
