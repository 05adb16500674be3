"""Run one cell of the benchmark of ``repro_torch`` on the card(s) of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up makes the weights (and any session
history) on the card from the seed, hands them to the program's serving
engine, captures its decode step for the cell's batch and warms it up.
Then the window: whole batches of the lockstep schedule (``lockstep.py``)
on the replayed step, until a batch ends at least ``--seconds`` after the
window opened, timed on the host's clock.  A window of whole batches holds
every request it starts to its end, so its rate does not hang on where a
batch is cut.  With ``--trace 1`` a few
more steps, from the middle of the next batch, run under the profiler for
the per-layer metrics.  Then the
program's state is freed and the plain reference checks a sample of the
requests the window served (``check.py``).  The last line of standard
output is the result as JSON; the numbers compared, with their limits, are
the last lines of standard error.

Without a card (or with fewer than the cell asks for) it exits with 2 and
prints no result.  If JAX or the JAX package was loaded it exits with 3.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the wall clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_PROCESS = process_start()


def loaded_banned() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def fail(code: int, msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(code)


def percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=float), q))


def end_to_end(ls, steps: list, t0: float, t_end: float, setup_s: float) -> dict:
    """The metrics a user sees, from the window alone."""
    window = t_end - t0
    generated = sum(b.generated for b in ls.batches)
    ttft = [(r.t_first if r.t_first is not None and r.t_first <= t_end else t_end)
            - r.t_start for r in ls.requests if r.t_start < t_end]
    return {"tokens_per_s": (generated / window, "tokens/s"),
            "step_ms_p95": (percentile(steps, 95) * 1e3, "ms"),
            "ttft_ms_p95": (percentile(ttft, 95) * 1e3, "ms"),
            "setup_s": (setup_s, "s")}


def window_counts(ls, cfg: dict, arch, traffic) -> dict:
    """The window's steps, tokens and least time by the peaks."""
    from bench import counts
    least, steps = 0.0, 0
    for b in ls.batches:
        for pos in ls.positions(b):
            least += counts.step_counts(cfg, arch, pos, traffic.seq_len,
                                        traffic.kv_bits)["least_s"]
        steps += b.steps
    return {"steps": steps, "generated": sum(b.generated for b in ls.batches),
            "batch": traffic.B, "least_s": least}


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """Set-up, the window, the traced steps and the check of one cell ->
    the result line (a dict) and the check's numbers and limits."""
    import torch
    from bench import check, counts, inputs, lockstep, profile, system

    cuda = torch.device(device).type == "cuda"
    marks = [("start", time.time() - T_PROCESS)]

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks.append((name, time.time() - T_PROCESS))
    cfg, arch = cell.config, cell.arch
    traffic = cell.generator.make(cell.traffic, cfg["vocab"], seed)
    weights = inputs.weights(cfg, arch, seed, device)
    mark("weights")
    server = system.Server(cell.bridge, cfg, traffic, weights, device)
    mark("engine_and_capture")
    hist = check.history_fn(cfg, traffic, seed, device)
    if hist is not None:
        server.fill_history(hist)
        mark("history")
    # warm-up: a batch's first steps through the whole path; the window's
    # first batch begins the state again
    lockstep.Lockstep(server, traffic).run_steps(3)
    mark("warm_up")

    ls = lockstep.Lockstep(server, traffic)
    t0 = time.perf_counter()
    setup_s = time.time() - T_PROCESS
    steps = ls.run_until(t0 + seconds)
    t_end = time.perf_counter()
    e2e = end_to_end(ls, steps, t0, t_end, setup_s)
    ctx = {"cfg": cfg, "traffic": traffic,
           "window": window_counts(ls, cfg, arch, traffic), "profile": None}
    ctx["window"]["seconds"] = t_end - t0

    n_batches, requests = len(ls.batches), list(ls.requests)   # the window's

    if trace and cuda:
        K, L = int(cell.traffic["profile_steps"]), cfg["n_layers"]
        positions = []
        ls.run_into_batch(0.5)    # the stretch stands for a batch's middle

        def traced():
            for _ in range(K):
                positions.append(ls.next_positions())
                ls.step()
        before = system.kernel_launches()
        server.annotate = True
        prof = profile.profile(traced, expect={system.ATTN_KERNEL: L * K})
        server.annotate = False
        after = system.kernel_launches()
        sessions = prof["sessions"] if prof else 3
        want = {n: per * L * K * sessions
                for n, per in cell.bridge.DECODE_KERNELS.items()}
        ctx.update(profile=prof, profile_steps=K, profile_attn_launches=L * K,
                   profile_launches_ok={n: after[n] - before[n] for n in want} == want,
                   profile_attn_bytes=sum(
                       counts.decode_attention_bytes(cfg, v, traffic.kv_bits)
                       for p in positions[-K:]
                       for v in counts.layers_slots(cfg, arch, p, traffic.seq_len)))

    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    server.free()
    del server, ls
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result = check.compare(cfg, arch, weights, requests, traffic, seed, device)
    correct, shown = check.judge(result, cell.limits)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]][0]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(requests),
           "failed": 0 if correct else max(result["requests"], 1),
           "metrics": metrics, "device": dev}
    if ctx["profile"] is not None:
        dev["busy_s"] = ctx["profile"]["busy_s"]
        dev["window_s"] = ctx["profile"]["window_s"]
        out["breakdown"] = {"device_ops": ctx["profile"]["device_ops"],
                            "idle_gaps": ctx["profile"]["idle_gaps"]}
    out["check"] = shown
    w = ctx["window"]
    print("setup marks (s since process start): "
          + ", ".join(f"{n} {t:.3f}" for n, t in marks), file=sys.stderr)
    print(f"setup_s {setup_s:.3f}; window {w['seconds']:.3f} s, {w['steps']} steps, "
          f"{n_batches} batches, {w['generated']} tokens", file=sys.stderr)
    return out, shown, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import spec
    cell = spec.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(2, f"{args.workload} needs {cell.chips} CUDA device(s); this machine "
                f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    torch.cuda.set_device(0)
    out, shown, result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    banned = loaded_banned()
    if banned:
        fail(3, f"the run loaded {', '.join(banned)}: the benchmark measures the "
                f"port alone")
    from bench import check
    check.print_numbers(shown, result)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
