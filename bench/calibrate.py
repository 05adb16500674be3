"""Readings for the limits of ``correct``: the program's, and its control's.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 3 --seconds <s> [--out calib.jsonl]

For each seed, in one process (set-up is long): the cell's set-up and a
short window of whole batches at its own load, the
window's sample checked as ``run.py`` checks it (the program's readings);
then, on the first ``--control-seeds`` seeds, the control: the program
with its KV cache packed to the next width below the configuration's
(int8 -> int4, the program's own path), fed the same prompts and served
tokens of the sampled requests, and at each served position the token it
puts first read against the same reference logits.  One JSON line a seed.
The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOWER = {16: 8, 8: 4}


def control_tokens(cell, traffic, weights, reqs: list, seed: int, device,
                   bits: int) -> list:
    """The token the program at ``bits`` puts first at each served position
    of each request, teacher-forced on its prompt and served tokens, in
    batches of the cell's B with each request in its own row."""
    import numpy as np
    import torch
    from bench import check, system
    cfg = cell.config
    low = copy.copy(traffic)
    low.kv_bits = bits
    server = system.Server(cell.bridge, cfg, low, weights, device)
    hist = check.history_fn(cfg, low, seed, device)
    if hist is not None:
        server.fill_history(hist)
    out = [None] * len(reqs)
    todo = list(range(len(reqs)))
    while todo:
        rows, now = {}, []
        for i in todo:
            if reqs[i].row not in rows:
                rows[reqs[i].row] = i
                now.append(i)
        todo = [i for i in todo if i not in now]
        seqs = {r: np.concatenate([reqs[i].prompt, np.asarray(reqs[i].served[:-1])])
                for r, i in rows.items()}
        T = max(len(s) for s in seqs.values())
        server.begin_batch()
        picked = {r: [] for r in rows}
        for t in range(T):
            cur = np.zeros(traffic.B, np.int64)
            for r, s in seqs.items():
                cur[r] = s[min(t, len(s) - 1)]
            top = server(cur)
            for r, i in rows.items():
                first = len(reqs[i].prompt) - 1
                if first <= t < first + len(reqs[i].served):
                    picked[r].append(int(top[r]))
        for r, i in rows.items():
            out[i] = picked[r]
    server.free()
    del server
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


#: a router margin (k-th minus (k+1)-th probability) under this is a near
#: tie: bf16's rounding of the hidden state and of the router's logits can
#: break it otherwise than f32 does
TIE = 0.01


def near_ties(g, reqs: list, margins: list) -> dict:
    """The program's gaps split by whether the reference's routing of the
    served token's input position was within ``TIE`` of a tie in any
    layer: the look at why a MoE's widest gap swings."""
    import numpy as np
    tied = []
    for r, m in zip(reqs, margins):
        least = np.min(np.stack([t.cpu().numpy() for t in m]), axis=0)  # (T,)
        first = len(r.prompt) - 1
        tied.append(least[first:first + len(r.served)] < TIE)
    tied = np.concatenate(tied)
    out = {"tie": TIE, "tokens_near_tie": int(tied.sum()), "tokens": int(tied.size)}
    for name, sel in (("near_tie", tied), ("clear", ~tied)):
        if sel.any():
            out[name] = {"gap_max": float(g[sel].max()), "gap_mean": float(g[sel].mean())}
    return out


def readings(cell, seed: int, seconds: float, control: bool, device: str) -> dict:
    import torch
    from bench import check, inputs, lockstep, system
    cfg, arch = cell.config, cell.arch
    traffic = cell.generator.make(cell.traffic, cfg["vocab"], seed)
    weights = inputs.weights(cfg, arch, seed, device)
    server = system.Server(cell.bridge, cfg, traffic, weights, device)
    hist = check.history_fn(cfg, traffic, seed, device)
    if hist is not None:
        server.fill_history(hist)
    ls = lockstep.Lockstep(server, traffic)
    t0 = time.perf_counter()
    ls.run_until(t0 + seconds)    # whole batches, as a run's window
    server.free()
    del server
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    reqs = check.sample(ls.requests, int(traffic.mix["check_requests"]), seed)
    row = {"seed": seed, "requests": len(reqs),
           "tokens": sum(len(r.served) for r in reqs)}
    if not reqs:
        return row
    ctrl = None
    if control:
        bits = LOWER[traffic.kv_bits]
        ctrl = control_tokens(cell, traffic, weights, reqs, seed, device, bits)
        row["control_bits"] = bits
    margins = [[] for _ in reqs] if arch.routes(cfg) else None
    lg = check.reference_logits(cfg, arch, weights, reqs, traffic, seed, device,
                                margins)
    g = check.gaps(lg, reqs, [r.served for r in reqs])
    row["program"] = check.numbers(g)
    if ctrl is not None:
        row["control"] = check.numbers(check.gaps(lg, reqs, ctrl))
    if margins is not None:
        row["routing"] = near_ties(g, reqs, margins)
    del weights, lg
    gc.collect()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    for n, seed in enumerate(seeds):
        t = time.time()
        row = readings(cell, seed, args.seconds, n < args.control_seeds, "cuda")
        row["seconds"] = time.time() - t
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
