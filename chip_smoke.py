#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernels
against their plain PyTorch versions.

Run from the repository root, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

The main path is the paper's device pipeline at full size: a 2^26-cell f32
field (256 MiB, seeded with numpy) through ``ops.jacobi1d_tiled`` (T = 64,
W = 512), quantized by ``blockcodec.quantize`` into int32 codes
[2^18, 256] at 7 bits, packed by ``ops.pack_codes`` at 8 bits, unpacked by
``ops.unpack_codes`` and dequantized.  Phases, one line each:

1. build   — compile every ``csrc/*.cu`` with nvcc, all in parallel, and
             launch each kernel once on a tiny input (set-up);
2. card    — ``nvidia-smi`` name and power limit, and the rate of a 1 GiB
             device-to-device copy;
3. main    — the path above, launch counts zeroed before and read after;
4. stencil — the jacobi kernel against its plain version (<= 1e-5, the
             tolerance of tests/test_kernels.py), and the whole path against
             the independent oracle ``ref.jacobi_chunked_ref`` on a small input;
5. codec   — pack / unpack bit-identical to their plain versions at the
             main-path shape and over a bits sweep with int32 wrap;
6. the ``{"kernels": [...]}`` line, then the card line, then the result line.

``bound_ms`` is the larger of the bytes the function must move over the
H100's published 3.35 TB/s and its operations over the published 67 TFLOP/s
of fp32 outside the tensor cores (the table has no int32 rate; 32-bit
integer operations are charged at that rate).  ``copy_bound_ms`` divides the
same bytes by this run's measured copy rate.  Exits non-zero, printing no
result, when there is no GPU or any check fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import blockcodec  # noqa: E402
from repro_torch.kernels import _build, bitplane, jacobi_mars, ops, ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores

SEED = 0
N_CELLS, T_STEPS, WIDTH = 1 << 26, 64, 512
QBITS, BITS, BLOCK = 7, 8, 256
SWEEP_BITS, SWEEP_ROWS = (1, 4, 7, 8, 13, 16, 31, 32), 4096
JACOBI_TOL = 1e-5


class CheckFailed(RuntimeError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: int, nops: int, copy_rate: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "copy_bound_ms": nbytes / copy_rate * 1e3}


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if a.dtype == torch.int32:
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    return float((a - b).abs().max())


def wrapped_codes(rng, rows: int, bits: int) -> np.ndarray:
    """int32 codes whose deltas (first word included) fit `bits`; their
    running sum wraps int32 where `bits` is wide enough."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    d = rng.integers(lo, hi, size=(rows, BLOCK), dtype=np.int64)
    q = np.cumsum(d, axis=1)
    return (((q + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)


def phase_build(dev) -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    regs = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for name, log in logs.items()}
    # first launch of each library (dlopen, CUDA runtime start-up) on tiny
    # inputs, so the main path's wall time is not charged this set-up
    t1 = time.perf_counter()
    codes = torch.zeros(8, BLOCK, dtype=torch.int32, device=dev)
    bitplane.unpack(bitplane.pack(codes, BITS), BITS, BLOCK)
    jacobi_mars.jacobi_chunked(torch.zeros(64, device=dev), 4, 16)
    torch.cuda.synchronize()
    emit({"phase": "build", "seconds": t1 - t0,
          "first_launch_seconds": time.perf_counter() - t1,
          "sources": list(_build.SOURCES), "ptxas": regs})


def phase_card(dev) -> tuple:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    src = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    rate = 2 * src.numel() * 4 / (ms * 1e-3)                      # read + write
    del src, dst
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(dev),
          "copy_GiB": 1, "copy_ms": ms, "copy_bytes_per_s": rate})
    return smi, rate


def phase_main(dev) -> dict:
    rng = np.random.default_rng(SEED)
    x_np = np.cumsum(rng.uniform(-0.01, 0.01, N_CELLS)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    y = ops.jacobi1d_tiled(x, T_STEPS, width=WIDTH)
    q, scale = blockcodec.quantize(y, QBITS, BLOCK)
    planes = ops.pack_codes(q, BITS)
    q2 = ops.unpack_codes(planes, BITS, BLOCK)
    out = blockcodec.dequantize(q2, scale)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()

    for name, count in launches.items():
        check(count >= 1, f"main path never launched {name}: {launches}")
    check(out.shape == (N_CELLS // BLOCK, BLOCK), f"output shape {out.shape}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(bool(torch.equal(q2, q)), "codes changed in the pack/unpack round trip")
    err = (out.reshape(-1) - y).abs().reshape(-1, BLOCK)
    check(bool((err <= scale[:, None] / 2 * (1 + 1e-5) + 1e-7).all()),
          "round trip lost more than half a quantization step")
    emit({"phase": "main", "n_cells": N_CELLS, "t_steps": T_STEPS,
          "width": WIDTH, "codes": list(q.shape), "qbits": QBITS, "bits": BITS,
          "wall_ms": wall_ms, "launches": launches,
          "peak_GiB": torch.cuda.max_memory_allocated(dev) / 2**30,
          "max_roundtrip_err": float(err.max())})
    return {"x": x, "y": y, "q": q, "planes": planes, "launches": launches}


def phase_stencil(dev, main: dict, copy_rate: float) -> dict:
    x = main["x"]
    y_plain = ops.jacobi1d_tiled(x, T_STEPS, width=WIDTH, backend="ref")
    err_path = max_abs_diff(main["y"], y_plain)
    check(err_path <= JACOBI_TOL, f"jacobi1d_tiled vs plain: {err_path}")

    xp = ops.pad_chunked(x, T_STEPS, WIDTH)
    yk = jacobi_mars.jacobi_chunked(xp, T_STEPS, WIDTH)
    yp = jacobi_mars.jacobi_chunked_plain(xp, T_STEPS, WIDTH)
    err = max_abs_diff(yk, yp)
    check(err <= JACOBI_TOL, f"jacobi_chunked vs plain: {err}")
    ms = time_ms(lambda: jacobi_mars.jacobi_chunked(xp, T_STEPS, WIDTH), reps=3)
    plain_ms = time_ms(lambda: jacobi_mars.jacobi_chunked_plain(xp, T_STEPS, WIDTH),
                       reps=3)

    # the whole path on a small input against the independent oracle
    xs = torch.from_numpy(
        np.random.default_rng(SEED + 1).standard_normal(4096).astype(np.float32)).to(dev)
    err_small = max_abs_diff(ops.jacobi1d_tiled(xs, 16, width=256),
                             ref.jacobi_chunked_ref(xs, 16))
    check(err_small <= JACOBI_TOL, f"small jacobi vs jacobi_chunked_ref: {err_small}")

    nbytes = sum(ops.jacobi_io_bytes(xp.numel()))
    nops = 3 * T_STEPS * xp.numel()             # 2 adds + 1 divide per cell and level
    row = {"name": "jacobi_mars.jacobi_chunked", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/jacobi_mars.cu",
           "replaces": "src/repro/kernels/jacobi_mars.py:36",
           "launches": main["launches"]["jacobi_mars.jacobi_chunked"],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes, nops, copy_rate),
           "library_ms": None}
    emit({"phase": "stencil", "n_padded": xp.numel(), "t_steps": T_STEPS,
          "width": WIDTH, "path_vs_plain_err": err_path,
          "small_vs_oracle_err": err_small, "tol": JACOBI_TOL, **row})
    return row


def phase_codec(dev, main: dict, copy_rate: float) -> list:
    q, planes = main["q"], main["planes"]
    n = q.shape[0]
    pk, pp = bitplane.pack(q, BITS), bitplane.pack_plain(q, BITS)
    err_pack = max_abs_diff(pk, pp)
    check(err_pack == 0, f"pack planes differ from plain: {err_pack}")
    uk, up = bitplane.unpack(planes, BITS, BLOCK), bitplane.unpack_plain(planes, BITS, BLOCK)
    err_unpack = max_abs_diff(uk, up)
    check(err_unpack == 0, f"unpack codes differ from plain: {err_unpack}")
    check(bool(torch.equal(uk, q)), "unpack(pack(q)) != q")

    # 32-bit integer operations per word: pack = subtract, mask, and per
    # plane a shift and an and; unpack = per plane two shifts, an and and
    # an or, then the sign extension and the scan's add
    rows = []
    for name, line, fn, plain, err, io, nops in (
        ("bitplane.pack", 46, lambda: bitplane.pack(q, BITS),
         lambda: bitplane.pack_plain(q, BITS), err_pack,
         ops.pack_io_bytes(n, BLOCK, BITS), n * BLOCK * (2 + 2 * BITS)),
        ("bitplane.unpack", 62, lambda: bitplane.unpack(planes, BITS, BLOCK),
         lambda: bitplane.unpack_plain(planes, BITS, BLOCK), err_unpack,
         ops.unpack_io_bytes(n, BLOCK, BITS), n * BLOCK * (4 * BITS + 3)),
    ):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/bitplane.cu",
                     "replaces": f"src/repro/kernels/bitplane.py:{line}",
                     "launches": main["launches"][name], "max_abs_err": err,
                     "ms": time_ms(fn, reps=20), "plain_ms": time_ms(plain, reps=3),
                     **bound(sum(io), nops, copy_rate), "library_ms": None})
    emit({"phase": "codec", "codes": [n, BLOCK], "bits": BITS, "rows": rows})

    rng = np.random.default_rng(SEED + 2)
    sweep = []
    for bits in SWEEP_BITS:
        full = torch.from_numpy(rng.integers(-2**31, 2**31, size=(SWEEP_ROWS, BLOCK),
                                             dtype=np.int64).astype(np.int32)).to(dev)
        pk = bitplane.pack(full, bits)
        e_pack = max_abs_diff(pk, bitplane.pack_plain(full, bits))
        e_unpack = max_abs_diff(bitplane.unpack(pk, bits, BLOCK),
                                bitplane.unpack_plain(pk, bits, BLOCK))
        qw = torch.from_numpy(wrapped_codes(rng, SWEEP_ROWS, bits)).to(dev)
        trip = bool(torch.equal(bitplane.unpack(bitplane.pack(qw, bits), bits, BLOCK), qw))
        check(e_pack == 0 and e_unpack == 0 and trip,
              f"bits={bits}: pack err {e_pack}, unpack err {e_unpack}, trip {trip}")
        sweep.append({"bits": bits, "pack_err": e_pack, "unpack_err": e_unpack,
                      "roundtrip": trip})
    emit({"phase": "codec_sweep", "rows": SWEEP_ROWS, "block": BLOCK,
          "sweep": sweep})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    phase_build(dev)
    smi, copy_rate = phase_card(dev)
    main_out = phase_main(dev)
    rows = [phase_stencil(dev, main_out, copy_rate),
            *phase_codec(dev, main_out, copy_rate)]
    emit({"kernels": [{k: v for k, v in r.items() if k != "copy_bound_ms"}
                      for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
