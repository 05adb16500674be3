#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold its kernels
against their plain PyTorch versions.

Run from the repository root, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Four paths, each driven with the launch counts set to 0 just before it and
read just after:

* stencil and codec: a 2^26-cell f32 field (256 MiB, seeded with numpy)
  through ``ops.jacobi1d_tiled`` (T = 64, W = 512), quantized by
  ``blockcodec.quantize`` into int32 codes [2^18, 256] at 7 bits, packed by
  ``ops.pack_codes`` at 8 bits, unpacked by ``ops.unpack_codes`` and
  dequantized;
* serving granite-8b at its full published width (36 layers, d_model 4096,
  bf16, random weights from a seeded ``torch.Generator`` on the card):
  ``ModelApi.prefill`` on 4 x 2048 tokens (flash attention in every layer)
  and ``ServeEngine.generate`` with an int8 KV cache on 8 prompts of
  16-128 tokens, 32 new tokens each (the decode step replayed as a CUDA
  graph: kv_quant_store once and kv_dequant twice in every layer at every
  step), then a short int4 generate;
* training tinyllama-1.1b at its full published width and depth (22 layers,
  d_model 2048, bf16 weights, f32 AdamW moments, remat): 3 timed steps of
  ``train.step.make_train_step`` (the step ``train.loop.train`` runs) on
  8 x 4096 tokens each, the batch cut from the 256 of ``SHAPES["train_4k"]``
  to keep the run short (flash forward twice per layer, forward and remat
  recompute, and both flash backward kernels once per layer);
* the paper's host analysis (``core``: MARS, the layout ILP, the codec, the
  transfer model, the tiled-accelerator executor) with the obs exporters,
  tied to the card by the Jacobi kernel: the executor's full-tile rows held
  against ``ops.jacobi1d_tiled`` on the card (three launches).

Phases, one JSON line each:

1. build     — compile every ``csrc/*.cu`` with nvcc, all in parallel; check
               that the SASS of the three tensor-core kernels
               (``flash_attention_sm90.cu``: forward, dK/dV, dQ) holds HGMMA
               (wgmma) instructions and report their count, registers and
               spills; report the codec kernels' static SASS (instructions,
               SHFL / VOTE and the other opcodes of their inner loop) and
               their registers, shared memory and spills; launch each kernel
               once on a tiny input, the flash ones in f32 and bf16 (set-up);
2. card      — ``nvidia-smi`` name and power limit, and the rate of a 1 GiB
               device-to-device copy;
3. main      — the stencil and codec path above, then a profile of one
               more run (device ops, idle share);
4. stencil   — the jacobi wavefront kernel bit-identical (``torch.equal``) to
               its plain version: the whole path, the kernel at the main
               shape, two back-to-back launches, and a sweep of (n, T, W)
               with T = 0, T = W - 3, n below and ragged against the
               kernel's 4096-cell tile, and a ghost x[0] that the update
               changes; its division by 3 against IEEE division on all
               2^32 f32 inputs (no mismatch); the whole path against the
               independent oracle ``ref.jacobi_chunked_ref`` on a small
               input (<= 1e-5, the tolerance of tests/test_kernels.py);
5. codec     — pack / unpack bit-identical to their plain versions at the
               main-path shape and on two back-to-back launches, and their
               launch plans (grid, shared memory);
               ``blockcodec.quantize`` on the card equal to its CPU run at
               the main shape, codes and scales; then a sweep of every bits
               1..32 at blocks 32, 96, 256, 4096 and 65536, in row counts
               ragged against the kernels' tile and on one row, plus views
               4 bytes off 16-byte alignment, plus cases at each block whose
               units outnumber the persistent grid 2.5 to 1 (each block
               walks several units; at block 65536 it starts each new long
               row with a fresh carry): full-range codes whose deltas
               wrap int32 through pack and unpack bit-identical to the plain
               versions, and the round trip of codes whose deltas fit;
6. paper     — Table 1 over ``stencil.ZOO`` equal to the paper's numbers
               (MARS in / out, read / write bursts); Fig. 10's transfer cases
               (a jacobi-1d history of 4000 cells x 500 steps, seed 0, an
               interior tile at (64, 64) and (200, 200), fixed18 / fixed24 /
               float, every pattern of ``transfer.MODES``): ``mars_comp`` the
               fewest cycles, and the ``transfer/cycles`` counters, through
               ``obs.sink``'s sidecar written and read back, equal to the
               direct totals (the report's transfer table printed on a line
               before); ``Jacobi1dMarsExecutor`` (4000 cells, T = 256,
               (64, 64) tiles, fixed18 and float) within 1e-2 / 1e-5 of the
               dense reference, and its full-tile values of rows 64, 128 and
               the latest within the same tolerance of ``ops.jacobi1d_tiled``
               on the card, on the cells more than t from both ends (where
               the reference's fixed ends and the entry point's edge padding
               agree); cells compared, deviations, compression ratios and
               each part's host seconds (host time, not device time);
7. lm_init   — the granite-8b weights on the card (count, GiB, seconds);
8. prefill   — the prefill path: 36 flash launches, finite logits (4, 49152),
               a profile of one more prefill (device ops, idle share);
9. serve     — the generate path: the graph's capture ms, then launches
               checked exactly (36 x steps kv_quant_store, 72 x steps
               kv_dequant, no kv_quant and nothing else), tokens/s, cache
               bytes, peak memory; an int4 generate, counted the same way;
               the graph against eager ``decode_step`` from the same state
               (16 int8 steps, and the int4 generate's schedule): logits
               ``torch.equal`` at every step, identical greedy tokens, equal
               caches, host ms a step of both; a profile of 8 replayed steps
               (top device ops, idle share; kv_quant_store found 36 x 8
               times, kv_dequant 72 x 8); a step's token copy and replay
               by CUDA events, and the idle share of the untraced generate's
               step against the profile's busy time a step;
10. kvpack    — kv_quant / kv_dequant bit-identical to their plain versions
               at the serve path's shapes, bits 8 and 4, f32 and bf16, and on
               an odd row count; kv_quant_store ``torch.equal`` to its plain
               version on caches full of seeded noise, at the serve shape
               and two small ones, bits 8 and 4, f32 and bf16, every
               sequence at slot 0, mid, S - 1, past the end, and a seeded
               mix (60 cases); the three kv rows timed by events, back to
               back and in the profile, beside the profiler's device time of
               a one-element ``fill_`` (the card's launch floor);
11. attention — the flash forward against its plain version at one layer's
               prefill shape (bf16: o within 3e-2, lse within 1e-3, and o's
               relative error on every 64-row query tile of each head within
               FLASH_BF16_REL), on bf16 cases for the tensor-core kernel's
               mask and padding paths (window 64, ragged S = Sk = 100, D = 32,
               non-causal, ragged D = 128, Sk < S) and on the f32 cases
               of tests/test_flash_attention.py (2e-5); the bf16 forward and
               SDPA's forward timed at the prefill and the train shapes;
12. lm_parity — the granite-8b smoke config with the same weights on the card
               (kernels) and on the CPU (plain paths): f32 logits within 1e-4
               and identical greedy tokens, bf16 logits within 3e-2 of the
               largest logit, for kv_cache_bits 16, 8 and 4;
13. train    — the training path above: step ms (median), tokens/s, MFU,
               peak memory, loss and grad norm per step (finite), launches
               per step checked exactly, a profile of one more step;
14. train_loop — ``train.loop.train`` itself on the card at the smoke
               config of tests/test_train_loop.py, checkpoints in a temp
               dir: no restart without injection and the loss drops; with an
               injected failure one restart, and the resumed losses equal
               the uninterrupted run's (atol 1e-5);
15. attention_bwd — the dK/dV and dQ kernels (bf16: both on the tensor
               cores; f32: on the CUDA cores) against ``flash_bwd_plain``:
               f32 on the shapes of tests/test_flash_attention.py's gradient
               test, windows 32 and 64, ragged S and D = 128 (relative error
               2e-4); bf16 on the forward's mask and padding cases
               (1e-2 of each gradient's largest magnitude); bf16 at the train
               shape (8, 4096, 4, 8, 64), causal,
               each kernel launched once on the batch and each sequence
               held against the plain forward (o within 3e-2 and its tiles
               within FLASH_BF16_REL, lse within 1e-3) and backward (each
               gradient within 1e-2 of its largest magnitude) run on it
               alone; the kernels timed at that shape,
               the plain backward's times summed over the sequences;
16. train_parity — the tinyllama smoke config with the same weights on the
               card (kernels) and on the CPU (plain paths), 3 train steps:
               f32 losses within 1e-4 and grad norms within 1e-4 relative,
               bf16 losses within 2e-2 and grad norms within 5e-3 relative;
17. the ``{"kernels": [...]}`` line, then the card line, then the result line.

The three tensor-core rows (flash forward, dK/dV, dQ), the jacobi row, the
two codec rows and the fused KV store's row also carry ``design``; the
codec rows add their time a launch in the main path's profile
(``profile_ms``), the kv rows their time back to back, in the profile and
the launch floor.  kv_quant's ``launches`` is 0: the serve path writes its
cache through kv_quant_store.

``bound_ms`` is the larger of the bytes the function must move over the
H100's published 3.35 TB/s and its operations over the published peak for
their type: 989 TFLOP/s for bf16 attention (tensor cores, dense), else
67 TFLOP/s of fp32 outside the tensor cores (the table has no int32 rate;
32-bit integer operations are charged at that rate).  ``copy_bound_ms``
divides the same bytes by this run's measured copy rate.  Exits non-zero,
printing no result, when there is no GPU or any check fails.
"""
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.core import (blockcodec, executor, layout, mars,  # noqa: E402
                              stencil, transfer)
from repro_torch.kernels import (_build, bitplane, flash_attention,  # noqa: E402
                                 jacobi_mars, kvpack, ops, ref)
from repro_torch.data.pipeline import SyntheticPipeline, device_batch  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM, bf16 tensor cores, dense (data sheet)

SEED = 0
N_CELLS, T_STEPS, WIDTH = 1 << 26, 64, 512
QBITS, BITS, BLOCK = 7, 8, 256
#: the codec sweep: every bits 1..32 at each block, on about SWEEP_WORDS
#: codes a case in a row count ragged against the kernels' tile
SWEEP_BLOCKS, SWEEP_WORDS = (32, 96, 256, 4096, 65536), 1 << 20
#: (block, bits) of the cases run on a view 4 bytes off 16-byte alignment
OFFSET_CASES = ((256, 8), (96, 13), (32, 32), (65536, 31))
#: bits of the walk cases: units = WALK_UNITS x the largest grid, so that
#: every block of the persistent grid takes several units
WALK_BITS, WALK_UNITS = (1, 7, 13, 32), 2.5
#: the codec kernels, as their names stand (mangled) in ptxas' log and SASS
BITPLANE_KERNELS = {"pack": "11pack_kernel", "unpack": "13unpack_kernel"}
#: ... and as the profiler names them (demangled)
CODEC_PROFILE_KEYS = {"pack": "::pack_kernel", "unpack": "unpack_kernel"}
JACOBI_TOL = 1e-5                         # the small input against the oracle
#: (n, T, W) for the jacobi kernel against its plain version: the build's
#: and the oracle's shapes, T = 0, T = W - 3, n below and ragged against
#: the kernel's 4096-cell tile, and many tiles at a deep T
JACOBI_SWEEP = ((64, 4, 16), (4096, 16, 256), (1024, 0, 64), (4096, 61, 64),
                (1536, 125, 128), (96, 5, 32), (2144, 29, 32),
                (10752, 64, 512), (1 << 20, 200, 256))
STENCIL_KERNELS = ("bitplane.pack", "bitplane.unpack", "jacobi_mars.jacobi_chunked")

#: the paper's Table 1: (input MARS, output MARS, read bursts, write bursts)
PAPER_TABLE1 = {"jacobi-1d": (7, 4, 3, 1), "jacobi-2d": (28, 13, 10, 1),
                "seidel-2d": (33, 13, 10, 1)}
#: the transfer cases: a jacobi-1d history of PAPER_N cells x PAPER_T steps,
#: the interior tile holding PAPER_POINT = (t, i) at each tile size
PAPER_N, PAPER_T, PAPER_POINT = 4000, 500, (300, 2000)
PAPER_TILES, PAPER_DTYPES = ((64, 64), (200, 200)), ("fixed18", "fixed24", "float")
#: the executor: EXEC_T steps on PAPER_N cells in EXEC_TILE tiles, held to the
#: dense reference and to the card's Jacobi within tests/test_executor.py's
#: tolerance for the dtype
EXEC_T, EXEC_TILE = 256, (64, 64)
EXEC_TOLS = {"fixed18": 1e-2, "float": 1e-5}
EXEC_WIDTH = 512

ARCH = "granite-8b"
PREFILL_B, PREFILL_S = 4, 2048
SERVE_B, SERVE_SEQ, SERVE_NEW = 8, 256, 32
#: (B, S, KV, D) of the fused KV store's sweep: the serve path's (one layer
#: of granite-8b at batch 8, seq 256), and two small ones
STORE_SHAPES = ((SERVE_B, SERVE_SEQ, 8, 128), (3, 16, 2, 8), (1, 4, 1, 128))
PROFILE_STEPS = 8
PARITY_B, PARITY_S, PARITY_STEPS, PARITY_NEW = 4, 64, 24, 8
F32_TOL, BF16_REL = 1e-4, 3e-2          # bf16: relative to the largest logit
FLASH_BF16_TOL, FLASH_LSE_TOL, FLASH_F32_TOL = 3e-2, 1e-3, 2e-5
#: bf16 o: the largest relative Frobenius error over the 64-row query tiles
#: of each head (see ``tile_rel_err``); ~3x the 2.73e-3 read on an H100
FLASH_BF16_REL = 8e-3

TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_B = 8                               # cut from train_4k's 256 by time
TRAIN_STEPS = 3                           # timed, after one warm-up step
BWD_REL_TOL, BWD_BF16_TOL = 2e-4, 1e-2    # relative to each gradient's max
TRAIN_F32_TOL, TRAIN_BF16_REL = 1e-4, 2e-2
TRAIN_BF16_GN_REL = 5e-3                  # ~10x the 5.9e-4 read on an H100
#: bf16 cases for the tensor-core kernels' mask and padding paths, as
#: (B, S, Sk, KV, G, D), causal, window: a sliding window, ragged S = Sk,
#: D = 32 (the smoke configs' head size, zero-padded to 64 by TMA),
#: no mask, ragged S = Sk at D = 128, and Sk < S (rows past Sk + 7 have no
#: key in the window)
BF16_CASES = (((1, 256, 256, 2, 2, 64), True, 64),
              ((1, 100, 100, 2, 2, 64), True, 0),
              ((2, 128, 128, 2, 2, 32), True, 0),
              ((1, 256, 256, 2, 2, 64), False, 0),
              ((1, 300, 300, 1, 2, 128), False, 0),
              ((1, 50, 20, 2, 2, 64), True, 8))
FLASH_KERNELS = ("flash_attention.flash_fwd", "flash_attention.flash_bwd_dkv",
                 "flash_attention.flash_bwd_dq")
#: the bf16 kernels on the tensor cores, by the names in their SASS
TENSOR_CORE_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dkv_sm90_kernel",
                       "flash_bwd_dq_sm90_kernel")
SM90_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"


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


def stream_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call in a stream of back-to-back calls: CUDA
    events around `calls` calls, divided, median of `reps`.  The wrapper's
    host time overlaps the kernels before it, so unlike ``time_ms`` this
    reads the kernel and not the host, as long as the host keeps ahead."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def bound(nbytes: int, nops: int, copy_rate: float,
          ops_per_s: float = FP32_OPS_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "copy_bound_ms": nbytes / copy_rate * 1e3}


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if a.dtype == torch.int32:
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    return float((a - b).abs().max())


def tile_rel_err(got: torch.Tensor, want: torch.Tensor, rows: int = 64) -> float:
    """Largest ||got - want|| / ||want|| (Frobenius) over the ``rows``-row
    query tiles of each head of two (B, S, KV, G, D) tensors: a fault in a
    few tiles shows here even where |o| is small, as in a causal row's late
    tiles, which an absolute max-diff and a whole-tensor norm both dilute."""
    def tiles(t):
        t = t.float().permute(0, 2, 3, 1, 4)                    # B, KV, G, S, D
        t = torch.nn.functional.pad(t, (0, 0, 0, -t.shape[3] % rows))
        return t.reshape(*t.shape[:3], -1, rows * t.shape[4])
    w = tiles(want)
    num = (tiles(got) - w).norm(dim=-1)
    return float((num / w.norm(dim=-1).clamp_min(1e-30)).max())


def wrapped_codes(rng, rows: int, bits: int, block: int = BLOCK) -> np.ndarray:
    """int32 codes whose deltas (first word included) fit `bits`; their
    running sum wraps int32 where `bits` is wide enough."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    d = rng.integers(lo, hi, size=(rows, block), dtype=np.int64)
    q = np.cumsum(d, axis=1)
    return (((q + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)


def bitplane_sass(lib: Path, log: str) -> dict:
    """pack_kernel's and unpack_kernel's static SASS (instructions, the
    shuffle/vote pipe's SHFL and VOTE, and the opcodes the byte-slice
    transpose and the copies use) beside ptxas' registers and spills."""
    sass, ptxas = _build.sass_opcodes(lib), _build.ptxas_by_kernel(log)
    keep = ("SHFL", "VOTE", "PRMT", "LOP3", "SHF", "IADD3", "LDS", "STS",
            "LDGSTS", "LDG", "STG", "BAR", "BRA")
    out = {}
    for label, key in BITPLANE_KERNELS.items():
        fns = [fn for fn in sass if key in fn]
        check(len(fns) == 1, f"{key}: expected one kernel in the SASS, got {fns}")
        ops_ = sass[fns[0]]["by_opcode"]
        out[label] = {"sass_instructions": sass[fns[0]]["instructions"],
                      **{op: ops_.get(op, 0) for op in keep},
                      **next((v for k, v in ptxas.items() if key in k), {})}
    return out


def tensor_core_sass(name: str) -> dict:
    """HGMMA (wgmma) instructions in the SASS of each kernel of a library."""
    return {fn: k["by_opcode"].get("HGMMA", 0)
            for fn, k in _build.sass_opcodes(_build.lib_path(name)).items()}


def phase_build(dev) -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    regs = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for name, log in logs.items()}
    # the tensor-core kernels: each instantiation's SASS must hold HGMMA
    hgmma = tensor_core_sass("flash_attention_sm90")
    ptxas = _build.ptxas_by_kernel(logs["flash_attention_sm90"])
    tc = {}
    for kernel in TENSOR_CORE_KERNELS:
        found = {fn: n for fn, n in hgmma.items() if kernel in fn}
        check(found and all(n > 0 for n in found.values()),
              f"{kernel}: no HGMMA in its SASS: {found}")
        tc[kernel] = [{"hgmma": n, **ptxas.get(fn, {}),
                       "instance": "D<=64" if "ILi64E" in fn else "D<=128"}
                      for fn, n in sorted(found.items())]
    # first launch of each library (dlopen, CUDA runtime start-up, the
    # lookup of the tensor-map encoder) on tiny inputs, so the main path's
    # wall time is not charged this set-up
    t1 = time.perf_counter()
    codes = torch.zeros(8, BLOCK, dtype=torch.int32, device=dev)
    bitplane.unpack(bitplane.pack(codes, BITS), BITS, BLOCK)
    jacobi_mars.jacobi_chunked(torch.zeros(64, device=dev), 4, 16)
    kvpack.kv_dequant(*kvpack.kv_quant(torch.ones(8, 128, device=dev), 8), 8)
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.ones(1, 64, 1, 1, 64, device=dev, dtype=dt)
        o, lse = flash_attention.flash_fwd(qkv, qkv[:, :, :, 0], qkv[:, :, :, 0])
        flash_attention.flash_bwd(qkv, qkv[:, :, :, 0], qkv[:, :, :, 0], o, lse, o)
    torch.cuda.synchronize()
    emit({"phase": "build", "seconds": t1 - t0,
          "first_launch_seconds": time.perf_counter() - t1,
          "sources": list(_build.SOURCES), "ptxas": regs,
          "tensor_core_kernels": tc,
          "bitplane_kernels": bitplane_sass(_build.lib_path("bitplane"),
                                            logs["bitplane"])})


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

    def path():
        y = ops.jacobi1d_tiled(x, T_STEPS, width=WIDTH)
        q, scale = blockcodec.quantize(y, QBITS, BLOCK)
        planes = ops.pack_codes(q, BITS)
        q2 = ops.unpack_codes(planes, BITS, BLOCK)
        return y, q, scale, planes, q2, blockcodec.dequantize(q2, scale)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    y, q, scale, planes, q2, out = path()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()

    for name, count in launches.items():
        if name in STENCIL_KERNELS:
            check(count >= 1, f"main path never launched {name}: {launches}")
        else:
            check(count == 0, f"the stencil path launched {name}: {launches}")
    check(out.shape == (N_CELLS // BLOCK, BLOCK), f"output shape {out.shape}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(bool(torch.equal(q2, q)), "codes changed in the pack/unpack round trip")
    err = (out.reshape(-1) - y).abs().reshape(-1, BLOCK)
    check(bool((err <= scale[:, None] / 2 * (1 + 1e-5) + 1e-7).all()),
          "round trip lost more than half a quantization step")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # one more run under the profiler: how much of the wall time is device
    prof = device_profile(path, {"jacobi": "jacobi_wavefront_kernel",
                                 **CODEC_PROFILE_KEYS})
    emit({"phase": "main", "n_cells": N_CELLS, "t_steps": T_STEPS,
          "width": WIDTH, "codes": list(q.shape), "qbits": QBITS, "bits": BITS,
          "wall_ms": wall_ms, "launches": launches, "peak_GiB": peak,
          "max_roundtrip_err": float(err.max()), **prof})
    return {"x": x, "y": y, "q": q, "scale": scale, "planes": planes,
            "launches": launches, "watched": prof.get("watched", {})}


def evolving_ghost(rng) -> np.float32:
    """A value a that the update changes, ((a + a) + a) / 3 != a: as x[0] it
    makes the ghost left of cell 0 differ from level to level."""
    while True:
        a = np.float32(rng.standard_normal())
        if ((a + a) + a) / np.float32(3) != a:
            return a


def phase_stencil(dev, main: dict, copy_rate: float) -> dict:
    x = main["x"]
    y_plain = ops.jacobi1d_tiled(x, T_STEPS, width=WIDTH, backend="ref")
    check(bool(torch.equal(main["y"], y_plain)), "jacobi1d_tiled differs from plain: "
          f"{max_abs_diff(main['y'], y_plain)}")

    # the kernel at the main shape, twice back to back (the workspace is
    # zeroed anew each call), bit-identical to the plain version
    xp = ops.pad_chunked(x, T_STEPS, WIDTH)
    yk = jacobi_mars.jacobi_chunked(xp, T_STEPS, WIDTH)
    yk2 = jacobi_mars.jacobi_chunked(xp, T_STEPS, WIDTH)
    yp = jacobi_mars.jacobi_chunked_plain(xp, T_STEPS, WIDTH)
    err = max_abs_diff(yk, yp)
    check(bool(torch.equal(yk, yp)), f"jacobi_chunked vs plain: {err}")
    check(bool(torch.equal(yk2, yk)), "two back-to-back launches differ")
    del yk2, yp
    div3_bad = jacobi_mars.div3_mismatches(dev)
    check(div3_bad == 0, f"the kernel's division by 3 differs from IEEE on "
          f"{div3_bad} f32 inputs")
    ms = time_ms(lambda: jacobi_mars.jacobi_chunked(xp, T_STEPS, WIDTH), reps=20)
    plain_ms = time_ms(lambda: jacobi_mars.jacobi_chunked_plain(xp, T_STEPS, WIDTH),
                       reps=3)

    rng = np.random.default_rng(SEED + 9)
    sweep = []
    for n, t, w in JACOBI_SWEEP:
        xs = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        xs[0] = float(evolving_ghost(rng))
        same = bool(torch.equal(jacobi_mars.jacobi_chunked(xs, t, w),
                                jacobi_mars.jacobi_chunked_plain(xs, t, w)))
        check(same, f"jacobi_chunked vs plain at n={n}, T={t}, W={w}")
        sweep.append([n, t, w])

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
           "design": "wavefront",
           "replaces": "src/repro/kernels/jacobi_mars.py:36",
           "launches": main["launches"]["jacobi_mars.jacobi_chunked"],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes, nops, copy_rate),
           "library_ms": None}
    tile = jacobi_mars._lib().jacobi_chunked_tile()
    emit({"phase": "stencil", "n_padded": xp.numel(), "t_steps": T_STEPS,
          "width": WIDTH, "kernel_tile": tile, "blocks": -(-xp.numel() // tile),
          "bit_identical": {"path": True, "main": True, "back_to_back": True,
                            "sweep_n_t_w": sweep},
          "div3_mismatches_of_2^32": div3_bad,
          "small_vs_oracle_err": err_small, "tol": JACOBI_TOL, **row})
    return row


def placed(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts `offset` int32 words into its
    buffer (offset 1: 4 bytes off the allocator's alignment)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=torch.int32, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t.view(torch.int32))
    check(view.is_contiguous() and view.data_ptr() % 16 == 4 * offset % 16,
          f"offset view at {view.data_ptr() % 16}")
    return view


def codec_case(dev, rng, n: int, block: int, bits: int, offset: int = 0) -> dict:
    """pack and unpack of [n, block] codes against their plain versions:
    full-range codes (deltas wrap int32 and overflow `bits`), their plain
    planes, and codes whose deltas fit `bits` (the round trip restores
    them).  Every input is placed `offset` words into its buffer."""
    full = placed(torch.from_numpy(rng.integers(
        -2**31, 2**31, size=(n, block), dtype=np.int64).astype(np.int32)).to(dev), offset)
    e_pack = max_abs_diff(bitplane.pack(full, bits), bitplane.pack_plain(full, bits))
    planes = placed(bitplane.pack_plain(full, bits), offset)
    e_unpack = max_abs_diff(bitplane.unpack(planes, bits, block),
                            bitplane.unpack_plain(planes, bits, block))
    qw = placed(torch.from_numpy(wrapped_codes(rng, n, bits, block)).to(dev), offset)
    trip = bool(torch.equal(bitplane.unpack(bitplane.pack(qw, bits), bits, block), qw))
    check(e_pack == 0 and e_unpack == 0 and trip,
          f"n={n} block={block} bits={bits} offset={offset}: pack err {e_pack}, "
          f"unpack err {e_unpack}, round trip {trip}")
    return {"n": n, "block": block, "bits": bits, "offset_words": offset}


def sweep_rows(block: int, sms: int) -> int:
    """About SWEEP_WORDS codes in a row count ragged against the tile."""
    plan = bitplane.launch_plan("pack", 1, block, 8, sms)
    r = plan.rows_per_tile
    return max(1, SWEEP_WORDS // block // r) * r + max(1, r // 2)


def walk_rows(block: int, sms: int) -> int:
    """Rows that give WALK_UNITS units to each block of the largest grid,
    the last unit a part of a tile where a tile holds several rows."""
    plan = bitplane.launch_plan("pack", 1, block, 8, sms)
    units = int(WALK_UNITS * sms * bitplane.BLOCKS_PER_SM)
    r = plan.rows_per_tile
    return units * r + (r // 2 if r > 1 else 0)


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
    check(bool(torch.equal(bitplane.pack(q, BITS), pk)), "two back-to-back packs differ")
    check(bool(torch.equal(bitplane.unpack(planes, BITS, BLOCK), uk)),
          "two back-to-back unpacks differ")
    del pp, up

    # quantize on the card against its CPU run, bit for bit; beside it the
    # scales that a division by a host scalar would give on the card
    y = main["y"]
    q_cpu, s_cpu = blockcodec.quantize(y.cpu(), QBITS, BLOCK)
    check(bool(torch.equal(main["q"].cpu(), q_cpu)), "quantize: card codes differ from CPU")
    check(bool(torch.equal(main["scale"].cpu(), s_cpu)),
          "quantize: card scales differ from CPU")
    amax = y.reshape(-1, BLOCK).abs().amax(dim=-1)
    host_scalar = int((amax / float(2 ** (QBITS - 1) - 1)).cpu().ne(
        amax.cpu() / float(2 ** (QBITS - 1) - 1)).sum())
    del q_cpu, s_cpu, amax

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 32-bit integer operations per word: pack = subtract, mask, and per
    # plane a shift and an and; unpack = per plane two shifts, an and and
    # an or, then the sign extension and the scan's add
    rows = []
    for name, kind, line, fn, plain, err, io, nops in (
        ("bitplane.pack", "pack", 46, lambda: bitplane.pack(q, BITS),
         lambda: bitplane.pack_plain(q, BITS), err_pack,
         ops.pack_io_bytes(n, BLOCK, BITS), n * BLOCK * (2 + 2 * BITS)),
        ("bitplane.unpack", "unpack", 62, lambda: bitplane.unpack(planes, BITS, BLOCK),
         lambda: bitplane.unpack_plain(planes, BITS, BLOCK), err_unpack,
         ops.unpack_io_bytes(n, BLOCK, BITS), n * BLOCK * (4 * BITS + 3)),
    ):
        watched = main["watched"].get(kind, {})
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/bitplane.cu",
                     "design": "tiles+cp.async, thread per group",
                     "replaces": f"src/repro/kernels/bitplane.py:{line}",
                     "launches": main["launches"][name], "max_abs_err": err,
                     "ms": time_ms(fn, reps=20), "plain_ms": time_ms(plain, reps=3),
                     **bound(sum(io), nops, copy_rate), "library_ms": None,
                     "profile_ms": (watched["device_ms"] / watched["launches"]
                                    if watched.get("launches") else None),
                     "ms_back_to_back": stream_ms(fn),
                     **launch_costs(fn, CODEC_PROFILE_KEYS[kind])})
    plans = {kind: bitplane.launch_plan(kind, n, BLOCK, BITS, sms)
             for kind in bitplane.KINDS}
    emit({"phase": "codec", "codes": [n, BLOCK], "bits": BITS,
          "plans": {kind: {"grid": p.grid, "units": p.units, "smem_bytes": p.smem}
                    for kind, p in plans.items()},
          "bit_identical": {"main": True, "back_to_back": True},
          "quantize_card_equals_cpu": True,
          "host_scalar_scale_mismatches": host_scalar, "rows": rows})

    rng = np.random.default_rng(SEED + 2)
    sweep = []
    for block in SWEEP_BLOCKS:
        rows_ = sweep_rows(block, sms)
        for bits in range(1, 33):
            sweep.append(codec_case(dev, rng, rows_, block, bits))
        sweep.append(codec_case(dev, rng, 1, block, 5))
    for block, bits in OFFSET_CASES:
        sweep.append(codec_case(dev, rng, sweep_rows(block, sms), block, bits, offset=1))
    walks = {}
    for block in SWEEP_BLOCKS:
        rows_ = walk_rows(block, sms)
        for bits in WALK_BITS:
            for kind in bitplane.KINDS:
                plan = bitplane.launch_plan(kind, rows_, block, bits, sms)
                check(plan.units >= 2 * plan.grid,
                      f"walk case {kind} block={block} bits={bits}: {plan.units} "
                      f"units on a grid of {plan.grid}")
            sweep.append(codec_case(dev, rng, rows_, block, bits))
        walks[block] = {"rows": rows_, "units": plan.units, "grid": plan.grid}
        torch.cuda.empty_cache()
    emit({"phase": "codec_sweep", "cases": len(sweep),
          "rows_by_block": {b: sweep_rows(b, sms) for b in SWEEP_BLOCKS},
          "walk_cases": {"bits": WALK_BITS, "by_block": walks},
          "offset_cases": [c for c in sweep if c["offset_words"]],
          "all_bit_identical": True})
    return rows


def dev_us(e) -> float:
    """Self device time of a profiler average, in us (either attribute name)."""
    return getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)


def launch_costs(fn, kernel_key: str, n: int = 200) -> dict:
    """Host us per call of a wrapper, and its kernel's own device us.

    CUDA events around one call of a tiny kernel time the wrapper's host
    work as much as the kernel; these two numbers split that time.
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel_key in e.key and dev_us(e) > 0]
    return {"host_us_per_call": host_us,
            "kernel_device_us": dev_us(hits[0]) / hits[0].count if hits else None}


def device_profile(fn, watch: dict, top: int = 5) -> dict:
    """Run fn under torch.profiler: top device ops by self time, idle share.

    The idle share is 1 - (union of device-op intervals) / (first device-op
    start to last device-op end): the part of the device's own window in
    which no kernel, copy or fill ran.  Each top op's share is of the busy
    time.  ``watch`` maps a label to a substring of kernel names whose
    device time is summed under that label (the port's own kernels).
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return {"profiled_wall_ms": wall_ms, "top_device_ops": None,
                "device_idle_share": None,
                "note": "the profiler recorded no device events: not measured"}
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window_us = spans[-1][1] - spans[0][0]
    # device-side entries only: a CPU op's own entry repeats the device
    # time of the kernels it launched
    ops_ = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=dev_us, reverse=True)
    return {"profiled_wall_ms": wall_ms, "device_window_ms": window_us / 1e3,
            "device_busy_ms": busy / 1e3, "device_ops": len(spans),
            "device_idle_share": 1 - busy / window_us,
            "watched": {label: {
                "device_ms": sum(dev_us(e) for e in ops_ if key in e.key) / 1e3,
                "launches": sum(e.count for e in ops_ if key in e.key),
                "share_of_busy": sum(dev_us(e) for e in ops_ if key in e.key) / busy}
                for label, key in watch.items()},
            "top_device_ops": [{"name": e.key[:120], "device_ms": dev_us(e) / 1e3,
                                "share_of_busy": dev_us(e) / busy,
                                "count": e.count}
                               for e in ops_[:top] if dev_us(e) > 0]}


def paper_table1() -> list:
    """Table 1 over the port's stencil zoo: the MARS analysis and the
    layout ILP of each (stencil, tile sizes) equal to the paper's numbers."""
    rows = []
    for (name, ts), spec in stencil.zoo_specs().items():
        a = mars.analyze(spec)
        lay = layout.layout_for_analysis(a)
        got = (a.n_in, a.n_out, lay.read_bursts, lay.write_bursts)
        check(got == PAPER_TABLE1[name] and lay.exact,
              f"Table 1 {name} {ts}: {got}, exact {lay.exact}; the paper has "
              f"{PAPER_TABLE1[name]}")
        rows.append({"stencil": name, "tiles": list(ts), "n_in": a.n_in,
                     "n_out": a.n_out, "read_bursts": lay.read_bursts,
                     "write_bursts": lay.write_bursts, "order": list(lay.order)})
    return rows


def paper_transfer(hist: np.ndarray) -> tuple:
    """Fig. 10's cases on an interior jacobi-1d tile at each PAPER_TILES
    size and each PAPER_DTYPES: every pattern of ``transfer.MODES``, the
    compressed MARS taking the fewest cycles; the ``transfer/cycles``
    counters, through a sidecar written and read back, equal to the direct
    totals.  Returns (cases, the report's transfer table)."""
    direct, cases = {}, []
    with obs.enabled_scope() as (reg, tr):
        for ts in PAPER_TILES:
            spec = stencil.jacobi1d_spec(ts)
            a = mars.analyze(spec)
            rep = tuple(int(x) for x in spec.tile_of(np.array([PAPER_POINT]))[0])
            model = transfer.TileIOModel(spec, a, layout.layout_for_analysis(a),
                                         rep_tile=rep)
            pts = np.concatenate(model.input_mars_points() + model.output_mars_points())
            check(pts[:, 0].min() >= 1 and pts[:, 0].max() <= PAPER_T
                  and pts[:, 1].min() >= 0 and pts[:, 1].max() < PAPER_N,
                  f"transfer tile {rep} at {ts} reaches outside the history")
            for dtype in PAPER_DTYPES:
                cyc = {}
                for mode in transfer.MODES:
                    io = model.tile_io(dtype, mode, hist=hist)
                    cyc[mode] = io.total_cycles
                    direct[("x".join(map(str, ts)), dtype, mode)] = io.total_cycles
                check(cyc["mars_comp"] == min(cyc.values()),
                      f"transfer {ts} {dtype}: mars_comp is not the fewest: {cyc}")
                cases.append({"tiles": list(ts), "tile": list(rep), "dtype": dtype,
                              "cycles": cyc,
                              "minimal_over_mars_comp": cyc["minimal"] / cyc["mars_comp"]})
        with tempfile.TemporaryDirectory() as tmp:
            obs.write_sidecar(tmp, reg, tr, meta=obs.run_metadata(config="paper"))
            doc = obs.read_summary(tmp)
    counters = doc["metrics"]["counters"]
    for (tile, dtype, mode), total in direct.items():
        key = obs.series_key("transfer/cycles", dict(
            bench="jacobi-1d", tile=tile, dtype=dtype, pattern=mode))
        check(counters.get(key) == total,
              f"sidecar {key} = {counters.get(key)}, tile_io says {total}")
    table = report.render(doc).split("\n## ")[1].split("\n", 1)[1].strip()
    check(table.count("| jacobi-1d") == len(PAPER_TILES) * len(PAPER_DTYPES),
          f"the report's transfer table: {table}")
    return cases, table


def paper_executor(init: np.ndarray, hist: np.ndarray, dev) -> dict:
    """``Jacobi1dMarsExecutor`` (the software model of the paper's tiled
    accelerator) at each EXEC_TOLS dtype, against the dense reference, and
    its full-tile rows against the card's ``ops.jacobi1d_tiled`` (f32,
    ``csrc/jacobi_mars.cu``).  Compared only on the cells more than t from
    both ends: the dense reference keeps its two end cells fixed, the entry
    point pads the edges, and the two agree only inside that band."""
    n = init.shape[0]
    runs, values = {}, {}
    for dtype, tol in EXEC_TOLS.items():
        t0 = time.perf_counter()
        ex = executor.Jacobi1dMarsExecutor(stencil.jacobi1d_spec(EXEC_TILE), n, EXEC_T,
                                           dtype=dtype, record=True)
        out = ex.run(init)
        secs = time.perf_counter() - t0
        vals = ex.full_tile_values
        keys = np.array(list(vals), dtype=np.int64)
        ref_err = max(float(np.abs(out - hist[EXEC_T]).max()),
                      float(np.abs(np.fromiter(vals.values(), float)
                                   - hist[keys[:, 0], keys[:, 1]]).max()))
        check(ref_err < tol, f"executor {dtype} vs the dense reference: {ref_err}")
        st = ex.stats
        values[dtype] = vals
        runs[dtype] = {"host_seconds": secs, "ref_max_abs_err": ref_err,
                       "stats": dataclasses.asdict(st),
                       "full_tile_values": len(vals),
                       "compression_ratio": st.uncompressed_bits / st.compressed_bits}
    ts_full = {t for t, _ in values["float"]}
    check(all({t for t, _ in v} == ts_full for v in values.values()),
          "the dtypes' executors ran different full tiles")
    rows = [64, 128, max(ts_full)]
    x = torch.from_numpy(init.astype(np.float32)).to(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kernel = {t: ops.jacobi1d_tiled(x, t, width=EXEC_WIDTH, backend="cuda").cpu().numpy()
              for t in rows}
    kernel_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = {name: 0 for name in launches}
    want["jacobi_mars.jacobi_chunked"] = len(rows)
    check(launches == want, f"the paper phase launched {launches}, want {want}")
    for dtype, tol in EXEC_TOLS.items():
        vals = values[dtype]
        by_row = []
        for t in rows:
            cells = np.array(sorted(i for (r, i) in vals if r == t and t < i < n - 1 - t))
            check(cells.size > 0, f"row {t} has no full-tile cell inside the band")
            got = np.array([vals[(t, int(i))] for i in cells])
            err = float(np.abs(got - kernel[t][cells]).max())
            check(err <= tol, f"executor {dtype} row {t} vs the card's jacobi1d_tiled: "
                              f"{err} over {cells.size} cells")
            by_row.append({"t": t, "cells": int(cells.size), "first": int(cells[0]),
                           "last": int(cells[-1]), "max_abs_err": err})
        runs[dtype].update({"rows_vs_card": by_row, "tol": tol,
                            "cells_compared": sum(r["cells"] for r in by_row),
                            "card_max_abs_err": max(r["max_abs_err"] for r in by_row)})
    return {"runs": runs, "rows": rows, "launches": launches,
            "kernel_host_seconds": kernel_s}


def phase_paper(dev, smi: str) -> None:
    """The paper's host analysis, tied to the card: Table 1, the transfer
    model and the obs exporters, and the executor against the Jacobi
    kernel.  Its seconds are host time on the card's machine."""
    t0 = time.perf_counter()
    table1 = paper_table1()
    t1 = time.perf_counter()
    init = np.cumsum(np.random.default_rng(SEED).uniform(-0.01, 0.01, PAPER_N)) + 1.0
    hist = stencil.jacobi1d_reference(init, PAPER_T)
    t2 = time.perf_counter()
    cases, table = paper_transfer(hist)
    t3 = time.perf_counter()
    ex = paper_executor(init, hist[:EXEC_T + 1], dev)
    t4 = time.perf_counter()
    print(table, flush=True)
    emit({"phase": "paper", "nvidia_smi": smi,
          "host_seconds": {"table1": t1 - t0, "history": t2 - t1,
                           "transfer_and_sidecar": t3 - t2,
                           **{f"executor_{d}": r["host_seconds"]
                              for d, r in ex["runs"].items()},
                           "card_rows": ex["kernel_host_seconds"], "total": t4 - t0},
          "time_note": "host time on the card's machine; transfer cycles model "
                       "the paper's FPGA bus, not the card",
          "table1": table1, "transfer": cases,
          "executor": {"n": PAPER_N, "t_steps": EXEC_T, "tiles": list(EXEC_TILE),
                       "width": EXEC_WIDTH, "rows": ex["rows"],
                       "launches": ex["launches"], "by_dtype": ex["runs"]}})


def phase_lm_init(dev) -> dict:
    cfg = configs.load_arch(ARCH)
    rc = configs.RunConfig(seq_len=SERVE_SEQ, global_batch=SERVE_B,
                           kind="decode", kv_cache_bits=8)
    t0 = time.perf_counter()
    params = model_zoo.get_api(cfg, rc, dev).init(SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(n == cfg.param_count(), f"{n} parameters, config says {cfg.param_count()}")
    check(all(p.device.type == "cuda" and p.dtype == torch.bfloat16
              for p in params.parameters()), "a weight is not bf16 on the card")
    emit({"phase": "lm_init", "arch": ARCH, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n, "GiB": nbytes / 2**30,
          "seconds": secs, "seed": SEED})
    return {"cfg": cfg, "rc": rc, "params": params}


def phase_prefill(dev, lm: dict) -> dict:
    cfg, params = lm["cfg"], lm["params"]
    rc = configs.RunConfig(seq_len=PREFILL_S, global_batch=PREFILL_B,
                           kind="prefill")
    api = model_zoo.get_api(cfg, rc, dev)
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)
    t0 = time.perf_counter()
    api.prefill(params, {"tokens": toks})        # first use of the GEMM shapes
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg = api.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()

    check(launches["flash_attention.flash_fwd"] == cfg.n_layers,
          f"prefill launched flash {launches['flash_attention.flash_fwd']} times")
    check(all(v == 0 for k, v in launches.items()
              if k != "flash_attention.flash_fwd"), f"prefill launches {launches}")
    check(tuple(lg.shape) == (PREFILL_B, cfg.vocab), f"logits {tuple(lg.shape)}")
    check(bool(torch.isfinite(lg).all()), "non-finite prefill logits")
    prof = device_profile(lambda: api.prefill(params, {"tokens": toks}),
                          {"flash": "flash_fwd_sm90_kernel"})
    emit({"phase": "prefill", "batch": PREFILL_B, "seq": PREFILL_S,
          "q_block": rc.q_block, "kv_block": rc.kv_block,
          "first_call_ms": warm_ms, "wall_ms": wall_ms,
          "tokens_per_s": PREFILL_B * PREFILL_S / (wall_ms * 1e-3),
          "launches": launches,
          "peak_GiB": torch.cuda.max_memory_allocated(dev) / 2**30,
          "logits": list(lg.shape), **prof})
    return {"launches": launches, "wall_ms": wall_ms}


def lockstep(engine: ServeEngine, prompts: list, max_new: int, dev) -> dict:
    """``generate``'s schedule run twice side by side from the same fresh
    state: the engine's CUDA graph replayed, and ``decode_step`` eagerly.
    The logits must be ``torch.equal`` at every step, the greedy tokens
    identical, and the caches and positions equal at the end.  Host ms a
    step (each ending in the argmax's copy to the host) for both."""
    B, lens = len(prompts), [len(p) for p in prompts]
    total = max(lens) + max_new
    step = engine.graphed_step(B)
    step.reset()
    state = engine.api.init_decode_state(B)
    toks = {k: [[] for _ in range(B)] for k in ("graph", "eager")}
    cur = {k: np.array([p[0] for p in prompts], np.int64) for k in toks}
    ms = {k: [] for k in toks}
    equal = 0
    for t in range(total - 1):
        t0 = time.perf_counter()
        lg_g, nxt_g = step(torch.from_numpy(cur["graph"]))
        model = {"graph": nxt_g.cpu().numpy()}
        t1 = time.perf_counter()
        lg_e, state = engine.api.decode_step(
            engine.params, state, torch.from_numpy(cur["eager"]).to(dev))
        model["eager"] = torch.argmax(lg_e, dim=-1).cpu().numpy()
        t2 = time.perf_counter()
        ms["graph"].append((t1 - t0) * 1e3)
        ms["eager"].append((t2 - t1) * 1e3)
        equal += bool(torch.equal(lg_g, lg_e))
        for k in toks:
            for i in range(B):
                if t + 1 < lens[i]:
                    cur[k][i] = prompts[i][t + 1]
                else:
                    cur[k][i] = model[k][i]
                    if len(toks[k][i]) < max_new:
                        toks[k][i].append(int(model[k][i]))
    state_equal = torch.equal(step.state.pos, state.pos) and all(
        torch.equal(a, b) for ca, cb in zip(step.state.caches, state.caches)
        for a, b in zip(ca, cb) if a is not None)
    check(equal == total - 1, f"graph logits equal eager on {equal} of "
          f"{total - 1} steps")
    check(toks["graph"] == toks["eager"], "graph and eager greedy tokens differ")
    check(state_equal, "graph and eager caches differ after the steps")
    return {"steps": total - 1, "logits_equal_steps": equal,
            "tokens_identical": True, "state_equal": True,
            "graph_step_ms": float(np.median(ms["graph"])),
            "eager_step_ms": float(np.median(ms["eager"])),
            "tokens": toks["graph"]}


def captured(engine: ServeEngine, batch: int) -> float:
    """Build the engine's graph for ``batch``: ms of its eager warm-up step,
    capture and instantiation (a one-off cost a batch size)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.graphed_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_serve_launches(launches: dict, n_layers: int, steps: int) -> None:
    """The serve path's exact counts: the fused store once a layer and step,
    dequant twice (K and V), and no other kernel (kv_quant is off the path)."""
    want = {name: 0 for name in launches}
    want["kvpack.kv_quant_store"] = n_layers * steps
    want["kvpack.kv_dequant"] = 2 * n_layers * steps
    check(launches == want, f"generate launched {launches}, want {want}")


def phase_serve(dev, lm: dict) -> dict:
    cfg, rc, params = lm["cfg"], lm["rc"], lm["params"]
    rng = np.random.default_rng(SEED + 4)
    lens = rng.integers(16, 129, SERVE_B)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in lens]
    engine = ServeEngine(cfg, rc, params=params, device=str(dev))
    capture_ms = captured(engine, SERVE_B)
    engine.generate([p[:4] for p in prompts], max_new=2)   # first use of the loop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    steps = int(lens.max()) + SERVE_NEW - 1
    check_serve_launches(launches, cfg.n_layers, steps)
    check([len(t) for t in out] == [SERVE_NEW] * SERVE_B, "generated lengths")
    check(all(0 <= t < cfg.vocab for seq in out for t in seq), "token out of range")

    # the int4 cache on the path too: a short generate
    rc4 = dataclasses.replace(rc, kv_cache_bits=4)
    engine4 = ServeEngine(cfg, rc4, params=params, device=str(dev))
    capture4_ms = captured(engine4, SERVE_B)
    short = [p[:16] for p in prompts]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out4 = engine4.generate(short, max_new=4)
    torch.cuda.synchronize()
    wall4_ms = (time.perf_counter() - t0) * 1e3
    launches4 = ops.launch_counts()
    steps4 = 16 + 4 - 1
    check_serve_launches(launches4, cfg.n_layers, steps4)
    check([len(t) for t in out4] == [4] * SERVE_B, "int4 generated lengths")

    # the graph against eager decode_step: 16 int8 steps (prompts of 4-11
    # tokens, some steps teacher-forced, some greedy), and the int4 generate
    ls8 = lockstep(engine, [p[:4 + i] for i, p in enumerate(prompts)], 6, dev)
    check(ls8["steps"] == 16, f"int8 lockstep ran {ls8['steps']} steps")
    ls4 = lockstep(engine4, short, 4, dev)
    check(ls4["tokens"] == out4, "int4 generate's tokens differ from eager's")

    # 8 replayed steps of the int8 engine under the profiler
    step = engine.graphed_step(SERVE_B)
    step.reset()
    cur = torch.tensor([p[0] for p in prompts])
    step(cur)

    def steps_fn():
        for _ in range(PROFILE_STEPS):
            step(cur)[1].cpu()                           # as generate syncs
    prof = device_profile(steps_fn, {"kv_quant_store": "quant_store_kernel",
                                     "kv_quant": "::quant_kernel",
                                     "kv_dequant": "dequant_kernel"})
    seen = {k: v["launches"] for k, v in (prof.get("watched") or {}).items()}
    want = {"kv_quant_store": cfg.n_layers * PROFILE_STEPS, "kv_quant": 0,
            "kv_dequant": 2 * cfg.n_layers * PROFILE_STEPS}
    check(seen == want, f"profile of {PROFILE_STEPS} replayed steps: kernels "
          f"{seen}, want {want}")
    # without the profiler (whose per-kernel records stretch a replay): the
    # device time of a step's token copy and replay by CUDA events, and the
    # idle share from the profile's busy time over the timed generate's step
    replay_ms = time_ms(lambda: step(cur), reps=20)
    busy_step_ms = prof["device_busy_ms"] / PROFILE_STEPS
    n_prompt, n_gen = int(lens.sum()), SERVE_B * SERVE_NEW
    emit({"phase": "serve", "batch": SERVE_B, "seq_len": SERVE_SEQ,
          "kv_cache_bits": 8, "prompt_lens": lens.tolist(), "max_new": SERVE_NEW,
          "decode_steps": steps, "wall_ms": wall_ms,
          "step_ms": wall_ms / steps,
          "prompt_tokens_per_s": n_prompt / (wall_ms * 1e-3),
          "generated_tokens_per_s": n_gen / (wall_ms * 1e-3),
          "capture_ms": capture_ms, "graph_launches_per_step": step.launches,
          "kv_cache_bytes": engine.kv_cache_bytes(SERVE_B),
          "kv_cache_bytes_int4": engine4.kv_cache_bytes(SERVE_B),
          "peak_GiB": torch.cuda.max_memory_allocated(dev) / 2**30,
          "launches": launches,
          "int4": {"decode_steps": steps4, "wall_ms": wall4_ms,
                   "capture_ms": capture4_ms, "launches": launches4},
          "graph_vs_eager": {
              "int8": {k: v for k, v in ls8.items() if k != "tokens"},
              "int4": {k: v for k, v in ls4.items() if k != "tokens"}},
          "replay_device_ms": replay_ms,
          "device_busy_ms_per_step": busy_step_ms,
          "device_idle_share_untraced": 1 - busy_step_ms / (wall_ms / steps),
          "profile_steps": PROFILE_STEPS, **prof})
    return {"launches": launches, "wall_ms": wall_ms, "steps": steps}


def phase_lm_parity(dev) -> dict:
    """The smoke config, same weights, kernels on the card vs plain on the CPU."""
    cfg = configs.load_smoke(ARCH)
    rng = np.random.default_rng(SEED + 5)
    toks = rng.integers(0, cfg.vocab, (PARITY_B, PARITY_S))
    prompts = [toks[i, :n].tolist() for i, n in enumerate((5, 17, 24, 9))]
    results = []
    for dtype in ("float32", "bfloat16"):
        for bits in (16, 8, 4):
            rc = configs.RunConfig(seq_len=PARITY_S, global_batch=PARITY_B,
                                   kind="decode", param_dtype=dtype,
                                   kv_cache_bits=bits, q_block=16, kv_block=32)
            apis = {d: model_zoo.get_api(cfg, rc, d) for d in ("cpu", "cuda")}
            params = {"cpu": apis["cpu"].init(SEED)}
            params["cuda"] = copy.deepcopy(params["cpu"]).to(dev)
            t = {d: torch.from_numpy(toks).to(d) for d in ("cpu", "cuda")}
            pre = {d: apis[d].prefill(params[d], {"tokens": t[d]}).float().cpu()
                   for d in apis}
            errs = [float((pre["cuda"] - pre["cpu"]).abs().max())]
            scales = [float(pre["cpu"].abs().max())]
            states = {d: apis[d].init_decode_state(PARITY_B) for d in apis}
            for i in range(PARITY_STEPS):
                lg = {}
                for d in apis:
                    out, states[d] = apis[d].decode_step(params[d], states[d],
                                                         t[d][:, i])
                    lg[d] = out.float().cpu()
                errs.append(float((lg["cuda"] - lg["cpu"]).abs().max()))
                scales.append(float(lg["cpu"].abs().max()))
            gen = {d: ServeEngine(cfg, rc, params=params[d], device=d).generate(
                prompts, max_new=PARITY_NEW) for d in apis}
            if dtype == "float32":
                ok = max(errs) <= F32_TOL and gen["cuda"] == gen["cpu"]
            else:
                ok = all(e <= BF16_REL * s for e, s in zip(errs, scales))
            row = {"dtype": dtype, "kv_cache_bits": bits,
                   "prefill_err": errs[0], "decode_max_err": max(errs[1:]),
                   "max_rel_err": max(e / s for e, s in zip(errs, scales)),
                   "tokens_equal": gen["cuda"] == gen["cpu"], "ok": ok}
            results.append(row)
            check(ok, f"lm_parity {row}")
    emit({"phase": "lm_parity", "config": cfg.name, "batch": PARITY_B,
          "seq": PARITY_S, "decode_steps": PARITY_STEPS, "max_new": PARITY_NEW,
          "f32_tol": F32_TOL, "bf16_rel_tol": BF16_REL, "results": results})
    return {"results": results}


def store_inputs(dev, rng, B: int, S: int, KV: int, D: int, dt, bits: int,
                 slot: torch.Tensor) -> list:
    """kv_quant_store's arguments (bits aside): int8 caches and f32 scales
    full of seeded noise, new K and V rows, the slot on the card."""
    cd = D if bits == 8 else D // 2
    caches = [torch.from_numpy(rng.integers(-128, 128, (B, S, KV, cd)).astype(
        np.int8)).to(dev) for _ in range(2)]
    scales = [torch.from_numpy(rng.random((B, S, KV, 1)).astype(np.float32) + 0.5)
              .to(dev) for _ in range(2)]
    new = [torch.from_numpy(rng.standard_normal((B, 1, KV, D)).astype(np.float32))
           .to(dev).to(dt) for _ in range(2)]
    return [*caches, *scales, *new, slot.to(dev)]


def store_case(dev, rng, shape: tuple, dt, bits: int, slots: str) -> dict:
    """kv_quant_store on the card against its plain version, whole caches
    ``torch.equal``; ``slots``: every sequence at slot 0, mid, S - 1 or past
    the end (clamped), or a seeded mix of those and negative positions."""
    B, S, KV, D = shape
    slot = {"first": [0] * B, "mid": [S // 2] * B, "last": [S - 1] * B,
            "past_end": [S + 7] * B,
            "mixed": rng.integers(-2, 2 * S, B).tolist()}[slots]
    args = store_inputs(dev, rng, B, S, KV, D, dt, bits,
                        torch.tensor(slot, dtype=torch.int32))
    got, want = [t.clone() for t in args[:4]], [t.clone() for t in args[:4]]
    kvpack.kv_quant_store(*got, *args[4:], bits)
    kvpack.kv_quant_store_plain(*want, *args[4:], bits)
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    check(all(same), f"kv_quant_store {shape} {dt} bits={bits} slots={slot}: "
          f"k/v/k_scale/v_scale equal {same}")
    return {"shape": list(shape), "dtype": str(dt).split(".")[1], "bits": bits,
            "slots": slots, "identical": True}


def phase_kvpack(dev, serve: dict, copy_rate: float) -> list:
    rng = np.random.default_rng(SEED + 6)
    cases = []
    for rows in (64, 16384, 37):            # new rows, whole cache, odd count
        base = rng.standard_normal((rows, 128)).astype(np.float32)
        base[0] = 0.0                       # an all-zero row takes scale 1
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(base).to(dev).to(dt)
            for bits in (8, 4):
                c, s = kvpack.kv_quant(x, bits)
                cp, sp = kvpack.kv_quant_plain(x, bits)
                y, yp = kvpack.kv_dequant(c, s, bits), kvpack.kv_dequant_plain(c, s, bits)
                same = [bool(torch.equal(c, cp)), bool(torch.equal(s, sp)),
                        bool(torch.equal(y, yp))]
                check(all(same), f"kvpack rows={rows} {dt} bits={bits}: "
                      f"codes/scales/values equal {same}")
                cases.append({"rows": rows, "dtype": str(dt).split(".")[1],
                              "bits": bits, "identical": True})
    # the fused store against its plain version: whole caches pre-filled with
    # seeded noise, so a slot the store should not touch shows if it changed
    store_cases = [store_case(dev, rng, shape, dt, bits, slots)
                   for shape in STORE_SHAPES
                   for dt in (torch.float32, torch.bfloat16) for bits in (8, 4)
                   for slots in ("first", "mid", "last", "past_end", "mixed")]
    # the serve path's own calls: bf16 new rows [64, 128] and the int8 cache
    # [16384, 128] of one layer's K (or V) at batch 8, seq 256; the fused
    # store's K and V rows (8, 1, 8, 128) into one layer's int8 cache
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(dev).to(
        torch.bfloat16)
    cache = torch.from_numpy(rng.standard_normal((16384, 128)).astype(np.float32)).to(dev)
    codes, scales = kvpack.kv_quant(cache, 8)
    B, S, KV, D = STORE_SHAPES[0]
    store = store_inputs(dev, rng, B, S, KV, D, torch.bfloat16, 8,
                         torch.full((B,), S // 2, dtype=torch.int32))
    # the card's floor for one launch: the profiler's device time of a
    # one-element fill_
    one = torch.zeros(1, device=dev)
    floor = launch_costs(lambda: one.fill_(1.0), "FillFunctor")["kernel_device_us"]
    check(floor is not None, "the profiler recorded no fill_ kernel")
    rows_out, costs = [], {}
    for name, line, fn, plain, io, nops, key in (
        ("kvpack.kv_quant", 26, lambda: kvpack.kv_quant(x, 8),
         lambda: kvpack.kv_quant_plain(x, 8),
         ops.kv_quant_io_bytes(64, 128, 8, 2), 64 * 128 * 7, "::quant_kernel"),
        ("kvpack.kv_dequant", 40, lambda: kvpack.kv_dequant(codes, scales, 8),
         lambda: kvpack.kv_dequant_plain(codes, scales, 8),
         ops.kv_dequant_io_bytes(16384, 128, 8), 16384 * 128 * 2, "dequant_kernel"),
        ("kvpack.kv_quant_store", 26, lambda: kvpack.kv_quant_store(*store, 8),
         lambda: kvpack.kv_quant_store_plain(*store, 8),
         ops.kv_quant_store_io_bytes(B, KV, D, 8, 2), 2 * B * KV * D * 7,
         "quant_store_kernel"),
    ):
        costs[name] = launch_costs(fn, key)
        rows_out.append({"name": name, "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/kvpack.cu",
                         "replaces": f"src/repro/kernels/kvpack.py:{line}",
                         "launches": serve["launches"][name], "max_abs_err": 0.0,
                         "ms": time_ms(fn, reps=50), "plain_ms": time_ms(plain, reps=20),
                         **bound(sum(io), nops, copy_rate), "library_ms": None,
                         "ms_back_to_back": stream_ms(fn),
                         "profile_ms": (costs[name]["kernel_device_us"] or 0) / 1e3,
                         "launch_floor_ms": floor / 1e3})
    rows_out[-1]["design"] = ("the K and V rows of a layer's step quantized by "
                              "quant_kernel's row function and stored into the "
                              "cache slot: one launch, no scatter")
    emit({"phase": "kvpack", "cases": cases, "store_cases": store_cases,
          "launch_costs": costs, "fill_floor_us": floor,
          "timed": {"kv_quant": [64, 128, "bfloat16", 8],
                    "kv_dequant": [16384, 128, "int8"],
                    "kv_quant_store": [B, S, KV, D, "bfloat16", 8]},
          "library_ms_null": "no single PyTorch call computes per-row absmax "
                             "int8/int4 packing or its inverse",
          "rows": rows_out})
    return rows_out


def phase_attention(dev, prefill: dict, copy_rate: float) -> dict:
    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)

    def qkv(B, S, KV, G, D, dt, Sk=None):
        Sk = Sk or S
        return (torch.randn(B, S, KV, G, D, generator=gen, device=dev).to(dt),
                torch.randn(B, Sk, KV, D, generator=gen, device=dev).to(dt),
                torch.randn(B, Sk, KV, D, generator=gen, device=dev).to(dt))

    small = []
    for (B, S, KV, G, D), causal, window in (
            *[(shape, c, 0) for shape in ((1, 128, 1, 1, 64), (2, 256, 2, 2, 64),
                                          (1, 256, 4, 1, 128), (1, 512, 2, 4, 64))
              for c in (True, False)],
            ((1, 256, 2, 2, 64), True, 32), ((1, 256, 2, 2, 64), True, 64)):
        q, k, v = qkv(B, S, KV, G, D, torch.float32)
        o, lse = flash_attention.flash_fwd(q, k, v, causal, window)
        op, lp = flash_attention.flash_attention_plain(q, k, v, causal, window)
        e_o, e_l = max_abs_diff(o, op), max_abs_diff(lse, lp)
        check(e_o < FLASH_F32_TOL and e_l < FLASH_F32_TOL,
              f"flash f32 {(B, S, KV, G, D)} causal={causal} window={window}: "
              f"o {e_o}, lse {e_l}")
        small.append({"shape": [B, S, KV, G, D], "causal": causal,
                      "window": window, "o_err": e_o, "lse_err": e_l})

    # bf16 on the tensor-core kernel: its mask and padding paths
    small_bf16 = []
    for (B, S, Sk, KV, G, D), causal, window in BF16_CASES:
        q, k, v = qkv(B, S, KV, G, D, torch.bfloat16, Sk)
        o, lse = flash_attention.flash_fwd(q, k, v, causal, window)
        op, lp = flash_attention.flash_attention_plain(q, k, v, causal, window)
        e_o, e_l = max_abs_diff(o.float(), op.float()), max_abs_diff(lse, lp)
        e_r = tile_rel_err(o, op)
        check(e_o < FLASH_BF16_TOL and e_l < FLASH_LSE_TOL and e_r < FLASH_BF16_REL,
              f"flash bf16 {(B, S, Sk, KV, G, D)} causal={causal} window={window}: "
              f"o {e_o}, lse {e_l}, o tile rel {e_r}")
        small_bf16.append({"shape": [B, S, Sk, KV, G, D], "causal": causal,
                           "window": window, "o_err": e_o, "lse_err": e_l,
                           "o_tile_rel_err": e_r})

    # bf16 at the prefill shape (one granite-8b layer), then the train shape
    # (one tinyllama-1.1b layer: its sequences are held against the plain
    # version in attention_bwd)
    tcfg = configs.load_arch(TRAIN_ARCH)
    shapes = {"prefill": (PREFILL_B, PREFILL_S, 8, 4, 128),
              "train": (TRAIN_B, configs.SHAPES["train_4k"][0], tcfg.n_kv_heads,
                        tcfg.n_heads // tcfg.n_kv_heads, tcfg.hd)}
    timed = {}
    for label, (B, S, KV, G, D) in shapes.items():
        q, k, v = qkv(B, S, KV, G, D, torch.bfloat16)
        if label == "prefill":
            o, lse = flash_attention.flash_fwd(q, k, v, True, 0)
            op, lp = flash_attention.flash_attention_plain(q, k, v, True, 0)
            e_o, e_l = max_abs_diff(o.float(), op.float()), max_abs_diff(lse, lp)
            e_r = tile_rel_err(o, op)
            check(e_o < FLASH_BF16_TOL and e_l < FLASH_LSE_TOL and e_r < FLASH_BF16_REL,
                  f"flash bf16 at the prefill shape: o {e_o}, lse {e_l}, "
                  f"o tile rel {e_r}")
            del op, lp
            plain_ms = time_ms(
                lambda: flash_attention.flash_attention_plain(q, k, v, True, 0), reps=3)
        ms = time_ms(lambda: flash_attention.flash_fwd(q, k, v, True, 0), reps=10)
        qs = q.reshape(B, S, KV * G, D).transpose(1, 2)
        ks, vs = k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), reps=10)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * KV * G * S
        flops = 4 * B * KV * G * S * S * D // 2            # useful, causal
        timed[label] = {"shape": [B, S, KV, G, D], "ms": ms, "library_ms": lib_ms,
                        **bound(nbytes, flops, copy_rate, BF16_FLOPS_PER_S),
                        "tflops_per_s": flops / (ms * 1e-3) / 1e12}
        timed[label]["share_of_bound"] = timed[label]["bound_ms"] / ms
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()
    pre = timed["prefill"]
    row = {"name": "flash_attention.flash_fwd", "route": "cuda",
           "source": SM90_SOURCE, "design": "wgmma+tma",
           "replaces": "src/repro/kernels/flash_attention.py:50",
           "launches": prefill["launches"]["flash_attention.flash_fwd"],
           "max_abs_err": e_o, "ms": pre["ms"], "plain_ms": plain_ms,
           "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
           "copy_bound_ms": pre["copy_bound_ms"], "library_ms": pre["library_ms"],
           "at_train_shape": {k: timed["train"][k] for k in
                              ("shape", "ms", "library_ms", "bound_ms")}}
    emit({"phase": "attention", "shape": pre["shape"], "dtype": "bfloat16",
          "causal": True, "o_err": e_o, "lse_err": e_l, "o_tile_rel_err": e_r,
          "tol": {"bf16_o": FLASH_BF16_TOL, "lse": FLASH_LSE_TOL,
                  "bf16_o_tile_rel": FLASH_BF16_REL, "f32": FLASH_F32_TOL},
          "library": "F.scaled_dot_product_attention(is_causal, enable_gqa)",
          "timed": timed, "small_f32": small, "small_bf16": small_bf16, **row})
    return row


def phase_train(dev) -> dict:
    """tinyllama-1.1b at full width: warm-up, TRAIN_STEPS timed steps, a profile."""
    cfg = configs.load_arch(TRAIN_ARCH)
    rc = configs.run_config_for("train_4k", cfg, global_batch=TRAIN_B)
    check(rc.remat and rc.opt_dtype == "float32" and rc.param_dtype == "bfloat16",
          f"train config {rc}")
    api = model_zoo.get_api(cfg, rc, dev)
    t0 = time.perf_counter()
    state = train_step.init_state(api, rc, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in state.params.parameters())
    check(n == cfg.param_count(), f"{n} parameters, config says {cfg.param_count()}")
    step_fn = train_step.make_train_step(api, cfg, rc)
    pipe = SyntheticPipeline(cfg, rc, seed=SEED)
    batches = [device_batch(pipe.next(), cfg, rc, dev) for _ in range(TRAIN_STEPS + 2)]

    t0 = time.perf_counter()
    state, m = step_fn(state, batches[0])
    warm_loss = float(m["loss"])
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    times, losses, gnorms = [], [], []
    for b in batches[1:TRAIN_STEPS + 1]:
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    L = cfg.n_layers
    want = {"flash_attention.flash_fwd": 2 * L * TRAIN_STEPS,     # forward + recompute
            "flash_attention.flash_bwd_dkv": L * TRAIN_STEPS,
            "flash_attention.flash_bwd_dq": L * TRAIN_STEPS}
    for name, count in launches.items():
        check(count == want.get(name, 0),
              f"train launched {name} {count} times, want {want.get(name, 0)}")
    check(all(np.isfinite(losses + gnorms)) and np.isfinite(warm_loss),
          f"non-finite loss or grad norm: {losses}, {gnorms}")
    check(int(state.step) == TRAIN_STEPS + 1, f"step counter {int(state.step)}")

    def one_step():
        nonlocal state
        state, m = step_fn(state, batches[-1])
        float(m["loss"])
    prof = device_profile(one_step, {"flash_fwd": "flash_fwd_sm90_kernel",
                                     "flash_bwd_dkv": "flash_bwd_dkv_sm90_kernel",
                                     "flash_bwd_dq": "flash_bwd_dq_sm90_kernel"}, top=8)
    step_ms = float(np.median(times))
    tokens = TRAIN_B * rc.seq_len
    n_params = cfg.param_count()
    # causal attention: half of PaLM's 12 L H D S flops per token (forward
    # 2 products, backward 4); the remat recompute is not counted
    attn_flops = 6 * L * cfg.n_heads * cfg.hd * rc.seq_len * tokens
    model_flops = 6 * n_params * tokens + attn_flops
    emit({"phase": "train", "arch": TRAIN_ARCH, "n_layers": L,
          "d_model": cfg.d_model, "params": n_params, "batch": TRAIN_B,
          "seq": rc.seq_len, "tokens_per_step": tokens,
          "reduced": {"global_batch": [256, TRAIN_B]},
          "remat": rc.remat, "param_dtype": rc.param_dtype,
          "opt_dtype": rc.opt_dtype, "init_s": init_s,
          "warmup_step_ms": warm_ms, "step_ms": times, "step_ms_median": step_ms,
          "tokens_per_s": tokens / (step_ms * 1e-3),
          "mfu": model_flops / (step_ms * 1e-3) / BF16_FLOPS_PER_S,
          "mfu_formula": "(6*N*tokens + 6*L*H*D*S*tokens) / step_s / 989e12",
          "model_flops_per_step": model_flops, "attention_flops_per_step": attn_flops,
          "loss": [warm_loss] + losses, "grad_norm": gnorms, "peak_GiB": peak,
          "launches": launches,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
          **prof})
    return {"launches": launches, "step_ms": step_ms}


def phase_train_loop(dev) -> None:
    """``train()`` on the card at the smoke config of tests/test_train_loop.py."""
    cfg = configs.load_smoke(TRAIN_ARCH)
    rc = configs.RunConfig(seq_len=64, global_batch=8, kind="train", remat=False,
                           q_block=32, kv_block=32, lr=1e-3)
    steps = 25
    fired = []

    def hook(step):
        if step == 13 and not fired:
            fired.append(1)
            raise RuntimeError("injected node failure")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ref = train(cfg, rc, LoopConfig(total_steps=steps, ckpt_every=5,
                                         ckpt_dir=f"{d}/a"),
                    device=str(dev), log_every=0)
        ref_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        got = train(cfg, rc, LoopConfig(total_steps=steps, ckpt_every=5,
                                         ckpt_dir=f"{d}/b"),
                    device=str(dev), failure_hook=hook, log_every=0)
        published = sorted(p.name for p in Path(d, "a").iterdir())
    L = cfg.n_layers
    check(ref["restarts"] == 0, f"restarts without injection: {ref['restarts']}")
    check(launches["flash_attention.flash_fwd"] == L * steps and
          launches["flash_attention.flash_bwd_dkv"] == L * steps and
          launches["flash_attention.flash_bwd_dq"] == L * steps,
          f"train() launches {launches}")
    check(ref["loss"][-1] < ref["loss"][0] - 0.3, f"loss did not drop: {ref['loss']}")
    check(got["restarts"] == 1, f"restarts with one injected failure: {got['restarts']}")
    resumed_err = float(np.abs(np.array(ref["loss"][-5:]) - np.array(got["loss"][-5:])).max())
    check(resumed_err <= 1e-5, f"resumed losses differ by {resumed_err}")
    check(published[-1] == f"step_{steps:08d}", f"checkpoints {published}")
    emit({"phase": "train_loop", "config": cfg.name, "steps": steps,
          "batch": rc.global_batch, "seq": rc.seq_len, "seconds": ref_s,
          "loss_first_last": [ref["loss"][0], ref["loss"][-1]],
          "restarts": [ref["restarts"], got["restarts"]],
          "resumed_max_abs_err": resumed_err, "checkpoints": published,
          "launches": launches})


def phase_attention_bwd(dev, trained: dict, copy_rate: float) -> list:
    F = torch.nn.functional
    fa = flash_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)

    def inputs(B, S, KV, G, D, dt, Sk=None):
        Sk = Sk or S
        return [torch.randn(shape, generator=gen, device=dev).to(dt) for shape in
                ((B, S, KV, G, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, S, KV, G, D))]

    def abs_errs(got, want):
        return [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]

    def rel_errs(got, want):
        scales = [float(b.float().abs().max()) for b in want]
        check(min(scales) > 0, f"a plain gradient is all zero: {scales}")
        return [e / m for e, m in zip(abs_errs(got, want), scales)]

    small = []
    for (B, S, Sk, KV, G, D), causal, window in (
            ((1, 128, 128, 1, 1, 64), True, 0), ((1, 128, 128, 2, 2, 64), True, 0),
            ((1, 256, 256, 2, 2, 64), True, 32), ((1, 256, 256, 2, 2, 64), True, 64),
            ((2, 256, 256, 2, 4, 64), False, 0), ((1, 256, 256, 4, 1, 128), False, 0),
            ((1, 100, 100, 2, 2, 64), True, 0), ((1, 50, 20, 2, 2, 64), True, 8)):
        q, k, v, do = inputs(B, S, KV, G, D, torch.float32, Sk)
        o, lse = fa.flash_fwd(q, k, v, causal, window)
        errs = rel_errs(fa.flash_bwd(q, k, v, o, lse, do, causal, window),
                        fa.flash_bwd_plain(q, k, v, o, lse, do, causal, window))
        check(max(errs) < BWD_REL_TOL, f"flash bwd f32 {(B, S, Sk, KV, G, D)} "
              f"causal={causal} window={window}: rel dq, dk, dv {errs}")
        small.append({"shape": [B, S, Sk, KV, G, D], "causal": causal,
                      "window": window, "rel_err_dq_dk_dv": errs})

    small_bf16 = []
    for (B, S, Sk, KV, G, D), causal, window in BF16_CASES:
        q, k, v, do = inputs(B, S, KV, G, D, torch.bfloat16, Sk)
        o, lse = fa.flash_fwd(q, k, v, causal, window)
        errs = rel_errs(fa.flash_bwd(q, k, v, o, lse, do, causal, window),
                        fa.flash_bwd_plain(q, k, v, o, lse, do, causal, window))
        check(max(errs) < BWD_BF16_TOL, f"flash bwd bf16 {(B, S, Sk, KV, G, D)} "
              f"causal={causal} window={window}: rel dq, dk, dv {errs}")
        small_bf16.append({"shape": [B, S, Sk, KV, G, D], "causal": causal,
                           "window": window, "rel_err_dq_dk_dv": errs})

    # bf16 at the train shape: each kernel launched once on the whole batch,
    # each sequence held against the plain versions run on it alone (the
    # plain backward at B = 8 would need ~17 GB for each S x S f32 tensor)
    cfg = configs.load_arch(TRAIN_ARCH)
    B, S, KV, D = TRAIN_B, configs.SHAPES["train_4k"][0], cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KV
    q, k, v, do = inputs(B, S, KV, G, D, torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v, True, 0)
    got = fa.flash_bwd(q, k, v, o, lse, do, True, 0)
    fa.flash_bwd_plain(q[:1], k[:1], v[:1], o[:1], lse[:1], do[:1], True, 0)  # warm-up
    fwd_errs, bf16_errs, bf16_abs, plain_ms = [0.0] * 3, [0.0] * 3, [0.0] * 3, 0.0
    for b in range(B):
        qb, kb, vb, ob, lb, dob = (t[b:b + 1] for t in (q, k, v, o, lse, do))
        op, lp = fa.flash_attention_plain(qb, kb, vb, True, 0)
        fwd_errs = list(map(max, fwd_errs, (max_abs_diff(ob.float(), op.float()),
                                            max_abs_diff(lb, lp), tile_rel_err(ob, op))))
        del op, lp
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = fa.flash_bwd_plain(qb, kb, vb, ob, lb, dob, True, 0)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        mine = [g[b:b + 1] for g in got]
        bf16_errs = list(map(max, bf16_errs, rel_errs(mine, want)))
        bf16_abs = list(map(max, bf16_abs, abs_errs(mine, want)))
        del want, mine
    check(fwd_errs[0] < FLASH_BF16_TOL and fwd_errs[1] < FLASH_LSE_TOL
          and fwd_errs[2] < FLASH_BF16_REL,
          f"flash fwd bf16 at the train shape: o, lse, o tile rel {fwd_errs}")
    check(max(bf16_errs) < BWD_BF16_TOL,
          f"flash bwd bf16 at the train shape: rel dq, dk, dv {bf16_errs}")
    del got
    torch.cuda.empty_cache()

    delta = fa.bwd_delta(o, do)
    ms_dkv = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, 0), reps=5)
    ms_dq = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True, 0), reps=5)

    # the library yardstick: SDPA's backward computes dq, dk and dv together
    qs = q.reshape(B, S, KV * G, D).transpose(1, 2).detach().requires_grad_()
    ks = k.transpose(1, 2).detach().requires_grad_()
    vs = v.transpose(1, 2).detach().requires_grad_()
    dos = do.reshape(B, S, KV * G, D).transpose(1, 2)
    try:
        os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        lib_ms = time_ms(lambda: torch.autograd.grad(os_, (qs, ks, vs), dos,
                                                     retain_graph=True), reps=5)
        lib_note = "F.scaled_dot_product_attention(is_causal, enable_gqa) backward: dq, dk, dv together"
    except RuntimeError as e:                       # the yardstick only
        lib_ms, lib_note = None, f"SDPA backward failed: {e}"[:300]
    del qs, ks, vs, dos

    H = KV * G
    io = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * (lse.numel() + delta.numel())
    rows = []
    for name, line, ms, nbytes, nflops in (
            ("flash_attention.flash_bwd_dkv", 131, ms_dkv, io + 2 * 2 * k.numel(),
             8 * B * H * S * S * D // 2),
            ("flash_attention.flash_bwd_dq", 168, ms_dq, io + 2 * q.numel(),
             6 * B * H * S * S * D // 2)):
        rows.append({"name": name, "route": "cuda", "source": SM90_SOURCE,
                     "design": "wgmma+tma",
                     "replaces": f"src/repro/kernels/flash_attention.py:{line}",
                     "launches": trained["launches"][name],
                     # at the bf16 train shape: dq, or the larger of dk and dv
                     "max_abs_err": bf16_abs[0] if line == 168 else max(bf16_abs[1:]),
                     "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, nflops, copy_rate, BF16_FLOPS_PER_S),
                     "library_ms": lib_ms,
                     "tflops_per_s": nflops / (ms * 1e-3) / 1e12})
    emit({"phase": "attention_bwd", "shape": [B, S, KV, G, D], "dtype": "bfloat16",
          "causal": True, "tol": {"f32_rel": BWD_REL_TOL, "bf16_rel": BWD_BF16_TOL},
          "small_f32": small, "small_bf16": small_bf16,
          "bf16_fwd_o_lse_tile_rel_err": fwd_errs,
          "bf16_rel_err_dq_dk_dv": bf16_errs, "bf16_abs_err_dq_dk_dv": bf16_abs,
          "plain_ms_shape": [B, S, KV, G, D],
          "plain_note": f"flash_bwd_plain (dq, dk, dv together) on each of the {B} "
                        f"sequences alone, one call each, times summed",
          "library": lib_note, "rows": rows})
    for r in rows:
        r.pop("tflops_per_s")
    return rows


def phase_train_parity(dev) -> None:
    """The smoke config, same weights, kernels on the card vs plain on the CPU."""
    cfg = configs.load_smoke(TRAIN_ARCH)
    results = []
    for dtype in ("float32", "bfloat16"):
        rc = configs.RunConfig(seq_len=64, global_batch=4, kind="train",
                               param_dtype=dtype, q_block=16, kv_block=32, lr=1e-3)
        apis = {d: model_zoo.get_api(cfg, rc, d) for d in ("cpu", "cuda")}
        states = {d: train_step.init_state(apis[d], rc, SEED) for d in apis}
        with torch.no_grad():
            for pc, pg in zip(states["cpu"].params.parameters(),
                              states["cuda"].params.parameters()):
                pg.copy_(pc)
        steps = {d: train_step.make_train_step(apis[d], cfg, rc) for d in apis}
        pipe = SyntheticPipeline(cfg, rc, seed=SEED)
        ops.reset_launch_counts()
        losses, gnorms = {"cpu": [], "cuda": []}, {"cpu": [], "cuda": []}
        for _ in range(3):
            batch = pipe.next()
            for d in apis:
                states[d], m = steps[d](states[d], device_batch(batch, cfg, rc, d))
                losses[d].append(float(m["loss"]))
                gnorms[d].append(float(m["grad_norm"]))
        launches = ops.launch_counts()
        loss_err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        gn_rel = max(abs(a - b) / abs(b) for a, b in zip(gnorms["cuda"], gnorms["cpu"]))
        ok = (loss_err <= TRAIN_F32_TOL and gn_rel <= TRAIN_F32_TOL
              if dtype == "float32" else
              loss_rel <= TRAIN_BF16_REL and gn_rel <= TRAIN_BF16_GN_REL)
        ok = ok and all(launches[n] > 0 for n in FLASH_KERNELS)
        row = {"dtype": dtype, "loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
               "loss_max_abs_err": loss_err, "loss_max_rel_err": loss_rel,
               "grad_norm_max_rel_err": gn_rel, "launches": launches, "ok": ok}
        results.append(row)
        check(ok, f"train_parity {row}")
    emit({"phase": "train_parity", "config": cfg.name, "steps": 3,
          "f32_tol": TRAIN_F32_TOL, "bf16_rel_tol": TRAIN_BF16_REL,
          "bf16_grad_norm_rel_tol": TRAIN_BF16_GN_REL,
          "results": results})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 parity: full f32
    torch.backends.cudnn.allow_tf32 = False

    phase_build(dev)
    smi, copy_rate = phase_card(dev)
    main_out = phase_main(dev)
    rows = [phase_stencil(dev, main_out, copy_rate),
            *phase_codec(dev, main_out, copy_rate)]
    del main_out                                    # the stencil buffers
    torch.cuda.empty_cache()
    phase_paper(dev, smi)

    lm = phase_lm_init(dev)
    prefill = phase_prefill(dev, lm)
    serve = phase_serve(dev, lm)
    del lm
    torch.cuda.empty_cache()
    rows += phase_kvpack(dev, serve, copy_rate)
    rows.append(phase_attention(dev, prefill, copy_rate))
    phase_lm_parity(dev)
    torch.cuda.empty_cache()

    trained = phase_train(dev)
    torch.cuda.empty_cache()
    phase_train_loop(dev)
    rows += phase_attention_bwd(dev, trained, copy_rate)
    phase_train_parity(dev)
    emit({"kernels": [{k: v for k, v in r.items()
                       if k != "copy_bound_ms"}
                      for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
