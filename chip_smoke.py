#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold its kernels
against their plain PyTorch versions.

Run from the repository root, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Twelve paths, each driven with the launch counts set to 0 just before it
and read just after:

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
* serving mixtral-8x7b (moe) at full width, 16 of its 32 layers (memory:
  23.5e9 bf16 weights, 43.7 GiB): a 4 x 2048 prefill and a generate of
  8 prompts through the replayed decode graph (the expert dispatch and
  combine are torch ops; kv_quant_store once and kv_dequant twice a layer
  and step);
* serving hymba-1.5b (hybrid: attention with a 1024 window beside the SSD
  mixer) at full size: a 4 x 2048 prefill (the windowed flash forward in
  every layer) and a generate of 8 prompts of 1000-1100 tokens through
  the 1024-slot ring cache; mamba2-130m (ssm, no attention, no kernel)
  likewise with the generate of mixtral's;
* training hymba-1.5b and mamba2-130m at full size on train_4k's
  4096-token sequences, batch 8 (hymba: the windowed flash forward twice
  and both windowed backward kernels once per layer);
* serving whisper-tiny (encoder-decoder) at full size: a prefill of 32
  clips of 1500 frame embeddings and 448 tokens (the non-causal flash
  forward over the 1500 frames in each encoder layer, the causal one and
  the cross-attention to the frames in each decoder layer) and a generate
  of 32 prompts of 4 tokens, 444 new each, int8, through the replayed
  graph (kv_quant_store once and kv_dequant twice a decoder layer and step;
  the cross-attention over the cached cross K/V is torch ops, as in the
  reference), then a short int4 generate;
* training whisper-tiny at full size, 128 clips of 1500 frames and 448
  tokens (the batch cut from Whisper's 256 by memory): the flash forward
  twice and both backward kernels once per attention call (4 encoder, 4
  decoder self, 4 cross);
* training tinyllama-1.1b at full size on two ranks of the one card (two
  processes, a gloo group: NCCL refuses two ranks on one GPU), the mesh
  (2, 1, 1) over (pod, data, model), a global batch of 4 x 4096 tokens
  (2 a pod), 3 steps each at ``grad_compress_bits`` 0, 8 and 16 through
  ``train.step.make_train_step(..., mesh)``: at 8 and 16 the paper's
  compressed cross-pod exchange (quantize, bitplane-pack, gather the packed
  planes and scales, dequantize the pods' mean) with error feedback; the
  flash forward twice and both backward kernels once per layer and step;
* training tinyllama-1.1b at full width, 8 of its 22 layers (by time), on
  four ranks of the one card (four processes, gloo), the mesh (2, 2) over
  (data, model): tensor
  parallelism over heads, ff and vocab (16 query heads, 2 KV heads, ff
  2816 and vocab 16000 a rank), the residual stream split over the
  sequence between layers, ZeRO-3 over data, remat; a global batch of
  4 x 4096 tokens (2 a data rank), 3 steps through
  ``train.step.make_train_step(..., mesh)``, then one more under each remat
  policy; the flash forward twice and both backward kernels once per layer
  and step on every rank, at its local heads;
* the ``model`` axis for the ssm, hybrid and encdec families on the same
  four ranks: mamba2-130m at full size and hymba-1.5b at full width, 4 of
  its 32 layers (by time), on (2, 2) over (data, model), and whisper-tiny
  at full size on (1, 4), each 2 steps of a global batch of 4 (mamba2 and
  hymba 4096 tokens, whisper 448 tokens and 1500 frames); the SSD on a
  rank's heads (``in_proj``'s product and the conv gathered, the gated
  norm's squares all-reduced), hymba's attention at 12.5 query heads a
  rank (13 computed), whisper's at 1.5 (2 computed) with its stream whole
  over ``model``; the flash forward twice and both backward kernels once
  per attention call and step on every rank.

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
               largest logit, for kv_cache_bits 16, 8 and 4; each prefill
               and step runs on the card first, and in f32 the CPU takes
               the card's cache code where the two round a value apart at a
               boundary (one code, both values within 1e-3 of a code of the
               boundary; any other difference fails; ties listed);
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
17. families_parity — the smoke configs of mixtral, grok, mamba2 and hymba
               with the same weights on the card and on the CPU, by
               lm_parity's rules at bits 16, 8 and 4 (mamba2: 16); where
               the CPU's MoE routing differs from the card's, it takes the
               card's experts if the CPU's probabilities of the swapped
               choices lie within 2e-2 (a near-tie; else the run fails), so
               every bf16 step is held to 3e-2 and f32 allows no flip; a
               generate of 100 steps past mixtral's and hymba's 64-slot
               ring in f32 at bits 16 and 8 (the f32 rule on every step,
               tokens equal; at 8 the cache-code ties followed and listed),
               train_parity's 3 steps in f32 and bf16, and a mixtral bf16
               train step run twice from one state: loss, gradients and
               updated weights ``torch.equal``;
18. moe_serve — mixtral at full width, depth 16: weights counted against
               ``param_count()``; the prefill (16 flash launches, nothing
               else; wall ms, tokens/s, profile) and the share of routed
               copies past the expert capacity (2560) in one more prefill;
               the generate (int8, seq_len 256; launches checked exactly,
               16 x steps kv_quant_store, 32 x steps kv_dequant), a profile
               of 8 replayed steps, and the graph against eager
               ``decode_step`` on 16 steps (logits ``torch.equal``);
19. hybrid_serve — hymba-1.5b: the prefill (32 windowed flash launches);
               the windowed forward at one layer's shape (4, 2048, 5, 5,
               64), window 1024, against its plain version (o, lse and
               o's tiles as in attention) and timed beside SDPA with the
               band as an explicit mask (backend named); the generate
               (seq_len 1280, 8 prompts of 1000-1100 tokens, 64 new, int8,
               the ring wraps; launches exact); the graph against eager on
               steps 1016-1039, across the wrap at 1024 (the eager state a
               copy of the graph's at step 1016); kv_quant_store
               ``torch.equal`` to its plain version at (8, 1, 5, 64) into
               (8, 1024, 5, 64), and kv_dequant on that cache's 40,960 rows
               of 64, int8 and int4, full of seeded noise;
20. ssm_serve — mamba2-130m: prefill and generate as moe_serve (no kernel
               launched), the graph against eager with logits and the
               final state (h, conv) equal;
21. families_train — hymba-1.5b and mamba2-130m, 8 x 4096 tokens: step ms
               (median of 3), tokens/s, MFU from the counted parameters,
               peak memory, launches per step checked exactly, a profiled
               step; for hymba the windowed dK/dV and dQ at (8, 4096, 5,
               5, 64), window 1024, each sequence held against the plain
               forward and ``flash_bwd_plain`` run on it alone (attention_bwd's
               rules), and timed beside SDPA's banded backward;
22. encdec_parity — whisper-tiny's smoke config with the same weights on the
               card and on the CPU: ``prefill`` and ``decoder_forward``
               logits, 24 decode steps from the zero state and again from
               seeded cross K/V, a generate, at bits 16, 8 and 4, by
               lm_parity's rules; ``loss_fn`` and every gradient with and
               without remat (f32: each leaf within 1e-4 of its largest;
               bf16: the loss and the gradient norm by train_parity's rules),
               train_parity's 3 steps, in f32 and bf16; and one full-width
               f32 layer each side at enc_seq 1500 and a 447-token decoder
               (prefill, loss, every gradient);
23. encdec_flash — the forward, dK/dV and dQ at whisper's three shapes
               (B = 32; encoder 1500 x 1500 non-causal, cross 448 x 1500,
               decoder 447 causal; G = 1), f32 and bf16, against their plain
               versions on the whole batch (attention's and attention_bwd's
               rules); the bf16 kernels timed beside the plain versions and
               SDPA's forward and backward;
24. encdec_serve — whisper-tiny's prefill (12 flash launches) and generate
               (launches exact: 4 x steps kv_quant_store, 8 x steps
               kv_dequant), tokens/s, capture, a profile of 8 replayed steps,
               the read bound of a step (the decoder's weights and the cross
               K/V); an int4 generate; the graph against eager on 15 steps
               from the zero state and from seeded cross K/V (int8 and int4);
25. encdec_train — train_run at whisper-tiny's size (flash launches 24 / 12
               / 12 a step, checked exactly), and the warm-up batch's loss
               lower after the steps than before;
26. dist_codec — ``distributed.collectives.quantize_tree`` and
               ``dequant_mean_tree`` on a full-size tinyllama gradient tree
               (bf16 gradients and f32 residuals of seeded noise, the
               reference-view stacked leaves) at bits 4, 8 and 16: ms of the
               whole tree's quantize-and-pack and unpack-and-dequantize,
               ``exchange_stats`` (leaves, raw and wire bytes, reduction)
               and the bytes' bound; the same on the CPU (in a thread beside
               the next phase's ranks) bit-equal: planes, scales, residuals;
27. dist     — the two ranks above (each process is this script run as
               ``--dist-rank <r> <dir>``): every rank's losses equal, the
               flash launches exact, the bytes each compressed step sent
               equal to ``ExchangeStats.wire_bytes``, the last loss at bits
               16 within 0.1 of bits 0's and at 8 within 0.35
               (tests/_distributed_main.py); after the bits-8 steps each
               rank's parameters and residuals ``torch.equal`` to a
               one-process emulation on the card (each pod's backward in
               turn, ``quantize_tree``, ``dequant_mean_tree``, AdamW); step
               ms, the exchange's pieces timed one at a time (quantize-and-
               pack, wire, dequant-mean; at bits 0 the f32 all-reduce),
               peak memory per rank; a failing rank fails the run;
28. tp       — the four ranks above (each ``--tp-rank <r> <dir>``): each
               rank's losses within 5e-3 of a one-process run of the same
               global batch from the same weights (the reference's
               dist_equivalence rule); the weights and moments each rank
               holds equal to its share by the rules (``tp_expected_held``);
               its flash launches equal to the one-process run's;
               the bytes each collective is handed a step equal to
               ``tp_bytes``' formula from the shapes; one more step from the
               same state under ``remat_policy="save_collectives"`` and
               ``tp_scatter`` ``torch.equal`` (loss and every parameter) to
               the same step under ``"full"``; step ms, peak memory per
               rank; then the flash forward and backward at a rank's shape
               (2, 4096, 2, 8, 64) against their plain versions, timed
               beside SDPA;
29. tp_families — the four ranks of the ssm, hybrid and encdec path above
               (each ``--tp-families-rank <r> <dir>``), by tp's rules: each
               rank's losses within 5e-3 of a one-process run, the weights
               and moments it holds, its flash launches, the bytes each
               collective is handed a step against ``tp_bytes``; the SSD's
               and the attention's heads a rank; then the flash forward and
               backward at the shapes a rank launched (hymba (2, 4096, 13,
               1, 64), window 1024; whisper's encoder (4, 1500, 1500, 2, 1,
               64) non-causal, cross (4, 448, 1500, ...) and decoder (4,
               448, 448, ...) causal) against their plain versions, timed
               beside SDPA;
30. the ``{"kernels": [...]}`` line, then the card line, then the result line.
               The kv and flash rows add ``launches_by_path`` (their
               launches on every LM path run), the flash rows
               ``at_hymba_window`` (the windowed times and bounds),
               ``at_whisper_shapes`` (times and bounds at whisper's three)
               ``at_tp_rank_shape`` and ``at_tp_families_rank_shapes``;
               ``launches_by_path`` counts every rank of the dist, tp and
               tp_families paths.

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
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint.ckpt import Stacked, flatten, map_tree  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.core import (blockcodec, executor, layout, mars,  # noqa: E402
                              stencil, transfer)
from repro_torch.kernels import (_build, bitplane, flash_attention,  # noqa: E402
                                 jacobi_mars, kvpack, ops, ref)
from repro_torch.data.pipeline import SyntheticPipeline, device_batch  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import encdec, model_zoo, moe, transformer  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
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
#: idle host time at each end of a profiling session (``device_profile``)
PROFILE_PAD_S = 0.05
PARITY_B, PARITY_S, PARITY_STEPS, PARITY_NEW = 4, 64, 24, 8
F32_TOL, BF16_REL = 1e-4, 3e-2          # bf16: relative to the largest logit
#: a MoE routing flip between the card and the CPU in bf16 is a near-tie
#: broken apart by bf16 rounding: the CPU's router probabilities of the
#: swapped choices within this gap (bf16's ~4e-3 relative rounding of
#: unit-scale router logits moves a probability of ~0.25 by ~5e-3); the CPU
#: then takes the card's experts, and every step stays within BF16_REL
FLIP_MARGIN = 2e-2
#: an int8 / int4 code that the card and the CPU round apart in f32: both
#: values (value / scale, in codes) within this distance of the half code
#: between the two (the devices' f32 K and V differ by ~1e-6 relative, so
#: by ~1e-4 of a code at the top of int8's range)
ROUND_TIE_EPS = 1e-3
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

#: the moe, ssm and hybrid families: their smoke configs against the CPU,
#: and the ring generate (seq_len 128 past a 64-slot ring: 100 steps)
FAMILY_SMOKES = ("mixtral-8x7b", "grok-1-314b", "mamba2-130m", "hymba-1.5b")
RING_ARCHES, RING_SEQ, RING_STEPS = ("mixtral-8x7b", "hymba-1.5b"), 128, 100
RING_PROMPTS, RING_NEW = (61, 40, 52, 17), 40
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 16  # depth cut from 32: memory
HYBRID_ARCH, SSM_ARCH = "hymba-1.5b", "mamba2-130m"
#: hymba's generate: prompts of 1000-1100 tokens, 64 new, through its
#: 1024-slot ring; the graph held to eager on steps 1016-1039 (the wrap)
HYBRID_SEQ, HYBRID_LENS, HYBRID_NEW = 1280, (1000, 1101), 64
HYBRID_LOCKSTEP, HYBRID_SKIP = 1040, 1016

#: the encoder-decoder family: whisper-tiny's attention shapes as
#: ((B, S, Sk, KV, G, D), causal): the encoder's self-attention over its
#: 1500 frames (11 full 128-key tiles and a ragged one of 92), the
#: cross-attention of 448 decoder queries to them, the decoder's causal
#: self-attention at 447 (a ragged query tile); 6 heads, G = 1
ENCDEC_ARCH, ENCDEC_SEQ = "whisper-tiny", 448
ENCDEC_SHAPES = {"encoder": ((32, 1500, 1500, 6, 1, 64), False),
                 "cross": ((32, 448, 1500, 6, 1, 64), False),
                 "decoder": ((32, 447, 447, 6, 1, 64), True)}
#: serving: 32 clips; prompts of 4 tokens, 444 new (the 448-slot cache
#: full), int8; a short int4 run of 8 prompts, 60 new
ENCDEC_SERVE_B, ENCDEC_PROMPT, ENCDEC_NEW = 32, 4, 444
ENCDEC_INT4_B, ENCDEC_INT4_NEW = 8, 60
#: training: the batch cut from Whisper's 256 segments to 128 by memory (the
#: fused loss's f32 logits are B x 448 x 51865 x 4 bytes, 23.8 GB at 256,
#: held several times over: 256 runs out of the card's 80 GB, 128 peaks at
#: ~50 GiB); a peak rate at which the bf16 weights move within the
#: warm-up's first steps (their updates at train_4k's 3e-4 round away)
ENCDEC_TRAIN_B, ENCDEC_LR = 128, 1e-2
GRAD_F32_REL = 1e-4          # each f32 gradient leaf, of its largest magnitude

#: the distributed path: tinyllama-1.1b at full size on two ranks of the
#: one card, the mesh (2, 1, 1) over (pod, data, model), gloo (NCCL refuses
#: two ranks on one GPU); train_4k's sequences, the global batch cut from
#: 256 to 4 (2 a pod) by time; 3 steps at each bits
DIST_ARCH, DIST_SHAPE = TRAIN_ARCH, (2, 1, 1)
DIST_NAMES = ("pod", "data", "model")
DIST_B, DIST_STEPS, DIST_BITS = 4, 3, (0, 8, 16)
DIST_EQUAL_BITS = 8          # held torch.equal to the one-process emulation
#: the last loss within these of bits 0's (tests/_distributed_main.py: 0.1
#: at 16 bits, 0.35 at 8)
DIST_TRACK = {16: 0.1, 8: 0.35}
DIST_CODEC_BITS = (4, 8, 16)
#: CPU threads of the codec's CPU run, beside the two ranks, and of each
#: rank (which only stages the exchange through host memory): 8 cores
DIST_CPU_THREADS, DIST_RANK_THREADS = 6, 1
DIST_TIMEOUT_S = 600

#: tensor parallelism: tinyllama-1.1b at full width on four ranks of the one
#: card, the mesh (2, 2) over (data, model), gloo: tensor and sequence
#: parallelism over ``model`` (16 query heads, 2 KV heads, ff 2816 and vocab
#: 16000 a rank), ZeRO-3 over ``data``; train_4k's sequences, the global
#: batch cut from 256 to 4 and the depth from 22 layers to 8, by time;
#: remat, bf16 weights, f32 moments
TP_ARCH, TP_SHAPE, TP_NAMES = TRAIN_ARCH, (2, 2), ("data", "model")
TP_B, TP_STEPS, TP_LAYERS = 4, 3, 8
TP_LOSS_TOL = 5e-3           # tests/_distributed_main.py's dist_equivalence
TP_RANK_THREADS = 2
TP_TIMEOUT_S = 700
#: the ``model`` axis for the ssm, hybrid and encdec families on the same
#: four ranks: (arch, mesh over (data, model), layers kept (0: all),
#: sequence); a global batch of 4 (cut from train_4k's 256 by time), 2
#: steps each; hymba's depth cut from 32 layers to 4 by time
TPF_RUNS = (("mamba2-130m", (2, 2), 0, 4096), ("hymba-1.5b", (2, 2), 4, 4096),
            ("whisper-tiny", (1, 4), 0, ENCDEC_SEQ))
TPF_B, TPF_STEPS = 4, 2
TPF_TIMEOUT_S = 600


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
    work as much as the kernel; these two numbers split that time.  A
    profiler session can come back with no device events (seen once on an
    H100, the session after the serve phase's profiled graph replays): then
    a fresh session runs, up to three (``profiler_sessions`` says how many).
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    for sessions in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel_key in e.key and dev_us(e) > 0]
        if hits:
            break
    return {"host_us_per_call": host_us,
            "kernel_device_us": dev_us(hits[0]) / hits[0].count if hits else None,
            "profiler_sessions": sessions}


def device_profile(fn, watch: dict, top: int = 5) -> dict:
    """Run fn under torch.profiler: top device ops by self time, idle share.

    The idle share is 1 - (union of device-op intervals) / (first device-op
    start to last device-op end): the part of the device's own window in
    which no kernel, copy or fill ran.  Each top op's share is of the busy
    time.  ``watch`` maps a label to a substring of kernel names whose
    device time is summed under that label (the port's own kernels).  A
    session that comes back with no device events is taken again, fn run
    once more, up to three sessions (``launch_costs`` says why).

    The session opens PROFILE_PAD_S before fn and closes PROFILE_PAD_S
    after the device is idle: the profiler keeps only the device records
    that lie inside its window, whose ends it reads on the host's clock,
    and a kernel that ends microseconds before the session stops can fall
    outside it by the skew between the card's clock and the host's (seen
    once on an H100: a profile of 8 replayed decode steps kept 122 of 128
    ``kv_quant_store`` and 244 of 256 ``kv_dequant`` records, the last
    six layers of the last step, while the launch counts were exact).
    """
    from torch.profiler import ProfilerActivity, profile
    for sessions in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.time_range.end > e.time_range.start)
        if spans:
            break
    if not spans:
        return {"profiled_wall_ms": wall_ms, "top_device_ops": None,
                "device_idle_share": None, "profiler_sessions": sessions,
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
    return {"profiled_wall_ms": wall_ms, "profiler_sessions": sessions,
            "device_window_ms": window_us / 1e3,
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


def prefill_run(dev, cfg, params, seed: int, watch: dict,
                batch: dict = None) -> tuple:
    """A prefill of ``batch`` (the encoder-decoder's frames and tokens), by
    default of PREFILL_B x PREFILL_S seeded tokens: one warm-up (the first
    use of the GEMM shapes), one timed, one profiled; flash launched once an
    attention call (``attention_calls``), else no kernel.
    -> (row, api, tokens)."""
    if batch is None:
        rng = np.random.default_rng(seed)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)}
    B, S = batch["tokens"].shape
    rc = configs.RunConfig(seq_len=S, global_batch=B, kind="prefill")
    api = model_zoo.get_api(cfg, rc, dev)
    t0 = time.perf_counter()
    api.prefill(params, batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg = api.prefill(params, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    want = {k: 0 for k in launches}
    if attention_calls(cfg):
        want["flash_attention.flash_fwd"] = attention_calls(cfg)
    check(launches == want, f"{cfg.name} prefill launched {launches}, want {want}")
    check(tuple(lg.shape) == (B, cfg.vocab), f"logits {tuple(lg.shape)}")
    check(bool(torch.isfinite(lg).all()), f"{cfg.name}: non-finite prefill logits")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    prof = device_profile(lambda: api.prefill(params, batch), watch, top=8)
    row = {"batch": B, "seq": S, "q_block": rc.q_block, "kv_block": rc.kv_block,
           "window": cfg.sliding_window if cfg.sliding_window < S else 0,
           "first_call_ms": warm_ms, "wall_ms": wall_ms,
           "tokens_per_s": B * S / (wall_ms * 1e-3),
           "launches": launches, "peak_GiB": peak, "logits": list(lg.shape), **prof}
    if "frames" in batch:
        row["frames"] = list(batch["frames"].shape)
        row["frames_per_s"] = B * batch["frames"].shape[1] / (wall_ms * 1e-3)
    return row, api, batch["tokens"]


def phase_prefill(dev, lm: dict) -> dict:
    row, _, _ = prefill_run(dev, lm["cfg"], lm["params"], SEED + 3,
                            {"flash": "flash_fwd_sm90_kernel"})
    emit({"phase": "prefill", **row})
    return {"launches": row["launches"], "wall_ms": row["wall_ms"]}


def lockstep(engine: ServeEngine, prompts: list, max_new: int, dev,
             skip: int = 0, fill=None) -> dict:
    """``generate``'s schedule run twice side by side from the same fresh
    state: the engine's CUDA graph replayed, and ``decode_step`` eagerly.
    The logits must be ``torch.equal`` at every step, the greedy tokens
    identical, and the states (kv caches, SSM state, positions) equal at the
    end.  Host ms a step (each ending in the argmax's copy to the host) for
    both.  With ``skip``, the graph runs the first ``skip`` steps alone and
    the eager state starts as a copy of the graph's there: the comparison
    covers the steps from ``skip`` on (a ring's wrap, far into a sequence).
    ``fill(state)``, where given, writes the same values into both fresh
    states (the encoder-decoder's cross K/V)."""
    B, lens = len(prompts), [len(p) for p in prompts]
    total = max(lens) + max_new
    step = engine.graphed_step(B)
    step.reset()
    state = engine.api.init_decode_state(B)
    leaves = engine.api.cache_leaves
    if fill is not None:
        fill(step.state)
        fill(state)
    toks = {k: [[] for _ in range(B)] for k in ("graph", "eager")}
    cur = {k: np.array([p[0] for p in prompts], np.int64) for k in toks}
    ms = {k: [] for k in toks}
    equal = 0
    for t in range(total - 1):
        if t == skip and skip:
            for a, b in zip(leaves(state), leaves(step.state)):
                a.copy_(b)
            state.pos.copy_(step.state.pos)
            cur["eager"] = cur["graph"].copy()
            toks["eager"] = copy.deepcopy(toks["graph"])
        t0 = time.perf_counter()
        lg_g, nxt_g = step(torch.from_numpy(cur["graph"]))
        model = {"graph": nxt_g.cpu().numpy()}
        t1 = time.perf_counter()
        if t >= skip:
            lg_e, state = engine.api.decode_step(
                engine.params, state, torch.from_numpy(cur["eager"]).to(dev))
            model["eager"] = torch.argmax(lg_e, dim=-1).cpu().numpy()
            ms["eager"].append((time.perf_counter() - t1) * 1e3)
            equal += bool(torch.equal(lg_g, lg_e))
        ms["graph"].append((t1 - t0) * 1e3)
        for k in model:
            for i in range(B):
                if t + 1 < lens[i]:
                    cur[k][i] = prompts[i][t + 1]
                else:
                    cur[k][i] = model[k][i]
                    if len(toks[k][i]) < max_new:
                        toks[k][i].append(int(model[k][i]))
    state_equal = torch.equal(step.state.pos, state.pos) and all(
        torch.equal(a, b) for a, b in zip(leaves(step.state), leaves(state)))
    compared = total - 1 - skip
    check(equal == compared, f"graph logits equal eager on {equal} of "
          f"{compared} steps")
    check(toks["graph"] == toks["eager"], "graph and eager greedy tokens differ")
    check(state_equal, "graph and eager states differ after the steps")
    return {"steps": total - 1, "compared_from_step": skip,
            "logits_equal_steps": equal, "tokens_identical": True,
            "state_equal": True,
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


def generate_run(dev, cfg, rc, params, prompts: list, max_new: int) -> tuple:
    """``ServeEngine.generate`` through the replayed graph: capture, one
    warm-up (the first use of the loop), one timed run with its launches
    checked exactly (the fused store once an attention layer and step,
    dequant twice, nothing else), a profile of PROFILE_STEPS replayed steps
    with the same counts, and a step's token copy and replay by CUDA events.
    -> (row, engine)."""
    B = len(prompts)
    engine = ServeEngine(cfg, rc, params=params, device=str(dev))
    capture_ms = captured(engine, B)
    engine.generate([p[:4] for p in prompts], max_new=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=max_new)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    lens = [len(p) for p in prompts]
    steps = max(lens) + max_new - 1
    n_attn = cfg.n_layers if transformer._has_attn(cfg) else 0
    check_serve_launches(launches, n_attn, steps)
    check([len(t) for t in out] == [max_new] * B, "generated lengths")
    check(all(0 <= t < cfg.vocab for seq in out for t in seq), "token out of range")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    step = engine.graphed_step(B)
    step.reset()
    cur = torch.tensor([p[0] for p in prompts])
    step(cur)

    def steps_fn():
        for _ in range(PROFILE_STEPS):
            step(cur)[1].cpu()                           # as generate syncs
    prof = device_profile(steps_fn, {"kv_quant_store": "quant_store_kernel",
                                     "kv_quant": "::quant_kernel",
                                     "kv_dequant": "dequant_kernel"}, top=8)
    seen = {k: v["launches"] for k, v in (prof.get("watched") or {}).items()}
    want = {"kv_quant_store": n_attn * PROFILE_STEPS, "kv_quant": 0,
            "kv_dequant": 2 * n_attn * PROFILE_STEPS}
    check(seen == want, f"profile of {PROFILE_STEPS} replayed steps: kernels "
          f"{seen}, want {want}")
    # without the profiler (whose per-kernel records stretch a replay): the
    # device time of a step's token copy and replay by CUDA events, and the
    # idle share from the profile's busy time over the timed generate's step
    replay_ms = time_ms(lambda: step(cur), reps=20)
    busy_step_ms = prof["device_busy_ms"] / PROFILE_STEPS
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    row = {"batch": B, "seq_len": rc.seq_len, "kv_cache_bits": rc.kv_cache_bits,
           "prompt_lens": lens, "max_new": max_new, "decode_steps": steps,
           "wall_ms": wall_ms, "step_ms": wall_ms / steps,
           "prompt_tokens_per_s": sum(lens) / (wall_ms * 1e-3),
           "generated_tokens_per_s": B * max_new / (wall_ms * 1e-3),
           "capture_ms": capture_ms, "graph_launches_per_step": step.launches,
           "kv_cache_bytes": engine.kv_cache_bytes(B), "peak_GiB": peak,
           "launches": launches, "replay_device_ms": replay_ms,
           "device_busy_ms_per_step": busy_step_ms,
           "device_idle_share_untraced": 1 - busy_step_ms / (wall_ms / steps),
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "profile_steps": PROFILE_STEPS, **prof}
    return row, engine


def serve_prompts(rng, cfg, lens) -> list:
    return [rng.integers(0, cfg.vocab, int(n)).tolist() for n in lens]


def phase_serve(dev, lm: dict) -> dict:
    cfg, rc, params = lm["cfg"], lm["rc"], lm["params"]
    rng = np.random.default_rng(SEED + 4)
    prompts = serve_prompts(rng, cfg, rng.integers(16, 129, SERVE_B))
    row, engine = generate_run(dev, cfg, rc, params, prompts, SERVE_NEW)

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
    emit({"phase": "serve", **row,
          "kv_cache_bytes_int4": engine4.kv_cache_bytes(SERVE_B),
          "int4": {"decode_steps": steps4, "wall_ms": wall4_ms,
                   "capture_ms": capture4_ms, "launches": launches4},
          "graph_vs_eager": {
              "int8": {k: v for k, v in ls8.items() if k != "tokens"},
              "int4": {k: v for k, v in ls4.items() if k != "tokens"}}})
    return {"launches": row["launches"], "wall_ms": row["wall_ms"],
            "steps": row["decode_steps"]}


class moe_routes:
    """Within the block, ``moe.route`` records each call's route in
    ``.calls`` as (device type, route).  With ``follow``, the CPU routes as
    the card did: where its j-th call's top k differs from the card's j-th
    call (the card's call comes first), it takes the card's experts, with
    combine weights and rows from its own probabilities (``moe.assign``),
    and records the flip in ``.flips``: the call, its rows, and the largest
    gap, in the CPU's probabilities, between an expert it chose and the
    card's choice in that place.  A sync a call: eager runs only."""

    def __init__(self, follow: bool = False):
        self.follow, self.calls, self.flips = follow, [], []

    def __enter__(self) -> "moe_routes":
        self.orig = moe.route

        def recording(xf, router, cfg, *batch):
            r = self.orig(xf, router, cfg, *batch)
            if self.follow and xf.device.type == "cpu":
                r = self._follow(r, cfg, *batch)
            self.calls.append((xf.device.type, r))
            return r
        moe.route = recording
        return self

    def __exit__(self, *exc) -> None:
        moe.route = self.orig

    def _follow(self, r, cfg, *batch):
        j = sum(d == "cpu" for d, _ in self.calls)
        card = [g for d, g in self.calls if d == "cuda"]
        check(j < len(card), "the CPU routed before the card")
        want = card[j].top_e.cpu()
        rows = (r.top_e != want).any(dim=-1).nonzero()[:, 0]
        if not len(rows):
            return r
        gap = (torch.gather(r.probs, 1, r.top_e) - torch.gather(r.probs, 1, want))[rows]
        self.flips.append({"call": j, "rows": rows.tolist()[:8], "n_rows": len(rows),
                           "margin": float(gap.abs().max())})
        return moe.assign(r.probs, want, cfg, *batch)


class kv_ties:
    """Within the block, ``ops.kv_quant_store`` on the CPU stores the codes
    that the card's call of the same index stored (the card's call comes
    first), where the two differ by one code at a rounding boundary: both
    devices' value / scale within ROUND_TIE_EPS of the half code between
    the two codes.  Any other difference fails.  ``.ties`` lists each call
    with ties: its index, the codes taken and their largest distance from
    the boundary.  A sync a call: eager runs only."""

    def __enter__(self) -> "kv_ties":
        self.orig, self.card, self.n_cpu, self.ties = ops.kv_quant_store, [], 0, []

        def storing(cache_k, cache_v, k_scale, v_scale, k_new, v_new, slot,
                    bits=8, backend="auto"):
            self.orig(cache_k, cache_v, k_scale, v_scale, k_new, v_new, slot,
                      bits, backend)
            b = torch.arange(slot.shape[0], device=slot.device)
            s = torch.clamp(slot, 0, cache_k.shape[1] - 1)
            rows = [(codes, codes[b, s].cpu(), scales[b, s].cpu(), new[:, 0].float().cpu())
                    for codes, scales, new in ((cache_k, k_scale, k_new),
                                               (cache_v, v_scale, v_new))]
            if cache_k.device.type == "cuda":
                self.card.append([r[1:] for r in rows])
                return
            j = self.n_cpu
            self.n_cpu += 1
            check(j < len(self.card), "the CPU stored before the card")
            for (cache, codes, scales, new), (c_codes, c_scales, c_new) in zip(
                    rows, self.card[j]):
                got, want = unpacked(codes, bits), unpacked(c_codes, bits)
                diff = got != want
                if not diff.any():
                    continue
                half = torch.minimum(got, want) + 0.5
                dist = torch.maximum((new / scales - half).abs(),
                                     (c_new / c_scales - half).abs())[diff]
                one = bool(((got - want).abs()[diff] == 1).all())
                check(one and float(dist.max()) <= ROUND_TIE_EPS,
                      f"kv store call {j}: {int(diff.sum())} codes differ from "
                      f"the card's, one step each {one}, farthest "
                      f"{float(dist.max())} from a rounding boundary")
                cache[b, s] = c_codes
                self.ties.append({"call": j, "codes": int(diff.sum()),
                                  "boundary_dist": float(dist.max())})
        ops.kv_quant_store = storing
        return self

    def __exit__(self, *exc) -> None:
        ops.kv_quant_store = self.orig


def unpacked(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed int8 / int4 codes (..., cd) as f32 code values (..., D)."""
    rows = codes.reshape(-1, codes.shape[-1])
    out = ref.kv_dequant_ref(rows, torch.ones(rows.shape[0], 1), bits)
    return out.reshape(*codes.shape[:-1], -1)


def serve_parity(dev, cfg, dtype: str, bits: int, toks: np.ndarray,
                 prompts: list, seq_len: int = PARITY_S,
                 steps: int = PARITY_STEPS, max_new: int = PARITY_NEW) -> dict:
    """One smoke config, the same weights on the card (kernels) and on the
    CPU (plain paths): a prefill of ``toks``, ``steps`` decode steps on its
    first tokens and a generate.  Each prefill and step runs on the card
    first; the CPU then follows the card's MoE routing where they differ
    by a near-tie (``moe_routes``: each flip's gap within FLIP_MARGIN) and,
    in f32, the card's cache codes where they differ by a rounding tie
    (``kv_ties``).  f32: logits within F32_TOL, no routing flip and
    identical greedy tokens; bf16: within BF16_REL of the largest logit."""
    B = toks.shape[0]
    rc = configs.RunConfig(seq_len=seq_len, global_batch=B, kind="decode",
                           param_dtype=dtype, kv_cache_bits=bits, q_block=16,
                           kv_block=32)
    order = ("cuda", "cpu")
    apis = {d: model_zoo.get_api(cfg, rc, d) for d in order}
    params = {"cpu": apis["cpu"].init(SEED)}
    params["cuda"] = copy.deepcopy(params["cpu"]).to(dev)
    t = {d: torch.from_numpy(toks).to(d) for d in order}
    ties = kv_ties() if dtype == "float32" else contextlib.nullcontext()
    with moe_routes(follow=True) as routes, ties:
        pre = {d: apis[d].prefill(params[d], {"tokens": t[d]}).float().cpu()
               for d in order}
        errs = [float((pre["cuda"] - pre["cpu"]).abs().max())]
        scales = [float(pre["cpu"].abs().max())]
        states = {d: apis[d].init_decode_state(B) for d in order}
        for i in range(steps):
            lg = {}
            for d in order:
                out, states[d] = apis[d].decode_step(params[d], states[d],
                                                     t[d][:, i])
                lg[d] = out.float().cpu()
            errs.append(float((lg["cuda"] - lg["cpu"]).abs().max()))
            scales.append(float(lg["cpu"].abs().max()))
    n_calls = {d: sum(dd == d for dd, _ in routes.calls) for d in order}
    check(n_calls["cuda"] == n_calls["cpu"], f"moe calls differ in number {n_calls}")
    per_step = max(cfg.n_layers, 1)          # prefill is step 0
    flips = [{"step": f["call"] // per_step, "layer": f["call"] % per_step, **f}
             for f in routes.flips]
    gen = {d: ServeEngine(cfg, rc, params=params[d], device=d).generate(
        prompts, max_new=max_new) for d in order}
    if dtype == "float32":
        ok = max(errs) <= F32_TOL and not flips and gen["cuda"] == gen["cpu"]
    else:
        ok = (all(e <= BF16_REL * sc for e, sc in zip(errs, scales))
              and all(f["margin"] <= FLIP_MARGIN for f in flips))
    row = {"config": cfg.name, "dtype": dtype, "kv_cache_bits": bits,
           "prefill_err": errs[0], "decode_max_err": max(errs[1:]),
           "max_rel_err": max(e / s for e, s in zip(errs, scales)),
           "steps_past_rule": [i for i, (e, sc) in enumerate(zip(errs, scales))
                               if e > (F32_TOL if dtype == "float32" else BF16_REL * sc)],
           "routing_flips_followed": flips,
           "kv_code_ties_followed": ties.ties if dtype == "float32" else None,
           "tokens_equal": gen["cuda"] == gen["cpu"], "ok": ok}
    check(ok, f"serve parity {row}")
    return row


def phase_lm_parity(dev) -> dict:
    """The smoke config, same weights, kernels on the card vs plain on the CPU."""
    cfg = configs.load_smoke(ARCH)
    rng = np.random.default_rng(SEED + 5)
    toks = rng.integers(0, cfg.vocab, (PARITY_B, PARITY_S))
    prompts = [toks[i, :n].tolist() for i, n in enumerate((5, 17, 24, 9))]
    results = []
    for dtype in ("float32", "bfloat16"):
        for bits in (16, 8, 4):
            row = serve_parity(dev, cfg, dtype, bits, toks, prompts)
            results.append({k: v for k, v in row.items() if k != "config"})
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


def attention_calls(cfg) -> int:
    """Flash attention calls in one forward: a layer's self-attention where
    the family has attention; the encoder-decoder's encoder layers and its
    decoder layers' self- and cross-attention."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers if transformer._has_attn(cfg) else 0


def train_flops(cfg, params, batch: int, S: int) -> tuple:
    """(model FLOPs a step, of which attention, the formula): 6 x weights x
    the tokens each weight sees, plus 12 x H x D x keys scored a token.
    Decoder-only: every weight sees the B x S tokens, a query scores k keys
    (the mean under the window, (S + 1) / 2 causal).  Encoder-decoder: the
    encoder's weights and the cross-attention's wk, wv see the B x enc_seq
    frames, the rest the B x S tokens; the encoder scores enc_seq keys a
    frame, the decoder (S + 1) / 2 causal and enc_seq across."""
    HD = cfg.n_heads * cfg.hd
    n = sum(p.numel() for p in params.parameters())
    if cfg.family != "encdec":
        attn = 0
        if transformer._has_attn(cfg):
            keys = band_pairs(S, cfg.sliding_window) / S
            attn = int(12 * cfg.n_layers * HD * keys * batch * S)
        return 6 * n * batch * S + attn, attn, (
            "(6*N*tokens + 12*L*H*D*k*tokens) / step_s / 989e12, N the counted "
            "parameters, k the mean keys a query scores (window-limited); the "
            "SSD scan not counted")
    E = cfg.enc_seq
    n_frames = sum(p.numel() for p in params.enc_layers.parameters()) + \
        params.enc_norm.numel() + sum(
            lp.cross_attn.wk.numel() + lp.cross_attn.wv.numel()
            for lp in params.dec_layers)
    attn = int(12 * HD * (cfg.enc_layers * E * batch * E
                          + cfg.n_layers * ((S + 1) / 2 + E) * batch * S))
    return 6 * (n_frames * batch * E + (n - n_frames) * batch * S) + attn, attn, (
        "(6*(N_f*frames + N_t*tokens) + 12*H*D*(L_enc*E*frames + "
        "L_dec*((S+1)/2 + E)*tokens)) / step_s / 989e12, N_f the encoder's "
        "weights and the cross wk, wv, N_t the rest, E = enc_seq")


def train_run(dev, arch: str, batch: int = TRAIN_B, seq_len: int = 0,
              lr: float = 0.0) -> dict:
    """One model at full size, batch ``batch`` (cut from train_4k's 256),
    on train_4k's sequences or ``seq_len``, bf16 weights, f32 AdamW
    moments, remat: TRAIN_STEPS timed steps of ``train.step.make_train_step``
    (the step ``train.loop.train`` runs) after a warm-up, launches checked
    exactly (flash forward twice an attention call, forward and remat
    recompute, and both backward kernels once), a profiled step.  With
    ``lr`` (a peak rate over train_4k's), the loss on the warm-up's batch
    after the steps must fall below the warm-up's loss."""
    cfg = configs.load_arch(arch)
    over = {"global_batch": batch}
    if seq_len:
        over["seq_len"] = seq_len
    if lr:
        over["lr"] = lr
    rc = configs.run_config_for("train_4k", cfg, **over)
    check(rc.remat and rc.opt_dtype == "float32" and rc.param_dtype == "bfloat16",
          f"train config {rc}")
    api = model_zoo.get_api(cfg, rc, dev)
    t0 = time.perf_counter()
    state = train_step.init_state(api, rc, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    step_fn = train_step.make_train_step(api, cfg, rc)
    pipe = SyntheticPipeline(cfg, rc, seed=SEED)
    batches = [device_batch(pipe.next(), cfg, rc, dev) for _ in range(TRAIN_STEPS + 2)]
    B = batch
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
    L, calls = cfg.n_layers, attention_calls(cfg)
    want = {k: 0 for k in launches}
    if calls:
        want.update({"flash_attention.flash_fwd": 2 * calls * TRAIN_STEPS,
                     "flash_attention.flash_bwd_dkv": calls * TRAIN_STEPS,
                     "flash_attention.flash_bwd_dq": calls * TRAIN_STEPS})
    check(launches == want, f"{arch} train launched {launches}, want {want}")
    check(all(np.isfinite(losses + gnorms)) and np.isfinite(warm_loss),
          f"{arch}: non-finite loss or grad norm: {losses}, {gnorms}")
    check(int(state.step) == TRAIN_STEPS + 1, f"step counter {int(state.step)}")

    def one_step():
        nonlocal state
        state, m = step_fn(state, batches[-1])
        float(m["loss"])
    prof = device_profile(one_step, {"flash_fwd": "flash_fwd_sm90_kernel",
                                     "flash_bwd_dkv": "flash_bwd_dkv_sm90_kernel",
                                     "flash_bwd_dq": "flash_bwd_dq_sm90_kernel"}, top=8)
    step_ms = float(np.median(times))
    tokens = B * rc.seq_len
    model_flops, attn_flops, formula = train_flops(cfg, state.params, B, rc.seq_len)
    extra = {}
    if lr:
        with torch.no_grad():
            after = float(api.loss_fn(state.params, batches[0]))
        check(np.isfinite(after) and after < warm_loss,
              f"{arch}: the warm-up batch's loss went {warm_loss} -> {after}")
        extra = {"lr": rc.lr, "warmup_batch_loss_after": after}
    if cfg.family == "encdec":
        extra.update(enc_layers=cfg.enc_layers, enc_seq=cfg.enc_seq,
                     frames_per_step=B * cfg.enc_seq)
    del state, batches
    torch.cuda.empty_cache()
    return {"arch": arch, "n_layers": L, "d_model": cfg.d_model,
            "params": n_params, "param_count_formula": cfg.param_count(),
            "batch": B, "seq": rc.seq_len,
            "window": cfg.sliding_window, "tokens_per_step": tokens,
            "reduced": {"global_batch": [configs.SHAPES["train_4k"][1], B]},
            "remat": rc.remat, "param_dtype": rc.param_dtype,
            "opt_dtype": rc.opt_dtype, "init_s": init_s,
            "warmup_step_ms": warm_ms, "step_ms": times, "step_ms_median": step_ms,
            "tokens_per_s": tokens / (step_ms * 1e-3),
            "mfu": model_flops / (step_ms * 1e-3) / BF16_FLOPS_PER_S,
            "mfu_formula": formula, **extra,
            "model_flops_per_step": model_flops, "attention_flops_per_step": attn_flops,
            "loss": [warm_loss] + losses, "grad_norm": gnorms, "peak_GiB": peak,
            "launches": launches,
            "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
            **prof}


def phase_train(dev) -> dict:
    """tinyllama-1.1b at full width: warm-up, TRAIN_STEPS timed steps, a profile."""
    row = train_run(dev, TRAIN_ARCH)
    check(row["params"] == row["param_count_formula"],
          f"{row['params']} parameters, config says {row['param_count_formula']}")
    emit({"phase": "train", **row})
    return {"launches": row["launches"], "step_ms": row["step_ms_median"]}


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


def train_parity(dev, cfg, dtype: str) -> dict:
    """One smoke config, the same weights on the card (kernels) and on the
    CPU (plain paths), 3 train steps: f32 losses within TRAIN_F32_TOL and
    grad norms within TRAIN_F32_TOL relative, bf16 losses within
    TRAIN_BF16_REL and grad norms within TRAIN_BF16_GN_REL relative; a
    family with attention launched every flash kernel."""
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
    flash = transformer._has_attn(cfg)
    ok = ok and all((launches[n] > 0) == flash for n in FLASH_KERNELS)
    row = {"dtype": dtype, "loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
           "loss_max_abs_err": loss_err, "loss_max_rel_err": loss_rel,
           "grad_norm_max_rel_err": gn_rel, "launches": launches, "ok": ok}
    check(ok, f"train_parity {cfg.name} {row}")
    return row


def phase_train_parity(dev) -> None:
    """The smoke config, same weights, kernels on the card vs plain on the CPU."""
    cfg = configs.load_smoke(TRAIN_ARCH)
    results = [train_parity(dev, cfg, dtype) for dtype in ("float32", "bfloat16")]
    emit({"phase": "train_parity", "config": cfg.name, "steps": 3,
          "f32_tol": TRAIN_F32_TOL, "bf16_rel_tol": TRAIN_BF16_REL,
          "bf16_grad_norm_rel_tol": TRAIN_BF16_GN_REL,
          "results": results})


# ---------------------------------------------------------------------------
# The moe, ssm and hybrid families
# ---------------------------------------------------------------------------

def phase_families_parity(dev) -> None:
    """The four smoke configs with the same weights on the card (kernels)
    and on the CPU (plain paths): serving at bits 16, 8 and 4 (mamba2 has
    no kv cache: 16 only), a generate past the 64-slot ring of mixtral and
    hymba at bits 16 and 8, 3 train steps; and a mixtral train step run
    twice from one state, bit-identical."""
    rng = np.random.default_rng(SEED + 9)
    serve, ring, trained = [], [], []
    for arch in FAMILY_SMOKES:
        cfg = configs.load_smoke(arch)
        toks = rng.integers(0, cfg.vocab, (PARITY_B, PARITY_S))
        prompts = [toks[i, :n].tolist() for i, n in enumerate((5, 17, 24, 9))]
        for dtype in ("float32", "bfloat16"):
            for bits in (16, 8, 4) if transformer._has_attn(cfg) else (16,):
                serve.append(serve_parity(dev, cfg, dtype, bits, toks, prompts))
        trained += [{"config": cfg.name, **train_parity(dev, cfg, dtype)}
                    for dtype in ("float32", "bfloat16")]
    for arch in RING_ARCHES:
        cfg = configs.load_smoke(arch)
        check(cfg.sliding_window == 64, f"{arch} smoke window {cfg.sliding_window}")
        toks = rng.integers(0, cfg.vocab, (len(RING_PROMPTS), RING_SEQ))
        prompts = [toks[i, :n].tolist() for i, n in enumerate(RING_PROMPTS)]
        check(max(RING_PROMPTS) + RING_NEW - 1 == RING_STEPS, "ring schedule")
        ring += [serve_parity(dev, cfg, "float32", bits, toks, prompts,
                              seq_len=RING_SEQ, steps=RING_STEPS, max_new=RING_NEW)
                 for bits in (16, 8)]

    # determinism: one mixtral state, the gradient pass twice and the whole
    # step on two copies of it, bit for bit
    cfg = configs.load_smoke("mixtral-8x7b")
    rc = configs.RunConfig(seq_len=64, global_batch=4, kind="train",
                           param_dtype="bfloat16", q_block=16, kv_block=32, lr=1e-3)
    api = model_zoo.get_api(cfg, rc, dev)
    state = train_step.init_state(api, rc, SEED)
    batch = device_batch(SyntheticPipeline(cfg, rc, seed=SEED).next(), cfg, rc, dev)
    runs = []
    for _ in range(2):
        for p in state.params.parameters():
            p.grad = None
        loss = api.loss_fn(state.params, batch)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in state.params.parameters()]))
    twin = copy.deepcopy(state)
    step_fn = train_step.make_train_step(api, cfg, rc)
    (a, ma), (b, mb) = step_fn(state, batch), step_fn(twin, batch)
    same = {"loss": bool(torch.equal(runs[0][0], runs[1][0])),
            "grads": all(torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1])),
            "step_loss": bool(torch.equal(ma["loss"], mb["loss"])),
            "step_params": all(torch.equal(x, y) for x, y in
                               zip(a.params.parameters(), b.params.parameters()))}
    check(all(same.values()), f"mixtral train step not bit-identical: {same}")
    emit({"phase": "families_parity", "configs": list(FAMILY_SMOKES),
          "batch": PARITY_B, "seq": PARITY_S, "decode_steps": PARITY_STEPS,
          "f32_tol": F32_TOL, "bf16_rel_tol": BF16_REL, "serve": serve,
          "ring": {"seq_len": RING_SEQ, "window": 64, "decode_steps": RING_STEPS,
                   "prompt_lens": list(RING_PROMPTS), "max_new": RING_NEW,
                   "results": ring},
          "train": {"steps": 3, "f32_tol": TRAIN_F32_TOL,
                    "bf16_rel_tol": TRAIN_BF16_REL,
                    "bf16_grad_norm_rel_tol": TRAIN_BF16_GN_REL, "results": trained},
          "mixtral_step_bit_identical": same})


def init_family(dev, cfg, rc) -> tuple:
    """Random bf16 weights on the card: (params, facts for the phase line)."""
    t0 = time.perf_counter()
    params = model_zoo.get_api(cfg, rc, dev).init(SEED)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    if cfg.family in ("moe", "encdec"):
        # the encdec formula leaves out the encoder's final norm (d_model)
        want = cfg.param_count() + (cfg.d_model if cfg.family == "encdec" else 0)
        check(n == want, f"{n} parameters, want {want} (param_count() "
              f"{cfg.param_count()})")
    return params, {"arch": cfg.name, "n_layers": cfg.n_layers,
                    "d_model": cfg.d_model, "params": n,
                    "param_count_formula": cfg.param_count(),
                    "GiB": nbytes / 2**30, "init_s": time.perf_counter() - t0}


def routed_drops(fn) -> dict:
    """Run ``fn`` counting each MoE call's routed copies and the ones past
    their expert's capacity (a sync a layer: untimed)."""
    with moe_routes() as routes:
        fn()
    seen = [(int(r.keep.numel() - r.keep.sum()), r.keep.numel(), r.cap)
            for _, r in routes.calls]
    dropped, routed = sum(d for d, _, _ in seen), sum(n for _, n, _ in seen)
    return {"calls": len(seen), "capacity": seen[0][2], "routed_copies": routed,
            "dropped_copies": dropped, "dropped_share": dropped / routed,
            "dropped_by_layer": [d for d, _, _ in seen]}


def phase_moe_serve(dev) -> dict:
    """mixtral-8x7b at full width, 16 of its 32 layers: prefill, generate."""
    cfg = dataclasses.replace(configs.load_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    rc = configs.RunConfig(seq_len=SERVE_SEQ, global_batch=SERVE_B, kind="decode",
                           kv_cache_bits=8)
    params, facts = init_family(dev, cfg, rc)
    pre, api, toks = prefill_run(dev, cfg, params, SEED + 10,
                                 {"flash": "flash_fwd_sm90_kernel"})
    drops = routed_drops(lambda: api.prefill(params, {"tokens": toks}))
    check(drops["calls"] == cfg.n_layers and drops["capacity"] == int(
        cfg.capacity_factor * cfg.topk * PREFILL_B * PREFILL_S / cfg.n_experts),
        f"moe calls {drops['calls']}, capacity {drops['capacity']}")
    rng = np.random.default_rng(SEED + 11)
    prompts = serve_prompts(rng, cfg, rng.integers(16, 129, SERVE_B))
    gen, engine = generate_run(dev, cfg, rc, params, prompts, SERVE_NEW)
    ls = lockstep(engine, [p[:4 + i] for i, p in enumerate(prompts)], 6, dev)
    check(ls["steps"] == 16, f"lockstep ran {ls['steps']} steps")
    emit({"phase": "moe_serve", **facts,
          "reduced": {"n_layers": [32, MOE_LAYERS]},
          "prefill": pre, "prefill_routing": drops, "generate": gen,
          "graph_vs_eager": {k: v for k, v in ls.items() if k != "tokens"}})
    return {"prefill": pre["launches"], "generate": gen["launches"]}


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal attention of S positions scores, within
    ``window`` keys of the query when window > 0."""
    return sum(min(q + 1, window) if window else q + 1 for q in range(S))


def sdpa_run(q, k, v, causal: bool, window: int = 0):
    """SDPA on (B, S, KV, G, D) q and (B, Sk, KV, D) k, v, the kv heads
    expanded to the query heads; a window as an explicit band mask, else
    ``is_causal``: (a function that runs it, the backend that ran), the
    first of cuDNN, flash, efficient, math that takes the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    B, S, KV, G, D = q.shape
    Sk = k.shape[1]
    qs = q.reshape(B, S, KV * G, D).transpose(1, 2)
    ks = k[:, :, :, None].expand(B, Sk, KV, G, D).reshape(B, Sk, KV * G, D).transpose(1, 2)
    vs = v[:, :, :, None].expand(B, Sk, KV, G, D).reshape(B, Sk, KV * G, D).transpose(1, 2)
    kw = ({"attn_mask": flash_attention._mask(S, Sk, causal, window, q.device)}
          if window else {"is_causal": causal})
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(qs[:1], ks[:1], vs[:1], **kw)
        except RuntimeError:
            continue

        def run(qs=qs, ks=ks, vs=vs, backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qs, ks, vs, **kw)
        return run, backend.name
    return None, "none ran"

def windowed_fwd(dev, shape: tuple, window: int, copy_rate: float,
                 causal: bool = True, Sk: int = 0) -> dict:
    """The bf16 flash forward with a sliding window at one layer's shape
    against its plain version (o within FLASH_BF16_TOL and its query tiles
    within FLASH_BF16_REL, lse within FLASH_LSE_TOL), timed beside SDPA
    with the same band as an explicit mask.  ``shape`` is (B, S, KV, G, D),
    the keys ``Sk`` (default S), causal or not."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    B, S, KV, G, D = shape
    Sk = Sk or S
    q = torch.randn(B, S, KV, G, D, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, Sk, KV, D, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    o, lse = flash_attention.flash_fwd(q, k, v, causal, window)
    op, lp = flash_attention.flash_attention_plain(q, k, v, causal, window)
    e_o, e_l = max_abs_diff(o.float(), op.float()), max_abs_diff(lse, lp)
    e_r = tile_rel_err(o, op)
    check(e_o < FLASH_BF16_TOL and e_l < FLASH_LSE_TOL and e_r < FLASH_BF16_REL,
          f"windowed flash bf16 {shape} Sk {Sk} causal {causal} window {window}: "
          f"o {e_o}, lse {e_l}, o tile rel {e_r}")
    del op, lp
    plain_ms = time_ms(lambda: flash_attention.flash_attention_plain(
        q, k, v, causal, window), reps=3)
    ms = time_ms(lambda: flash_attention.flash_fwd(q, k, v, causal, window), reps=10)
    lib, backend = sdpa_run(q, k, v, causal, window)
    lib_ms = time_ms(lib, reps=10) if lib else None
    pairs = band_pairs(S, window) if causal else S * Sk
    flops = 4 * B * KV * G * D * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * KV * G * S
    row = {"shape": list(shape), "Sk": Sk, "causal": causal, "window": window,
           "o_err": e_o, "lse_err": e_l,
           "o_tile_rel_err": e_r, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_backend": backend,
           **bound(nbytes, flops, copy_rate, BF16_FLOPS_PER_S),
           "tflops_per_s": flops / (ms * 1e-3) / 1e12}
    row["share_of_bound"] = row["bound_ms"] / ms
    return row


def phase_hybrid_serve(dev, copy_rate: float) -> dict:
    """hymba-1.5b at full size: prefill (windowed flash), the windowed
    forward at one layer's shape, a generate through the 1024-slot ring."""
    cfg = configs.load_arch(HYBRID_ARCH)
    rc = configs.RunConfig(seq_len=HYBRID_SEQ, global_batch=SERVE_B,
                           kind="decode", kv_cache_bits=8)
    params, facts = init_family(dev, cfg, rc)
    pre, _, _ = prefill_run(dev, cfg, params, SEED + 10,
                            {"flash": "flash_fwd_sm90_kernel"})
    check(pre["window"] == cfg.sliding_window > 0, f"prefill window {pre['window']}")
    G = cfg.n_heads // cfg.n_kv_heads
    fwd = windowed_fwd(dev, (PREFILL_B, PREFILL_S, cfg.n_kv_heads, G, cfg.hd),
                       cfg.sliding_window, copy_rate)
    rng = np.random.default_rng(SEED + 13)
    prompts = serve_prompts(rng, cfg, rng.integers(*HYBRID_LENS, SERVE_B))
    gen, engine = generate_run(dev, cfg, rc, params, prompts, HYBRID_NEW)
    check(gen["decode_steps"] > cfg.sliding_window, "the ring did not wrap")
    ls = lockstep(engine, [p[:HYBRID_LOCKSTEP] for p in prompts], 1, dev,
                  skip=HYBRID_SKIP)
    check(ls["steps"] == HYBRID_LOCKSTEP and HYBRID_SKIP < cfg.sliding_window
          < HYBRID_LOCKSTEP, f"hybrid lockstep ran {ls['steps']} steps")
    # the fused store at this path's shape: (8, 1, 5, 64) into a 1024-slot ring
    store = [store_case(dev, rng, (SERVE_B, cfg.sliding_window, cfg.n_kv_heads,
                                   cfg.hd), torch.bfloat16, 8, slots)
             for slots in ("first", "mid", "last", "mixed")]
    # kv_dequant at this path's shape: one layer's K (or V) ring cache,
    # (8, 1024, 5, 64) as 40,960 rows of 64, codes and scales seeded noise
    rows = SERVE_B * cfg.sliding_window * cfg.n_kv_heads
    dequant = []
    for bits in (8, 4):
        cd = cfg.hd if bits == 8 else cfg.hd // 2
        codes = torch.from_numpy(rng.integers(-128, 128, (rows, cd), dtype=np.int8)).to(dev)
        scales = torch.from_numpy(np.abs(rng.standard_normal((rows, 1))).astype(
            np.float32)).to(dev)
        same = bool(torch.equal(kvpack.kv_dequant(codes, scales, bits),
                                kvpack.kv_dequant_plain(codes, scales, bits)))
        check(same, f"kv_dequant at ({rows}, {cfg.hd}) bits {bits} differs from "
              f"its plain version")
        dequant.append({"rows": rows, "d": cfg.hd, "bits": bits, "identical": same})
    emit({"phase": "hybrid_serve", **facts, "prefill": pre,
          "windowed_flash_fwd": fwd, "generate": gen,
          "ring_slots": cfg.sliding_window,
          "graph_vs_eager": {k: v for k, v in ls.items() if k != "tokens"},
          "kv_quant_store_cases": store, "kv_dequant_cases": dequant})
    return {"prefill": pre["launches"], "generate": gen["launches"],
            "window_fwd": fwd}


def phase_ssm_serve(dev) -> dict:
    """mamba2-130m at full size: prefill and generate (no kernel: the SSD
    scan and conv are torch ops), the graph held to eager with the state."""
    cfg = configs.load_arch(SSM_ARCH)
    rc = configs.RunConfig(seq_len=SERVE_SEQ, global_batch=SERVE_B, kind="decode",
                           kv_cache_bits=8)
    params, facts = init_family(dev, cfg, rc)
    pre, _, _ = prefill_run(dev, cfg, params, SEED + 10, {})
    rng = np.random.default_rng(SEED + 14)
    prompts = serve_prompts(rng, cfg, rng.integers(16, 129, SERVE_B))
    gen, engine = generate_run(dev, cfg, rc, params, prompts, SERVE_NEW)
    ls = lockstep(engine, [p[:4 + i] for i, p in enumerate(prompts)], 6, dev)
    check(ls["steps"] == 16, f"lockstep ran {ls['steps']} steps")
    emit({"phase": "ssm_serve", **facts, "prefill": pre, "generate": gen,
          "graph_vs_eager": {k: v for k, v in ls.items() if k != "tokens"}})
    return {"prefill": pre["launches"], "generate": gen["launches"]}


def windowed_bwd(dev, shape: tuple, window: int, copy_rate: float,
                 causal: bool = True, Sk: int = 0) -> dict:
    """The bf16 dK/dV and dQ kernels with a sliding window at one layer's
    train shape: launched on the whole batch, each sequence held against
    the plain forward and backward run on it alone; timed beside SDPA's
    backward with the band as an explicit mask.  ``shape``, ``causal`` and
    ``Sk`` as ``windowed_fwd``'s."""
    fa = flash_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    B, S, KV, G, D = shape
    Sk = Sk or S
    q, k, v, do = [torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
                   for sh in ((B, S, KV, G, D), (B, Sk, KV, D), (B, Sk, KV, D),
                              (B, S, KV, G, D))]
    o, lse = fa.flash_fwd(q, k, v, causal, window)
    got = fa.flash_bwd(q, k, v, o, lse, do, causal, window)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fwd_errs, abs_errs, rel_errs, plain_ms = [0.0] * 3, [0.0] * 3, [0.0] * 3, 0.0
    for b in range(B):
        one = [t[b:b + 1] for t in (q, k, v, o, lse, do)]
        op, lp = fa.flash_attention_plain(*one[:3], causal, window)
        fwd_errs = list(map(max, fwd_errs, (
            max_abs_diff(one[3].float(), op.float()), max_abs_diff(one[4], lp),
            tile_rel_err(one[3], op))))
        del op, lp
        if b == 0:
            fa.flash_bwd_plain(*one, causal, window)                # warm-up
        start.record()
        want = fa.flash_bwd_plain(*one, causal, window)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        errs = [max_abs_diff(g[b:b + 1].float(), w.float()) for g, w in zip(got, want)]
        abs_errs = list(map(max, abs_errs, errs))
        rel_errs = list(map(max, rel_errs, (e / float(w.float().abs().max())
                                            for e, w in zip(errs, want))))
        del want
    check(fwd_errs[0] < FLASH_BF16_TOL and fwd_errs[1] < FLASH_LSE_TOL
          and fwd_errs[2] < FLASH_BF16_REL,
          f"windowed flash fwd at {shape}: o, lse, o tile rel {fwd_errs}")
    check(max(rel_errs) < BWD_BF16_TOL,
          f"windowed flash bwd at {shape}: rel dq, dk, dv {rel_errs}")
    del got
    torch.cuda.empty_cache()
    delta = fa.bwd_delta(o, do)
    ms_dkv = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, window), reps=5)
    ms_dq = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, window), reps=5)
    qs = q.detach().requires_grad_()
    ks, vs = k.detach().requires_grad_(), v.detach().requires_grad_()
    lib, backend = sdpa_run(qs, ks, vs, causal, window)
    lib_ms = None
    if lib:
        try:                                        # the yardstick only
            os_ = lib()
            dos = do.reshape(B, S, KV * G, D).transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(os_, (qs, ks, vs), dos,
                                                         retain_graph=True), reps=5)
            del os_, dos
        except RuntimeError as e:
            backend = f"{backend}: backward failed: {e}"[:300]
    del qs, ks, vs
    pairs = band_pairs(S, window) if causal else S * Sk
    H = KV * G
    io = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * (lse.numel() + delta.numel())
    rows = {}
    for name, ms, nbytes, nflops in (
            ("flash_attention.flash_bwd_dkv", ms_dkv, io + 2 * 2 * k.numel(),
             8 * B * H * D * pairs),
            ("flash_attention.flash_bwd_dq", ms_dq, io + 2 * q.numel(),
             6 * B * H * D * pairs)):
        rows[name] = {"shape": list(shape), "Sk": Sk, "causal": causal,
                      "window": window, "ms": ms,
                      "plain_ms": plain_ms, "plain_note": f"flash_bwd_plain "
                      f"(dq, dk, dv together) on each of the {B} sequences "
                      f"alone, one call each, times summed",
                      "library_ms": lib_ms, "library_backend": backend,
                      "library_note": "SDPA backward with the band as an "
                                      "explicit mask, heads expanded: dq, dk, "
                                      "dv together",
                      **bound(nbytes, nflops, copy_rate, BF16_FLOPS_PER_S),
                      "tflops_per_s": nflops / (ms * 1e-3) / 1e12}
        rows[name]["share_of_bound"] = rows[name]["bound_ms"] / ms
    return {"fwd_o_lse_tile_rel_err": fwd_errs, "rel_err_dq_dk_dv": rel_errs,
            "abs_err_dq_dk_dv": abs_errs, "rows": rows}


def phase_families_train(dev, copy_rate: float) -> dict:
    hybrid = train_run(dev, HYBRID_ARCH)
    emit({"phase": "families_train", **hybrid})
    cfg = configs.load_arch(HYBRID_ARCH)
    G = cfg.n_heads // cfg.n_kv_heads
    bwd = windowed_bwd(dev, (TRAIN_B, configs.SHAPES["train_4k"][0],
                             cfg.n_kv_heads, G, cfg.hd), cfg.sliding_window, copy_rate)
    emit({"phase": "families_train_windowed_bwd", **bwd})
    torch.cuda.empty_cache()
    ssm_ = train_run(dev, SSM_ARCH)
    emit({"phase": "families_train", **ssm_})
    return {"hybrid": hybrid["launches"], "ssm": ssm_["launches"],
            "window_bwd": bwd["rows"]}


# ---------------------------------------------------------------------------
# The encoder-decoder family
# ---------------------------------------------------------------------------

def seeded_cross(seed: int):
    """A fill for a fresh encoder-decoder decode state: its cross K/V set to
    seeded N(0, 1) noise, drawn on the CPU, so every device gets the same
    values (the serve path leaves them zero, as the reference does)."""
    def fill(state):
        g = torch.Generator().manual_seed(seed)
        for t in (state.cross_k, state.cross_v):
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return fill


def encdec_serve_parity(dev, cfg, dtype: str, bits: int, frames: np.ndarray,
                        toks: np.ndarray, prompts: list) -> dict:
    """The smoke config, the same weights on the card (kernels) and on the
    CPU (plain paths): ``prefill`` and ``decoder_forward`` logits,
    PARITY_STEPS decode steps from the zero state and again from seeded
    cross K/V, and a generate.  serve_parity's rules: f32 within F32_TOL
    (the CPU taking the card's cache code at a rounding tie, ``kv_ties``)
    and identical tokens, bf16 within BF16_REL of the largest logit."""
    B = toks.shape[0]
    rc = configs.RunConfig(seq_len=PARITY_S, global_batch=B, kind="decode",
                           param_dtype=dtype, kv_cache_bits=bits, q_block=16,
                           kv_block=32)
    order = ("cuda", "cpu")
    apis = {d: model_zoo.get_api(cfg, rc, d) for d in order}
    params = {"cpu": apis["cpu"].init(SEED)}
    params["cuda"] = copy.deepcopy(params["cpu"]).to(dev)
    fr = {d: torch.from_numpy(frames).to(d, rc.torch_dtype) for d in order}
    t = {d: torch.from_numpy(toks).to(d) for d in order}
    errs, scales = {}, {}

    def record(key: str, out: dict) -> None:
        errs[key] = float((out["cuda"] - out["cpu"]).abs().max())
        scales[key] = float(out["cpu"].abs().max())

    ties = kv_ties() if dtype == "float32" else contextlib.nullcontext()
    with ties, torch.no_grad():
        record("prefill", {d: apis[d].prefill(
            params[d], {"frames": fr[d], "tokens": t[d]}).float().cpu() for d in order})
        record("decoder_forward", {d: encdec.decoder_forward(
            params[d], t[d], encdec.encode(params[d], fr[d], cfg, rc), cfg,
            rc).float().cpu() for d in order})
        for cross in ("zero", "seeded"):
            states = {d: apis[d].init_decode_state(B) for d in order}
            if cross == "seeded":
                for d in order:
                    seeded_cross(SEED + 16)(states[d])
            for i in range(PARITY_STEPS):
                lg = {}
                for d in order:
                    out, states[d] = apis[d].decode_step(params[d], states[d],
                                                         t[d][:, i])
                    lg[d] = out.float().cpu()
                record(f"decode_{cross}_{i}", lg)
    gen = {d: ServeEngine(cfg, rc, params=params[d], device=d).generate(
        prompts, max_new=PARITY_NEW) for d in order}
    rule = {k: F32_TOL if dtype == "float32" else BF16_REL * scales[k] for k in errs}
    past = [k for k in errs if errs[k] > rule[k]]
    ok = not past and (dtype != "float32" or gen["cuda"] == gen["cpu"])
    row = {"dtype": dtype, "kv_cache_bits": bits, "prefill_err": errs["prefill"],
           "decoder_forward_err": errs["decoder_forward"],
           "decode_zero_cross_max_err": max(errs[f"decode_zero_{i}"]
                                            for i in range(PARITY_STEPS)),
           "decode_seeded_cross_max_err": max(errs[f"decode_seeded_{i}"]
                                              for i in range(PARITY_STEPS)),
           "max_rel_err": max(errs[k] / scales[k] for k in errs),
           "past_rule": past,
           "kv_code_ties_followed": ties.ties if dtype == "float32" else None,
           "tokens_equal": gen["cuda"] == gen["cpu"], "ok": ok}
    check(ok, f"encdec serve parity {row}")
    return row


def encdec_grad_parity(dev, cfg, dtype: str, remat: bool, B: int, S: int,
                       seed: int) -> dict:
    """``prefill`` logits, ``loss_fn`` and every gradient on the card (the
    flash kernels forward and backward) against the CPU (plain paths), the
    same weights and seeded inputs.  f32: logits and loss within F32_TOL,
    each gradient leaf within GRAD_F32_REL of its largest magnitude; bf16:
    the logits within BF16_REL of the largest, train_parity's rules on the
    loss (TRAIN_BF16_REL) and the gradient norm (TRAIN_BF16_GN_REL), each
    leaf's error reported.  The card launches the forward once an attention
    call (twice with remat) and each backward kernel once."""
    rc = configs.RunConfig(seq_len=S, global_batch=B, kind="train",
                           param_dtype=dtype, q_block=16, kv_block=32, remat=remat)
    order = ("cuda", "cpu")
    apis = {d: model_zoo.get_api(cfg, rc, d) for d in order}
    params = {"cpu": apis["cpu"].init(SEED)}
    params["cuda"] = copy.deepcopy(params["cpu"]).to(dev)
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model)) * 0.5).astype(np.float32)
    toks, labels = rng.integers(0, cfg.vocab, (2, B, S))
    logits, loss, grads = {}, {}, {}
    for d in order:
        batch = {"frames": torch.from_numpy(frames).to(d, rc.torch_dtype),
                 "tokens": torch.from_numpy(toks).to(d),
                 "labels": torch.from_numpy(labels).to(d)}
        logits[d] = apis[d].prefill(params[d], batch).float().cpu()
        ops.reset_launch_counts()
        out = apis[d].loss_fn(params[d], batch)
        out.backward()
        if d == "cuda":
            launches = ops.launch_counts()
        loss[d] = float(out.detach())
        grads[d] = {n: p.grad.float().cpu() for n, p in params[d].named_parameters()}
    calls = attention_calls(cfg)
    want = {k: 0 for k in launches}
    want.update({"flash_attention.flash_fwd": calls * (2 if remat else 1),
                 "flash_attention.flash_bwd_dkv": calls,
                 "flash_attention.flash_bwd_dq": calls})
    check(launches == want, f"encdec loss/grad launched {launches}, want {want}")
    lg_err = float((logits["cuda"] - logits["cpu"]).abs().max())
    lg_scale = float(logits["cpu"].abs().max())
    leaf = {n: float((grads["cuda"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
            for n, g in grads["cpu"].items()}
    gn = {d: float(torch.sqrt(sum((g * g).sum() for g in grads[d].values())))
          for d in order}
    gn_rel = abs(gn["cuda"] - gn["cpu"]) / gn["cpu"]
    loss_err = abs(loss["cuda"] - loss["cpu"])
    if dtype == "float32":
        ok = lg_err <= F32_TOL and loss_err <= F32_TOL and max(leaf.values()) <= GRAD_F32_REL
    else:
        ok = (lg_err <= BF16_REL * lg_scale and loss_err / abs(loss["cpu"]) <= TRAIN_BF16_REL
              and gn_rel <= TRAIN_BF16_GN_REL)
    worst = max(leaf, key=leaf.get)
    row = {"config": cfg.name, "enc_layers": cfg.enc_layers, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "batch": B, "dec_seq": S, "enc_seq": cfg.enc_seq,
           "dtype": dtype, "remat": remat, "prefill_err": lg_err,
           "prefill_rel_err": lg_err / lg_scale, "loss_cuda": loss["cuda"],
           "loss_cpu": loss["cpu"], "loss_err": loss_err, "grad_norm_rel_err": gn_rel,
           "grad_leaves": len(leaf), "grad_leaf_max_rel_err": leaf[worst],
           "grad_leaf_worst": worst, "launches": launches, "ok": ok}
    check(ok, f"encdec loss/grad parity {row}")
    return row


def phase_encdec_parity(dev) -> None:
    """whisper-tiny's smoke config on the card against the CPU: serving at
    bits 16, 8 and 4 (zero and seeded cross K/V), loss and every gradient
    with and without remat, train_parity's 3 steps, in f32 and bf16; and one
    full-width f32 layer each side at enc_seq 1500 and a 447-token decoder,
    so the ragged key and query tiles are held end to end."""
    cfg = configs.load_smoke(ENCDEC_ARCH)
    rng = np.random.default_rng(SEED + 22)
    frames = (rng.standard_normal((PARITY_B, cfg.enc_seq, cfg.d_model)) * 0.5).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (PARITY_B, PARITY_S))
    prompts = [toks[i, :n].tolist() for i, n in enumerate((5, 17, 24, 9))]
    serve = [encdec_serve_parity(dev, cfg, dtype, bits, frames, toks, prompts)
             for dtype in ("float32", "bfloat16") for bits in (16, 8, 4)]
    grads = [encdec_grad_parity(dev, cfg, dtype, remat, PARITY_B, PARITY_S - 1, SEED + 23)
             for dtype in ("float32", "bfloat16") for remat in (False, True)]
    trained = [train_parity(dev, cfg, dtype) for dtype in ("float32", "bfloat16")]
    wide = dataclasses.replace(configs.load_arch(ENCDEC_ARCH), n_layers=1, enc_layers=1)
    full = encdec_grad_parity(dev, wide, "float32", False, 2, ENCDEC_SEQ - 1, SEED + 24)
    emit({"phase": "encdec_parity", "config": cfg.name, "batch": PARITY_B,
          "seq": PARITY_S, "decode_steps": PARITY_STEPS, "max_new": PARITY_NEW,
          "f32_tol": F32_TOL, "bf16_rel_tol": BF16_REL, "grad_f32_rel_tol": GRAD_F32_REL,
          "serve": serve, "loss_and_grads": grads,
          "train": {"steps": 3, "f32_tol": TRAIN_F32_TOL, "bf16_rel_tol": TRAIN_BF16_REL,
                    "bf16_grad_norm_rel_tol": TRAIN_BF16_GN_REL, "results": trained},
          "full_width_one_layer": full})


def phase_encdec_flash(dev, copy_rate: float) -> dict:
    """The flash forward, dK/dV and dQ at whisper-tiny's three attention
    shapes (ENCDEC_SHAPES), f32 and bf16, against their plain versions on the
    whole batch (f32: o and lse within FLASH_F32_TOL, gradients within
    BWD_REL_TOL of their largest magnitude; bf16: o within FLASH_BF16_TOL and
    its tiles within FLASH_BF16_REL, lse within FLASH_LSE_TOL, gradients
    within BWD_BF16_TOL); the bf16 kernels timed beside their plain versions
    and SDPA forward and backward.  -> {shape label: {kernel: timed row}}."""
    fa = flash_attention
    cfg = configs.load_arch(ENCDEC_ARCH)
    check((cfg.enc_seq, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd)
          == (1500, 6, 1, 64), "whisper-tiny's attention shape")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    out, lines = {}, {}
    for label, ((B, S, Sk, KV, G, D), causal) in ENCDEC_SHAPES.items():
        line = {"shape": [B, S, Sk, KV, G, D], "causal": causal}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = [torch.randn(sh, generator=gen, device=dev).to(dt) for sh in
                           ((B, S, KV, G, D), (B, Sk, KV, D), (B, Sk, KV, D),
                            (B, S, KV, G, D))]
            o, lse = fa.flash_fwd(q, k, v, causal, 0)
            op, lp = fa.flash_attention_plain(q, k, v, causal, 0)
            e_o, e_l = max_abs_diff(o.float(), op.float()), max_abs_diff(lse, lp)
            e_r = tile_rel_err(o, op)
            del op, lp
            got = fa.flash_bwd(q, k, v, o, lse, do, causal, 0)
            want = fa.flash_bwd_plain(q, k, v, o, lse, do, causal, 0)
            rel = [max_abs_diff(g.float(), w.float()) / float(w.float().abs().max())
                   for g, w in zip(got, want)]
            del got, want
            bf16 = dt == torch.bfloat16
            name = "bfloat16" if bf16 else "float32"
            line[name] = {"o_err": e_o, "lse_err": e_l, "o_tile_rel_err": e_r,
                          "rel_err_dq_dk_dv": rel}
            if bf16:
                ok = (e_o < FLASH_BF16_TOL and e_l < FLASH_LSE_TOL
                      and e_r < FLASH_BF16_REL and max(rel) < BWD_BF16_TOL)
            else:
                ok = e_o < FLASH_F32_TOL and e_l < FLASH_F32_TOL and max(rel) < BWD_REL_TOL
            check(ok, f"flash at whisper's {label} shape {line['shape']} {name}: "
                  f"{line[name]}")
            if not bf16:
                continue
            delta = fa.bwd_delta(o, do)
            ms = {"flash_attention.flash_fwd": time_ms(
                      lambda: fa.flash_fwd(q, k, v, causal, 0), reps=10),
                  "flash_attention.flash_bwd_dkv": time_ms(
                      lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, 0), reps=10),
                  "flash_attention.flash_bwd_dq": time_ms(
                      lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, 0), reps=10)}
            plain_fwd = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal, 0), reps=3)
            plain_bwd = time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, causal, 0),
                                reps=3)
            qs = q.detach().requires_grad_()
            ks, vs = k.detach().requires_grad_(), v.detach().requires_grad_()
            lib, backend = sdpa_run(qs, ks, vs, causal)
            lib_fwd = lib_bwd = None
            if lib:
                lib_fwd = time_ms(lib, reps=10)
                try:                                # the yardstick only
                    os_ = lib()
                    dos = do.reshape(B, S, KV * G, D).transpose(1, 2)
                    lib_bwd = time_ms(lambda: torch.autograd.grad(
                        os_, (qs, ks, vs), dos, retain_graph=True), reps=10)
                    del os_, dos
                except RuntimeError as e:
                    backend = f"{backend}: backward failed: {e}"[:300]
            del qs, ks, vs
            pairs = band_pairs(S, 0) if causal else S * Sk
            H = KV * G
            io = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + \
                4 * (lse.numel() + delta.numel())
            rows = {}
            for kname, nbytes, nflops, plain_ms, lib_ms in (
                    ("flash_attention.flash_fwd",
                     2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel(),
                     4 * B * H * D * pairs, plain_fwd, lib_fwd),
                    ("flash_attention.flash_bwd_dkv", io + 2 * 2 * k.numel(),
                     8 * B * H * D * pairs, plain_bwd, lib_bwd),
                    ("flash_attention.flash_bwd_dq", io + 2 * q.numel(),
                     6 * B * H * D * pairs, plain_bwd, lib_bwd)):
                r = {"shape": line["shape"], "causal": causal, "ms": ms[kname],
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_backend": backend,
                     **bound(nbytes, nflops, copy_rate, BF16_FLOPS_PER_S),
                     "tflops_per_s": nflops / (ms[kname] * 1e-3) / 1e12}
                r["share_of_bound"] = r["bound_ms"] / ms[kname]
                rows[kname] = r
            line["timed_bf16"] = rows
            out[label] = rows
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
        lines[label] = line
    emit({"phase": "encdec_flash", "tol": {"f32": FLASH_F32_TOL, "f32_bwd_rel": BWD_REL_TOL,
                                           "bf16_o": FLASH_BF16_TOL, "lse": FLASH_LSE_TOL,
                                           "bf16_o_tile_rel": FLASH_BF16_REL,
                                           "bf16_bwd_rel": BWD_BF16_TOL},
          "plain_note": "the plain backward computes dq, dk, dv together; the "
                        "library's backward likewise (SDPA, heads as they are: G = 1)",
          "shapes": lines})
    return out


def phase_encdec_serve(dev) -> dict:
    """whisper-tiny at full size, bf16: a prefill of ENCDEC_SERVE_B clips
    (frames and ENCDEC_SEQ tokens); a generate through the graphed step at
    int8 (prompts of ENCDEC_PROMPT tokens, ENCDEC_NEW new, the cache full at
    the end) and a short one at int4; the graph held to eager
    ``decode_step`` from the zero state and from seeded cross K/V."""
    cfg = configs.load_arch(ENCDEC_ARCH)
    B = ENCDEC_SERVE_B
    rc = configs.RunConfig(seq_len=ENCDEC_SEQ, global_batch=B, kind="decode",
                           kv_cache_bits=8)
    params, facts = init_family(dev, cfg, rc)
    gen_ = torch.Generator(device=dev)
    gen_.manual_seed(SEED + 19)
    batch = {"frames": (torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen_,
                                    device=dev) * 0.02).to(rc.torch_dtype),
             "tokens": torch.randint(0, cfg.vocab, (B, ENCDEC_SEQ), generator=gen_,
                                     device=dev)}
    pre, _, _ = prefill_run(dev, cfg, params, SEED, {"flash": "flash_fwd_sm90_kernel"},
                            batch)
    del batch
    rng = np.random.default_rng(SEED + 20)
    prompts = serve_prompts(rng, cfg, [ENCDEC_PROMPT] * B)
    gen, engine = generate_run(dev, cfg, rc, params, prompts, ENCDEC_NEW)
    check(gen["decode_steps"] == ENCDEC_SEQ - 1, f"{gen['decode_steps']} steps")
    # a step reads the decoder's weights and the tied table, not the
    # encoder's, and the cross K/V (besides the self-attention cache)
    state = engine.graphed_step(B).state
    read = {"decode_weights": sum(p.numel() * p.element_size() for n, p in
                                  params.named_parameters()
                                  if not n.startswith(("enc_layers.", "enc_norm"))),
            "cross_kv": sum(t.numel() * t.element_size()
                            for t in (state.cross_k, state.cross_v))}
    read_bytes = sum(read.values())
    gen.update(read_bytes=read, weights_cross_kv_bound_ms=read_bytes / HBM_BYTES_PER_S * 1e3)
    gen["share_of_read_bound"] = gen["weights_cross_kv_bound_ms"] / gen["step_ms"]

    rc4 = dataclasses.replace(rc, kv_cache_bits=4)
    engine4 = ServeEngine(cfg, rc4, params=params, device=str(dev))
    short = prompts[:ENCDEC_INT4_B]
    capture4_ms = captured(engine4, ENCDEC_INT4_B)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out4 = engine4.generate(short, max_new=ENCDEC_INT4_NEW)
    torch.cuda.synchronize()
    wall4_ms = (time.perf_counter() - t0) * 1e3
    launches4 = ops.launch_counts()
    steps4 = ENCDEC_PROMPT + ENCDEC_INT4_NEW - 1
    check_serve_launches(launches4, cfg.n_layers, steps4)
    check([len(t) for t in out4] == [ENCDEC_INT4_NEW] * ENCDEC_INT4_B,
          "int4 generated lengths")

    ls = {"int8_zero_cross": lockstep(engine, prompts, 12, dev),
          "int8_seeded_cross": lockstep(engine, prompts, 12, dev,
                                        fill=seeded_cross(SEED + 21)),
          "int4_seeded_cross": lockstep(engine4, short, 12, dev,
                                        fill=seeded_cross(SEED + 21))}
    check(all(r["steps"] == ENCDEC_PROMPT + 11 for r in ls.values()),
          f"lockstep steps {[r['steps'] for r in ls.values()]}")
    emit({"phase": "encdec_serve", **facts, "enc_layers": cfg.enc_layers,
          "enc_seq": cfg.enc_seq, "prefill": pre, "generate": gen,
          "kv_cache_bytes_int4": engine4.kv_cache_bytes(ENCDEC_INT4_B),
          "int4": {"batch": ENCDEC_INT4_B, "decode_steps": steps4,
                   "wall_ms": wall4_ms, "step_ms": wall4_ms / steps4,
                   "capture_ms": capture4_ms, "launches": launches4},
          "graph_vs_eager": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                             for k, v in ls.items()}})
    return {"prefill": pre["launches"], "generate": gen["launches"]}


def phase_encdec_train(dev) -> dict:
    """whisper-tiny at full size: ENCDEC_TRAIN_B clips of enc_seq frames and
    ENCDEC_SEQ tokens, bf16 weights, f32 AdamW moments, remat; train_run's
    warm-up, timed steps and profile, the loss falling."""
    row = train_run(dev, ENCDEC_ARCH, batch=ENCDEC_TRAIN_B, seq_len=ENCDEC_SEQ,
                    lr=ENCDEC_LR)
    emit({"phase": "encdec_train", **row})
    return {"launches": row["launches"]}


# ---------------------------------------------------------------------------
# The distributed path: the compressed cross-pod exchange on two ranks
# ---------------------------------------------------------------------------

def dist_config(bits: int = 0) -> tuple:
    cfg = configs.load_arch(DIST_ARCH)
    return cfg, configs.run_config_for("train_4k", cfg, global_batch=DIST_B,
                                       grad_compress_bits=bits)


def full_size_shapes(cfg, rc) -> list:
    """(name, shape, dtype) of every parameter at full size, from fake
    tensors (nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    api = model_zoo.get_api(cfg, rc, "cpu")
    with FakeTensorMode():
        params = api.init(SEED)
    return [(n, tuple(p.shape), p.dtype) for n, p in params.named_parameters()]


def parts(tree) -> list:
    """Every tensor of a reference-view tree, in leaf order."""
    return [p for _, leaf in flatten(tree)
            for p in (leaf.parts if isinstance(leaf, Stacked) else [leaf])]


def on_pods(*trees):
    """Trees of one pod each -> one tree with a leading pod dimension, as
    ``collectives.exchange`` returns them."""
    def stack(*ts):
        if isinstance(ts[0], Stacked):
            return Stacked([torch.stack([t.parts[k] for t in ts])
                            for k in range(len(ts[0].parts))], ts[0].axis)
        return torch.stack(ts)
    return map_tree(stack, *trees)


def codec_outputs(grads: dict, resid: dict, bits: int) -> tuple:
    """``quantize_tree`` of the whole tree (one pod): the planes, scales and
    raw-leaf trees; the new residuals are written into ``resid``."""
    planes, scales, raw, _ = collectives.quantize_tree(
        train_step.reference_tree(grads), train_step.reference_tree(resid), bits)
    return planes, scales, raw


def phase_dist_codec(dev, smi: str) -> tuple:
    """The exchange's codec on a full-size tinyllama gradient tree (bf16
    gradients, f32 residuals of seeded noise) on the card at each bits;
    returns the inputs and the card's outputs on the host, for the CPU run."""
    cfg, rc = dist_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    grads, resid = {}, {}
    for n, shape, dt in full_size_shapes(cfg, rc):
        grads[n] = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(dt)
        resid[n] = torch.randn(shape, generator=gen, device=dev) * 1e-5
    host_in = ({n: t.cpu() for n, t in grads.items()},
               {n: t.cpu() for n, t in resid.items()})
    g_tree = train_step.reference_tree(grads)
    n_values = sum(t.numel() for t in grads.values())
    rows, outputs = {}, {}
    for bits in DIST_CODEC_BITS:
        stats = collectives.exchange_stats(g_tree, bits)
        codec_outputs(grads, {n: t.clone() for n, t in resid.items()}, bits)
        r = {n: t.clone() for n, t in resid.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes, scales, raw = codec_outputs(grads, r, bits)
        torch.cuda.synchronize()
        q_ms = (time.perf_counter() - t0) * 1e3
        one_pod = (on_pods(planes), on_pods(scales))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = collectives.dequant_mean_tree(g_tree, *one_pod, raw, bits, 1)
        torch.cuda.synchronize()
        d_ms = (time.perf_counter() - t0) * 1e3
        check(all(bool(torch.isfinite(t).all()) for t in parts(mean)),
              f"bits {bits}: non-finite dequantized gradients")
        # bytes: read g (bf16) and resid, write planes, scales and resid;
        # dequant: read planes and scales, write the gradients (bf16)
        packed = stats.wire_bytes - 4 * sum(
            t.numel() for t in parts(raw) if t is not None)
        q_bytes = n_values * (2 + 4 + 4) + packed
        d_bytes = packed + 2 * n_values
        outputs[bits] = {
            "planes": [t.view(torch.int32).cpu() for t in parts(planes)],
            "scales": [t.cpu() for t in parts(scales)],
            "resid": {n: t.cpu() for n, t in r.items()}}
        rows[bits] = {
            "quantize_pack_ms": q_ms, "unpack_dequant_ms": d_ms,
            "quantize_bound_ms": q_bytes / HBM_BYTES_PER_S * 1e3,
            "dequant_bound_ms": d_bytes / HBM_BYTES_PER_S * 1e3,
            "stats": {**dataclasses.asdict(stats), "reduction": stats.reduction}}
        del planes, scales, raw, mean, one_pod, r
    del grads, resid, g_tree
    torch.cuda.empty_cache()
    emit({"phase": "dist_codec", "arch": DIST_ARCH, "values": n_values,
          "bits": rows, "bound": "bytes over 3.35 TB/s (data sheet)",
          "nvidia_smi": smi})
    return host_in, outputs


def dist_codec_cpu(host_in: tuple, outputs: dict, result: dict) -> None:
    """The same codec on the CPU, held bit-equal to the card's outputs
    (planes, scales, new residuals); runs beside the two ranks."""
    try:
        grads, resid = host_in
        for bits in DIST_CODEC_BITS:
            r = {n: t.clone() for n, t in resid.items()}
            t0 = time.perf_counter()
            planes, scales, _ = codec_outputs(grads, r, bits)
            want = outputs[bits]
            result[bits] = {
                "cpu_s": time.perf_counter() - t0,
                "planes_equal": all(torch.equal(a.view(torch.int32), b) for a, b in
                                    zip(parts(planes), want["planes"], strict=True)),
                "scales_equal": all(torch.equal(a, b) for a, b in
                                    zip(parts(scales), want["scales"], strict=True)),
                "resid_equal": all(torch.equal(r[n], want["resid"][n]) for n in r)}
            del planes, scales, r
    except Exception as e:  # reported, and failed, by the phase
        result["error"] = repr(e)


def dist_exchange_split(api, state, batch, bits: int, mesh) -> dict:
    """One more backward, then the exchange's pieces one at a time (device
    synchronised between): quantize-and-pack, wire, dequant-mean; at bits 0
    the f32 all-reduce of the gradients."""
    params = dict(state.params.named_parameters())
    for p in params.values():
        p.grad = None
    api.loss_fn(state.params, batch).backward()
    grads = {n: p.grad for n, p in params.items()}
    out = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - t0) * 1e3
        return value

    if bits == 0:
        timed("allreduce_ms", lambda: train_step._average(
            list(grads.values()), mesh.get_group(("pod", "data")), mesh.size(("pod", "data"))))
    else:
        group = mesh.get_group("pod")
        r = {n: t[0].clone() for n, t in state.resid.items()}
        planes, scales, raw, _ = timed("quantize_pack_ms", lambda: collectives.quantize_tree(
            train_step.reference_tree(grads), train_step.reference_tree(r), bits, group))
        planes, scales = timed("wire_ms", lambda: collectives.exchange(planes, scales, group))
        timed("dequant_mean_ms", lambda: collectives.dequant_mean_tree(
            train_step.reference_tree(params), planes, scales, raw, bits,
            mesh.shape["pod"]))
    for p in params.values():
        p.grad = None
    return out


def dist_emulate(cfg, rc, api, dev) -> tuple:
    """The two ranks' compressed steps in one process: each pod's backward
    on its rows in turn, then ``quantize_tree``, the pods' planes stacked
    as the exchange stacks them, ``dequant_mean_tree`` and AdamW.  Returns
    the parameters and the residuals (n_pods, ...) by name."""
    n_pods, bits = DIST_SHAPE[0], rc.grad_compress_bits
    state = train_step.init_state(api, rc, SEED)
    params = dict(state.params.named_parameters())
    resid = collectives.init_residuals(params, n_pods)
    names = train_step.reference_tree({n: n for n in params})
    acfg, opt = train_step.adam_config(rc), state.opt
    pipe = SyntheticPipeline(cfg, rc, seed=SEED)
    rows = rc.global_batch // n_pods
    for _ in range(DIST_STEPS):
        batch_np = pipe.next()
        planes, scales, raws = [], [], []
        for i in range(n_pods):
            batch = device_batch({k: v[i * rows:(i + 1) * rows] for k, v in batch_np.items()},
                                 cfg, rc, dev)
            for p in params.values():
                p.grad = None
            api.loss_fn(state.params, batch).backward()
            grads = {n: p.grad for n, p in params.items()}
            p_, s_, raw, _ = collectives.quantize_tree(
                train_step.reference_tree(grads),
                train_step.reference_tree({n: r[i] for n, r in resid.items()}), bits)
            planes.append(p_)
            scales.append(s_)
            raws.append(map_tree(lambda t: Stacked([x.float() for x in t.parts], t.axis)
                                 if isinstance(t, Stacked) else t.float(), raw))
        for p in params.values():
            p.grad = None

        def pod_mean(*ts):
            if isinstance(ts[0], Stacked):
                return Stacked([collectives.pod_mean(torch.stack([t.parts[k] for t in ts]),
                                                     rc.torch_dtype)
                                for k in range(len(ts[0].parts))], ts[0].axis)
            return collectives.pod_mean(torch.stack(ts), rc.torch_dtype)
        mean = collectives.dequant_mean_tree(
            train_step.reference_tree(params), on_pods(*planes), on_pods(*scales),
            map_tree(pod_mean, *raws), bits, n_pods)
        grads = dict(train_step._by_name(names, mean))
        _, opt = adamw.update(grads, opt, params, acfg, adamw.global_norm(grads.values()))
    return params, resid


def dist_compare(cfg, rc, api, state, mesh, dev) -> dict:
    """Each rank's parameters and residuals after the steps against the
    one-process emulation (rank 0 runs it): ``torch.equal``, leaf by leaf."""
    import torch.distributed as dist
    state.opt.mu.clear()              # the moments are not compared: room
    state.opt.nu.clear()
    torch.cuda.empty_cache()
    emu = None
    t0 = time.perf_counter()
    if mesh.rank == 0:
        emu = dist_emulate(cfg, rc, api, dev)
    emulate_s = time.perf_counter() - t0
    dist.barrier()
    mismatched = []
    params = dict(state.params.named_parameters())
    for n, p in params.items():
        both = (collectives.all_gather(p.detach(), None),
                collectives.all_gather(state.resid[n][0], None))
        if emu is not None:
            for r in range(both[0].shape[0]):
                if not torch.equal(both[0][r], emu[0][n].detach()):
                    mismatched.append(f"param {n} rank {r}")
                if not torch.equal(both[1][r], emu[1][n][r]):
                    mismatched.append(f"resid {n} rank {r}")
    del emu
    torch.cuda.empty_cache()
    return {"emulate_s": emulate_s, "leaves": len(params),
            "mismatched": mismatched if mesh.rank == 0 else None}


def dist_run(dev, mesh, bits: int) -> dict:
    """DIST_STEPS steps of ``make_train_step`` on this rank's rows at
    ``bits``; at DIST_EQUAL_BITS the comparison with the emulation; then
    the exchange's pieces timed."""
    cfg, rc = dist_config(bits)
    check(rc.remat and rc.opt_dtype == "float32" and rc.param_dtype == "bfloat16",
          f"dist config {rc}")
    api = model_zoo.get_api(cfg, rc, dev)
    state = train_step.init_state(api, rc, SEED, mesh)
    step = train_step.make_train_step(api, cfg, rc, mesh)
    pipe = SyntheticPipeline(cfg, rc, seed=SEED)
    batches = [device_batch(pipe.next(), cfg, rc, dev, mesh) for _ in range(DIST_STEPS)]
    stats = collectives.exchange_stats(
        train_step.reference_tree(dict(state.params.named_parameters())), bits)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, times, wire = [], [], []
    for b in batches:
        collectives.reset_wire_bytes()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        wire.append(collectives.wire_bytes_sent())
    out = {"loss": losses, "step_ms": times, "wire_bytes": wire,
           "stats_wire_bytes": stats.wire_bytes if bits else 0,
           "stats": {**dataclasses.asdict(stats), "reduction": stats.reduction},
           "launches": ops.launch_counts(),
           "peak_GiB": torch.cuda.max_memory_allocated(dev) / 2**30,
           "rows": list(batches[0]["tokens"].shape),
           "resid_shape": None if state.resid is None else
           list(state.resid["layers.0.attn.wq"].shape)}
    if bits == DIST_EQUAL_BITS:
        out["equal"] = dist_compare(cfg, rc, api, state, mesh, dev)
    out["split"] = dist_exchange_split(api, state, batches[0], bits, mesh)
    del state, batches
    torch.cuda.empty_cache()
    return out


def dist_child(rank: int, workdir: str) -> int:
    """One rank of the two: the mesh over a gloo group, the runs at each
    bits; its result in ``workdir``."""
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(DIST_RANK_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=DIST_SHAPE[0])
    try:
        mesh = make_mesh(DIST_SHAPE, DIST_NAMES, dev)
        out = {"rank": rank, "coords": mesh.coords,
               "backend": dist.get_backend(mesh.get_group("pod")),
               "runs": {bits: dist_run(dev, mesh, bits) for bits in DIST_BITS}}
        Path(workdir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def phase_dist(dev, smi: str) -> dict:
    """The codec at full size on the card, held to the CPU; two ranks of
    tinyllama-1.1b on the one card; the bits-8 run held ``torch.equal`` to
    the one-process emulation."""
    host_in, outputs = phase_dist_codec(dev, smi)
    cpu = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(DIST_CPU_THREADS)
    checker = threading.Thread(target=dist_codec_cpu, args=(host_in, outputs, cpu))
    checker.start()
    torch.cuda.empty_cache()
    procs = []
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as d:
            env = dict(os.environ, PYTHONUNBUFFERED="1")
            procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--dist-rank", str(r), d], env=env)
                     for r in range(DIST_SHAPE[0])]
            deadline = time.monotonic() + DIST_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            codes = [p.returncode for p in procs]
            check(codes == [0] * len(procs), f"dist ranks exited {codes}")
            ranks = [json.loads(Path(d, f"rank{r}.json").read_text())
                     for r in range(len(procs))]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        checker.join()
        torch.set_num_threads(threads)
    ranks_s = time.perf_counter() - t0
    check("error" not in cpu, f"the codec's CPU run failed: {cpu.get('error')}")
    for bits in DIST_CODEC_BITS:
        c = cpu[bits]
        check(c["planes_equal"] and c["scales_equal"] and c["resid_equal"],
              f"bits {bits}: the card's codec differs from the CPU's: {c}")
    cfg, _ = dist_config()
    calls = attention_calls(cfg)
    want = {"flash_attention.flash_fwd": 2 * calls * DIST_STEPS,
            "flash_attention.flash_bwd_dkv": calls * DIST_STEPS,
            "flash_attention.flash_bwd_dq": calls * DIST_STEPS}
    runs = {int(b): [r["runs"][b] for r in ranks] for b in ranks[0]["runs"]}
    for bits, rs in runs.items():
        for rank, r in enumerate(rs):
            got = {k: v for k, v in r["launches"].items() if v}
            check(got == want, f"bits {bits} rank {rank} launched {got}, want {want}")
            check(all(np.isfinite(r["loss"])), f"bits {bits}: loss {r['loss']}")
            check(r["loss"] == rs[0]["loss"], f"bits {bits}: ranks' losses differ")
            check(r["rows"] == [DIST_B // DIST_SHAPE[0], configs.SHAPES["train_4k"][0]],
                  f"rank rows {r['rows']}")
            if bits:
                check(r["wire_bytes"] == [r["stats_wire_bytes"]] * DIST_STEPS,
                      f"bits {bits}: sent {r['wire_bytes']}, ExchangeStats "
                      f"{r['stats_wire_bytes']}")
                check(r["resid_shape"][0] == 1, f"residual shape {r['resid_shape']}")
            else:
                check(r["wire_bytes"] == [0] * DIST_STEPS, "bits 0 sent codec bytes")
    equal = runs[DIST_EQUAL_BITS][0]["equal"]
    check(equal["mismatched"] == [],
          f"the two ranks differ from the one-process emulation: {equal['mismatched'][:8]}")
    track = {b: abs(runs[b][0]["loss"][-1] - runs[0][0]["loss"][-1]) for b in DIST_TRACK}
    for b, tol in DIST_TRACK.items():
        check(track[b] < tol, f"bits {b} ends {track[b]} from bits 0's loss (< {tol})")
    emit({"phase": "dist", "arch": DIST_ARCH, "mesh": dict(zip(DIST_NAMES, DIST_SHAPE)),
          "backend": ranks[0]["backend"], "batch": DIST_B,
          "seq": configs.SHAPES["train_4k"][0],
          "reduced": {"global_batch": [configs.SHAPES["train_4k"][1], DIST_B]},
          "ranks_s": ranks_s, "codec_cpu": cpu,
          "equal_to_emulation": {"bits": DIST_EQUAL_BITS, **equal},
          "last_loss_from_bits0": track,
          "runs": {b: {"loss": rs[0]["loss"],
                       "step_ms": [r["step_ms"] for r in rs],
                       "step_ms_median": float(np.median([t for r in rs for t in r["step_ms"]])),
                       "exchange_split_ms": [r["split"] for r in rs],
                       "wire_bytes_per_step": rs[0]["wire_bytes"],
                       "stats": rs[0]["stats"],
                       "peak_GiB": [r["peak_GiB"] for r in rs]}
                   for b, rs in runs.items()},
          "nvidia_smi": smi})
    return {f"tinyllama_2ranks_3_steps_bits{b}": {
        k: sum(r["launches"].get(k, 0) for r in rs) for k in ops.launch_counts()}
        for b, rs in runs.items()}


def tp_config(**kw) -> tuple:
    cfg = configs.load_arch(TP_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=TP_LAYERS)
    return cfg, configs.run_config_for("train_4k", cfg, global_batch=TP_B, **kw)


def _kv_gathered(H: int, KV: int, hd: int, tp: int) -> bool:
    """Whether attention gathers k and v over ``model`` (``layers._heads``'
    rule, from the shapes): a rank's KV block cuts a head, or the query
    heads covering a rank's query block read KV heads outside its KV
    block."""
    qc, kc = H * hd // tp, KV * hd // tp
    if (KV * hd) % tp or tp == 1:
        return False
    if kc % hd:
        return True
    G = H // KV
    for r in range(tp):
        lo, hi = r * qc // hd, -(-(r + 1) * qc // hd)
        if lo // G < r * kc // hd or (hi - 1) // G + 1 > (r + 1) * kc // hd:
            return True
    return False


def tp_bytes(cfg, rc, shape: tuple, names: tuple = DIST_NAMES) -> dict:
    """The bytes each differentiable collective is handed a rank and step
    (``collectives.collective_bytes``: a gather counts the block it sends,
    in its dtype; a reduction the f32 tensor it reduces) on a mesh of
    ``shape`` over ``names``, from the shapes, for the dense, ssm, hybrid
    and encdec families.

    B = the global batch over the batch ranks (pod x data), S the sequence,
    d the width, tp the ``model`` axis, data the ``data`` axis; a rule that
    names ``model`` cuts a dimension n to n / tp where tp divides it, else
    keeps it whole.  Each layer's forward, in call order:

    * decoder-only: where the stream is split (``seq_shard``, tp | S), the
      normed stream gathered before the mixers and before the MLP (a block
      of B x S/tp x d each); every family's stream is whole in encdec;
    * ZeRO-3 (data > 1): each weight the ``fsdp`` rule shards gathered over
      ``data`` on first use (this rank's block of its tp block);
    * attention (q and kv heads cut): q gathered (B x S x its columns)
      where its block cuts a head; k and v gathered (``kv_gathered``) where
      their block cuts a head or the covering query heads read another
      rank's KV heads (``_kv_gathered``); the out-projection's f32 B x S x d
      partial reduce-scattered onto the split stream, else all-reduced
      (``proj_out``);
    * the SSD: the ``in_proj`` product's block (B x S x W/tp, W = 2 di + 2 N
      + H) gathered where tp divides W, the conv's weights and bias where
      tp divides di + 2 N; where tp divides di, the gated norm's f32 sums of
      squares (B x S) all-reduced and the out-projection as attention's;
    * the MLP (ff cut): its out-projection as attention's; encdec's encoder
      layers run at the frames' length (``enc_seq``), its cross-attention's
      k and v too.

    Backward runs each one's adjoint once: a gather's is a reduce-scatter
    of the whole f32 gradient (tp or data times the block), a
    reduce-scatter's a gather of the f32 block, an all-reduce's an
    all-reduce.  With remat (``full``) the recompute runs the layer's
    collectives again but the last out-projection's (the checkpoint stops
    at the last tensor backward needs); under ``save_collectives`` all but
    those named ``proj_out`` and ``kv_gathered``.  Outside the layers: the
    table (and the unembedding, or the tied table again for the loss)
    gathered over ``data``; where tp divides the vocabulary the embedding's
    all-reduce (B x S x d) and its adjoint, and the loss's max, sum of
    exponentials and gold logit (B x S each, again in each chunk's
    recompute, the last two with their adjoints: 8 x B x S); the stream
    gathered after the last layer where it is split; the grad norm's f32
    scalar once for each set of axes the leaves are split over."""
    from repro_torch.launch.mesh import abstract_mesh
    sizes = dict(zip(names, shape))
    pod, data, tp = (sizes.get(a, 1) for a in ("pod", "data", "model"))
    if cfg.family not in ("dense", "ssm", "hybrid", "encdec"):
        raise ValueError(f"tp_bytes has no formula for the {cfg.family} family")
    B, S, d, L = rc.global_batch // (pod * data), rc.seq_len, cfg.d_model, cfg.n_layers
    g = 2 if rc.param_dtype == "bfloat16" else 4      # a gather's dtype
    V = cfg.vocab

    def cut(n: int) -> int:
        return n // tp if n % tp == 0 else n

    split = cfg.family != "encdec" and rc.seq_shard and tp > 1 and S % tp == 0
    vocab_cut = rc.shard_vocab and tp > 1 and V % tp == 0
    moved = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}

    def add(kind: str, n: int, *, again: bool = False) -> None:
        """One collective of n values (a gather: its block; a reduction:
        the tensor) and its adjoint; ``again`` once more in a recompute."""
        for _ in range(2 if again else 1):
            if kind == "gather_model" or kind == "gather_data":
                moved["all_gather"] += n * g
            elif kind == "scatter":
                moved["reduce_scatter"] += n * 4
            else:
                moved["all_reduce"] += n * 4
        if kind == "gather_model":
            moved["reduce_scatter"] += n * tp * 4
        elif kind == "gather_data":
            moved["reduce_scatter"] += n * data * 4
        elif kind == "scatter":
            moved["all_gather"] += n // tp * 4
        else:
            moved["all_reduce"] += n * 4

    def zero(*weights: int) -> list:
        return [("gather_data", w // data, None) for w in weights] if data > 1 else []

    def out(n: int) -> list:
        return [("scatter" if split else "reduce", n, "proj_out")]

    def attention(Sq: int, Sk: int) -> list:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        qc, kc = cut(H * hd), cut(KV * hd)
        ev = zero(d * qc, d * kc, d * kc)
        if qc < H * hd and qc % hd:
            ev.append(("gather_model", B * Sq * qc, None))
        if _kv_gathered(H, KV, hd, tp):
            ev += [("gather_model", B * Sk * kc, "kv_gathered")] * 2
        ev += zero(qc * d)
        return ev + (out(B * Sq * d) if qc < H * hd else [])

    def ssd() -> list:
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        W, C = 2 * di + 2 * N + H, di + 2 * N
        ev = zero(d * cut(W))
        if cut(W) < W:
            ev.append(("gather_model", B * S * W // tp, None))
        if cut(C) < C:
            ev += [("gather_model", cfg.ssm_conv * C // tp, None),
                   ("gather_model", C // tp, None)]
        ev += zero(cut(di) * d)
        if cut(di) < di:
            ev += [("reduce", B * S, None)] + out(B * S * d)
        return ev

    def mlp(Sx: int) -> list:
        ff = cut(cfg.d_ff)
        ev = zero(*([d * ff] * (2 if cfg.mlp_act == "swiglu" else 1)), ff * d)
        return ev + (out(B * Sx * d) if ff < cfg.d_ff else [])

    stream = [("gather_model", B * S // tp * d, None)] if split else []
    if cfg.family == "encdec":
        Se = cfg.enc_seq
        layers = [attention(Se, Se) + mlp(Se)] * cfg.enc_layers
        layers += [attention(S, S) + attention(S, Se) + mlp(S)] * L
    else:
        mix = stream + (attention(S, S) if cfg.family != "ssm" else []) \
            + (ssd() if cfg.family in ("ssm", "hybrid") else [])
        layers = [mix + (stream + mlp(S) if cfg.family != "ssm" else [])] * L
    for ev in layers:
        for i, (kind, n, name) in enumerate(ev):
            if not rc.remat:
                again = False
            elif rc.remat_policy == "save_collectives":
                again = name not in ("proj_out", "kv_gathered")
            else:
                again = not (i == len(ev) - 1 and name == "proj_out")
            add(kind, n, again=again)
    table = cut(V) * d if vocab_cut else V * d
    for kind, n, _ in zero(table, table):   # the embedding's, the loss's
        add(kind, n)
    if vocab_cut:
        add("reduce", B * S * d)
        moved["all_reduce"] += 8 * B * S * 4
    for kind, n, _ in stream:
        add(kind, n)
    specs = train_step.param_partition(model_zoo.get_api(cfg, rc, "cpu"), rc,
                                       abstract_mesh(shape, names))
    groups = {frozenset(a for part in sp if part
                        for a in ((part,) if isinstance(part, str) else part)
                        if a in ("data", "model") and sizes.get(a, 1) > 1)
              for sp in specs.values()}
    moved["all_reduce"] += 4 * len(groups - {frozenset()})
    return moved


def tp_child(rank: int, workdir: str) -> int:
    """One rank of the four: the mesh over a gloo group, TP_STEPS steps,
    then one more from the same state under each remat policy."""
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(TP_RANK_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=int(np.prod(TP_SHAPE)))
    try:
        mesh = make_mesh(TP_SHAPE, TP_NAMES, dev)
        cfg, rc = tp_config()
        check(rc.remat and rc.fsdp and rc.seq_shard and rc.opt_dtype == "float32"
              and rc.param_dtype == "bfloat16", f"tp config {rc}")
        api = model_zoo.get_api(cfg, rc, dev)
        t0 = time.perf_counter()
        state = train_step.init_state(api, rc, SEED, mesh)
        init_s = time.perf_counter() - t0
        specs = train_step.param_partition(api, rc, mesh)
        params = dict(state.params.named_parameters())
        held = sum(p.numel() for p in params.values())
        moments = sum(t.numel() for t in (*state.opt.mu.values(), *state.opt.nu.values()))
        step = train_step.make_train_step(api, cfg, rc, mesh)
        pipe = SyntheticPipeline(cfg, rc, seed=SEED)
        batches = [device_batch(pipe.next(), cfg, rc, dev, mesh)
                   for _ in range(TP_STEPS + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        losses, times, moved = [], [], []
        for b in batches[:TP_STEPS]:
            collectives.reset_collective_bytes()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            moved.append(collectives.collective_bytes())
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        # one more step from the same state under each remat policy
        snap = {n: p.detach().clone() for n, p in params.items()}
        snap_mu = {n: t.clone() for n, t in state.opt.mu.items()}
        snap_nu = {n: t.clone() for n, t in state.opt.nu.items()}
        count, step_num = state.opt.count.clone(), state.step.clone()
        policy_out, after = {}, None
        for policy in ("save_collectives", "full"):
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(snap[n])
                    state.opt.mu[n].copy_(snap_mu[n])
                    state.opt.nu[n].copy_(snap_nu[n])
                state.opt.count.copy_(count)
                state.step.copy_(step_num)
            rc_p = dataclasses.replace(rc, remat_policy=policy, tp_scatter=True)
            step_p = train_step.make_train_step(model_zoo.get_api(cfg, rc_p, dev),
                                                cfg, rc_p, mesh)
            collectives.reset_collective_bytes()
            t0 = time.perf_counter()
            state, m = step_p(state, batches[TP_STEPS])
            loss = float(m["loss"])
            torch.cuda.synchronize()
            policy_out[policy] = {"loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
                                  "moved": collectives.collective_bytes()}
            if after is None:
                after = {n: p.detach().clone() for n, p in params.items()}
            else:
                policy_out["equal"] = policy_out["save_collectives"]["loss"] == loss \
                    and all(torch.equal(after[n], p) for n, p in params.items())
        del snap, snap_mu, snap_nu, after
        out = {"rank": rank, "coords": mesh.coords,
               "backend": dist.get_backend(mesh.get_group("model")),
               "init_s": init_s, "held": held, "moments": moments,
               "sharded_leaves": sum(1 for sp in specs.values() if any(sp)),
               "loss": losses, "step_ms": times, "moved": moved,
               "launches": launches, "peak_GiB": peak, "policies": policy_out,
               "rows": list(batches[0]["tokens"].shape),
               "local_wq": list(params["layers.0.attn.wq"].shape),
               "local_wk": list(params["layers.0.attn.wk"].shape),
               "spec_wq": list(map(str, specs["layers.0.attn.wq"]))}
        Path(workdir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def tp_expected_held(cfg, rc, shape: tuple = TP_SHAPE, names: tuple = TP_NAMES) -> int:
    """Weights a rank holds on a mesh of ``shape`` over ``names``, from the
    rules: each leaf's whole size over the sizes of the axes its spec
    names."""
    from repro_torch.launch.mesh import abstract_mesh
    api = model_zoo.get_api(cfg, rc, "cpu")
    sizes = dict(zip(names, shape))
    specs = train_step.param_partition(api, rc, abstract_mesh(shape, names))
    held = 0
    for n, shape in train_step.full_shapes(api).items():
        div = int(np.prod([sizes[a] for part in specs[n]
                           for a in ((part,) if isinstance(part, str) else part or ())]))
        held += int(np.prod(shape)) // div
    return held


def phase_tp(dev, smi: str, copy_rate: float) -> dict:
    """Four ranks of tinyllama-1.1b on (2, 2) data x model on the one card
    against a one-process run of the same global batch from the same
    weights; the flash kernels at a rank's shape."""
    torch.cuda.empty_cache()
    procs = []
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as d:
            env = dict(os.environ, PYTHONUNBUFFERED="1")
            procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--tp-rank", str(r), d], env=env)
                     for r in range(int(np.prod(TP_SHAPE)))]
            deadline = time.monotonic() + TP_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            codes = [p.returncode for p in procs]
            check(codes == [0] * len(procs), f"tp ranks exited {codes}")
            ranks = [json.loads(Path(d, f"rank{r}.json").read_text())
                     for r in range(len(procs))]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    # the one-process run: the whole global batch from the same weights
    cfg, rc = tp_config()
    api = model_zoo.get_api(cfg, rc, dev)
    state = train_step.init_state(api, rc, SEED)
    step = train_step.make_train_step(api, cfg, rc)
    pipe = SyntheticPipeline(cfg, rc, seed=SEED)
    ops.reset_launch_counts()
    single, single_ms = [], []
    for _ in range(TP_STEPS):
        b = device_batch(pipe.next(), cfg, rc, dev)
        t1 = time.perf_counter()
        state, m = step(state, b)
        single.append(float(m["loss"]))
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t1) * 1e3)
    single_launches = ops.launch_counts()
    del state, step, b
    torch.cuda.empty_cache()
    want_held = tp_expected_held(cfg, rc)
    want_bytes = tp_bytes(cfg, rc, TP_SHAPE, TP_NAMES)
    for r in ranks:
        check(all(np.isfinite(r["loss"])), f"rank {r['rank']} loss {r['loss']}")
        gap = max(abs(a - b) for a, b in zip(r["loss"], single))
        check(gap < TP_LOSS_TOL, f"rank {r['rank']} losses {r['loss']} against "
              f"the one-process run's {single} (< {TP_LOSS_TOL})")
        check(r["held"] == want_held and r["moments"] == 2 * want_held,
              f"rank {r['rank']} holds {r['held']} weights, {r['moments']} "
              f"moments; want {want_held}, {2 * want_held}")
        got = {k: v for k, v in r["launches"].items() if v}
        want = {k: v for k, v in single_launches.items() if v}
        check(got == want, f"rank {r['rank']} launched {got}, the one-process "
              f"run {want}")
        check(all(m == want_bytes for m in r["moved"]),
              f"rank {r['rank']} moved {r['moved']}, want {want_bytes}")
        check(r["policies"]["equal"], f"rank {r['rank']}: save_collectives differs "
              f"from full: {r['policies']}")
        check(r["rows"] == [TP_B // TP_SHAPE[0], rc.seq_len], f"rows {r['rows']}")
    fwd = windowed_fwd(dev, (TP_B // TP_SHAPE[0], rc.seq_len, cfg.n_kv_heads // TP_SHAPE[1],
                             cfg.n_heads // cfg.n_kv_heads, cfg.hd), 0, copy_rate)
    bwd = windowed_bwd(dev, (TP_B // TP_SHAPE[0], rc.seq_len, cfg.n_kv_heads // TP_SHAPE[1],
                             cfg.n_heads // cfg.n_kv_heads, cfg.hd), 0, copy_rate)
    torch.cuda.empty_cache()
    emit({"phase": "tp", "arch": TP_ARCH, "mesh": dict(zip(TP_NAMES, TP_SHAPE)),
          "backend": ranks[0]["backend"], "n_layers": cfg.n_layers,
          "batch": TP_B, "seq": rc.seq_len,
          "reduced": {"global_batch": [configs.SHAPES["train_4k"][1], TP_B],
                      "n_layers": [configs.load_arch(TP_ARCH).n_layers, TP_LAYERS]},
          "ranks_s": ranks_s, "held": [r["held"] for r in ranks],
          "held_want": want_held, "whole_weights": sum(
              int(np.prod(s)) for s in train_step.full_shapes(
                  model_zoo.get_api(cfg, rc, "cpu")).values()),
          "local_wq_wk": [ranks[0]["local_wq"], ranks[0]["local_wk"]],
          "spec_wq": ranks[0]["spec_wq"],
          "loss": [r["loss"] for r in ranks], "single_loss": single,
          "single_step_ms": single_ms,
          "step_ms": [r["step_ms"] for r in ranks],
          "step_ms_median": float(np.median([t for r in ranks for t in r["step_ms"]])),
          "moved_per_step": ranks[0]["moved"][0], "moved_formula": want_bytes,
          "init_s": [r["init_s"] for r in ranks],
          "peak_GiB": [r["peak_GiB"] for r in ranks],
          "policies": [r["policies"] for r in ranks],
          "launches_per_rank": ranks[0]["launches"],
          "flash_at_rank_shape": {"fwd": fwd, "bwd": {k: v for k, v in bwd.items()
                                                      if k != "rows"},
                                  "bwd_rows": bwd["rows"]},
          "nvidia_smi": smi})
    return {"launches": {f"tinyllama_tp_2x2_{TP_STEPS}_steps": {
        k: sum(r["launches"].get(k, 0) for r in ranks) for k in ops.launch_counts()}},
        "fwd": fwd, "bwd": bwd["rows"]}



def tpf_config(arch: str, n_layers: int, seq: int) -> tuple:
    cfg = configs.load_arch(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, configs.run_config_for("train_4k", cfg, seq_len=seq,
                                       global_batch=TPF_B)


def tpf_heads(cfg, rc, mesh) -> dict:
    """The heads this rank computes under the rules: the SSD's (covering
    its block of di rows) and attention's (covering its query block), and
    the (KV, G) its flash launches take."""
    from repro_torch.models import layers as model_layers
    from repro_torch.models import ssm as model_ssm
    from repro_torch.distributed import sharding as shd
    out = {}
    with shd.use_rules(train_step.rules_for(rc, mesh)):
        if cfg.family in ("ssm", "hybrid"):
            out["ssd_heads"] = list(model_ssm._ssd_heads(cfg).heads)
        if cfg.n_heads:
            plan = model_layers._heads(cfg)
            nq = plan.q[1] - plan.q[0]
            kv = nq if plan.kv_index is not None else plan.kv_local[1] - plan.kv_local[0]
            out.update(q_heads=list(plan.q), q_gathered=plan.q_gather,
                       kv_gathered=plan.kv_gather, kv_g=[kv, nq // kv])
    return out


def tpf_child(rank: int, workdir: str) -> int:
    """One rank of the four: each TPF_RUNS mesh over a gloo group in turn,
    TPF_STEPS steps of its model from the seed's weights."""
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(TP_RANK_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=4)
    try:
        out = {"rank": rank, "runs": {}}
        for arch, shape, n_layers, seq in TPF_RUNS:
            mesh = make_mesh(shape, TP_NAMES, dev)
            cfg, rc = tpf_config(arch, n_layers, seq)
            check(rc.remat and rc.fsdp and rc.seq_shard and rc.opt_dtype == "float32"
                  and rc.param_dtype == "bfloat16", f"tp_families config {rc}")
            api = model_zoo.get_api(cfg, rc, dev)
            t0 = time.perf_counter()
            state = train_step.init_state(api, rc, SEED, mesh)
            init_s = time.perf_counter() - t0
            params = dict(state.params.named_parameters())
            held = sum(p.numel() for p in params.values())
            moments = sum(t.numel() for t in (*state.opt.mu.values(),
                                              *state.opt.nu.values()))
            step = train_step.make_train_step(api, cfg, rc, mesh)
            pipe = SyntheticPipeline(cfg, rc, seed=SEED)
            batches = [device_batch(pipe.next(), cfg, rc, dev, mesh)
                       for _ in range(TPF_STEPS)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            losses, times, moved = [], [], []
            for b in batches:
                collectives.reset_collective_bytes()
                t0 = time.perf_counter()
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                moved.append(collectives.collective_bytes())
            out["runs"][arch] = {
                "coords": mesh.coords, "init_s": init_s, "held": held,
                "moments": moments, "loss": losses, "step_ms": times,
                "moved": moved, "launches": ops.launch_counts(),
                "peak_GiB": torch.cuda.max_memory_allocated(dev) / 2**30,
                "rows": list(batches[0]["tokens"].shape),
                "heads": tpf_heads(cfg, rc, mesh)}
            del state, step, batches, params, api
            torch.cuda.empty_cache()
        Path(workdir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def tpf_flash(dev, copy_rate: float, runs: dict) -> dict:
    """Rows 6-8 at the shapes the ranks launched (rank 0's; every rank's
    (KV, G) checked equal): hymba's windowed causal self-attention, and
    whisper's encoder, cross and decoder attention. -> {label: {kernel:
    row}}."""
    out = {}
    for arch, label, S, Sk, causal in (
            ("hymba-1.5b", "hymba_window", 4096, 4096, True),
            ("whisper-tiny", "whisper_encoder", 1500, 1500, False),
            ("whisper-tiny", "whisper_cross", ENCDEC_SEQ, 1500, False),
            ("whisper-tiny", "whisper_decoder", ENCDEC_SEQ, ENCDEC_SEQ, True)):
        per_rank = runs[arch]
        kv_g = {tuple(r["heads"]["kv_g"]) for r in per_rank}
        check(len(kv_g) == 1, f"{arch}: ranks launch (KV, G) {kv_g}")
        cfg = configs.load_arch(arch)
        shape = (per_rank[0]["rows"][0], S, *next(iter(kv_g)), cfg.hd)
        window = cfg.sliding_window if causal else 0
        fwd = windowed_fwd(dev, shape, window, copy_rate, causal, Sk)
        bwd = windowed_bwd(dev, shape, window, copy_rate, causal, Sk)
        out[label] = {"flash_attention.flash_fwd": fwd, **bwd["rows"],
                      "bwd_checks": {k: v for k, v in bwd.items() if k != "rows"}}
        torch.cuda.empty_cache()
    return out


def phase_tp_families(dev, smi: str, copy_rate: float) -> dict:
    """The ssm, hybrid and encdec families on four ranks of the one card
    (TPF_RUNS) against one-process runs of the same global batch from the
    same weights; the flash kernels at the shapes a rank launched."""
    torch.cuda.empty_cache()
    procs = []
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tpf_") as d:
            env = dict(os.environ, PYTHONUNBUFFERED="1")
            procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--tp-families-rank", str(r), d], env=env)
                     for r in range(4)]
            deadline = time.monotonic() + TPF_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            codes = [p.returncode for p in procs]
            check(codes == [0] * len(procs), f"tp_families ranks exited {codes}")
            ranks = [json.loads(Path(d, f"rank{r}.json").read_text())
                     for r in range(len(procs))]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    runs, report, launches = {}, {}, {}
    for arch, shape, n_layers, seq in TPF_RUNS:
        cfg, rc = tpf_config(arch, n_layers, seq)
        api = model_zoo.get_api(cfg, rc, dev)
        state = train_step.init_state(api, rc, SEED)
        step = train_step.make_train_step(api, cfg, rc)
        pipe = SyntheticPipeline(cfg, rc, seed=SEED)
        ops.reset_launch_counts()
        single, single_ms = [], []
        for _ in range(TPF_STEPS):
            b = device_batch(pipe.next(), cfg, rc, dev)
            t1 = time.perf_counter()
            state, m = step(state, b)
            single.append(float(m["loss"]))
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t1) * 1e3)
        single_launches = {k: v for k, v in ops.launch_counts().items() if v}
        del state, step, b, api
        torch.cuda.empty_cache()
        want_held = tp_expected_held(cfg, rc, shape, TP_NAMES)
        want_bytes = tp_bytes(cfg, rc, shape, TP_NAMES)
        per_rank = [r["runs"][arch] for r in ranks]
        for i, r in enumerate(per_rank):
            who = f"{arch} rank {i}"
            check(all(np.isfinite(r["loss"])), f"{who} loss {r['loss']}")
            gap = max(abs(a - b) for a, b in zip(r["loss"], single))
            check(gap < TP_LOSS_TOL, f"{who} losses {r['loss']} against the "
                  f"one-process run's {single} (< {TP_LOSS_TOL})")
            check(r["held"] == want_held and r["moments"] == 2 * want_held,
                  f"{who} holds {r['held']} weights, {r['moments']} moments; "
                  f"want {want_held}, {2 * want_held}")
            got = {k: v for k, v in r["launches"].items() if v}
            check(got == single_launches, f"{who} launched {got}, the "
                  f"one-process run {single_launches}")
            check(all(m == want_bytes for m in r["moved"]),
                  f"{who} moved {r['moved']}, want {want_bytes}")
            check(r["rows"] == [TPF_B // shape[0], seq], f"{who} rows {r['rows']}")
            ssd = r["heads"].get("ssd_heads")
            check(ssd is None or ssd[1] - ssd[0] < cfg.ssm_heads,
                  f"{who} runs the SSD on heads {ssd} of {cfg.ssm_heads}")
        runs[arch] = per_rank
        path = f"{arch}_{cfg.n_layers}L_tp_{shape[0]}x{shape[1]}_{TPF_STEPS}_steps"
        launches[path] = {k: sum(r["launches"].get(k, 0) for r in per_rank)
                          for k in ops.launch_counts()}
        report[arch] = {
            "mesh": dict(zip(TP_NAMES, shape)), "n_layers": cfg.n_layers,
            "seq": seq, "enc_seq": cfg.enc_seq or None,
            "reduced": {"global_batch": [configs.SHAPES["train_4k"][1], TPF_B],
                        **({"n_layers": [configs.load_arch(arch).n_layers, n_layers]}
                           if n_layers else {})},
            "held": [r["held"] for r in per_rank], "held_want": want_held,
            "whole_weights": sum(int(np.prod(s)) for s in train_step.full_shapes(
                model_zoo.get_api(cfg, rc, "cpu")).values()),
            "loss": [r["loss"] for r in per_rank], "single_loss": single,
            "single_step_ms": single_ms, "step_ms": [r["step_ms"] for r in per_rank],
            "step_ms_median": float(np.median([t for r in per_rank for t in r["step_ms"]])),
            "moved_per_step": per_rank[0]["moved"][0], "moved_formula": want_bytes,
            "init_s": [r["init_s"] for r in per_rank],
            "peak_GiB": [r["peak_GiB"] for r in per_rank],
            "heads": [r["heads"] for r in per_rank],
            "launches_per_rank": {k: v for k, v in per_rank[0]["launches"].items() if v}}
    flash = tpf_flash(dev, copy_rate, runs)
    emit({"phase": "tp_families", "backend": "gloo", "ranks_s": ranks_s,
          "batch": TPF_B, "steps": TPF_STEPS, "runs": report,
          "flash_at_rank_shapes": flash, "nvidia_smi": smi})
    return {"launches": launches,
            "flash": {label: {k: v for k, v in rows.items() if k != "bwd_checks"}
                      for label, rows in flash.items()}}


def add_family_paths(rows: list, prefill: dict, serve: dict, trained: dict,
                     paths: dict) -> None:
    """The kv and flash rows of the kernels line: their launches on every LM
    path run (``launches`` stays the first path's), and the flash rows'
    windowed times at hymba's shapes and times at whisper-tiny's three."""
    by_path = {
        "granite8b_prefill": prefill["launches"],
        "granite8b_generate": serve["launches"],
        "tinyllama_train_3_steps": trained["launches"],
        "mixtral16L_prefill": paths["moe_serve"]["prefill"],
        "mixtral16L_generate": paths["moe_serve"]["generate"],
        "hymba_prefill": paths["hybrid_serve"]["prefill"],
        "hymba_generate": paths["hybrid_serve"]["generate"],
        "mamba2_prefill": paths["ssm_serve"]["prefill"],
        "mamba2_generate": paths["ssm_serve"]["generate"],
        "hymba_train_3_steps": paths["families_train"]["hybrid"],
        "mamba2_train_3_steps": paths["families_train"]["ssm"],
        "whisper_prefill": paths["encdec_serve"]["prefill"],
        "whisper_generate": paths["encdec_serve"]["generate"],
        "whisper_train_3_steps": paths["encdec_train"]["launches"],
        **paths["dist"], **paths["tp"]["launches"],
        **paths["tp_families"]["launches"]}
    windowed = {"flash_attention.flash_fwd": paths["hybrid_serve"]["window_fwd"],
                **paths["families_train"]["window_bwd"]}
    keep = ("shape", "window", "ms", "plain_ms", "library_ms", "library_backend",
            "bound_ms", "bound_by", "share_of_bound")
    for r in rows:
        if r["name"].startswith(("kvpack.", "flash_attention.")):
            r["launches_by_path"] = {k: v[r["name"]] for k, v in by_path.items()}
        if r["name"] in windowed:
            r["at_hymba_window"] = {k: windowed[r["name"]][k] for k in keep}
        tp = {"flash_attention.flash_fwd": paths["tp"]["fwd"], **paths["tp"]["bwd"]}
        if r["name"] in tp:
            r["at_tp_rank_shape"] = {k: tp[r["name"]][k] for k in keep}
        if r["name"].startswith("flash_attention."):
            r["at_tp_families_rank_shapes"] = {
                label: {k: v for k, v in rows_[r["name"]].items()
                        if k in keep + ("causal", "Sk")}
                for label, rows_ in paths["tp_families"]["flash"].items()}
            r["at_whisper_shapes"] = {
                label: {k: v for k, v in rows_[r["name"]].items()
                        if k in keep + ("causal",)}
                for label, rows_ in paths["encdec_flash"].items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dist-rank"]:       # one of phase_dist's ranks
        return dist_child(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--tp-rank"]:         # one of phase_tp's ranks
        return tp_child(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--tp-families-rank"]:   # one of phase_tp_families'
        return tpf_child(int(sys.argv[2]), sys.argv[3])
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
    torch.cuda.empty_cache()

    phase_families_parity(dev)
    paths = {"moe_serve": phase_moe_serve(dev)}
    torch.cuda.empty_cache()
    paths["hybrid_serve"] = phase_hybrid_serve(dev, copy_rate)
    torch.cuda.empty_cache()
    paths["ssm_serve"] = phase_ssm_serve(dev)
    torch.cuda.empty_cache()
    paths["families_train"] = phase_families_train(dev, copy_rate)
    torch.cuda.empty_cache()

    phase_encdec_parity(dev)
    paths["encdec_flash"] = phase_encdec_flash(dev, copy_rate)
    torch.cuda.empty_cache()
    paths["encdec_serve"] = phase_encdec_serve(dev)
    torch.cuda.empty_cache()
    paths["encdec_train"] = phase_encdec_train(dev)
    torch.cuda.empty_cache()
    paths["dist"] = phase_dist(dev, smi)
    torch.cuda.empty_cache()
    paths["tp"] = phase_tp(dev, smi, copy_rate)
    torch.cuda.empty_cache()
    paths["tp_families"] = phase_tp_families(dev, smi, copy_rate)
    add_family_paths(rows, prefill, serve, trained, paths)
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
