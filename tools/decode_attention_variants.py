#!/usr/bin/env python3
"""What bounds the decode attention kernel: time it beside copies of its
source with one part taken out.

Builds ``csrc/decode_attention.cu`` as it stands and three variants, each
into its own library (one nvcc each, all at once): ``noload`` issues no
copy from device memory (the ring's stages keep what they hold),
``nodeq`` dequantizes nothing (the tile is zeros), ``nowork`` takes no
product from the tile (no mma, no score written).  Each variant computes
garbage; only its time is read.  Then times each (CUDA events around
back-to-back calls) at granite-8b's serve shape and at one granite-8b
layer of 32,768 slots, every slot valid, and at granite's chat batch at
position 511 of 2,048 and the 32k layer at 29,696 (``chip_smoke.DA_TIMED``),
int8 and int4, bf16, through the port's own wrapper with the library
swapped.  A part whose removal saves little is not what bounds the kernel.

    python3 tools/decode_attention_variants.py        # on a machine with the card

Prints one JSON object: ms of each shape and variant, and the card.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

SHAPES = ("granite_serve", "granite_32k", "granite_chat_p511", "granite_32k_p29696")


def variants(src: str) -> dict:
    """The source, and copies with one part taken out."""
    def cut(old, new):
        if old not in src:
            raise SystemExit(f"the source no longer holds {old!r}")
        return src.replace(old, new)
    return {"base": src,
            "noload": cut("    if (t < t1)\n      issue_tile",
                          "    if (t < 0)\n      issue_tile"),
            "nodeq": cut("    if (FULL || (jj >= r0 && jj < r1)) dequant8<CODE, HD>(row, sc[jj], cu, v);",
                         "    if (jj < 0) dequant8<CODE, HD>(row, sc[jj], cu, v);"),
            "nowork": cut("      work(i);\n", "      if (t1 < 0) work(i);\n")}


def build(out: Path) -> dict:
    """One library a variant, built in parallel from copies of the sources
    (the header with its variant, the bf16 launcher beside it)."""
    csrc = _build.CSRC
    head = (csrc / "decode_attention.cuh").read_text()
    procs = {}
    for name, text in variants(head).items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_attention.cuh").write_text(text)
        (d / "decode_attention.cu").write_text((csrc / "decode_attention.cu").read_text())
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "decode_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kv_decode_attention_launch.argtypes = da.ARGTYPES
        lib.kv_decode_attention_launch.restype = da._I
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_attention_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = build(_build.BUILD_DIR / "decode_attention_variants")
    rng = np.random.default_rng(cs.SEED)
    out = {"device": torch.cuda.get_device_name(0), "ms": {}}
    real = da._lib
    try:
        for label in SHAPES:
            B, S, KV, G, hd, window, at = cs.DA_TIMED[label]
            for bits in (8, 4):
                cache = cs.da_inputs(dev, rng, B, S, KV, hd, bits, torch.bfloat16)
                q = torch.from_numpy(rng.standard_normal((B, 1, KV * G, hd)).astype(
                    np.float32)).to(dev).to(torch.bfloat16)
                pos = torch.full((B,), S - 1 if at is None else at,
                                 dtype=torch.int32, device=dev)
                for name, lib in libs.items():
                    da._lib = lambda bf16, lib=lib: lib
                    out["ms"][f"{label}_int{bits}_{name}"] = cs.stream_ms(
                        lambda: da.kv_decode_attention(q, cache, pos, bits, 0, G))
    finally:
        da._lib = real
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
