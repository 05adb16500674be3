"""Batched serving with a packed (paper-layout) KV cache (PyTorch port).

Generates continuations for a batch of mixed-length prompts twice — bf16
cache vs packed int8 — and reports cache footprint + agreement.  On a card
each decode step is replayed as a CUDA graph, and the int8 cache is
written by the fused ``kv_quant_store`` kernel and read by
``kv_decode_attention``, which dequantizes it on chip and attends.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--small] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.serve.engine import ServeEngine


def model(small: bool) -> ModelConfig:
    if small:
        return ModelConfig(name="serve-demo-small", family="dense",
                           n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                           d_ff=384, vocab=1024)
    return ModelConfig(name="serve-demo", family="dense", n_layers=4,
                       d_model=256, n_heads=8, n_kv_heads=4, d_ff=768,
                       vocab=4096)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model(args.small)
    prompts = [[1, 7, 42], [9, 9], [100, 200, 300, 400], [5]]

    engines = {}
    for bits in (16, 8):
        rc = RunConfig(seq_len=64, global_batch=len(prompts), kind="decode",
                       remat=False, kv_cache_bits=bits)
        eng = ServeEngine(cfg, rc, params=engines.get(16, None) and engines[16].params,
                          seed=0, device=args.device)
        engines[bits] = eng
        out = eng.generate(prompts, max_new=12)
        print(f"kv_cache_bits={bits}: cache={eng.kv_cache_bytes(len(prompts)):,} B")
        for p, o in zip(prompts, out):
            print(f"  prompt {p} -> {o}")

    agree = np.mean([
        a == b for a, b in zip(
            sum(engines[16].generate(prompts, max_new=12), []),
            sum(engines[8].generate(prompts, max_new=12), []))])
    print(f"\nint8-packed vs bf16 greedy agreement: {agree:.0%} "
          "(quantization may flip rare near-ties)")
    return agree


if __name__ == "__main__":
    main()
