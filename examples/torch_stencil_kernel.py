"""The §4 macro-pipeline as a hand-written kernel (PyTorch port).

Chunked jacobi-1d: the CUDA kernel of ``csrc/jacobi_mars.cu`` advances the
field T time steps tile by tile and carries the inter-tile MARS (2 columns
x T levels) from one tile to the next on chip — irredundant inter-tile
dataflow, per the paper.  On a CPU tensor the entry point runs its plain
PyTorch version instead.

Run:  PYTHONPATH=src python examples/torch_stencil_kernel.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.kernels import ops, ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n, T, W = 1 << 15, 32, 512
    x = torch.tensor(
        np.cumsum(np.random.default_rng(0).uniform(-0.01, 0.01, n)),
        dtype=torch.float32, device=args.device)

    y_kernel = ops.jacobi1d_tiled(x, T, width=W)
    y_ref = ref.jacobi_chunked_ref(x, T)
    err = float((y_kernel - y_ref).abs().max())
    print(f"jacobi1d chunked kernel: n={n} T={T} W={W}")
    print(f"max |kernel - reference| = {err:.2e}")

    halo_reads = (n // W) * 2 * T * 4
    print(f"irredundant carry saves {halo_reads / 1e3:.1f} kB of halo re-reads "
          f"per pass vs overlapped tiling "
          f"({100 * halo_reads / (n * 4):.1f}% of the input)")
    return y_kernel


if __name__ == "__main__":
    main()
