"""Quickstart (PyTorch port): the paper's full pipeline on jacobi-1d.

MARS extraction -> layout ILP -> compression/packing -> tiled execution ->
I/O-cycle comparison against non-MARS access patterns, through the port's
own copies of the host analysis (``repro_torch.core``); then the chunked
stencil on ``--device`` (the hand-written Jacobi kernel on a card).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import layout, mars, stencil, transfer
from repro_torch.core.executor import Jacobi1dMarsExecutor
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. Analyze the tiled stencil: which data flows between tiles?
    spec = stencil.jacobi1d_spec(tile_sizes=(6, 6))
    analysis = mars.analyze(spec)
    print(f"MARS: {analysis.n_in} in / {analysis.n_out} out per tile "
          f"(paper Table 1: 7 / 4)")

    # 2. Solve the layout ILP (Algorithm 1): order MARS to coalesce reads.
    lay = layout.layout_for_analysis(analysis)
    print(f"layout order {lay.order} -> {lay.read_bursts} read bursts, "
          f"{lay.write_bursts} write burst (paper: 3 / 1)")

    # 3. Execute the accelerator model end to end with compressed MARS
    # streams.
    n, tsteps = 120, 48
    init = np.cumsum(np.random.default_rng(0).uniform(-0.01, 0.01, n)) + 1.0
    ex = Jacobi1dMarsExecutor(spec, n, tsteps, dtype="fixed18")
    out = ex.run(init)
    ref = stencil.jacobi1d_reference(init, tsteps)[tsteps]
    print(f"executor max |err| vs dense reference: {np.abs(out - ref).max():.2e}")
    print(f"aggregate compression (padded baseline): "
          f"{ex.stats.uncompressed_bits / ex.stats.compressed_bits:.2f}x")

    # 4. Compare I/O cycles across access patterns (paper Fig. 10).
    spec_big = stencil.jacobi1d_spec((64, 64))
    a_big = mars.analyze(spec_big)
    l_big = layout.layout_for_analysis(a_big)
    hist = stencil.jacobi1d_reference(
        np.cumsum(np.random.default_rng(1).uniform(-0.01, 0.01, 4000)) + 1.0,
        300)
    rep = tuple(int(x) for x in spec_big.tile_of(np.array([[150, 2000]]))[0])
    model = transfer.TileIOModel(spec_big, a_big, l_big, rep_tile=rep)
    print("\nper-tile I/O cycles (fixed18, 64x64 tiles):")
    for mode in transfer.MODES:
        io = model.tile_io("fixed18", mode, hist=hist)
        print(f"  {mode:10s} {io.total_cycles:6d} cycles "
              f"({io.read_transactions} read tx)")

    # 5. The same stencil as the chunked macro-pipeline on the device: the
    # cells more than T from both ends, where the dense reference's fixed
    # ends and the entry point's edge padding agree.
    x = torch.tensor(init, dtype=torch.float32, device=args.device)
    y = ops.jacobi1d_tiled(x, tsteps, width=64).cpu().numpy()
    inner = slice(tsteps + 1, n - tsteps - 1)
    print(f"\nchunked jacobi on {torch.device(args.device).type}: max |err| vs "
          f"dense reference on {n - 2 * tsteps - 2} interior cells: "
          f"{np.abs(y[inner] - ref[inner]).max():.2e}")


if __name__ == "__main__":
    main()
