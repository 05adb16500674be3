"""The port's tiled MARS executor (software model of the paper's §4
accelerator) against the JAX package's, and against the port's chunked
Jacobi entry point.

The executor is host numpy in both packages: its output, every value a full
tile computed, its ``ExecStats`` and the compressed streams it leaves in
``memory`` must be equal exactly.  ``chip_smoke.py`` holds the executor's
full-tile rows against ``ops.jacobi1d_tiled`` on the card; here the same
chain runs on the CPU's plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import executor as jexecutor
from repro.core import stencil as jstencil
from repro_torch.core import executor, stencil
from repro_torch.kernels import ops

#: the dtypes and tolerances of tests/test_executor.py
TOLS = {"fixed24": 1e-4, "fixed18": 1e-2, "float": 1e-5, "double": 1e-12}


def _run_both(n, tsteps, dtype, init, ts=(6, 6), record=True):
    ex = executor.Jacobi1dMarsExecutor(stencil.jacobi1d_spec(ts), n, tsteps,
                                       dtype=dtype, record=record)
    jex = jexecutor.Jacobi1dMarsExecutor(jstencil.jacobi1d_spec(ts), n, tsteps,
                                         dtype=dtype, record=record)
    return ex, ex.run(init), jex, jex.run(init)


def _assert_same(ex, out, jex, jout):
    assert np.array_equal(out, jout)
    assert dataclasses.asdict(ex.stats) == dataclasses.asdict(jex.stats)
    assert ex.full_tile_values == jex.full_tile_values
    assert ex.layout.order == jex.layout.order
    assert sorted(ex.memory) == sorted(jex.memory)
    for tile, s in ex.memory.items():
        js = jex.memory[tile]
        assert np.array_equal(s.words, js.words)
        assert (s.total_bits, s.counts) == (js.total_bits, js.counts)
        assert [(m.coarse, m.fine) for m in s.markers] == \
            [(m.coarse, m.fine) for m in js.markers]


@pytest.mark.parametrize("dtype", sorted(TOLS))
def test_executor_equal(dtype):
    init = np.random.default_rng(1).uniform(0.0, 1.0, size=60)
    ex, out, jex, jout = _run_both(60, 24, dtype, init)
    _assert_same(ex, out, jex, jout)
    hist = stencil.jacobi1d_reference(init, 24)
    assert np.abs(out - hist[24]).max() < TOLS[dtype]
    assert ex.stats.full_tiles > 20
    assert max(abs(v - hist[t, i]) for (t, i), v in ex.full_tile_values.items()) \
        < TOLS[dtype]


def test_executor_compression_stats_equal():
    init = np.cumsum(np.random.default_rng(2).uniform(-0.005, 0.005, 80)) + 0.5
    ex, out, jex, jout = _run_both(80, 30, "fixed18", init, record=False)
    _assert_same(ex, out, jex, jout)
    assert ex.full_tile_values == {}
    assert ex.stats.compressed_bits < ex.stats.uncompressed_bits
    assert ex.stats.mars_read > 0 and ex.stats.mars_written > 0


def test_executor_marker_counts_equal():
    ex, out, jex, jout = _run_both(60, 12, "fixed24", np.linspace(0, 1, 60),
                                   record=False)
    _assert_same(ex, out, jex, jout)
    assert all(len(s.markers) == 4 for s in ex.memory.values())   # §4.2.2


def test_executor_tile_order_equal():
    ex = executor.Jacobi1dMarsExecutor(stencil.jacobi1d_spec((6, 6)), 60, 24)
    jex = jexecutor.Jacobi1dMarsExecutor(jstencil.jacobi1d_spec((6, 6)), 60, 24)
    assert ex._tiles_covering() == jex._tiles_covering()
    for tile in ex._tiles_covering()[:40]:
        assert np.array_equal(ex._tile_points(tile), jex._tile_points(tile))


@pytest.mark.parametrize("dtype", ["fixed18", "float"])
def test_full_tile_rows_agree_with_jacobi1d_tiled(dtype):
    """The chain the chip run checks: the executor's full-tile values of a
    row t against ``ops.jacobi1d_tiled(x, t)`` (here its plain version on
    the CPU), on the cells more than t from both ends, where the dense
    reference's fixed end cells and the entry point's edge padding agree."""
    n, tsteps = 240, 40
    init = np.cumsum(np.random.default_rng(0).uniform(-0.01, 0.01, n)) + 1.0
    ex = executor.Jacobi1dMarsExecutor(stencil.jacobi1d_spec((6, 6)), n, tsteps,
                                       dtype=dtype, record=True)
    ex.run(init)
    x = torch.from_numpy(init.astype(np.float32))
    ops.reset_launch_counts()
    compared = 0
    for t in (12, 24, max(t for t, _ in ex.full_tile_values)):
        cells = np.array(sorted(i for (r, i) in ex.full_tile_values
                                if r == t and t < i < n - 1 - t))
        assert cells.size > 0
        got = np.array([ex.full_tile_values[(t, int(i))] for i in cells])
        want = ops.jacobi1d_tiled(x, t, width=64).numpy()[cells]
        assert np.abs(got - want).max() <= TOLS[dtype]
        compared += cells.size
    assert compared > 100
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
