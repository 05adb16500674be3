"""The port's transfer-cycle model against the JAX package's.

``TileIOModel.tile_io`` is host numpy in both packages: every ``TileIO``
field must be equal, for every access pattern in ``MODES``.  The cycles
model the paper's FPGA bus (``TransferModel``'s defaults), not a GPU.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import layout as jlayout
from repro.core import mars as jmars
from repro.core import stencil as jstencil
from repro.core import transfer as jtransfer
from repro_torch.core import layout, mars, stencil, transfer


def _models(name, ts, point=None):
    """(port model, reference model) of the tile holding ``point``."""
    out = []
    for st, ma, la, tr in ((stencil, mars, layout, transfer),
                           (jstencil, jmars, jlayout, jtransfer)):
        spec = st.SPECS[name](ts)
        a = ma.analyze(spec)
        rep = (None if point is None else
               tuple(int(x) for x in spec.tile_of(np.array([point]))[0]))
        out.append(tr.TileIOModel(spec, a, la.layout_for_analysis(a), rep_tile=rep))
    return out


@pytest.fixture(scope="module")
def jacobi1d():
    """tests/test_system.py's case: (64, 64) tiles, the tile around
    (t, i) = (100, 100) of a 250-cell field run 160 steps."""
    init = np.cumsum(np.random.default_rng(1).uniform(-0.01, 0.01, 250)) + 1.0
    return _models("jacobi-1d", (64, 64), (100, 100)), \
        stencil.jacobi1d_reference(init, 160), jstencil.jacobi1d_reference(init, 160)


@pytest.fixture(scope="module")
def jacobi2d():
    """(4, 5, 7) tiles, the tile around skewed (t, u, v) = (9, 17, 24) of a
    40 x 40 field run 16 steps; it and its producers lie inside."""
    init = np.random.default_rng(2).uniform(0.0, 1.0, (40, 40))
    models = _models("jacobi-2d", (4, 5, 7), (9, 17, 24))
    pts = np.concatenate(models[0].input_mars_points() + models[0].output_mars_points())
    t, i, j = pts[:, 0], pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0]
    assert t.min() >= 1 and t.max() <= 16
    assert min(i.min(), j.min()) >= 0 and max(i.max(), j.max()) < 40
    return models, stencil.jacobi2d_reference(init, 16), jstencil.jacobi2d_reference(init, 16)


def test_histories_equal(jacobi1d, jacobi2d):
    for _, hist, jhist in (jacobi1d, jacobi2d):
        assert np.array_equal(hist, jhist)


@pytest.mark.parametrize("mode", transfer.MODES)
@pytest.mark.parametrize("dtype", ["fixed18", "fixed24", "float"])
def test_tile_io_equal_jacobi1d(jacobi1d, dtype, mode):
    (m, jm), hist, jhist = jacobi1d
    io, jio = m.tile_io(dtype, mode, hist=hist), jm.tile_io(dtype, mode, hist=jhist)
    assert dataclasses.asdict(io) == dataclasses.asdict(jio)
    assert io.total_cycles == jio.total_cycles


@pytest.mark.parametrize("mode", transfer.MODES)
@pytest.mark.parametrize("dtype", ["fixed12", "float"])
def test_tile_io_equal_jacobi2d(jacobi2d, dtype, mode):
    (m, jm), hist, jhist = jacobi2d
    io, jio = m.tile_io(dtype, mode, hist=hist), jm.tile_io(dtype, mode, hist=jhist)
    assert dataclasses.asdict(io) == dataclasses.asdict(jio)


def test_mars_comp_takes_fewest_cycles(jacobi1d):
    (m, _), hist, _ = jacobi1d
    cyc = {mode: m.tile_io("fixed18", mode, hist=hist).total_cycles
           for mode in transfer.MODES}
    assert cyc["mars_comp"] == min(cyc.values())
    assert m.tile_io("fixed18", "mars").read_transactions == 3


def test_canonical_tile_geometry_equal():
    """The canonical jacobi-2d tile: Table 1's 10 read bursts, and the
    model's bursts and point sets equal to the reference's."""
    m, jm = _models("jacobi-2d", (4, 5, 7))
    assert m.coalesced_read_bursts() == jm.coalesced_read_bursts()
    for got, want in ((m.input_mars_points(), jm.input_mars_points()),
                      (m.output_mars_points(), jm.output_mars_points())):
        assert all(np.array_equal(g, w) for g, w in zip(got, want, strict=True))
    for mode in ("minimal", "bbox", "mars", "mars_pack"):
        assert dataclasses.asdict(m.tile_io("float", mode)) == \
            dataclasses.asdict(jm.tile_io("float", mode))
    assert m.tile_io("float", "mars").read_transactions == 10


@pytest.mark.parametrize("bits", [0, 1, 64, 65, 640, 64 * 256, 64 * 257, 64000])
def test_transaction_cycles_equal(bits):
    for kw in ({}, {"bus_bits": 32, "burst_init": 4, "max_beats": 16}):
        assert transfer.TransferModel(**kw).transaction_cycles(bits) == \
            jtransfer.TransferModel(**kw).transaction_cycles(bits)


@pytest.mark.parametrize("name", ["jacobi-1d", "jacobi-2d", "seidel-2d"])
def test_original_cells_and_runs_equal(name):
    ndim = stencil.SPECS[name]().ndim
    pts = np.random.default_rng(5).integers(0, 12, size=(200, ndim))
    (r, i), (jr, ji) = transfer.original_cells(name, pts), jtransfer.original_cells(name, pts)
    assert np.array_equal(r, jr) and np.array_equal(i, ji)
    assert transfer._runs(*transfer._dedup_cells(r, i)) == \
        jtransfer._runs(*jtransfer._dedup_cells(jr, ji))
    assert transfer._bbox_bits(r, i, 32) == jtransfer._bbox_bits(jr, ji, 32)
