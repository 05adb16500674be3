"""The port's MARS analysis and layout ILP against the JAX package's.

Both are host numpy; the port keeps its own copy (``repro_torch.core``), so
every result must be equal exactly: each ``MarsAnalysis`` (counts, every
MARS's consumers and point set, ``consumed``) and each ``LayoutResult``
(all of it but ``solve_time_s``, which is wall time).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import layout as jlayout
from repro.core import mars as jmars
from repro.core import stencil as jstencil
from repro_torch.core import layout, mars, stencil

#: the paper's Table 1: (n_in, n_out, read bursts, write bursts)
TABLE1 = {"jacobi-1d": (7, 4, 3, 1), "jacobi-2d": (28, 13, 10, 1),
          "seidel-2d": (33, 13, 10, 1)}
ZOO = [(name, ts) for name, tiles in stencil.ZOO.items() for ts in tiles]


def assert_analysis_equal(got, want):
    assert got.spec.name == want.spec.name
    assert got.spec.tile_sizes == want.spec.tile_sizes
    assert (got.n_in, got.n_out, got.tile_points) == \
        (want.n_in, want.n_out, want.tile_points)
    assert got.consumed == want.consumed
    assert list(got.consumed) == list(want.consumed)          # same order
    for g, w in zip(got.out_mars, want.out_mars, strict=True):
        assert g.consumers == w.consumers
        assert g.points.dtype == w.points.dtype
        assert np.array_equal(g.points, w.points)


def layout_fields(r):
    d = dataclasses.asdict(r)
    d.pop("solve_time_s")
    return d


def test_zoo_and_specs_equal():
    assert stencil.ZOO == jstencil.ZOO
    assert sorted(stencil.SPECS) == sorted(jstencil.SPECS)
    for (name, ts), spec in stencil.zoo_specs().items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jstencil.SPECS[name](ts))


@pytest.mark.parametrize("name,ts", ZOO)
def test_analysis_and_layout_equal(name, ts):
    got, want = mars.analyze(stencil.SPECS[name](ts)), jmars.analyze(jstencil.SPECS[name](ts))
    assert_analysis_equal(got, want)
    mars.check_partition(got)
    lg, lw = layout.layout_for_analysis(got), jlayout.layout_for_analysis(want)
    assert layout_fields(lg) == layout_fields(lw)
    assert (got.n_in, got.n_out, lg.read_bursts, lg.write_bursts) == TABLE1[name]
    assert lg.exact


@pytest.mark.parametrize("name,ts,point", [
    ("jacobi-1d", (64, 64), (150, 2000)),         # tests/test_transfer.py's tile
    ("jacobi-1d", (6, 6), (5, 7)),
    ("jacobi-2d", (4, 5, 7), (3, 11, 20)),
])
def test_translated_analysis_equal(name, ts, point):
    """A tile other than the canonical one: the translation path."""
    spec, jspec = stencil.SPECS[name](ts), jstencil.SPECS[name](ts)
    rep = tuple(int(x) for x in spec.tile_of(np.array([point]))[0])
    assert_analysis_equal(mars.analyze(spec, rep), jmars.analyze(jspec, rep))
    # the direct (uncached) analysis of that tile agrees with the translation
    assert_analysis_equal(mars._analyze_at(spec, rep), mars.analyze(spec, rep))


def test_tile_points_equal():
    spec, jspec = stencil.jacobi1d_spec((6, 6)), jstencil.jacobi1d_spec((6, 6))
    for tile in ((0, 0), (3, -2), (7, 1)):
        got = mars._enumerate_tile_points(spec, np.array(tile))
        want = jmars._enumerate_tile_points(jspec, np.array(tile))
        assert np.array_equal(got, want)
    assert mars.analyze(spec).tile_points == 18                # paper Fig. 1


def _consumer_sets(seed: int, n: int, k: int):
    rng = np.random.default_rng(seed)
    return [sorted(int(x) for x in rng.choice(n, size=rng.integers(1, n + 1),
                                              replace=False))
            for _ in range(k)]


@pytest.mark.parametrize("seed,n,k", [(0, 5, 3), (1, 8, 6), (2, 13, 9), (3, 14, 4)])
def test_exact_layout_equal(seed, n, k):
    sets = _consumer_sets(seed, n, k)
    got, want = layout.solve_layout(n, sets), jlayout.solve_layout(n, sets)
    assert got.exact and layout_fields(got) == layout_fields(want)
    assert got.read_bursts == layout.count_bursts(got.order, sets)


@pytest.mark.parametrize("seed,n,k", [(4, 17, 6), (5, 20, 10)])
def test_greedy_layout_equal(seed, n, k):
    """Above EXACT_LIMIT: greedy 2-opt with its seeded restarts."""
    assert layout.EXACT_LIMIT == jlayout.EXACT_LIMIT == 16
    sets = _consumer_sets(seed, n, k)
    got, want = layout.solve_layout(n, sets), jlayout.solve_layout(n, sets)
    assert not got.exact
    assert layout_fields(got) == layout_fields(want)
    assert sorted(got.order) == list(range(n))


def test_brute_force_and_paper_example_equal():
    """§3.2.2: consumers {O2,O3,O4}, {O2}, {O1,O2,O3} -> 3 read bursts."""
    consumed = [[1, 2, 3], [1], [0, 1, 2]]
    for solve in ("solve_layout", "brute_force_layout"):
        got = getattr(layout, solve)(4, consumed)
        want = getattr(jlayout, solve)(4, consumed)
        assert layout_fields(got) == layout_fields(want)
        assert got.read_bursts == 3
    assert layout_fields(layout.solve_layout(0, [])) == \
        layout_fields(jlayout.solve_layout(0, []))
