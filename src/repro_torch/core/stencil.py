"""PolyBench-faithful stencil definitions and reference executors.

The PyTorch port's own copy of ``repro.core.stencil`` (host numpy; the port
imports nothing of ``repro``), numerically identical to it.

The paper evaluates on PolyBench/C jacobi-1d, jacobi-2d and seidel-2d.  Each
stencil is described here twice:

* a *single-assignment* view used by the polyhedral MARS analysis: an
  iteration space of dimension ``ndim`` where the point ``q`` reads the values
  produced at ``q + r`` for every read offset ``r`` (all offsets are
  lexicographically backward in time),
* a dense numpy reference executor used to generate real data for the
  compression-ratio and transfer-cycle experiments and to validate the tiled
  MARS executor end to end.

Tiling is expressed as an integer *skew* matrix ``S`` plus rectangular tile
sizes in the skewed basis.  ``tile_of(p) = floor(S @ p / tile_sizes)``.  The
diamond tiling of jacobi-1d used in the paper (Fig. 1: a 6x6 tile holding 18
``(t, i)`` points) is ``S = [[1, 1], [1, -1]]`` — a 6x6 box in the skewed
basis contains 18 integer preimages because ``u + v = 2t`` must be even.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

Offset = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """Single-assignment stencil + tiling description."""

    name: str
    ndim: int
    #: read offsets: iteration q reads value produced at q + r for r in reads
    reads: Tuple[Offset, ...]
    #: integer skew matrix (ndim x ndim), unimodular or integer-invertible
    skew: Tuple[Tuple[int, ...], ...]
    #: tile sizes in the skewed basis
    tile_sizes: Tuple[int, ...]

    @property
    def skew_matrix(self) -> np.ndarray:
        return np.asarray(self.skew, dtype=np.int64)

    def tile_of(self, points: np.ndarray) -> np.ndarray:
        """Tile index of each point (points: [n, ndim]) -> [n, ndim]."""
        y = points @ self.skew_matrix.T
        return np.floor_divide(y, np.asarray(self.tile_sizes, dtype=np.int64))

    def with_tile_sizes(self, tile_sizes: Sequence[int]) -> "StencilSpec":
        return dataclasses.replace(self, tile_sizes=tuple(int(t) for t in tile_sizes))


# ---------------------------------------------------------------------------
# Stencil catalogue (PolyBench semantics)
# ---------------------------------------------------------------------------

def jacobi1d_spec(tile_sizes: Sequence[int] = (6, 6)) -> StencilSpec:
    """c[t+1, i] = (c[t, i-1] + c[t, i] + c[t, i+1]) / 3, diamond tiling."""
    return StencilSpec(
        name="jacobi-1d",
        ndim=2,
        reads=((-1, -1), (-1, 0), (-1, 1)),
        skew=((1, 1), (1, -1)),
        tile_sizes=tuple(int(t) for t in tile_sizes),
    )


def jacobi2d_spec(tile_sizes: Sequence[int] = (4, 5, 7)) -> StencilSpec:
    """c[t+1,i,j] = 0.2*(c[t,i,j] + c[t,i±1,j] + c[t,i,j±1]).

    Classic time-skewing ``(t, i + t, j + t)`` makes all dependences
    non-negative so rectangular tiles are legal (Pluto-style).
    """
    return StencilSpec(
        name="jacobi-2d",
        ndim=3,
        reads=(
            (-1, -1, -1),   # (t-1, i,   j)   in skewed coords
            (-1, -2, -1),   # (t-1, i-1, j)
            (-1, 0, -1),    # (t-1, i+1, j)
            (-1, -1, -2),   # (t-1, i,   j-1)
            (-1, -1, 0),    # (t-1, i,   j+1)
        ),
        # reads above are already expressed in the skewed basis, so S = I.
        skew=((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        tile_sizes=tuple(int(t) for t in tile_sizes),
    )


def seidel2d_spec(tile_sizes: Sequence[int] = (4, 10, 10)) -> StencilSpec:
    """In-place 9-point Gauss-Seidel sweep (PolyBench seidel-2d).

    A[i][j] at sweep t reads the *current* sweep's values for (i-1, j-1),
    (i-1, j), (i-1, j+1), (i, j-1) and the *previous* sweep's values for
    (i, j), (i, j+1), (i+1, j-1), (i+1, j), (i+1, j+1).

    Skewing ``(t, u, v) = (t, 2t + i, 3t + 2i + j)`` makes every dependence
    component non-negative, legalising rectangular tiles.  The paper does not
    print its transform; among the legal small skews this one reproduces the
    published Table-1 characteristics exactly (33 input MARS, 13 output MARS,
    10 read bursts, 1 write burst) and is used throughout.  Read offsets below
    are the images of the 9 value-based dependences under the transform.
    """
    # original-space dependences: (dt, di, dj) meaning q reads q + (dt,di,dj)
    orig = [
        (0, -1, -1), (0, -1, 0), (0, -1, 1), (0, 0, -1),
        (-1, 0, 0), (-1, 0, 1), (-1, 1, -1), (-1, 1, 0), (-1, 1, 1),
    ]
    T = np.array([[1, 0, 0], [2, 1, 0], [3, 2, 1]], dtype=np.int64)
    reads = tuple(tuple(int(x) for x in (T @ np.array(d))) for d in orig)
    return StencilSpec(
        name="seidel-2d",
        ndim=3,
        reads=reads,
        skew=((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        tile_sizes=tuple(int(t) for t in tile_sizes),
    )


SPECS: Dict[str, Callable[..., StencilSpec]] = {
    "jacobi-1d": jacobi1d_spec,
    "jacobi-2d": jacobi2d_spec,
    "seidel-2d": seidel2d_spec,
}

#: the config zoo — every (benchmark, tile-size) pair the repo validates
#: against the paper's Table 1.  One source of truth: the table-1 bench,
#: the reference's layout-invariant pass, ``chip_smoke.py`` and tests iterate
#: this grid (MARS counts/bursts are tile-size independent; multiple tile
#: sizes per benchmark prove it).
ZOO: Dict[str, Tuple[Tuple[int, ...], ...]] = {
    "jacobi-1d": ((6, 6), (64, 64), (200, 200)),
    "jacobi-2d": ((4, 5, 7), (10, 10, 10)),
    "seidel-2d": ((4, 10, 10),),
}


def zoo_specs() -> Dict[Tuple[str, Tuple[int, ...]], StencilSpec]:
    """(name, tile_sizes) -> built spec, over the whole zoo."""
    return {(name, ts): SPECS[name](ts)
            for name, tiles in ZOO.items() for ts in tiles}


# ---------------------------------------------------------------------------
# Dense reference executors (data generators for compression experiments)
# ---------------------------------------------------------------------------

def jacobi1d_reference(init: np.ndarray, tsteps: int) -> np.ndarray:
    """Return the full (tsteps+1, n) single-assignment value array."""
    n = init.shape[0]
    hist = np.empty((tsteps + 1, n), dtype=np.float64)
    hist[0] = init
    cur = init.astype(np.float64)
    for t in range(tsteps):
        nxt = cur.copy()
        nxt[1:-1] = (cur[:-2] + cur[1:-1] + cur[2:]) / 3.0
        hist[t + 1] = nxt
        cur = nxt
    return hist


def jacobi2d_reference(init: np.ndarray, tsteps: int) -> np.ndarray:
    """Full (tsteps+1, n, n) history of the 5-point Jacobi iteration."""
    hist = np.empty((tsteps + 1,) + init.shape, dtype=np.float64)
    hist[0] = init
    cur = init.astype(np.float64)
    for t in range(tsteps):
        nxt = cur.copy()
        nxt[1:-1, 1:-1] = 0.2 * (
            cur[1:-1, 1:-1] + cur[:-2, 1:-1] + cur[2:, 1:-1]
            + cur[1:-1, :-2] + cur[1:-1, 2:]
        )
        hist[t + 1] = nxt
        cur = nxt
    return hist


def seidel2d_reference(init: np.ndarray, tsteps: int) -> np.ndarray:
    """Full (tsteps+1, n, n) history of in-place 9-point Gauss-Seidel."""
    hist = np.empty((tsteps + 1,) + init.shape, dtype=np.float64)
    hist[0] = init
    cur = init.astype(np.float64).copy()
    n = cur.shape[0]
    for t in range(tsteps):
        for i in range(1, n - 1):
            for j in range(1, n - 1):
                cur[i, j] = (
                    cur[i - 1, j - 1] + cur[i - 1, j] + cur[i - 1, j + 1]
                    + cur[i, j - 1] + cur[i, j] + cur[i, j + 1]
                    + cur[i + 1, j - 1] + cur[i + 1, j] + cur[i + 1, j + 1]
                ) / 9.0
        hist[t + 1] = cur.copy()
    return hist


REFERENCES = {
    "jacobi-1d": jacobi1d_reference,
    "jacobi-2d": jacobi2d_reference,
    "seidel-2d": seidel2d_reference,
}


def stencil_value(name: str, hist: np.ndarray, point: np.ndarray) -> float:
    """Value produced at single-assignment iteration ``point``.

    Conventions (consistent with each spec's read offsets):
      * jacobi kernels: point (t, ...) with t >= 1 produces hist[t] and reads
        hist[t-1] (hist[0] is the initial data, not a computed point);
      * seidel-2d: skewed point (t, u, v) with t >= 0 is sweep t, producing
        hist[t + 1]; its (t-1, .) reads reference hist[t].  The skewed point
        maps back via i = u - 2t, j = v - 3t - 2i.
    """
    if name == "jacobi-1d":
        t, i = point
        return hist[t, i]
    if name == "jacobi-2d":
        t, u, v = point
        return hist[t, u - t, v - t]
    if name == "seidel-2d":
        t, u, v = point
        i = u - 2 * t
        j = v - 3 * t - 2 * i
        return hist[t + 1, i, j]
    raise KeyError(name)


def stencil_values(name: str, hist: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Vectorized :func:`stencil_value` over ``points`` ([n, ndim])."""
    pts = np.asarray(points, dtype=np.int64)
    if name == "jacobi-1d":
        return hist[pts[:, 0], pts[:, 1]]
    if name == "jacobi-2d":
        t = pts[:, 0]
        return hist[t, pts[:, 1] - t, pts[:, 2] - t]
    if name == "seidel-2d":
        t, u, v = pts[:, 0], pts[:, 1], pts[:, 2]
        i = u - 2 * t
        j = v - 3 * t - 2 * i
        return hist[t + 1, i, j]
    raise KeyError(name)
