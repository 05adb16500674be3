"""MARS extraction: Maximal Atomic irRedundant Sets (paper §3.1, Ferry'23).

The PyTorch port's own copy of ``repro.core.mars`` (host numpy; the port
imports nothing of ``repro``), numerically identical to it.

For a tiled single-assignment program, the flow-out data of a tile is
partitioned into groups of points that share the *same set of consumer
tiles*.  Each group is a MARS:

* **atomic** — every point in a group is read by exactly the same consumer
  tiles, so if a tile needs one point of the group it needs all of them;
* **irredundant** — the groups partition the flow-out set, so every value is
  stored exactly once;
* **maximal** — merging two distinct groups would break atomicity.

Full tiles of a uniform stencil are translation-invariant, so the analysis is
performed once on a representative interior tile; consumer tiles are recorded
as *relative* tile offsets.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from fractions import Fraction
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from .stencil import StencilSpec

TileOffset = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Mars:
    """One maximal atomic irredundant set of a representative tile."""

    #: relative offsets of the tiles consuming this MARS (never empty)
    consumers: Tuple[TileOffset, ...]
    #: points of the MARS, original iteration-space coords, lexicographic order
    points: np.ndarray  # [n_points, ndim] int64

    @property
    def size(self) -> int:
        return int(self.points.shape[0])

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Mars(consumers={self.consumers}, n={self.size})"


@dataclasses.dataclass(frozen=True)
class MarsAnalysis:
    """Result of the MARS analysis on a representative full tile."""

    spec: StencilSpec
    #: output MARS of the tile (flow-out partition)
    out_mars: Tuple[Mars, ...]
    #: for each producer-tile offset, the indices (into that producer's
    #: out_mars — identical to ours by uniformity) consumed by this tile
    consumed: Dict[TileOffset, Tuple[int, ...]]
    #: tile volume (number of iteration points per full tile)
    tile_points: int

    @property
    def n_out(self) -> int:
        return len(self.out_mars)

    @property
    def n_in(self) -> int:
        """Number of input MARS = sum over producers of consumed sets."""
        return sum(len(v) for v in self.consumed.values())

    def out_sizes(self) -> List[int]:
        return [m.size for m in self.out_mars]


def _enumerate_tile_points(spec: StencilSpec, tile_index: np.ndarray) -> np.ndarray:
    """All integer iteration points p with tile_of(p) == tile_index.

    Enumerates the skewed-space box and keeps integral preimages of S^-1.
    """
    S = spec.skew_matrix
    ts = np.asarray(spec.tile_sizes, dtype=np.int64)
    lo = tile_index * ts
    ranges = [range(int(lo[d]), int(lo[d] + ts[d])) for d in range(spec.ndim)]
    ys = np.array(list(itertools.product(*ranges)), dtype=np.int64)
    # invert: p = S^-1 y ; use exact rational inverse
    Sf = [[Fraction(int(S[i, j])) for j in range(spec.ndim)] for i in range(spec.ndim)]
    # Gaussian elimination to get inverse as Fractions
    n = spec.ndim
    aug = [row[:] + [Fraction(int(i == r)) for i in range(n)] for r, row in enumerate(Sf)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        pv = aug[col][col]
        aug[col] = [x / pv for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col] != 0:
                f = aug[r][col]
                aug[r] = [a - f * b for a, b in zip(aug[r], aug[col])]
    inv = aug  # rows: [.., identity | inverse]
    num = np.array([[int(inv[i][n + j].numerator) for j in range(n)] for i in range(n)],
                   dtype=np.int64)
    den = np.array([[int(inv[i][n + j].denominator) for j in range(n)] for i in range(n)],
                   dtype=np.int64)
    lcm = int(np.lcm.reduce(den.reshape(-1)))
    scaled = num * (lcm // den)
    prod = ys @ scaled.T  # = lcm * p
    integral = np.all(prod % lcm == 0, axis=1)
    pts = prod[integral] // lcm
    return pts


CANONICAL_TILE_COORD = 64  # deep inside the (unbounded) domain


def analyze(spec: StencilSpec, rep_tile: Tuple[int, ...] | None = None) -> MarsAnalysis:
    """MARS analysis for a representative tile — memoized via translation.

    The analysis is domain-free and uniform stencils are translation
    invariant, so the expensive partition is computed once per spec on a
    canonical tile (:func:`_analyze_canonical`, ``lru_cache``d) and other
    tiles are served by translating the canonical point sets whenever the
    tile offset maps to an integral iteration-space shift (always, for
    unimodular-times-diagonal tilings like the paper's).  Non-integral
    offsets fall back to the direct computation.
    """
    ndim = spec.ndim
    canonical_rep = tuple([CANONICAL_TILE_COORD] * ndim)
    canonical = _analyze_canonical(spec)
    if rep_tile is None or tuple(rep_tile) == canonical_rep:
        return canonical
    dc = np.asarray(rep_tile, dtype=np.int64) - np.asarray(
        canonical_rep, dtype=np.int64)
    shift = _integral_point_shift(spec, dc)
    if shift is not None:
        return _translate_analysis(canonical, shift)
    return _analyze_at(spec, tuple(int(x) for x in rep_tile))


@functools.lru_cache(maxsize=None)
def _analyze_canonical(spec: StencilSpec) -> MarsAnalysis:
    return _analyze_at(spec, tuple([CANONICAL_TILE_COORD] * spec.ndim))


def _integral_point_shift(spec: StencilSpec,
                          dc: np.ndarray) -> Optional[np.ndarray]:
    """Iteration-space translation matching tile offset ``dc``, if integral.

    Tiles are boxes in the skewed basis, so shifting the skewed coords by
    ``dc * tile_sizes`` moves tile ``c0`` onto ``c0 + dc``; the preimage
    ``S^-1 (dc * ts)`` is the iteration-space shift when it is integral.
    """
    S = spec.skew_matrix
    y = dc * np.asarray(spec.tile_sizes, dtype=np.int64)
    x = np.linalg.solve(S.astype(np.float64), y.astype(np.float64))
    xi = np.rint(x).astype(np.int64)
    if np.array_equal(S @ xi, y):
        return xi
    return None


def _translate_analysis(a: MarsAnalysis, shift: np.ndarray) -> MarsAnalysis:
    """Translate every MARS point set by ``shift`` (structure is unchanged)."""
    out = tuple(Mars(consumers=m.consumers, points=m.points + shift)
                for m in a.out_mars)
    return MarsAnalysis(spec=a.spec, out_mars=out, consumed=a.consumed,
                        tile_points=a.tile_points)


def _analyze_at(spec: StencilSpec, rep_tile: Tuple[int, ...]) -> MarsAnalysis:
    """Direct (uncached) MARS analysis of one tile."""
    ndim = spec.ndim
    c0 = np.asarray(rep_tile, dtype=np.int64)
    pts = _enumerate_tile_points(spec, c0)
    if pts.shape[0] == 0:
        raise ValueError(f"empty representative tile for {spec.name}")
    reads = np.asarray(spec.reads, dtype=np.int64)  # [R, ndim]

    # --- flow-out partition (output MARS) ---------------------------------
    # consumers of p: q = p - r for each read offset r
    consumers_of = pts[:, None, :] - reads[None, :, :]          # [n, R, ndim]
    cons_tiles = spec.tile_of(consumers_of.reshape(-1, ndim)).reshape(
        pts.shape[0], reads.shape[0], ndim)
    rel = cons_tiles - c0[None, None, :]
    sig: List[FrozenSet[TileOffset]] = []
    for k in range(pts.shape[0]):
        offs = {tuple(int(x) for x in rel[k, j]) for j in range(reads.shape[0])}
        offs.discard(tuple([0] * ndim))
        sig.append(frozenset(offs))

    groups: Dict[FrozenSet[TileOffset], List[int]] = {}
    for k, s in enumerate(sig):
        if s:  # flow-out only
            groups.setdefault(s, []).append(k)

    def _sig_key(s: FrozenSet[TileOffset]) -> Tuple:
        return tuple(sorted(s))

    out_mars: List[Mars] = []
    for s in sorted(groups.keys(), key=_sig_key):
        idx = groups[s]
        gpts = pts[idx]
        order = np.lexsort(gpts.T[::-1])  # lexicographic by (dim0, dim1, ...)
        out_mars.append(Mars(consumers=tuple(sorted(s)), points=gpts[order]))

    # --- consumed input MARS per producer ---------------------------------
    # values read by the tile but produced elsewhere
    read_pts = pts[:, None, :] + reads[None, :, :]
    read_pts = read_pts.reshape(-1, ndim)
    prod_tiles = spec.tile_of(read_pts)
    rel_prod = prod_tiles - c0[None, :]
    outside = np.any(rel_prod != 0, axis=1)
    ext_pts = read_pts[outside]
    ext_rel = rel_prod[outside]

    # identify, for each external point, which out-MARS of its producer it
    # belongs to.  By uniformity the producer's MARS partition is ours
    # translated by (producer_tile - c0) in *tiled* space; rather than
    # translating point sets, recompute the point's signature in the
    # producer's frame.
    consumed: Dict[TileOffset, set] = {}
    # signature -> out-mars index
    sig_to_idx = {m.consumers: i for i, m in enumerate(out_mars)}
    cons_all = ext_pts[:, None, :] - reads[None, :, :]
    cons_all_tiles = spec.tile_of(cons_all.reshape(-1, ndim)).reshape(
        ext_pts.shape[0], reads.shape[0], ndim)
    own_tiles = spec.tile_of(ext_pts)
    for k in range(ext_pts.shape[0]):
        producer = tuple(int(x) for x in ext_rel[k])
        offs = {
            tuple(int(x) for x in (cons_all_tiles[k, j] - own_tiles[k]))
            for j in range(reads.shape[0])
        }
        offs.discard(tuple([0] * ndim))
        key = tuple(sorted(offs))
        if key not in sig_to_idx:
            raise AssertionError(
                f"{spec.name}: external point has signature {key} absent from "
                "the representative tile's partition — tile not interior?")
        consumed.setdefault(producer, set()).add(sig_to_idx[key])

    consumed_t = {k: tuple(sorted(v)) for k, v in sorted(consumed.items())}
    return MarsAnalysis(
        spec=spec,
        out_mars=tuple(out_mars),
        consumed=consumed_t,
        tile_points=int(pts.shape[0]),
    )


def check_partition(analysis: MarsAnalysis) -> None:
    """Invariant checks: MARS partition the flow-out set (irredundancy)."""
    seen = set()
    for m in analysis.out_mars:
        for p in m.points:
            key = tuple(int(x) for x in p)
            if key in seen:
                raise AssertionError(f"point {key} in two MARS (redundant)")
            seen.add(key)
        if not m.consumers:
            raise AssertionError("MARS with no consumer")
