"""End-to-end tiled MARS executor (software model of the §4 accelerator).

The PyTorch port's own copy of ``repro.core.executor`` (host numpy; the port
imports nothing of ``repro``), numerically identical to it.

Simulates the full paper pipeline for jacobi-1d with diamond tiling:

  read MARS (seek via markers, decompress) -> dispatch -> execute tile ->
  collect -> compress+pack -> write MARS

Global memory holds one `CompressedStream` per produced tile (the paper's
contiguous per-tile allocation, §3.2.1).  Full tiles run through the MARS
path; partial tiles (touching the space/time boundary) run on the "host"
(§4.3) using the dense reference allocation.  The executor's final state is
compared against the dense reference — this is the correctness proof of the
whole layout + codec machinery, standing in for the paper's on-board runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.obs import instrument as obs

from . import compression as comp
from .layout import LayoutResult, layout_for_analysis
from .mars import MarsAnalysis, analyze
from .stencil import StencilSpec, jacobi1d_reference

TileId = Tuple[int, ...]


@dataclasses.dataclass
class ExecStats:
    full_tiles: int = 0
    host_tiles: int = 0
    compressed_bits: int = 0
    uncompressed_bits: int = 0
    mars_read: int = 0
    mars_written: int = 0

    def publish(self, **labels) -> None:
        """Push every field into the obs registry as ``exec/<field>``.

        Counters accumulate across publishes, so call once per run (the
        executor does, at the end of :meth:`Jacobi1dMarsExecutor.run`).
        No-op while obs is disabled.
        """
        for f in dataclasses.fields(self):
            obs.counter_inc(f"exec/{f.name}", getattr(self, f.name), **labels)


class Jacobi1dMarsExecutor:
    """Tile-by-tile jacobi-1d using the MARS layout + codec."""

    def __init__(self, spec: StencilSpec, n: int, tsteps: int,
                 dtype: str = "fixed24", record: bool = False):
        assert spec.name == "jacobi-1d"
        self.spec = spec
        self.n, self.tsteps = n, tsteps
        self.dtype = dtype
        self.nbits = comp.DATA_TYPES[dtype][0]
        self.analysis: MarsAnalysis = analyze(spec)
        self.layout: LayoutResult = layout_for_analysis(self.analysis)
        #: MARS id -> slot in the layout order (avoids per-read .index())
        self._slot: Dict[int, int] = {m: k for k, m
                                      in enumerate(self.layout.order)}
        # global memory: tile id -> compressed stream of its out-MARS
        self.memory: Dict[TileId, comp.CompressedStream] = {}
        self.stats = ExecStats()
        self.record = record
        #: (t, i) -> value computed by a FULL tile through the MARS path
        self.full_tile_values: Dict[Tuple[int, int], float] = {}

    # -- geometry -----------------------------------------------------------
    def _tiles_covering(self) -> List[TileId]:
        """All tile indices intersecting the computed domain, wavefront order."""
        S = self.spec.skew_matrix
        ts = np.asarray(self.spec.tile_sizes)
        corners = []
        for t in (1, self.tsteps):
            for i in (0, self.n - 1):
                corners.append(S @ np.array([t, i]))
        corners = np.array(corners)
        lo = np.floor_divide(corners.min(axis=0), ts) - 1
        hi = np.floor_divide(corners.max(axis=0), ts) + 1
        tiles = [(int(a), int(b))
                 for a in range(lo[0], hi[0] + 1)
                 for b in range(lo[1], hi[1] + 1)]
        # dependence-legal order: skewed coordinates are lexicographically
        # non-decreasing along dependences, so sort by (a + b, a) wavefront.
        tiles.sort(key=lambda c: (c[0] + c[1], c[0]))
        return tiles

    def _tile_points(self, tile: TileId) -> np.ndarray:
        from .mars import _enumerate_tile_points
        pts = _enumerate_tile_points(self.spec, np.asarray(tile))
        in_dom = ((pts[:, 0] >= 1) & (pts[:, 0] <= self.tsteps)
                  & (pts[:, 1] >= 0) & (pts[:, 1] <= self.n - 1))
        return pts[in_dom]

    def _is_full(self, tile: TileId, pts: np.ndarray) -> bool:
        if pts.shape[0] != self.analysis.tile_points:
            return False
        # all stencil reads must be interior (no boundary clamping inside)
        return bool(np.all(pts[:, 1] >= 1) and np.all(pts[:, 1] <= self.n - 2)
                    and np.all(pts[:, 0] >= 1))

    # -- value plumbing ------------------------------------------------------
    def _encode(self, vals: np.ndarray) -> np.ndarray:
        if self.dtype.startswith("fixed"):
            return comp.quantize_fixed(vals, self.nbits)
        words, _ = comp.float_bits(vals, self.dtype)
        return words

    def _decode(self, words: np.ndarray) -> np.ndarray:
        if self.dtype.startswith("fixed"):
            return comp.dequantize_fixed(words, self.nbits)
        if self.dtype == "float":
            return words.astype(np.uint32).view(np.float32).astype(np.float64)
        return words.view(np.float64)

    def _read_inputs(self, tile: TileId) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Fetch all consumed MARS of this tile, decompressing via markers.

        Returns (points, values) array pairs — no per-point dict fills.
        """
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        c0 = np.asarray(tile)
        for producer_off, mars_ids in self.analysis.consumed.items():
            producer = tuple(int(x) for x in (c0 + np.asarray(producer_off)))
            stream = self.memory.get(producer)
            if stream is None:
                continue  # producer outside computed domain
            pa = analyze(self.spec, producer)
            for mid in mars_ids:
                words = comp.decompress_mars(stream, self._slot[mid])
                out.append((pa.out_mars[mid].points, self._decode(words)))
                self.stats.mars_read += 1
        return out

    def _write_output(self, tile: TileId, pa: MarsAnalysis,
                      getval: Callable[[np.ndarray], np.ndarray]) -> None:
        mars_vals: List[np.ndarray] = []
        for mid in self.layout.order:
            mars_vals.append(self._encode(getval(pa.out_mars[mid].points)))
        stream = comp.compress_mars_stream(mars_vals, self.nbits)
        self.memory[tile] = stream
        self.stats.mars_written += len(mars_vals)
        self.stats.compressed_bits += stream.compressed_bits
        self.stats.uncompressed_bits += stream.uncompressed_bits(
            padded_to=comp.DATA_TYPES[self.dtype][1])

    # -- execution -----------------------------------------------------------
    def run(self, init: np.ndarray) -> np.ndarray:
        """Execute all tiles; return final state, and validate against ref."""
        with obs.span("executor/run", bench=self.spec.name, n=self.n,
                      tsteps=self.tsteps, dtype=self.dtype):
            return self._run(init)

    def _run(self, init: np.ndarray) -> np.ndarray:
        assert init.shape[0] == self.n
        hist = jacobi1d_reference(init, self.tsteps)  # host-side truth for
        # partial tiles (§4.3) and boundary conditions
        final = np.array(hist[self.tsteps])

        for tile in self._tiles_covering():
            pts = self._tile_points(tile)
            if pts.shape[0] == 0:
                continue
            pa = analyze(self.spec, tile)
            if not self._is_full(tile, pts):
                # host tile: write back MARS from the reference allocation,
                # padding out-of-domain MARS points with zeros — no full
                # tile consumes them (§4.3: "no FPGA tiles need any missing
                # MARS data from partial tiles")
                def host_getval(mpts: np.ndarray) -> np.ndarray:
                    t, i = mpts[:, 0], mpts[:, 1]
                    ok = ((t >= 1) & (t <= self.tsteps)
                          & (i >= 0) & (i <= self.n - 1))
                    vals = np.zeros(mpts.shape[0])
                    vals[ok] = hist[t[ok], i[ok]]
                    return vals

                self._write_output(tile, pa, host_getval)
                self.stats.host_tiles += 1
                continue

            # full tile: dense wavefront buffer over the tile's (t, i)
            # window plus a one-cell halo; rows execute in ascending t,
            # each as one vectorized stencil update (no per-point dicts).
            t0 = int(pts[:, 0].min()) - 1           # buffer row 0 -> t0
            c0 = int(pts[:, 1].min()) - 1           # buffer col 0 -> c0
            n_rows = int(pts[:, 0].max()) - t0 + 1
            n_cols = int(pts[:, 1].max()) - c0 + 2
            buf = np.zeros((n_rows, n_cols))
            filled = np.zeros((n_rows, n_cols), dtype=bool)
            # seed values the stencil may read but no tile produces: the
            # initial state (t == 0) and the never-updated boundary columns
            if t0 == 0:
                buf[0, :] = init[c0:c0 + n_cols]
                filled[0, :] = True
            for col, edge in ((0, c0), (n_cols - 1, c0 + n_cols - 1)):
                if edge == 0 or edge == self.n - 1:
                    buf[:, col] = init[edge]
                    filled[:, col] = True
            # consumed MARS override the seeds (they carry quantized values)
            for ipts, ivals in self._read_inputs(tile):
                r, c = ipts[:, 0] - t0, ipts[:, 1] - c0
                ok = (r >= 0) & (r < n_rows) & (c >= 0) & (c < n_cols)
                buf[r[ok], c[ok]] = ivals[ok]
                filled[r[ok], c[ok]] = True

            order = np.lexsort(pts.T[::-1])  # by (t, i): legal for jacobi
            spts = pts[order]
            row_starts = np.flatnonzero(
                np.r_[True, spts[1:, 0] != spts[:-1, 0]])
            for lo, hi in zip(row_starts, np.r_[row_starts[1:], len(spts)]):
                r = int(spts[lo, 0]) - t0
                c = spts[lo:hi, 1] - c0
                src = filled[r - 1, c - 1] & filled[r - 1, c] & filled[r - 1, c + 1]
                if not src.all():
                    missing = c[np.argmin(src)]
                    raise KeyError((int(spts[lo, 0]) - 1, int(missing + c0)))
                buf[r, c] = (buf[r - 1, c - 1] + buf[r - 1, c]
                             + buf[r - 1, c + 1]) / 3.0
                filled[r, c] = True

            rr, cc = pts[:, 0] - t0, pts[:, 1] - c0
            self._write_output(
                tile, pa, lambda mpts: buf[mpts[:, 0] - t0, mpts[:, 1] - c0])
            self.stats.full_tiles += 1
            if self.record:
                tv = buf[rr, cc]
                self.full_tile_values.update(
                    {(int(t), int(i)): float(v)
                     for (t, i), v in zip(pts, tv)})
            last = pts[:, 0] == self.tsteps
            final[pts[last, 1]] = buf[rr[last], cc[last]]
        self.stats.publish(bench=self.spec.name, dtype=self.dtype)
        return final
