"""I/O transfer-cycle model (paper §5 protocol: on-FPGA cycle counters).

The PyTorch port's own copy of ``repro.core.transfer`` (host numpy; the port
imports nothing of ``repro``), numerically identical to it.
Its constants model the paper's FPGA bus (64-bit beats, an 8-cycle burst
start, 256 beats a burst), not a GPU: a ``transfer/cycles`` figure is a
model of that bus, never a measurement of the card the port runs on.

Models an AXI-style bus: a transaction (burst) of ``n`` bits costs
``init + ceil(n / bus_bits)`` cycles, with bursts capped at ``max_beats``
beats (AXI4: 256), long transfers paying the init latency once per burst.
Peak bandwidth = one beat/cycle, so *cycles* directly measure bandwidth
utilization — the paper's figure of merit.

Access patterns over the same tile I/O, mirroring §5.1.1:

* ``minimal``   — exact footprint on the original array layout, bursts where
                  the footprint happens to be contiguous (HLS-inferred);
* ``bbox``      — rectangular bounding box per array row (PolyOpt/HLS-style),
                  simple enough to always burst but transfers extra data;
* ``mars``      — MARS layout of §3.2 (ILP-coalesced bursts), padded words;
* ``mars_pack`` — MARS layout, bit-packed words (§2.4), no compression;
* ``mars_comp`` — compressed + packed MARS (§3.3), sizes from real data,
                  plus the bounded one-aligned-word slop per transaction end
                  (§3.3.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.obs import instrument as obs

from . import compression as comp
from . import packing
from .layout import LayoutResult
from .mars import MarsAnalysis, analyze
from .stencil import StencilSpec, stencil_values


@dataclasses.dataclass(frozen=True)
class TransferModel:
    bus_bits: int = 64
    burst_init: int = 8
    max_beats: int = 256

    def transaction_cycles(self, bits: int) -> int:
        if bits <= 0:
            return 0
        beats = -(-bits // self.bus_bits)
        bursts = -(-beats // self.max_beats)
        return self.burst_init * bursts + beats


# ---------------------------------------------------------------------------
# Original-allocation mapping (per benchmark)
# ---------------------------------------------------------------------------

def original_cells(name: str, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Map iteration points to (row_keys, innermost) original array cells.

    Row keys identify memory rows of the original allocation; the innermost
    coordinate is contiguous in memory within a row.
    """
    pts = np.asarray(points, dtype=np.int64)
    if name == "jacobi-1d":
        t, i = pts[:, 0], pts[:, 1]
        rows = (t % 2)[:, None]              # A/B ping-pong arrays
        return rows, i
    if name == "jacobi-2d":
        t, u, v = pts[:, 0], pts[:, 1], pts[:, 2]
        i, j = u - t, v - t
        rows = np.stack([t % 2, i], axis=1)
        return rows, j
    if name == "seidel-2d":
        t, u, v = pts[:, 0], pts[:, 1], pts[:, 2]
        i = u - 2 * t
        j = v - 3 * t - 2 * i
        rows = i[:, None]                    # single in-place array
        return rows, j
    raise KeyError(name)


def _dedup_cells(rows: np.ndarray, inner: np.ndarray):
    key = np.unique(np.concatenate([rows, inner[:, None]], axis=1), axis=0)
    return key[:, :-1], key[:, -1]


def _runs(rows: np.ndarray, inner: np.ndarray) -> List[int]:
    """Lengths of maximal contiguous runs within each row.

    Sorted with the row key as the *primary* lexsort key and the innermost
    (memory-contiguous) coordinate secondary, so adjacent cells of one row
    coalesce into a single run — ``rows=[0,0,0,1], inner=[0,1,2,0]`` is two
    runs ``[3, 1]``, not three.
    """
    if len(inner) == 0:
        return []
    # np.lexsort's LAST key is primary: pass (inner, ..., rows_0) so the
    # sort is lexicographic by row key first, innermost coordinate last
    keys = np.concatenate([rows, inner[:, None]], axis=1)
    order = np.lexsort(keys.T[::-1])
    rows_s, inner_s = rows[order], inner[order]
    same_row = np.all(rows_s[1:] == rows_s[:-1], axis=1)
    contiguous = same_row & (inner_s[1:] == inner_s[:-1] + 1)
    breaks = np.flatnonzero(~contiguous)
    edges = np.concatenate(([-1], breaks, [len(inner_s) - 1]))
    return [int(r) for r in np.diff(edges)]


def _bbox_bits(rows: np.ndarray, inner: np.ndarray, padded: int) -> List[int]:
    """Bounding-box transfer: one burst per distinct row key, full bbox width."""
    uniq = np.unique(rows, axis=0)
    width = int(inner.max() - inner.min() + 1)
    return [width * padded] * len(uniq)


# ---------------------------------------------------------------------------
# Per-tile I/O cycle accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileIO:
    read_cycles: int
    write_cycles: int
    read_bits: int
    write_bits: int
    read_transactions: int
    write_transactions: int

    @property
    def total_cycles(self) -> int:
        return self.read_cycles + self.write_cycles


class TileIOModel:
    """Per-tile I/O accounting for one stencil + tiling + layout.

    Caches the per-tile MARS analyses (the representative tile and its
    producer tiles) so repeated dtype/mode queries are cheap.
    """

    def __init__(self, spec: StencilSpec, analysis: MarsAnalysis,
                 layout_result: LayoutResult,
                 rep_tile: Tuple[int, ...] | None = None,
                 model: TransferModel = TransferModel()):
        self.spec = spec
        self.model = model
        self.order = list(layout_result.order)
        self.a = analysis if rep_tile is None else analyze(spec, rep_tile)
        c0 = self.a.spec.tile_of(self.a.out_mars[0].points[:1])[0]
        self._producers: Dict[Tuple[int, ...], MarsAnalysis] = {}
        for producer_off in self.a.consumed:
            rep = tuple(int(x) for x in (c0 + np.asarray(producer_off)))
            self._producers[producer_off] = analyze(spec, rep)

    # -- geometry ----------------------------------------------------------
    def input_mars_points(self) -> List[np.ndarray]:
        """Whole consumed MARS point sets, from the true producer tiles."""
        out: List[np.ndarray] = []
        for producer_off, mars_ids in self.a.consumed.items():
            pa = self._producers[producer_off]
            out.extend(pa.out_mars[mid].points for mid in mars_ids)
        return out

    def output_mars_points(self) -> List[np.ndarray]:
        return [m.points for m in self.a.out_mars]

    def coalesced_read_bursts(self) -> List[List[Tuple[Tuple[int, ...], int]]]:
        """Bursts as lists of (producer_offset, mars_id), per layout runs."""
        pos = {m: k for k, m in enumerate(self.order)}
        bursts: List[List[Tuple[Tuple[int, ...], int]]] = []
        for producer_off, mars_ids in self.a.consumed.items():
            ks = sorted(pos[m] for m in mars_ids)
            cur: List[Tuple[Tuple[int, ...], int]] = []
            prev = None
            for kpos in ks:
                if prev is not None and kpos != prev + 1:
                    bursts.append(cur)
                    cur = []
                cur.append((producer_off, self.order[kpos]))
                prev = kpos
            if cur:
                bursts.append(cur)
        return bursts

    def _values(self, points: np.ndarray, hist: np.ndarray) -> np.ndarray:
        return stencil_values(self.spec.name, hist, points)

    def _compressed_bits(self, points: np.ndarray, dtype: str,
                         hist: np.ndarray) -> int:
        words, nbits = comp.words_for(self._values(points, hist), dtype)
        return comp.compressed_cost_bits(words, nbits)

    # -- accounting --------------------------------------------------------
    def tile_io(self, dtype: str, mode: str,
                hist: np.ndarray | None = None) -> TileIO:
        nbits, padded = packing.dtype_widths(dtype)
        in_pts = self.input_mars_points()
        out_pts = self.output_mars_points()

        if mode == "minimal":
            rows, inner = original_cells(
                self.spec.name, np.concatenate(in_pts, axis=0))
            rows, inner = _dedup_cells(rows, inner)
            rbits = [r * padded for r in _runs(rows, inner)]
            orow, oinn = original_cells(
                self.spec.name, np.concatenate(out_pts, axis=0))
            orow, oinn = _dedup_cells(orow, oinn)
            wbits = [r * padded for r in _runs(orow, oinn)]
        elif mode == "bbox":
            rows, inner = original_cells(
                self.spec.name, np.concatenate(in_pts, axis=0))
            rbits = _bbox_bits(rows, inner, padded)
            orow, oinn = original_cells(
                self.spec.name, np.concatenate(out_pts, axis=0))
            wbits = _bbox_bits(orow, oinn, padded)
        elif mode in ("mars", "mars_pack", "mars_comp"):
            width = padded if mode == "mars" else nbits
            rbits = []
            for burst in self.coalesced_read_bursts():
                if mode == "mars_comp":
                    assert hist is not None, "mars_comp needs stencil data"
                    bits = sum(
                        self._compressed_bits(
                            self._producers[off].out_mars[mid].points,
                            dtype, hist)
                        for off, mid in burst)
                    bits += 2 * self.model.bus_bits  # §3.3.2 alignment slop
                else:
                    bits = sum(
                        self._producers[off].out_mars[mid].points.shape[0] * width
                        for off, mid in burst)
                rbits.append(bits)
            if mode == "mars_comp":
                assert hist is not None
                wtotal = sum(self._compressed_bits(p, dtype, hist)
                             for p in out_pts) + 2 * self.model.bus_bits
            else:
                wtotal = sum(p.shape[0] for p in out_pts) * width
            wbits = [wtotal]
        else:
            raise KeyError(mode)

        io = TileIO(
            read_cycles=sum(self.model.transaction_cycles(b) for b in rbits),
            write_cycles=sum(self.model.transaction_cycles(b) for b in wbits),
            read_bits=int(sum(rbits)),
            write_bits=int(sum(wbits)),
            read_transactions=len(rbits),
            write_transactions=len(wbits),
        )
        if obs.enabled():
            self._publish_io(io, dtype, mode, rbits, wbits)
        return io

    def _publish_io(self, io: TileIO, dtype: str, mode: str,
                    rbits: Sequence[int], wbits: Sequence[int]) -> None:
        """Emit per-pattern cycle/bit/beat counters for one tile_io call.

        Metric names and labels are the repo-wide convention documented in
        ``src/repro/obs/README.md``; ``repro_torch.obs.report`` pivots
        ``transfer/cycles`` on the ``pattern`` label to render Fig. 10.
        """
        labels = dict(bench=self.spec.name,
                      tile="x".join(map(str, self.spec.tile_sizes)),
                      dtype=dtype, pattern=mode)
        beats = sum(-(-b // self.model.bus_bits) for b in rbits)
        beats += sum(-(-b // self.model.bus_bits) for b in wbits)
        obs.counter_inc("transfer/cycles", io.total_cycles, **labels)
        obs.counter_inc("burst/beats", beats, **labels)
        for direction, bits, txns in (("read", io.read_bits,
                                       io.read_transactions),
                                      ("write", io.write_bits,
                                       io.write_transactions)):
            obs.counter_inc("transfer/bits", bits, dir=direction, **labels)
            obs.counter_inc("transfer/transactions", txns, dir=direction,
                            **labels)
        sp = obs.tracer().current()
        if sp is not None:
            sp.add_cycles(io.total_cycles)


MODES = ("minimal", "bbox", "mars", "mars_pack", "mars_comp")
