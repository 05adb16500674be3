"""Layout/codec invariant pass over the stencil config zoo (port of
``repro.analysis.layout_invariants``, over ``repro_torch.core``).

For every ``(benchmark, tile_sizes)`` pair in ``core/stencil.ZOO`` —
the same grid Table 1 is validated on — this pass re-derives the MARS
analysis and proves the solved layout and the codec's bit format hold
their invariants *before* anything is generated or run:

* **LAY301 invalid permutation** (error): the solved layout order must
  be a permutation of ``range(n_out)`` — a repeated or missing MARS
  index means the address generator would drop or duplicate data.
* **LAY302 burst accounting** (error): the reported ``read_bursts``
  must equal ``count_bursts(order, consumed_sets)`` recomputed from
  scratch, ``write_bursts`` must be 1 (output MARS are laid out in
  layout order, one contiguous stream), and for small instances
  (``n_out <= 8``) the burst count must match ``brute_force_layout``'s
  optimum — the solver may not silently go sub-optimal where
  exhaustive search is feasible.
* **LAY303 partition violation** (error): ``mars.check_partition`` —
  every tile point in exactly one consumed MARS, no consumer-less MARS
  (irredundancy + atomicity, §3).
* **LAY304 codec bounds** (error): for every paper data type, the
  compressed bit format stays inside its envelope: the length field
  ``F = length_field_bits(nbits)`` can index every magnitude length in
  ``[0, nbits]``; a synthetic per-MARS stream's markers are strictly
  increasing, word+bit aligned (``0 <= fine < bus_bits``), inside the
  stream, and each MARS independently seek-decodes back to its input.

Pure numpy/stdlib over the port's own copies of the host analysis, so
this pass runs anywhere.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import layout, mars, stencil
from repro_torch.core.compression import (compress_mars_stream,
                                          decompress_mars, length_field_bits)
from repro_torch.core.packing import DATA_TYPES

from .findings import Finding

PASS_NAME = "layout-invariants"

#: brute-force optimality cross-check limit (8! orders)
BRUTE_LIMIT = 8


def _loc(name: str, tile_sizes: Sequence[int]) -> str:
    return f"stencil:{name}@{'x'.join(map(str, tile_sizes))}"


def check_layout(name: str, tile_sizes: Sequence[int],
                 analysis=None, result=None) -> List[Finding]:
    """LAY301 + LAY302 for one zoo entry.

    ``result`` injects a precomputed (possibly corrupted) LayoutResult —
    the selftest path proving the rule actually fires.
    """
    a = analysis if analysis is not None else (
        mars.analyze(stencil.SPECS[name](tuple(tile_sizes))))
    lr = result if result is not None else layout.layout_for_analysis(a)
    loc = _loc(name, tile_sizes)
    findings: List[Finding] = []

    if sorted(lr.order) != list(range(a.n_out)):
        findings.append(Finding(
            rule="LAY301", severity="error", location=loc,
            message=(f"layout order {list(lr.order)} is not a permutation "
                     f"of range({a.n_out}) — address generator would "
                     "drop/duplicate MARS"),
            pass_name=PASS_NAME))
        return findings  # burst accounting is meaningless on a non-perm

    consumed_sets = list(a.consumed.values())
    recount = layout.count_bursts(lr.order, consumed_sets)
    if lr.read_bursts != recount:
        findings.append(Finding(
            rule="LAY302", severity="error", location=loc,
            message=(f"solver reports {lr.read_bursts} read bursts but "
                     f"count_bursts(order) == {recount}"),
            pass_name=PASS_NAME))
    if lr.write_bursts != 1:
        findings.append(Finding(
            rule="LAY302", severity="error", location=loc,
            message=(f"write_bursts == {lr.write_bursts}, expected 1 "
                     "(outputs are one contiguous stream in layout order)"),
            pass_name=PASS_NAME))
    if a.n_out <= BRUTE_LIMIT:
        opt = layout.brute_force_layout(a.n_out, consumed_sets)
        if lr.read_bursts != opt.read_bursts:
            findings.append(Finding(
                rule="LAY302", severity="error", location=loc,
                message=(f"solver burst count {lr.read_bursts} != brute-"
                         f"force optimum {opt.read_bursts} (n_out="
                         f"{a.n_out} is exhaustively checkable)"),
                pass_name=PASS_NAME))
    return findings


def check_partition(name: str, tile_sizes: Sequence[int],
                    analysis=None) -> List[Finding]:
    """LAY303 for one zoo entry."""
    a = analysis if analysis is not None else (
        mars.analyze(stencil.SPECS[name](tuple(tile_sizes))))
    try:
        mars.check_partition(a)
    except AssertionError as e:
        return [Finding(
            rule="LAY303", severity="error",
            location=_loc(name, tile_sizes),
            message=f"MARS partition violated: {e}",
            pass_name=PASS_NAME)]
    return []


def check_codec(name: str, tile_sizes: Sequence[int],
                analysis=None, bus_bits: int = 64) -> List[Finding]:
    """LAY304 for one zoo entry, across every paper data type."""
    a = analysis if analysis is not None else (
        mars.analyze(stencil.SPECS[name](tuple(tile_sizes))))
    loc = _loc(name, tile_sizes)
    findings: List[Finding] = []
    sizes = [m.size for m in a.out_mars] or [1]

    for dtype, (nbits, width) in sorted(DATA_TYPES.items()):
        if nbits > 64:
            findings.append(Finding(
                rule="LAY304", severity="error", location=f"{loc}/{dtype}",
                message=f"nbits {nbits} exceeds the 64-bit codec word",
                pass_name=PASS_NAME))
            continue
        F = length_field_bits(nbits)
        if (1 << F) <= nbits:
            findings.append(Finding(
                rule="LAY304", severity="error", location=f"{loc}/{dtype}",
                message=(f"length field F={F} cannot index magnitude "
                         f"lengths up to nbits={nbits}"),
                pass_name=PASS_NAME))
        # synthetic per-MARS payloads, deterministic, full bit range
        rng = np.random.RandomState(len(name) * 7 + sum(tile_sizes))
        mask = (1 << nbits) - 1 if nbits < 64 else (1 << 64) - 1
        data = [rng.randint(0, 1 << 30, size=max(s, 1)).astype(np.uint64)
                & np.uint64(mask) for s in sizes]
        # synthetic payloads: suppress obs so the linter's probe streams
        # never leak compression/* series into a surrounding bench run
        from repro_torch.obs import instrument as obs
        with obs.disabled_scope():
            stream = compress_mars_stream(data, nbits, bus_bits=bus_bits)
        prev_bit = -1
        for i, m in enumerate(stream.markers):
            bit = m.coarse * bus_bits + m.fine
            if not 0 <= m.fine < bus_bits:
                findings.append(Finding(
                    rule="LAY304", severity="error",
                    location=f"{loc}/{dtype}",
                    message=(f"marker {i} fine offset {m.fine} outside "
                             f"[0, bus_bits={bus_bits})"),
                    pass_name=PASS_NAME))
            if bit <= prev_bit or bit > stream.total_bits:
                findings.append(Finding(
                    rule="LAY304", severity="error",
                    location=f"{loc}/{dtype}",
                    message=(f"marker {i} bit offset {bit} not strictly "
                             f"increasing inside the {stream.total_bits}-"
                             "bit stream"),
                    pass_name=PASS_NAME))
            prev_bit = bit
        for i, arr in enumerate(data):
            got = decompress_mars(stream, i)
            if not np.array_equal(got, arr):
                findings.append(Finding(
                    rule="LAY304", severity="error",
                    location=f"{loc}/{dtype}",
                    message=(f"MARS {i} does not round-trip through "
                             "seek-decode at its marker"),
                    pass_name=PASS_NAME))
                break
    return findings


def run_pass(zoo: Optional[Dict[str, Tuple[Tuple[int, ...], ...]]] = None
             ) -> List[Finding]:
    zoo = zoo if zoo is not None else stencil.ZOO
    findings: List[Finding] = []
    for name, tiles in zoo.items():
        for ts in tiles:
            a = mars.analyze(stencil.SPECS[name](tuple(ts)))
            findings.extend(check_layout(name, ts, a))
            findings.extend(check_partition(name, ts, a))
            findings.extend(check_codec(name, ts, a))
    return findings
