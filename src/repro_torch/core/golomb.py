"""Cyclic Golomb-ruler shard placement (paper Def. B.1, Lemma B.2).

A SPARe scheme ``(N, r)`` distributes ``N`` shard *types* across ``N``
model-parallel groups with redundancy ``r`` using an optimal Golomb ruler
``G_r = {g_0=0, ..., g_{r-1}}`` interpreted cyclically modulo ``N``:

    H_i = {(i - g) mod N : g in G_r}     (host set of type i)
    T_w = {(w + g) mod N : g in G_r}     (type set of group w)

The ruler property — all pairwise differences distinct — carries to Z_N
whenever ``N >= 2*g_{r-1} + 1``, and then guarantees ``|H_i ∩ H_j| <= 1``
for i != j (Lemma B.2): no two shard types share more than one host, which
makes wipe-out events of different types nearly independent (the Poisson
approximation underlying Thm. 4.1).

This module provides verified optimal rulers for ``r <= 27`` (covering the
paper's full sweep: N=200 up to r=12, N=600 up to r=20, N=1000 up to r=26)
plus a greedy modular Sidon-set fallback for configurations where the table
ruler does not fit modulo ``N``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "OPTIMAL_RULERS",
    "is_cyclic_golomb",
    "golomb_ruler",
    "host_sets",
    "type_sets",
    "max_redundancy",
    "validate_placement",
]

# Optimal Golomb rulers (marks), OGR project / OEIS A003022 canonical forms.
# OPTIMAL_RULERS[r] has r marks, first 0, minimal last mark. Every entry is
# re-verified by tests (all pairwise differences distinct as integers).
OPTIMAL_RULERS: dict[int, tuple[int, ...]] = {
    1: (0,),
    2: (0, 1),
    3: (0, 1, 3),
    4: (0, 1, 4, 6),
    5: (0, 1, 4, 9, 11),
    6: (0, 1, 4, 10, 12, 17),
    7: (0, 1, 4, 10, 18, 23, 25),
    8: (0, 1, 4, 9, 15, 22, 32, 34),
    9: (0, 1, 5, 12, 25, 27, 35, 41, 44),
    10: (0, 1, 6, 10, 23, 26, 34, 41, 53, 55),
    11: (0, 1, 4, 13, 28, 33, 47, 54, 64, 70, 72),
    12: (0, 2, 6, 24, 29, 40, 43, 55, 68, 75, 76, 85),
    13: (0, 2, 5, 25, 37, 43, 59, 70, 85, 89, 98, 99, 106),
    14: (0, 4, 6, 20, 35, 52, 59, 77, 78, 86, 89, 99, 122, 127),
    15: (0, 4, 20, 30, 57, 59, 62, 76, 100, 111, 123, 136, 144, 145, 151),
    16: (0, 1, 4, 11, 26, 32, 56, 68, 76, 115, 117, 134, 150, 163, 168, 177),
    17: (0, 5, 7, 17, 52, 56, 67, 80, 81, 100, 122, 138, 159, 165, 168, 191,
         199),
    18: (0, 2, 10, 22, 53, 56, 82, 83, 89, 98, 130, 148, 153, 167, 188, 192,
         205, 216),
    19: (0, 1, 6, 25, 32, 72, 100, 108, 120, 130, 153, 169, 187, 190, 204,
         231, 233, 242, 246),
    20: (0, 1, 8, 11, 68, 77, 94, 116, 121, 156, 158, 179, 194, 208, 212,
         228, 240, 253, 259, 283),
    21: (0, 2, 24, 56, 77, 82, 83, 95, 129, 144, 179, 186, 195, 255, 265,
         285, 293, 296, 310, 329, 333),
    22: (0, 1, 9, 14, 43, 70, 106, 122, 124, 128, 159, 179, 204, 223, 253,
         263, 270, 291, 330, 341, 353, 356),
    23: (0, 3, 7, 17, 61, 66, 91, 99, 114, 159, 171, 199, 200, 226, 235, 246,
         277, 316, 329, 348, 350, 366, 372),
    24: (0, 9, 33, 37, 38, 97, 122, 129, 140, 142, 152, 191, 205, 208, 252,
         278, 286, 326, 332, 353, 368, 384, 403, 425),
    25: (0, 12, 29, 39, 72, 91, 146, 157, 160, 161, 166, 191, 207, 214, 258,
         290, 316, 354, 372, 394, 396, 431, 459, 467, 480),
    26: (0, 1, 33, 83, 104, 110, 124, 163, 185, 200, 203, 249, 251, 258, 314,
         318, 343, 356, 386, 430, 440, 456, 464, 475, 487, 492),
    27: (0, 3, 15, 41, 66, 95, 97, 106, 142, 152, 220, 221, 225, 242, 295,
         330, 338, 354, 382, 388, 402, 415, 486, 504, 523, 546, 553),
}


def is_cyclic_golomb(marks: tuple[int, ...] | list[int], n: int) -> bool:
    """True iff all pairwise differences of ``marks`` are distinct and
    non-zero modulo ``n`` (i.e. ``marks`` is a Sidon / B_2 set in Z_n).

    This is the exact property Lemma B.2 needs: it implies
    ``|H_i ∩ H_j| <= 1`` for every pair of distinct shard types.
    """
    marks = list(marks)
    r = len(marks)
    if len(set(m % n for m in marks)) != r:
        return False
    diffs: set[int] = set()
    for a in range(r):
        for b in range(r):
            if a == b:
                continue
            d = (marks[a] - marks[b]) % n
            if d == 0 or d in diffs:
                return False
            diffs.add(d)
    return True


def _greedy_sidon_mod(r: int, n: int) -> tuple[int, ...] | None:
    """Greedy (Mian–Chowla style) Sidon set of size ``r`` in Z_n.

    Fallback for (N, r) where the optimal line ruler does not embed
    cyclically. Returns None if the greedy scan exhausts Z_n first.
    """
    marks = [0]
    diffs: set[int] = set()
    for cand in range(1, n):
        new_diffs = []
        ok = True
        for m in marks:
            d1 = (cand - m) % n
            d2 = (m - cand) % n
            if d1 == 0 or d2 == 0 or d1 in diffs or d2 in diffs or d1 == d2:
                ok = False
                break
            new_diffs.append(d1)
            new_diffs.append(d2)
        # also check the new differences don't collide with each other
        if ok and len(set(new_diffs)) != len(new_diffs):
            ok = False
        if ok:
            marks.append(cand)
            diffs.update(new_diffs)
            if len(marks) == r:
                return tuple(marks)
    return None


@lru_cache(maxsize=None)
def golomb_ruler(r: int, n: int) -> tuple[int, ...]:
    """Return a ruler of ``r`` marks that is cyclically Golomb modulo ``n``.

    Preference order: (1) the optimal ruler table (minimal span — loosest
    ``N >= 2*g_max + 1`` embedding constraint, matching the paper's choice),
    (2) greedy modular Sidon fallback.

    Raises ValueError when no such set can exist
    (pigeonhole: ``r*(r-1) > n - 1``) or the fallback fails.
    """
    if r < 1:
        raise ValueError(f"redundancy r must be >= 1, got {r}")
    if r == 1:
        return (0,)
    if r * (r - 1) > n - 1:
        raise ValueError(
            f"no cyclic Golomb ruler with r={r} marks exists mod N={n}: "
            f"needs r(r-1)={r*(r-1)} distinct non-zero residues, "
            f"only {n-1} available. Reduce r or increase N."
        )
    table = OPTIMAL_RULERS.get(r)
    if table is not None and is_cyclic_golomb(table, n):
        return table
    greedy = _greedy_sidon_mod(r, n)
    if greedy is not None and is_cyclic_golomb(greedy, n):
        return greedy
    raise ValueError(f"could not construct cyclic Golomb ruler for r={r}, N={n}")


def host_sets(n: int, r: int) -> np.ndarray:
    """Host sets H_i (paper Eq. 10) as an int array of shape (N, r).

    ``host_sets(n, r)[i]`` lists the groups hosting shard type ``i``.
    """
    g = np.asarray(golomb_ruler(r, n), dtype=np.int64)
    types = np.arange(n, dtype=np.int64)[:, None]
    return (types - g[None, :]) % n


def type_sets(n: int, r: int) -> np.ndarray:
    """Type sets T_w (paper Eq. 11) as an int array of shape (N, r).

    ``type_sets(n, r)[w]`` lists the shard types hosted by group ``w``.
    The default local stack order of group ``w`` is exactly this row:
    stack j computes type ``(w + g_j) mod N`` — stack 0 covers all N types
    (cyclic rotation), so the no-failure all-reduce stack is 1.
    """
    g = np.asarray(golomb_ruler(r, n), dtype=np.int64)
    groups = np.arange(n, dtype=np.int64)[:, None]
    return (groups + g[None, :]) % n


def max_redundancy(n: int) -> int:
    """Largest r this module can place for a given N (used by config checks)."""
    best = 1
    for r in range(2, min(len(OPTIMAL_RULERS) + 1, n)):
        try:
            golomb_ruler(r, n)
            best = r
        except ValueError:
            break
    return best


def validate_placement(n: int, r: int) -> None:
    """Assert the Lemma B.2 invariant |H_i ∩ H_j| <= 1 for all i != j.

    O(N * r^2) via the difference-set argument: two types i != j share two
    hosts iff some difference repeats; we check directly on host sets for
    defence in depth (tests call this for every config).
    """
    h = host_sets(n, r)
    # membership matrix: M[i, w] = 1 iff group w hosts type i
    m = np.zeros((n, n), dtype=np.int8)
    rows = np.repeat(np.arange(n), r)
    m[rows, h.ravel()] = 1
    overlap = m @ m.T  # overlap[i, j] = |H_i ∩ H_j|
    np.fill_diagonal(overlap, 0)
    worst = int(overlap.max()) if n > 1 else 0
    if worst > 1:
        raise AssertionError(
            f"placement invariant violated for N={n}, r={r}: "
            f"two types share {worst} hosts"
        )
