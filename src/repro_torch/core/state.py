"""SPARe protocol state (paper Alg. 1 context).

:class:`SpareState` holds everything the SPARe training loop tracks between
steps: the cyclic-Golomb placement, per-group *persistent local stack orders*
``stk[w]`` (a permutation of the group's type set ``T_w``), the survivor
set, the committed *all-reduce stack* ``S_A``, and the designated supplier
of each shard type (which (group, slot) contributes that type's partial
gradient to the weighted all-reduce).

The state is deliberately a plain host-side object (NumPy only): SPARe's
control plane runs on the coordinator between device steps — it never enters
the compiled SPMD program. The device-side view of this state is the
``(weights, stack order)`` pair produced by :meth:`supplier_weights` /
:meth:`device_schedule`, which the trainer feeds to the jitted train step.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .golomb import host_sets, type_sets

__all__ = ["SpareState"]


@dataclass
class SpareState:
    """Mutable SPARe bookkeeping for one training job.

    Attributes
    ----------
    n: data-parallel degree (number of model-parallel groups and shard types).
    r: redundancy degree (stacks hosted per group).
    hosts: ``(N, r)`` — ``hosts[i]`` = groups hosting shard type ``i``.
    types: ``(N, r)`` — ``types[w]`` = shard types hosted by group ``w``.
    stacks: ``(N, r)`` — current *stack order*; ``stacks[w][j]`` is the type
        group ``w`` computes at stack depth ``j``. Row ``w`` is always a
        permutation of ``types[w]``.
    alive: ``(N,)`` bool survivor mask.
    s_a: committed all-reduce stack depth ``S_A`` (paper: default 1).
    supplier: ``(N, 2)`` — ``supplier[i] = (w, j)``: the designated group and
        stack slot contributing type ``i``'s partial gradient. ``(-1, -1)``
        when the type is currently unassigned (transient, mid-recovery).
    """

    n: int
    r: int
    hosts: np.ndarray = field(init=False)
    types: np.ndarray = field(init=False)
    stacks: np.ndarray = field(init=False)
    alive: np.ndarray = field(init=False)
    s_a: int = field(init=False, default=1)
    supplier: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        if not (1 <= self.r <= self.n):
            raise ValueError(f"need 1 <= r <= N, got r={self.r}, N={self.n}")
        self.hosts = host_sets(self.n, self.r)
        self.types = type_sets(self.n, self.r)
        self.reset()

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #
    def reset(self) -> None:
        """Global restart (Alg. 1 line 13): all groups active, original
        stack order (stack 0 covers all N types by cyclic rotation),
        all-reduce stack back to 1."""
        self.stacks = self.types.copy()
        self.alive = np.ones(self.n, dtype=bool)
        self.s_a = 1
        # default supplier: type i at (group i, slot 0) — stacks[i][0] == i
        self.supplier = np.stack(
            [np.arange(self.n), np.zeros(self.n, dtype=np.int64)], axis=1
        )

    # ------------------------------------------------------------------ #
    # views                                                              #
    # ------------------------------------------------------------------ #
    @property
    def survivors(self) -> np.ndarray:
        """Indices of active groups (``U_k``)."""
        return np.flatnonzero(self.alive)

    @property
    def failure_count(self) -> int:
        return int(self.n - self.alive.sum())

    def surviving_host_counts(self) -> np.ndarray:
        """``(N,)`` — number of surviving hosts per type; 0 = wiped out."""
        return self.alive[self.hosts].sum(axis=1)

    def wiped_types(self) -> np.ndarray:
        return np.flatnonzero(self.surviving_host_counts() == 0)

    def prefix_coverage(self, s: int | None = None) -> np.ndarray:
        """``(N,)`` bool — is type ``i`` present in some alive group's first
        ``s`` stacks? (HK-FIXED reduces to this coverage test because in the
        *fixed* graph each slot is bound to exactly one type — see App. D.)"""
        s = self.s_a if s is None else s
        covered = np.zeros(self.n, dtype=bool)
        prefix = self.stacks[self.alive, :s]
        covered[prefix.ravel()] = True
        return covered

    def assert_invariants(self) -> None:
        """Cheap structural sanity — used by property tests after every
        controller action."""
        assert 1 <= self.s_a <= self.r, f"S_A={self.s_a} out of [1, {self.r}]"
        # each stack row is a permutation of the group's type set
        assert np.array_equal(np.sort(self.stacks, axis=1), np.sort(self.types, axis=1)), (
            "stack rows must remain permutations of their type sets"
        )
        # each type's supplier (when set) is an alive host with the type in
        # its committed prefix
        for i in range(self.n):
            w, j = self.supplier[i]
            if w < 0:
                continue
            assert self.alive[w], f"type {i} supplied by dead group {w}"
            assert j < self.s_a, f"type {i} supplied beyond S_A ({j} >= {self.s_a})"
            assert self.stacks[w, j] == i, (
                f"supplier slot mismatch: stacks[{w},{j}]={self.stacks[w, j]} != {i}"
            )

    # ------------------------------------------------------------------ #
    # device-facing schedule                                             #
    # ------------------------------------------------------------------ #
    def device_schedule(self) -> tuple[np.ndarray, np.ndarray]:
        """Return ``(stack_types, weights)`` for the SPMD train step.

        ``stack_types``: ``(N, S_A)`` int — shard type computed by group
        ``w`` at stack slot ``j`` (the data pipeline gathers microbatches by
        these ids; rows of dead groups are kept for shape stability but
        carry zero weight).

        ``weights``: ``(N, S_A)`` float — ``1/N`` where ``(w, j)`` is the
        designated supplier of its type, else ``0``. The weighted
        ``psum`` over the data axis then reproduces the logical gradient
        ``ḡ = (1/N) Σ_i g_i`` exactly — reordering changes suppliers, never
        the collected gradient (paper §3.1 invariant).
        """
        stack_types = self.stacks[:, : self.s_a].copy()
        weights = np.zeros((self.n, self.s_a), dtype=np.float64)
        for i in range(self.n):
            w, j = self.supplier[i]
            if w >= 0:
                weights[w, j] = 1.0 / self.n
        return stack_types, weights

    def supplier_weights(self) -> np.ndarray:
        _, weights = self.device_schedule()
        return weights
