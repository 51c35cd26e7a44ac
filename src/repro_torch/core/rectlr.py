"""RECTLR — the SPARe reordering controller (paper Alg. 2, App. D).

Runs host-side when the all-reduce detects newly failed group(s):

* **Phase 0 — HK-FIXED.** Is the *committed* stack prefix (depth ``S_A``)
  still sufficient to collect all ``N`` shard types across survivors?
  In the fixed graph every slot is bound to one concrete type, so the
  Hopcroft-Karp feasibility test degenerates to exact coverage counting
  (each left vertex has edges only to slots holding its own type and any
  one of them completes the matching) — we implement it as the coverage
  test and property-test its equivalence with full HK.
* **Phase 1 — HK-FREE.** Smallest depth ``S* <= r`` at which a perfect
  types→slots matching exists when each group may freely permute its
  stack. Monotone in depth, so either a linear scan from ``S_A`` (paper
  Alg. 2) or binary search (paper App. D acceleration) applies. No
  feasible depth ⇒ wipe-out ⇒ flag system failure (global restart).
* **Phase 2 — MCMF.** Min-cost max-flow assignment of types to
  ``(group, slot<S*)`` with cost 0 for "slot already holds this type" and
  1 for a movement, so the reorder touches as few stacks as possible.

The controller also computes the **patch computes** (Alg. 1 line 19): shard
types whose every already-computed copy in the *current* step died with the
failing groups must be recomputed by a surviving host before the step's
all-reduce can complete.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .matching import hopcroft_karp, min_cost_assignment
from .state import SpareState

__all__ = ["Rectlr", "RectlrOutcome"]


@dataclass
class RectlrOutcome:
    """What the controller decided for one failure event."""

    wipeout: bool
    reordered: bool
    s_a_before: int
    s_a_after: int
    moves: int = 0                      # stack slots whose type changed
    patch: list[tuple[int, int]] = field(default_factory=list)  # (group, type)
    hk_free_calls: int = 0
    controller_seconds: float = 0.0

    @property
    def patch_count(self) -> int:
        return len(self.patch)


class Rectlr:
    """Stateless controller logic over a :class:`SpareState`.

    Parameters
    ----------
    binary_search: use the App.-D binary-search variant of HK-FREE
        (``O(log r)`` feasibility calls instead of ``O(r)``).
    """

    def __init__(self, binary_search: bool = False):
        self.binary_search = binary_search

    # ------------------------------------------------------------------ #
    # public entry point                                                 #
    # ------------------------------------------------------------------ #
    def on_failures(self, state: SpareState, failed: list[int] | np.ndarray) -> RectlrOutcome:
        """Process newly failed group(s) and mutate ``state`` accordingly.

        Follows Alg. 2 exactly; additionally computes the patch set for the
        interrupted step (Alg. 1 line 19) *before* committing the reorder,
        since patches are owed against the schedule that was executing when
        the failure hit.
        """
        t0 = time.perf_counter()
        failed = [int(f) for f in np.atleast_1d(np.asarray(failed))]
        s_a_before = state.s_a

        # ---- types lost from the in-flight step (for patch compute) ----
        lost_types = self._lost_supplier_types(state, failed)

        # ---- mark failures ----
        for w in failed:
            state.alive[w] = False
        if lost_types:
            state.supplier[np.asarray(lost_types, dtype=np.int64)] = (-1, -1)

        # ---- wipe-out short-circuit (some type has no surviving host) ----
        if state.wiped_types().size > 0:
            return RectlrOutcome(
                wipeout=True, reordered=False,
                s_a_before=s_a_before, s_a_after=s_a_before,
                controller_seconds=time.perf_counter() - t0,
            )

        # ---- patch compute for the interrupted step ----
        patch = self._assign_patches(state, lost_types)

        # ---- Phase 0: HK-FIXED on the committed prefix ----
        if bool(state.prefix_coverage(state.s_a).all()):
            self._reassign_suppliers_fixed(state)
            return RectlrOutcome(
                wipeout=False, reordered=False,
                s_a_before=s_a_before, s_a_after=state.s_a,
                patch=patch,
                controller_seconds=time.perf_counter() - t0,
            )

        # ---- Phase 1: HK-FREE — minimal feasible depth ----
        s_star, hk_calls = self._min_feasible_depth(state)
        if s_star is None:
            # Hall violation at every depth <= r: wipe-out by feasibility
            # (possible only via pathological multi-group Hall witnesses;
            # per Thm. 4.2 these are vanishingly rare — but handled).
            return RectlrOutcome(
                wipeout=True, reordered=False,
                s_a_before=s_a_before, s_a_after=s_a_before,
                hk_free_calls=hk_calls,
                controller_seconds=time.perf_counter() - t0,
            )

        # ---- Phase 2: MCMF minimal-movement reorder at depth S* ----
        if bool(state.prefix_coverage(s_star).all()):
            # zero-movement fast path: the existing order already covers all
            # types at depth S* — the min-cost assignment is the identity
            # (cost 0), so MCMF is skipped and only suppliers re-designate.
            state.s_a = s_star
            self._reassign_suppliers_fixed(state)
            moves = 0
        else:
            moves = self._reorder_min_movement(state, s_star)
            state.s_a = s_star
        return RectlrOutcome(
            wipeout=False, reordered=True,
            s_a_before=s_a_before, s_a_after=s_star,
            moves=moves, patch=patch, hk_free_calls=hk_calls,
            controller_seconds=time.perf_counter() - t0,
        )

    # ------------------------------------------------------------------ #
    # Phase 0 helpers                                                    #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _lost_supplier_types(state: SpareState, failed: list[int]) -> list[int]:
        """Types whose designated supplier for the in-flight step belongs to
        a newly failed group. These partial gradients were lost mid-step."""
        mask = np.isin(state.supplier[:, 0], np.asarray(failed, dtype=np.int64))
        return [int(i) for i in np.flatnonzero(mask)]

    @staticmethod
    def _assign_patches(state: SpareState, lost_types: list[int]) -> list[tuple[int, int]]:
        """Pick a surviving host for each lost type (patch compute).

        Prefers a survivor that *already computed the type* in its committed
        prefix this step (then the "patch" is free — just re-designate the
        supplier); otherwise chooses the least-loaded surviving host, which
        must compute one extra stack before the step's all-reduce.
        """
        patch: list[tuple[int, int]] = []
        extra_load = np.zeros(state.n, dtype=np.int64)
        for i in lost_types:
            hosts = state.hosts[i]
            live_hosts = hosts[state.alive[hosts]]
            assert live_hosts.size > 0, "caller guarantees no wipe-out here"
            # free re-designation: a live host already has i in its prefix?
            redesignated = False
            for w in live_hosts:
                js = np.flatnonzero(state.stacks[w, : state.s_a] == i)
                if js.size:
                    state.supplier[i] = (int(w), int(js[0]))
                    redesignated = True
                    break
            if redesignated:
                continue
            # otherwise: actual patch compute on the least-loaded live host
            w = int(live_hosts[np.argmin(extra_load[live_hosts])])
            extra_load[w] += 1
            patch.append((w, i))
            # supplier slot: conceptually an extra slot beyond the prefix;
            # it becomes consistent again after Phase 1/2 commit. Mark the
            # supplier as the patching group at its existing slot for i.
            j = int(np.flatnonzero(state.stacks[w] == i)[0])
            state.supplier[i] = (w, j) if j < state.s_a else (-1, -1)
        return patch

    @staticmethod
    def _reassign_suppliers_fixed(state: SpareState) -> None:
        """After Phase-0 success: every type has >= 1 alive prefix slot;
        designate one supplier per type (keep existing when still valid)."""
        # vectorized: which suppliers are still valid?
        w = state.supplier[:, 0]
        j = state.supplier[:, 1]
        valid = (w >= 0)
        if valid.any():
            wv = np.where(valid, w, 0)
            jv = np.where(valid, j, 0)
            valid &= state.alive[wv] & (jv < state.s_a)
            valid &= state.stacks[wv, jv] == np.arange(state.n)
        need = np.flatnonzero(~valid)
        if need.size == 0:
            return
        # build type -> (group, slot) map from alive prefixes in one pass
        alive_groups = state.survivors
        prefix = state.stacks[alive_groups, : state.s_a]       # (A, s)
        type_to_w = np.full(state.n, -1, dtype=np.int64)
        type_to_j = np.full(state.n, -1, dtype=np.int64)
        gg = np.repeat(alive_groups, state.s_a)
        jj = np.tile(np.arange(state.s_a), alive_groups.size)
        # reversed so the FIRST occurrence wins after overwrite
        type_to_w[prefix.ravel()[::-1]] = gg[::-1]
        type_to_j[prefix.ravel()[::-1]] = jj[::-1]
        assert (type_to_w[need] >= 0).all(), \
            "phase-0 coverage promised a prefix slot for every type"
        state.supplier[need, 0] = type_to_w[need]
        state.supplier[need, 1] = type_to_j[need]

    # ------------------------------------------------------------------ #
    # Phase 1 — HK-FREE                                                  #
    # ------------------------------------------------------------------ #
    def _min_feasible_depth(self, state: SpareState) -> tuple[int | None, int]:
        """Smallest ``S in [S_A, r]`` admitting a perfect free matching.

        Fast path per depth: if the *current* order already covers every
        type at depth ``s`` (vectorized check), the identity assignment is a
        perfect matching and HK is skipped — the common case right after a
        single failure, keeping the controller sub-10ms at N=1000.
        """
        lo, hi = state.s_a, state.r
        calls = 0

        def feasible(s: int) -> bool:
            nonlocal calls
            if bool(state.prefix_coverage(s).all()):
                return True
            calls += 1
            return self._feasible(state, s)

        if self.binary_search:
            # find any feasible point first (monotone predicate)
            if not feasible(hi):
                return None, calls
            while lo < hi:
                mid = (lo + hi) // 2
                if feasible(mid):
                    hi = mid
                else:
                    lo = mid + 1
            return lo, calls
        for s in range(lo, hi + 1):
            if feasible(s):
                return s, calls
        return None, calls

    @staticmethod
    def _feasible(state: SpareState, s: int) -> bool:
        """Perfect matching of N types onto survivors × s slots (free perm).

        Slots within one group are interchangeable under free permutation,
        so we match onto groups with capacity ``s`` by exploding each
        surviving group into ``s`` right-vertices.
        """
        survivors = state.survivors
        if survivors.size * s < state.n:
            return False  # capacity bound c(k) (Hall necessary condition)
        pos = -np.ones(state.n, dtype=np.int64)
        pos[survivors] = np.arange(survivors.size)
        adj: list[list[int]] = []
        for i in range(state.n):
            row = []
            for w in state.hosts[i]:
                p = pos[w]
                if p >= 0:
                    base = int(p) * s
                    row.extend(range(base, base + s))
            adj.append(row)
        size, _, _ = hopcroft_karp(adj, state.n, survivors.size * s)
        return size == state.n

    # ------------------------------------------------------------------ #
    # Phase 2 — MCMF                                                     #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _reorder_min_movement(state: SpareState, s_star: int) -> int:
        """Reorder stacks so depth-``s_star`` prefixes cover all types,
        moving as few slots as possible; commit suppliers. Returns the
        number of slots whose assigned type changed."""
        survivors = state.survivors
        pos = -np.ones(state.n, dtype=np.int64)
        pos[survivors] = np.arange(survivors.size)

        adj_cost: list[list[tuple[int, int]]] = []
        initial: list[int] = [-1] * state.n   # zero-cost jump-start matching
        for i in range(state.n):
            row: list[tuple[int, int]] = []
            for w in state.hosts[i]:
                p = pos[w]
                if p < 0:
                    continue
                for t in range(s_star):
                    slot = int(p) * s_star + t
                    if state.stacks[w, t] == i:
                        row.append((slot, 0))
                        if initial[i] == -1:
                            initial[i] = slot   # "stay" edge (unique per slot)
                    else:
                        row.append((slot, 1))
            adj_cost.append(row)
        matched, total_cost, match_l = min_cost_assignment(
            adj_cost, state.n, survivors.size * s_star, initial_match_l=initial
        )
        assert matched == state.n, "phase-1 feasibility promised a perfect matching"

        # apply the assignment group by group
        want: dict[int, dict[int, int]] = {int(w): {} for w in survivors}
        for i in range(state.n):
            v = match_l[i]
            w = int(survivors[v // s_star])
            t = v % s_star
            want[w][t] = i

        moves = 0
        for w, slot_map in want.items():
            row = state.stacks[w]
            new_row = np.full(state.r, -1, dtype=row.dtype)
            used = set()
            for t, i in slot_map.items():
                new_row[t] = i
                used.add(int(i))
            # remaining hosted types fill remaining slots in current order
            rest = [int(x) for x in row if int(x) not in used]
            free_slots = [t for t in range(state.r) if new_row[t] == -1]
            for t, x in zip(free_slots, rest):
                new_row[t] = x
            moves += int((new_row != row).sum())
            state.stacks[w] = new_row

        # commit suppliers from the matching
        for i in range(state.n):
            v = match_l[i]
            w = int(survivors[v // s_star])
            t = v % s_star
            state.supplier[i] = (w, t)
        return moves
