"""Monte-Carlo validation of Thms. 4.1 / 4.2 (paper App. C, Tables 4-6):
a copy of the JAX package's jax-free ``repro.core.montecarlo``.

Emulates trails of random group failures over the cyclic-Golomb
placement and measures, per trial:

* ``F`` — failure count at first wipe-out (validates ``mu(N, r)``);
* the minimal feasible all-reduce stack ``S(U_k)`` after each failure
  event (validates the Eq. 6 lower bound of ``S_bar``).

Victims default to a uniformly random kill order (the paper's App. C
assumption) but may instead be drawn from any
:class:`repro_torch.scenarios.models.FailureModel` over a
:class:`repro_torch.scenarios.topology.ClusterTopology` — rack/pod bursts then
arrive as *batches* of simultaneous kills, and the wipe-out / stack
accounting sees the whole blast radius at once.

Feasibility at depth ``s`` is maintained *incrementally* with
:class:`repro_torch.core.matching.IncrementalMatcher` — rebuilding Hopcroft-
Karp from scratch for each of the ~700 failures x 1000 trials at N=1000
would dominate the run time; equivalence of the incremental matcher with
full HK is property-tested in ``tests/test_matching.py``. (The matcher's
eviction chains are iterative, so no ``sys.setrecursionlimit`` games are
needed at any N.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .golomb import host_sets
from .matching import IncrementalMatcher
from .theory import capacity

__all__ = ["McResult", "run_trial", "run_montecarlo"]


@dataclass
class McResult:
    n: int
    r: int
    trials: int
    mean_failures: float           # MC E[F] over wiped-out trials (NaN if 0)
    mean_stack: float              # Monte-Carlo E[S(U_k)] averaged over k
    censored: int = 0              # trials that never wiped out (F > N)
    failures: list[int] = field(default_factory=list, repr=False)
    stacks_per_k: list[float] = field(default_factory=list, repr=False)


def run_trial(n: int, r: int, rng: np.random.Generator,
              hosts: np.ndarray | None = None,
              kill_batches: Sequence[Sequence[int]] | None = None,
              ) -> tuple[int | None, list[int]]:
    """One failure trail: kill groups until the first wipe-out; record
    the minimal feasible depth after each failure event.

    ``kill_batches`` is an ordered sequence of simultaneous-kill groups
    (one inner list per failure event — rack/pod bursts kill several at
    once); the default is the single-kill uniform random order of the
    paper's App. C. Returns ``(F, depths)`` where ``F`` counts
    *individual* group failures up to and including the wipe-out and
    ``depths[j]`` is the feasible stack after the ``(j+1)``-th surviving
    event. ``F is None`` flags the censored corner: the kill sequence
    ran out without a wipe-out (for the default full permutation that is
    the r ~ N edge; custom ``kill_batches`` may stop earlier). The old
    behavior of returning ``n`` silently deflated ``mean_failures``.
    """
    if hosts is None:
        hosts = host_sets(n, r)
    if kill_batches is None:
        kill_batches = [[int(w)] for w in rng.permutation(n)]
    host_alive = np.full(n, r, dtype=np.int64)  # surviving hosts per type

    matcher = IncrementalMatcher(hosts, n, depth=1)
    ok = matcher.initialise()
    assert ok, "depth-1 matching must exist before any failure (cyclic cover)"

    depths: list[int] = []
    k = 0
    for batch in kill_batches:
        displaced: list[int] = []
        fresh_kills = 0
        for w in batch:
            w = int(w)
            if not matcher.alive[w]:
                continue
            fresh_kills += 1
            k += 1
            # wipe-out check first (cheap counter update)
            types_of_w = np.flatnonzero((hosts == w).any(axis=1))
            host_alive[types_of_w] -= 1
            if (host_alive[types_of_w] == 0).any():
                return k, depths
            displaced.extend(matcher.fail_group(w))
        if fresh_kills == 0:
            continue
        depth = matcher.min_feasible_depth(displaced, r)
        assert depth is not None, "no wipe-out but infeasible at depth r"
        # the matcher's depth only grows; c(k) says the true minimum may be
        # smaller than the matcher's sticky depth — rebuild when the
        # capacity bound is lower than what we are currently using.
        c_k = capacity(k, n)
        if depth > c_k:
            fresh = IncrementalMatcher(hosts, n, depth=c_k)
            fresh.alive = matcher.alive.copy()
            fresh.cap = [c_k if a else 0 for a in fresh.alive]
            if fresh.initialise():
                depth = c_k
                matcher = fresh
            else:
                d2 = c_k
                while d2 < depth:
                    d2 += 1
                    fresh2 = IncrementalMatcher(hosts, n, depth=d2)
                    fresh2.alive = matcher.alive.copy()
                    fresh2.cap = [d2 if a else 0 for a in fresh2.alive]
                    if fresh2.initialise():
                        matcher = fresh2
                        depth = d2
                        break
        depths.append(depth)
    return None, depths  # every group failed without wipe-out (r = N corner)


def run_montecarlo(n: int, r: int, trials: int = 200, seed: int = 0,
                   failure_model=None, topology=None) -> McResult:
    """Paper App. C experiment: ``trials`` independent failure trails.

    With a ``failure_model`` (spec dict, name, or instance — see
    :func:`repro_torch.scenarios.models.model_from_spec`) victims are drawn by
    blast radius over ``topology`` instead of uniformly; each trial
    re-samples the model's event stream. Censored trials (no wipe-out)
    are excluded from ``mean_failures`` and counted in ``censored``.
    """
    rng = np.random.default_rng(seed)
    hosts = host_sets(n, r)
    failures: list[int] = []
    stack_means: list[float] = []
    censored = 0
    for _ in range(trials):
        batches = None
        if failure_model is not None:
            from ..scenarios.models import sample_kill_batches
            batches = sample_kill_batches(failure_model, n, rng,
                                          topology=topology)
        f, depths = run_trial(n, r, rng, hosts, kill_batches=batches)
        if f is None:
            censored += 1
        else:
            failures.append(f)
        if depths:
            stack_means.append(float(np.mean(depths)))
    return McResult(
        n=n, r=r, trials=trials,
        # all-censored => no wipe-out ever observed: NaN, not a silent n
        mean_failures=float(np.mean(failures)) if failures else float("nan"),
        mean_stack=float(np.mean(stack_means)) if stack_means else 1.0,
        censored=censored,
        failures=failures,
        stacks_per_k=stack_means,
    )
