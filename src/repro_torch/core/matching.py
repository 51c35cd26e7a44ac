"""Bipartite matching + min-cost max-flow primitives for RECTLR (App. D).

Implemented from scratch (no external graph dependency):

* :func:`hopcroft_karp` — maximum bipartite matching in O(E sqrt(V)),
  used by HK-FIXED (Phase 0) and HK-FREE (Phase 1) feasibility checks.
* :class:`IncrementalMatcher` — maintains a type→slot matching across
  failure events, repairing only the assignments invalidated by the newly
  failed group (single Kuhn augmentations). Used by the Monte-Carlo driver
  where thousands of sequential failures would make full HK rebuilds the
  bottleneck. Equivalence with full HK is property-tested.
* :func:`min_cost_assignment` — min-cost max-cardinality assignment via
  successive shortest augmenting paths with 0-1 BFS (costs are {0,1}:
  0 = "type keeps its current slot", 1 = "type moves"). Used by MCMF
  (Phase 2) minimal-movement reordering.
"""
from __future__ import annotations

from collections import deque
from typing import Sequence

__all__ = [
    "hopcroft_karp",
    "IncrementalMatcher",
    "min_cost_assignment",
]

_INF = float("inf")


def hopcroft_karp(
    adj: Sequence[Sequence[int]], n_left: int, n_right: int
) -> tuple[int, list[int], list[int]]:
    """Maximum bipartite matching.

    Parameters
    ----------
    adj: adjacency list; ``adj[u]`` lists right-vertices reachable from
        left-vertex ``u``. Left vertices are shard types; right vertices are
        (surviving group, stack slot) pairs flattened to ints.

    Returns
    -------
    (size, match_l, match_r): matching cardinality, left→right assignment
    (-1 when unmatched) and right→left inverse.
    """
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    dist = [0] * n_left

    def bfs() -> bool:
        q: deque[int] = deque()
        found = False
        for u in range(n_left):
            if match_l[u] == -1:
                dist[u] = 0
                q.append(u)
            else:
                dist[u] = -1
        while q:
            u = q.popleft()
            for v in adj[u]:
                w = match_r[v]
                if w == -1:
                    found = True
                elif dist[w] == -1:
                    dist[w] = dist[u] + 1
                    q.append(w)
        return found

    def dfs(u: int) -> bool:
        # iterative DFS to avoid Python recursion limits at N ~ 1e3
        stack: list[tuple[int, int]] = [(u, 0)]
        path: list[tuple[int, int]] = []
        while stack:
            node, idx = stack.pop()
            nbrs = adj[node]
            advanced = False
            while idx < len(nbrs):
                v = nbrs[idx]
                idx += 1
                w = match_r[v]
                if w == -1:
                    # augment along path + (node, v)
                    match_l[node] = v
                    match_r[v] = node
                    for pn, pv in reversed(path):
                        match_l[pn] = pv
                        match_r[pv] = pn
                    return True
                if dist[w] == dist[node] + 1:
                    stack.append((node, idx))
                    path.append((node, v))
                    stack.append((w, 0))
                    advanced = True
                    break
            if not advanced:
                dist[node] = -1
                if path and stack:
                    path.pop()
                elif path:
                    path.pop()
        return False

    size = 0
    while bfs():
        for u in range(n_left):
            if match_l[u] == -1 and dfs(u):
                size += 1
    return size, match_l, match_r


class IncrementalMatcher:
    """Maintain a perfect matching of types onto (group, slot) capacity slots
    while groups fail one at a time.

    Right vertices are dynamic: a *group* ``w`` with capacity ``s`` exposes
    slots ``w*s_max + t`` for ``t < s``. For Monte-Carlo we only need
    feasibility at a given depth ``s`` (free permutation within groups), so
    capacity per surviving group is simply ``s``; we model it as group
    capacities rather than exploded slots for speed.
    """

    def __init__(self, hosts, n: int, depth: int):
        # hosts: (N, r) array-like; hosts[i] = groups hosting type i
        self.n = n
        self.hosts = [list(map(int, row)) for row in hosts]
        self.depth = depth
        self.alive = [True] * n
        self.cap = [depth] * n          # remaining capacity per group
        self.assign = [-1] * n          # type -> group
        self.load: list[list[int]] = [[] for _ in range(n)]  # group -> types

    def set_depth(self, depth: int) -> None:
        """Raise (or lower) per-group capacity; lowering may require rebuild."""
        if depth < self.depth:
            raise ValueError("capacity decrease not supported; rebuild instead")
        delta = depth - self.depth
        self.depth = depth
        if delta:
            for w in range(self.n):
                if self.alive[w]:
                    self.cap[w] += delta

    def _try_assign(self, i: int, visited: list[bool]) -> bool:
        """Kuhn augmenting step: place type ``i``, evicting via alternating
        paths if needed. ``visited`` marks groups explored this attempt."""
        for w in self.hosts[i]:
            if not self.alive[w] or visited[w]:
                continue
            visited[w] = True
            if self.cap[w] > 0:
                self.cap[w] -= 1
                self.assign[i] = w
                self.load[w].append(i)
                return True
        for w in self.hosts[i]:
            if not self.alive[w] or not visited[w]:
                continue
            # try to evict one of w's current types elsewhere
            for j in list(self.load[w]):
                if self._try_assign_evict(j, visited, banned=w):
                    self.load[w].remove(j)
                    self.assign[i] = w
                    self.load[w].append(i)
                    return True
        return False

    def _try_assign_evict(self, i: int, visited: list[bool], banned: int) -> bool:
        """Iterative alternating-path search (same traversal order as the
        natural recursion, but eviction chains grow one frame per displaced
        type — at N=1000 that exceeds CPython's default recursion limit,
        so the stack is explicit)."""
        # frame: [type, banned group, next host index, current eviction
        #         group (or -1), load snapshot, next load index]
        frames = [[i, banned, 0, -1, None, 0]]
        result: bool | None = None
        while frames:
            f = frames[-1]
            ftype, fban, _, fw, floads, fli = f
            if result is True:
                # child relocated floads[fli] out of fw: take its slot
                j = floads[fli]
                self.load[fw].remove(j)
                self.assign[ftype] = fw
                self.load[fw].append(ftype)
                frames.pop()
                continue                    # result stays True: unwind
            if result is False:
                f[5] = fli = fli + 1        # next eviction candidate
                result = None
            if fw >= 0:
                if fli < len(floads):
                    frames.append([floads[fli], fw, 0, -1, None, 0])
                    continue
                f[3] = fw = -1              # loads exhausted: scan on
            hosts_i = self.hosts[ftype]
            progressed = False
            while f[2] < len(hosts_i):
                w = hosts_i[f[2]]
                f[2] += 1
                if w == fban or not self.alive[w] or visited[w]:
                    continue
                visited[w] = True
                if self.cap[w] > 0:
                    self.cap[w] -= 1
                    self.assign[ftype] = w
                    self.load[w].append(ftype)
                    frames.pop()
                    result = True
                    progressed = True
                    break
                # full group: suspend here and try evicting its types
                f[3] = w
                f[4] = list(self.load[w])
                f[5] = 0
                progressed = True
                break
            if not progressed:
                frames.pop()
                result = False
        return bool(result)

    def initialise(self) -> bool:
        """Build the initial matching (depth slots per group)."""
        ok = True
        for i in range(self.n):
            visited = [False] * self.n
            if not self._try_assign(i, visited):
                ok = False
                break
        return ok

    def fail_group(self, w: int) -> list[int]:
        """Mark group ``w`` failed; return the displaced types (unassigned)."""
        if not self.alive[w]:
            return []
        self.alive[w] = False
        displaced = self.load[w]
        self.load[w] = []
        self.cap[w] = 0
        for i in displaced:
            self.assign[i] = -1
        return displaced

    def repair(self, displaced: list[int]) -> list[int]:
        """Re-place displaced types. Returns the list that could NOT be placed
        at the current depth (empty = feasible at current depth)."""
        stuck = []
        for i in displaced:
            visited = [False] * self.n
            if not self._try_assign(i, visited):
                stuck.append(i)
        return stuck

    def min_feasible_depth(self, displaced: list[int], r: int) -> int | None:
        """HK-FREE scan: smallest depth <= r at which all types place.

        Monotone in depth (App. D), so after each capacity bump we only retry
        the still-stuck types. Returns None on wipe-out.
        """
        stuck = self.repair(displaced)
        while stuck:
            if self.depth >= r:
                return None
            self.set_depth(self.depth + 1)
            stuck = self.repair(stuck)
        return self.depth


def min_cost_assignment(
    adj_cost: Sequence[Sequence[tuple[int, int]]],
    n_left: int,
    n_right: int,
    initial_match_l: Sequence[int] | None = None,
) -> tuple[int, int, list[int]]:
    """Min-cost max-cardinality bipartite assignment (small integer costs).

    ``adj_cost[u]`` lists ``(v, cost)`` edges. Successive shortest augmenting
    paths; each augmentation finds a shortest path in the residual graph via
    SPFA (label-correcting Bellman-Ford — residual back edges carry negative
    costs but an extreme matching admits no negative cycle).

    ``initial_match_l`` may seed a *zero-cost* partial matching (RECTLR's
    "stay" edges: types already sitting in a valid slot of their own). A
    zero-cost matching is trivially extreme (minimum cost among matchings of
    its cardinality), so SSP stays exact while only the displaced types need
    augmentation — the controller becomes O(displaced x E) per failure event
    instead of O(N x E).

    Returns ``(matched, total_cost, match_l)``.
    """
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    matched = 0
    total_cost = 0
    if initial_match_l is not None:
        for u, v in enumerate(initial_match_l):
            if v >= 0:
                assert match_r[v] == -1, "initial matching must be injective"
                match_l[u] = v
                match_r[v] = u
                matched += 1

    cost_of = [dict(row) for row in adj_cost]

    for src in range(n_left):
        if match_l[src] != -1:
            continue
        # SPFA shortest alternating path from src to any free right vertex.
        dist_l = [_INF] * n_left
        dist_r = [_INF] * n_right
        par_r = [-1] * n_right   # right v reached from left par_r[v]
        dist_l[src] = 0.0
        q: deque[int] = deque([src])
        in_q = [False] * n_left
        in_q[src] = True
        while q:
            u = q.popleft()
            in_q[u] = False
            du = dist_l[u]
            for v, c in adj_cost[u]:
                nd = du + c
                if nd < dist_r[v]:
                    dist_r[v] = nd
                    par_r[v] = u
                    w = match_r[v]
                    if w != -1:
                        nd2 = nd - cost_of[w][v]   # residual back edge
                        if nd2 < dist_l[w]:
                            dist_l[w] = nd2
                            if not in_q[w]:
                                q.append(w)
                                in_q[w] = True
        best_v, best_d = -1, _INF
        for v in range(n_right):
            if match_r[v] == -1 and dist_r[v] < best_d:
                best_d, best_v = dist_r[v], v
        if best_v == -1:
            continue  # src cannot be matched at all
        # augment: walk parents back to src, flipping matched edges
        v = best_v
        while True:
            u = par_r[v]
            prev_v = match_l[u]   # the right vertex u was matched to (-1 @src)
            match_l[u] = v
            match_r[v] = u
            if u == src:
                break
            v = prev_v
        matched += 1
        total_cost += int(best_d)
    return matched, total_cost, match_l
