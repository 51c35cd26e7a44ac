"""Cluster topology model: groups -> hosts -> racks -> pods -> DCI domains.

The DES abstracts a cluster as ``N`` data-parallel groups of ``M``
model-sharded accelerators (paper Table 1: 600k H100 at N=600 means
1000 GPUs per group). Physically those GPUs live on hosts packed into
racks, racks into pods, pods into datacenter-interconnect (DCI) domains
— and production failures respect *that* hierarchy, not the logical
group numbering: a PDU trip takes a rack, a cooling event takes a pod,
a fiber cut takes a DCI domain (Kokolis et al. 2025 report rack- and
pod-level co-failures dominating downtime at 100k+ scale).

:class:`ClusterTopology` maps the hierarchy with a contiguous layout —
group ``g`` occupies hosts ``[g*H, (g+1)*H)``, rack ``k`` holds hosts
``[k*R, (k+1)*R)``, and so on — which is exactly how the production
mesh in :mod:`repro.launch.mesh` lays DP slices along the ``pod`` and
``data`` axes (the ``pod`` axis crosses the DCI boundary). Everything
is integer arithmetic on demand: a 600k-GPU preset costs nothing to
instantiate, and instances are frozen/hashable/picklable so campaign
cells can carry them across process boundaries.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["ClusterTopology", "TOPOLOGY_PRESETS", "topology_from_spec"]

#: failure scopes ordered from smallest to largest blast radius
SCOPES = ("group", "host", "rack", "pod", "dci")


@dataclass(frozen=True)
class ClusterTopology:
    """Contiguous group -> host -> rack -> pod -> DCI layout.

    ``hosts_per_group`` is the model-parallel span of one DP group (how
    many hosts its M shards occupy); the remaining fields describe the
    physical packaging. Defaults give a small, rack-dominated layout
    suitable for the N=200..1000 DES scales.
    """

    n_groups: int
    hosts_per_group: int = 1
    hosts_per_rack: int = 8
    racks_per_pod: int = 16
    pods_per_dci: int = 4
    gpus_per_host: int = 8

    def __post_init__(self):
        for f in ("n_groups", "hosts_per_group", "hosts_per_rack",
                  "racks_per_pod", "pods_per_dci", "gpus_per_host"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1")

    # ------------------------------------------------------------- #
    # sizes                                                         #
    # ------------------------------------------------------------- #
    @property
    def n_hosts(self) -> int:
        return self.n_groups * self.hosts_per_group

    @property
    def n_racks(self) -> int:
        return math.ceil(self.n_hosts / self.hosts_per_rack)

    @property
    def n_pods(self) -> int:
        return math.ceil(self.n_racks / self.racks_per_pod)

    @property
    def n_dcis(self) -> int:
        return math.ceil(self.n_pods / self.pods_per_dci)

    @property
    def total_gpus(self) -> int:
        return self.n_hosts * self.gpus_per_host

    # ------------------------------------------------------------- #
    # downward maps (containment)                                   #
    # ------------------------------------------------------------- #
    def hosts_of_group(self, g: int) -> range:
        return range(g * self.hosts_per_group, (g + 1) * self.hosts_per_group)

    def rack_of_host(self, h: int) -> int:
        return h // self.hosts_per_rack

    def pod_of_rack(self, k: int) -> int:
        return k // self.racks_per_pod

    def dci_of_pod(self, q: int) -> int:
        return q // self.pods_per_dci

    def group_of_host(self, h: int) -> int:
        return h // self.hosts_per_group

    def racks_of_group(self, g: int) -> range:
        first = self.rack_of_host(g * self.hosts_per_group)
        last = self.rack_of_host((g + 1) * self.hosts_per_group - 1)
        return range(first, last + 1)

    # ------------------------------------------------------------- #
    # upward maps (blast radii)                                     #
    # ------------------------------------------------------------- #
    def _groups_of_host_span(self, h0: int, h1: int) -> list[int]:
        """Groups with at least one host in ``[h0, h1)``."""
        g0 = h0 // self.hosts_per_group
        g1 = (h1 - 1) // self.hosts_per_group
        return [g for g in range(g0, g1 + 1) if g < self.n_groups]

    def groups_in_rack(self, k: int) -> list[int]:
        h0 = k * self.hosts_per_rack
        return self._groups_of_host_span(h0, min(h0 + self.hosts_per_rack,
                                                 self.n_hosts))

    def groups_in_pod(self, q: int) -> list[int]:
        k0 = q * self.racks_per_pod
        h0 = k0 * self.hosts_per_rack
        h1 = (k0 + self.racks_per_pod) * self.hosts_per_rack
        return self._groups_of_host_span(h0, min(h1, self.n_hosts))

    def groups_in_dci(self, d: int) -> list[int]:
        q0 = d * self.pods_per_dci
        h0 = q0 * self.racks_per_pod * self.hosts_per_rack
        h1 = ((q0 + self.pods_per_dci) * self.racks_per_pod
              * self.hosts_per_rack)
        return self._groups_of_host_span(h0, min(h1, self.n_hosts))

    def blast_radius(self, g: int, scope: str) -> list[int]:
        """All groups co-located with group ``g`` at the given scope —
        the simultaneous-failure set when that domain fails."""
        if scope in ("group", "host"):
            return [g]
        groups: set[int] = set()
        if scope == "rack":
            for k in self.racks_of_group(g):
                groups.update(self.groups_in_rack(k))
        elif scope == "pod":
            pods = {self.pod_of_rack(k) for k in self.racks_of_group(g)}
            for q in pods:
                groups.update(self.groups_in_pod(q))
        elif scope == "dci":
            dcis = {self.dci_of_pod(self.pod_of_rack(k))
                    for k in self.racks_of_group(g)}
            for d in dcis:
                groups.update(self.groups_in_dci(d))
        else:
            raise ValueError(f"unknown scope {scope!r}; have {SCOPES}")
        return sorted(groups)

    def resolve(self, scope: str, loc: int) -> list[int]:
        """Trace-event resolution: groups killed by a failure of
        ``scope``-level location ``loc``. Locations wrap modulo the
        domain count so traces recorded on other cluster shapes replay
        portably."""
        if scope == "group":
            return [loc % self.n_groups]
        if scope == "host":
            return [self.group_of_host(loc % self.n_hosts)]
        if scope == "rack":
            return self.groups_in_rack(loc % self.n_racks)
        if scope == "pod":
            return self.groups_in_pod(loc % self.n_pods)
        if scope == "dci":
            return self.groups_in_dci(loc % self.n_dcis)
        raise ValueError(f"unknown scope {scope!r}; have {SCOPES}")

    # ------------------------------------------------------------- #
    # constructors                                                  #
    # ------------------------------------------------------------- #
    @classmethod
    def for_gpu_count(cls, total_gpus: int, n_groups: int,
                      gpus_per_host: int = 8, hosts_per_rack: int = 8,
                      racks_per_pod: int = 16,
                      pods_per_dci: int = 4) -> "ClusterTopology":
        """Size the hierarchy from a GPU budget (paper Table 1 scales:
        e.g. 600k GPUs over N=600 groups => 125 hosts per group)."""
        hosts_per_group = max(1, total_gpus // (n_groups * gpus_per_host))
        return cls(n_groups=n_groups, hosts_per_group=hosts_per_group,
                   hosts_per_rack=hosts_per_rack, racks_per_pod=racks_per_pod,
                   pods_per_dci=pods_per_dci, gpus_per_host=gpus_per_host)

    @classmethod
    def from_mesh(cls, multi_pod: bool = False) -> "ClusterTopology":
        """The production-mesh layout of :mod:`repro.launch.mesh`
        (without importing jax): single-pod (16, 16) => 16 DP groups in
        one pod; multi-pod (2, 16, 16) => 32 DP groups, the ``pod``
        axis crossing the DCI boundary (one pod per DCI domain)."""
        if multi_pod:
            return cls(n_groups=32, hosts_per_group=4, hosts_per_rack=8,
                       racks_per_pod=8, pods_per_dci=1, gpus_per_host=4)
        return cls(n_groups=16, hosts_per_group=4, hosts_per_rack=8,
                   racks_per_pod=8, pods_per_dci=1, gpus_per_host=4)


#: paper-scale presets (Table 1 N-points at 100k-600k GPUs)
TOPOLOGY_PRESETS: dict[str, dict] = {
    "100k": dict(total_gpus=100_000, n_groups=200),
    "200k": dict(total_gpus=200_000, n_groups=200),
    "360k": dict(total_gpus=360_000, n_groups=600),
    "600k": dict(total_gpus=600_000, n_groups=600),
    "1m":   dict(total_gpus=1_000_000, n_groups=1000),
}


def topology_from_spec(spec, n_groups: int | None = None) -> ClusterTopology:
    """Build a topology from a preset name, kwargs dict, or instance.

    ``None`` gives the default small layout for ``n_groups`` (which is
    then required). Dict specs may carry ``preset`` plus overrides.
    """
    if isinstance(spec, ClusterTopology):
        return spec
    if spec is None:
        if n_groups is None:
            raise ValueError("n_groups required when spec is None")
        return ClusterTopology(n_groups=n_groups)
    if isinstance(spec, str):
        if spec not in TOPOLOGY_PRESETS:
            raise KeyError(f"unknown topology preset {spec!r}; "
                           f"have {sorted(TOPOLOGY_PRESETS)}")
        return ClusterTopology.for_gpu_count(**TOPOLOGY_PRESETS[spec])
    if isinstance(spec, dict):
        kw = dict(spec)
        preset = kw.pop("preset", None)
        if preset is not None:
            base = dict(TOPOLOGY_PRESETS[preset])
            base.update(kw)
            return ClusterTopology.for_gpu_count(**base)
        if "total_gpus" in kw:
            return ClusterTopology.for_gpu_count(**kw)
        kw.setdefault("n_groups", n_groups)
        if kw["n_groups"] is None:
            raise ValueError("n_groups required in topology spec")
        return ClusterTopology(**kw)
    raise TypeError(f"cannot build a topology from {spec!r}")
