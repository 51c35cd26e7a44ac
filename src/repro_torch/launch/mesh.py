"""The process groups of the port (the counterpart of
``repro.launch.mesh``).

The JAX package lays its ranks on a ``(data, model)`` device mesh; here
each rank of a ``torch.distributed`` group is one point of that grid.
At model degree 1 every rank is one data slice. At model degree ``M``,
:func:`init_mesh_groups` cuts the group into the grid's rows and
columns: rank ``d * M + m`` is grid point ``(d, m)``, as JAX's
``devices.reshape(data, model)`` places its devices. Torch has no mesh
object, so the production meshes' axis sizes are a plain dict
(:data:`PRODUCTION_AXES`), and :func:`production_groups` cuts a group of
256 or 512 ranks into the production grid: the data group of the
two-pod grid is the 32 ranks of ``("pod", "data")``, pod outermost, the
order of the rule table's tuple entry. :meth:`MeshGroups.coords` gives a
rank's coordinates in the form
:func:`repro_torch.dist.sharding.local_shard` takes.

Nothing tells a program of a cluster, so :func:`init_data_group` is
given its world size and rank, and rendezvous goes through a
``FileStore`` (no network, no port): a fresh temporary file for one
rank, a shared path for several. The backend follows the count of ranks
and cards (:func:`data_backend`): with a card for every rank the group
carries both backends, NCCL for CUDA tensors and gloo for CPU ones,
whichever device asks first (so a CPU reference run can share the
process with the card's); without a card, or with more ranks than cards
(NCCL refuses two ranks on one device), gloo alone, which takes CUDA
tensors too, through the host, at a small fraction of NCCL's speed.

:func:`spawn_ranks` runs one function on several ranks, each a spawned
process with the group up.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import sys
import tempfile
import traceback
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["init_data_group", "close_data_group", "require_nccl",
           "data_backend", "shares_card", "spawn_ranks",
           "init_mesh_groups", "MeshGroups", "dp_axes", "dp_degree",
           "PRODUCTION_AXES", "LOCKSTEP_TIMEOUT_S", "production_groups"]

#: how long a rank waits in one collective before it raises: ranks
#: that fall out of lockstep (one skips a collective the others make)
#: fail instead of hanging
LOCKSTEP_TIMEOUT_S = 600.0

#: the production meshes' axis sizes (``make_production_mesh``'s shapes):
#: 256 chips on one pod, 512 on two
PRODUCTION_AXES = {
    "single_pod": {"data": 16, "model": 16},
    "multi_pod": {"pod": 2, "data": 16, "model": 16},
}


def dp_axes(multi_pod: bool) -> tuple[str, ...]:
    """The mesh axes that carry the data-parallel groups."""
    return ("pod", "data") if multi_pod else ("data",)


def dp_degree(axis_sizes: dict, multi_pod: bool) -> int:
    """The data-parallel degree of a mesh of ``axis_sizes`` (``{axis:
    size}``): the product of its :func:`dp_axes`."""
    n = 1
    for a in dp_axes(multi_pod):
        n *= int(axis_sizes[a])
    return n


@dataclass(frozen=True)
class MeshGroups:
    """One rank's place on a ``(data, model)`` grid of ranks: its data
    group (the ranks of its model column ``m``, in data order), its
    model group (the ranks of its data row ``d``, in model order), its
    coordinates and the grid's degrees."""

    data_group: Any
    model_group: Any            # None at model degree 1
    data_rank: int
    model_rank: int
    data_degree: int
    model_degree: int
    #: the data axes' sizes, outermost first: ``{"data": D}``, or the
    #: two-pod grid's ``{"pod": 2, "data": 16}`` (None: ``{"data": D}``)
    data_axes: dict | None = None

    @property
    def multi_pod(self) -> bool:
        return self.data_axes is not None and "pod" in self.data_axes

    def axis_sizes(self) -> dict[str, int]:
        """``{axis: size}`` of the grid, the rule table's axes."""
        data = self.data_axes or {"data": self.data_degree}
        return {**data, "model": self.model_degree}

    def coords(self) -> dict[str, int]:
        """This rank's ``{axis: index}``; the data axes split its data
        rank in mixed radix, the first axis outermost."""
        out, rest = {}, self.data_rank
        data = self.data_axes or {"data": self.data_degree}
        for axis in reversed(list(data)):
            rest, out[axis] = divmod(rest, int(data[axis]))
        return {**dict(reversed(list(out.items()))),
                "model": self.model_rank}


def production_groups(world_group, multi_pod: bool = False) -> MeshGroups:
    """The production grid (:data:`PRODUCTION_AXES`) on ``world_group``'s
    256 (one pod) or 512 (two pods) ranks: :func:`init_mesh_groups` at
    model degree 16, its data rank split into ``(pod, data)``. A
    collective over ``world_group``, as :func:`init_mesh_groups` is."""
    axes = PRODUCTION_AXES["multi_pod" if multi_pod else "single_pod"]
    grid = init_mesh_groups(world_group, axes["model"])
    data = {a: n for a, n in axes.items() if a != "model"}
    want = dp_degree(axes, multi_pod)
    if grid.data_degree != want:
        raise ValueError(f"{grid.data_degree * grid.model_degree} ranks; "
                         f"the grid {axes} needs {want * axes['model']}")
    return dataclasses.replace(grid, data_axes=data)


def init_mesh_groups(world_group, model_degree: int) -> MeshGroups:
    """The data and model groups of this rank on the grid of
    ``world_group``'s ranks (``dist.get_world_size(world_group) ==
    data * model_degree``): rank ``d * model_degree + m`` of
    ``world_group`` is grid point ``(d, m)``. Every rank of the group
    must call this, in the same order as its other group builders: it
    calls ``dist.new_group`` for every column, then every row, whatever
    its own (``new_group`` is collective). At model degree 1 nothing is
    made: the data group is ``world_group`` itself and the model group
    is ``None`` (the rank alone), so a group of some ranks of a larger
    world may be cut by those ranks alone."""
    world = dist.get_world_size(world_group)
    if model_degree < 1 or world % model_degree:
        raise ValueError(f"{world} ranks do not tile a grid of model "
                         f"degree {model_degree}")
    data_degree = world // model_degree
    rank = dist.get_rank(world_group)
    d, m = divmod(rank, model_degree)
    ranks = dist.get_process_group_ranks(world_group)
    columns = [[ranks[i * model_degree + j] for i in range(data_degree)]
               for j in range(model_degree)]
    rows = [[ranks[i * model_degree + j] for j in range(model_degree)]
            for i in range(data_degree)]
    if model_degree == 1:
        data_group, model_group = world_group, None
    else:
        data_group = [dist.new_group(c) for c in columns][m]
        model_group = [dist.new_group(r) for r in rows][d]
    return MeshGroups(data_group=data_group, model_group=model_group,
                      data_rank=d, model_rank=m, data_degree=data_degree,
                      model_degree=model_degree)


def data_backend(device: torch.device | str, world_size: int) -> str:
    """The backend of a data group of ``world_size`` ranks on ``device``:
    ``cpu:gloo,cuda:nccl`` with a card for every rank, else ``gloo``
    (no card; or ranks that share a card, which NCCL refuses, so the
    choice is by count). A CPU group on a machine with enough cards
    takes both, as before, so it can share the process with a card's."""
    if not torch.cuda.is_available() or \
            world_size > torch.cuda.device_count():
        return "gloo"
    return "cpu:gloo,cuda:nccl"


def shares_card(group) -> bool:
    """Do the ranks of ``group`` outnumber the cards, so that some share
    one (and the group is gloo alone)?"""
    return dist.get_world_size(group) > torch.cuda.device_count()


def init_data_group(device: torch.device | str = "cuda", *,
                    world_size: int = 1, rank: int = 0,
                    store_path: str | None = None,
                    timeout: float | None = None):
    """The default process group, initialised here unless it already is
    (then its size must be ``world_size``), with the backend of
    :func:`data_backend`; ``timeout`` (seconds) bounds each collective.
    Returns the group."""
    dev = torch.device(device)
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already initialised; asked for {world_size}")
        return dist.group.WORLD
    if store_path is None:
        if world_size != 1:
            raise ValueError("several ranks need a shared store_path")
        fd, store_path = tempfile.mkstemp(prefix="repro_torch_store_")
        os.close(fd)
        os.unlink(store_path)
    if torch.cuda.is_available() and dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(data_backend(dev, world_size),
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size, **kw)
    return dist.group.WORLD


def close_data_group() -> None:
    """Tear the default process group down, if one is up. Safe right
    before the process exits, on several ranks too, because every
    collective of the port has returned only after gloo let go of its
    tensors (:func:`repro_torch.dist.collectives.collective`)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def require_nccl(group) -> None:
    """Raise unless ``group`` syncs CUDA tensors over NCCL."""
    backend = str(dist.get_backend(group))
    if "nccl" not in backend:
        raise RuntimeError(
            f"the data group's backend is {backend!r}: CUDA tensors need "
            f"NCCL (initialise the group with repro_torch.launch.mesh."
            f"init_data_group where a card is present)")


def _rank_main(fn, rank: int, world_size: int, device: str, store: str,
               timeout: float, args: tuple, results) -> None:
    """One spawned rank: the group up, ``fn`` run, the outcome queued as
    ``(rank, ok, value)`` (rank 0's value, or the traceback)."""
    try:
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        init_data_group(device, world_size=world_size, rank=rank,
                        store_path=store, timeout=timeout)
        try:
            value = fn(rank, world_size, *args)
        finally:
            close_data_group()
        results.put((rank, True, value if rank == 0 else None))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)


def spawn_ranks(fn, world_size: int, *, device: torch.device | str = "cuda",
                args: tuple = (), timeout: float = LOCKSTEP_TIMEOUT_S):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks, each a
    process of its own (started by ``spawn``: a fork after CUDA is
    unsafe) with the default group up on ``device`` (rendezvous through
    a ``FileStore`` in a fresh temporary directory). ``fn`` must be
    importable by its module path, and so must ``args`` pickle.
    Returns ``(rank 0's result, the backend)``. Raises with the rank's
    traceback as soon as one rank fails, a rank dies, or a collective
    waits longer than ``timeout`` seconds (the other ranks are then
    stopped), and if a rank exits with another code than 0."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, name=f"rank{rank}",
                             args=(fn, rank, world_size, str(device),
                                   os.path.join(tmp, "store"), timeout,
                                   tuple(args), results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.name for p in procs
                            if p.exitcode not in (None, 0)]
                    if not dead:
                        continue
                    try:    # a failed rank queues its traceback first
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"{dead} ended without a "
                                           f"result") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
            # a rank that aborts at its exit has a fault of its own
            bad = {p.name: p.exitcode for p in procs if p.exitcode != 0}
            if bad:
                raise RuntimeError(f"ranks ended with exit codes {bad}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    return out[0], data_backend(device, world_size)
