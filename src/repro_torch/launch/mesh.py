"""The data-parallel process group of the port (the counterpart of
``repro.launch.mesh``).

The JAX package lays its data-parallel groups on a ``(data, model)``
device mesh; here each rank of a ``torch.distributed`` group is one data
slice. Nothing tells a program of a cluster, so :func:`init_data_group`
is given its world size and rank, and rendezvous goes through a
``FileStore`` (no network, no port): a fresh temporary file for one
rank, a shared path for several. Where the process has a card, the group
carries both backends, NCCL for CUDA tensors and gloo for CPU ones,
whichever device asks first (so a CPU reference run can share the
process with the card's); without a card, gloo alone. A group made of
gloo alone would take CUDA tensors too, through the host, at a small
fraction of NCCL's speed.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

__all__ = ["init_data_group", "close_data_group", "require_nccl"]


def init_data_group(device: torch.device | str = "cuda", *,
                    world_size: int = 1, rank: int = 0,
                    store_path: str | None = None):
    """The default process group, initialised here unless it already is
    (then its size must be ``world_size``). Returns the group."""
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
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "cpu:gloo,cuda:nccl"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                          world_size),
                            rank=rank, world_size=world_size)
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
