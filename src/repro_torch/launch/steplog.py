"""One recorded step: its collectives, its host reads and the storage of
the state it updates (the counterpart of the collective half of
``repro.launch.hlo``: ``collective_report``, ``wire_byte_ratio``,
``same_collective_schedule``).

The JAX package reads a step's collectives off its compiled HLO. Eager
PyTorch compiles nothing, so here the step is *run* once under
:func:`record_step` and its :class:`StepLog` holds what it did:

* **the collectives, in order**, each as ``(op, dtype, numel, the
  group's global ranks, moved bytes)``, with the ring multipliers of
  :func:`repro_torch.dist.collectives.moved_bytes`. They are taken at
  the one place the port issues them,
  :func:`repro_torch.dist.collectives.collective` (the bucketed syncs'
  ``_collective`` and gathers go through it), which costs one ``None``
  check when no step is recorded;
* **host reads, fp64 and global RNG draws inside the step**: a
  ``TorchDispatchMode`` sees every aten call. A scalar read
  (``aten._local_scalar_dense``: ``.item()``, ``float()``, ``bool()``)
  counts where its tensor is the step's data: on a card, or derived from
  the step's inputs (so the learning rate's host scalar math, which
  touches no input, does not count on the CPU either); so does a copy
  from a device to the host, and a ``float64``/``complex128`` output of
  the step's data. A draw of a random op on the default generator
  counts wherever it lies. On a card ``torch.cuda.set_sync_debug_mode``
  adds every call that synchronises the host with the device. (A
  ``.tolist()`` or ``.numpy()`` of a CPU tensor calls no aten op, so on
  the CPU it goes unseen; on a card it is a copy to the host and a
  sync);
* **the storage of the state**: ``untyped_storage().data_ptr()`` of
  every leaf the step takes to update in place, read before the call and
  off the leaves it returns, and every copy of such a leaf made in the
  step that is still alive after it.

:func:`same_collective_schedule` compares the ordered lists, which is
stricter than the JAX package's per-op counts and bytes.
"""
from __future__ import annotations

import contextlib
import warnings
import weakref
from dataclasses import astuple, dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.dist import collectives

__all__ = ["Collective", "StepLog", "record_step", "collective_report",
           "wire_byte_ratio", "same_collective_schedule"]

_aten = torch.ops.aten
_WIDE = (torch.float64, torch.complex128)
_COPIES = (_aten.clone.default, _aten._to_copy.default, _aten.copy.default)
_TO_HOST = (_aten._to_copy.default, _aten.copy_.default, _aten.copy.default)


@dataclass(frozen=True)
class Collective:
    """One collective of a step."""

    op: str                   # e.g. "all_reduce", "all_to_all_single"
    dtype: str                # of its output, e.g. "float32", "int8"
    numel: int                # of its output
    ranks: tuple[int, ...]    # the group's global ranks
    moved: int                # bytes per rank, ring multipliers applied


@dataclass(frozen=True)
class StepLog:
    """What one call of a step did (see the module doc). Every field is
    plain data, so a log pickles and compares."""

    collectives: tuple[Collective, ...] = ()
    host_reads: tuple[str, ...] = ()      # scalar reads, copies to host
    syncs: tuple[str, ...] = ()           # the card's sync debug mode
    wide: tuple[str, ...] = ()            # fp64/c128 outputs
    rng_draws: tuple[str, ...] = ()       # random ops, default generator
    storage_before: tuple[int, ...] = ()  # the updated leaves, taken
    storage_after: tuple[int, ...] = ()   # the same leaves, returned
    copies_alive: tuple[str, ...] = ()    # copies of them left alive
    leaf_names: tuple[str, ...] = field(default=(), compare=False)
    loss: float | None = field(default=None, compare=False)  # read after

    def schedule(self) -> tuple:
        """The collectives as nested tuples (what two steps compare)."""
        return tuple(astuple(c) for c in self.collectives)


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors in ``tree``'s lists, tuples and dict values (an aten
    call's arguments, a step's inputs), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class _Recorder(TorchDispatchMode):
    """The dispatch mode and collective hook behind :func:`record_step`."""

    def __init__(self, inputs: list[torch.Tensor], donated: set[int]):
        super().__init__()
        self.derived = WeakIdKeyDictionary()
        for t in inputs:
            self.derived[t] = True
        self.donated = donated
        self.collectives: list[Collective] = []
        self.host_reads: list[str] = []
        self.wide: list[str] = []
        self.rng_draws: list[str] = []
        self.copies: list[tuple[str, weakref.ref]] = []

    def _is_data(self, t: torch.Tensor) -> bool:
        return t.device.type != "cpu" or t in self.derived

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(kwargs, _tensors(args))
        data = any(self._is_data(t) for t in ins)
        outs = _tensors(out)
        if data:
            for t in outs:
                self.derived[t] = True
        if func is _aten._local_scalar_dense.default and data:
            self.host_reads.append(f"{func} ({ins[0].device.type})")
        elif func in _TO_HOST and outs and ins:
            src = ins[1] if func is _aten.copy_.default else ins[0]
            if src.device.type != "cpu" and outs[0].device.type == "cpu":
                self.host_reads.append(f"{func} ({src.device.type} -> cpu)")
        if data and any(t.dtype in _WIDE for t in outs):
            self.wide.append(str(func))
        if torch.Tag.nondeterministic_seeded in func.tags and \
                kwargs.get("generator") is None:
            self.rng_draws.append(str(func))
        if func in _COPIES and outs and any(
                _ptr(t) in self.donated for t in ins):
            self.copies.append((str(func), weakref.ref(outs[0])))
        return out

    def collective(self, op, tensors, group) -> None:
        out = tensors[0]
        group = group if group is not None else dist.group.WORLD
        self.collectives.append(Collective(
            op=op.__name__, dtype=str(out.dtype).removeprefix("torch."),
            numel=out.numel(),
            ranks=tuple(dist.get_process_group_ranks(group)),
            moved=collectives.moved_bytes(op, out)))


def record_step(fn, args: tuple, *, donated: list[torch.Tensor],
                returned, names=None, watch: bool = True):
    """Call ``fn(*args)`` once under the recorder; returns ``(its result,
    StepLog)``. ``donated`` are the leaves ``fn`` takes to update in
    place, ``returned(result)`` the leaves of the result that hold them,
    in the same order; ``names`` labels them (for the findings). The
    step's inputs (the tensors of ``args``' dicts, lists and tuples, and
    ``donated``) are its data. On a card the
    sync debug mode is set to ``warn`` for the call and set back after
    it. ``watch=False`` records the collectives and the storage only:
    no dispatch mode and no sync debug mode, so the log's host reads,
    syncs, fp64 outputs, draws and live copies stay empty (what a
    schedule comparison needs, at a third of the cost)."""
    if collectives._recorder is not None:
        raise RuntimeError("a step is already being recorded")
    before = tuple(_ptr(t) for t in donated)
    inputs = _tensors(args) + list(donated)
    rec = _Recorder(inputs, set(before))
    card = watch and any(t.device.type == "cuda" for t in inputs)
    prev = torch.cuda.get_sync_debug_mode() if card else None
    collectives._recorder = rec.collective
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with rec if watch else contextlib.nullcontext():
                    out = fn(*args)
            finally:
                if card:
                    torch.cuda.set_sync_debug_mode(prev)
    finally:
        collectives._recorder = None
    after = tuple(_ptr(t) for t in returned(out))
    kept = set(after)
    alive = tuple(name for name, ref in rec.copies
                  if (t := ref()) is not None and _ptr(t) not in kept)
    # (the mode's own notice that it is a prototype is no sync)
    syncs = tuple(f"{w.filename}:{w.lineno}: {w.message}" for w in caught
                  if "called a synchronizing" in str(w.message))
    return out, StepLog(
        collectives=tuple(rec.collectives), host_reads=tuple(rec.host_reads),
        syncs=syncs, wide=tuple(rec.wide), rng_draws=tuple(rec.rng_draws),
        storage_before=before, storage_after=after, copies_alive=alive,
        leaf_names=tuple(names or ()))


def collective_report(log: StepLog) -> dict:
    """The step's collective table, as ``repro.launch.hlo
    .collective_report`` gives a compiled step's: counts and moved bytes
    per op, bytes per ``"op/dtype"``, and the total."""
    counts: dict[str, int] = {}
    nbytes: dict[str, int] = {}
    by_dtype: dict[str, int] = {}
    for c in log.collectives:
        counts[c.op] = counts.get(c.op, 0) + 1
        nbytes[c.op] = nbytes.get(c.op, 0) + c.moved
        key = f"{c.op}/{c.dtype}"
        by_dtype[key] = by_dtype.get(key, 0) + c.moved
    return {"counts": counts, "bytes": nbytes,
            "by_dtype": dict(sorted(by_dtype.items())),
            "total_bytes": sum(c.moved for c in log.collectives)}


def wire_byte_ratio(log: StepLog, baseline: StepLog) -> float:
    """Moved collective bytes of ``log`` relative to ``baseline``'s: the
    compressed sync's gate (the int8 EF step at most ~0.3x of the fp32
    step, as the JAX package's)."""
    base = sum(c.moved for c in baseline.collectives)
    return sum(c.moved for c in log.collectives) / max(base, 1e-30)


def same_collective_schedule(a: StepLog, b: StepLog) -> bool:
    """True iff two steps issue the same collectives in the same order,
    on the same groups, with the same dtypes, sizes and moved bytes."""
    return a.schedule() == b.schedule()
