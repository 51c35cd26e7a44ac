"""One recorded step: its collectives, its host reads and the storage of
the state it updates (the counterpart of ``repro.launch.hlo``: the
collective half, ``collective_report``, ``wire_byte_ratio``,
``same_collective_schedule``, and the cost half, :class:`StepCost` for
``HloCost`` and :func:`record_cost` for ``analyze_hlo``).

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

:func:`record_cost` records a step's cost besides, real or on
storage-free tensors (the dry run's): every aten op the step dispatches
(the backward's too) and every kernel call
(:data:`repro_torch.kernels.ops.cost_hook`). ``flops`` counts products
only, JAX's matmul convention (2 a multiply-add: ``mm``, ``addmm``,
``bmm``, ``baddbmm``, and K2/K2-bwd by their formulas); ``bytes_accessed``
each op's operands plus its outputs, the eager program's HBM traffic
(a view or an allocation moves nothing; a collective's buffers count, as
the JAX package counts them); ``bytes_written`` the outputs alone;
``traffic`` the bytes by op (collectives apart) and the block it ran in
(``layer S.I``, from the source of the latest collective). An eager step runs each loop as often as it turns, so there is no
trip count to miss (``unknown_trip_loops`` stays 0). The live storage is
tracked as well: the arguments' when the step starts, then every new
storage until it is freed; ``peak_bytes`` is the most alive at once.
"""
from __future__ import annotations

import contextlib
import re
import warnings
import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.dist import collectives
from repro_torch.kernels import ops

__all__ = ["Collective", "StepLog", "record_step", "collective_report",
           "wire_byte_ratio", "same_collective_schedule", "StepCost",
           "record_cost"]

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
    shape: tuple[int, ...] = field(default=(), compare=False)  # output's
    source: str = field(default="", compare=False)  # what it moves


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
        return tuple((c.op, c.dtype, c.numel, c.ranks, c.moved)
                     for c in self.collectives)


def _ptr(t: torch.Tensor) -> int:
    """The storage's address; a storage-free tensor's storage object
    (the same object while the storage lives)."""
    st = t.untyped_storage()
    return id(st) if t.is_meta else st.data_ptr()


#: canonical names of the collectives whose name changed across torch
#: releases, so that logs compare across them
_OP_NAMES = {"reduce_scatter_single": "reduce_scatter_tensor",
             "all_gather_single": "all_gather_into_tensor"}


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

    def collective(self, op, tensors, group, source: str = "") -> None:
        out = tensors[0]
        group = group if group is not None else dist.group.WORLD
        ranks = tuple(dist.get_process_group_ranks(group))
        self.collectives.append(Collective(
            op=_OP_NAMES.get(op.__name__, op.__name__),
            dtype=str(out.dtype).removeprefix("torch."),
            numel=out.numel(), ranks=ranks,
            moved=collectives.moved_bytes(op, out, len(ranks)),
            shape=tuple(out.shape), source=source))


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


# ------------------------------------------------------------------ #
# the cost half                                                      #
# ------------------------------------------------------------------ #
@dataclass
class StepCost:
    """A recorded step's cost, with ``HloCost``'s fields (see the module
    doc) and what the eager program adds: its live storage and its
    traffic by op."""

    flops: float = 0.0
    bytes_accessed: float = 0.0   # operands + outputs of every op
    bytes_written: float = 0.0    # outputs only
    collective_bytes: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    # (op, payload dtype) -> moved bytes
    collective_dtype_bytes: dict = field(default_factory=dict)
    unknown_trip_loops: int = 0
    start_bytes: int = 0          # live storage as the step began
    peak_bytes: int = 0           # live storage at its most
    # (op, source) -> [bytes accessed, calls]
    traffic: dict = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


_MM = {_aten.mm.default: (0, 1), _aten.addmm.default: (1, 2),
       _aten.bmm.default: (0, 1), _aten.baddbmm.default: (1, 2)}
#: ops that move no data: allocations, and a view autograd does not track
_FREE = {_aten.empty, _aten.empty_strided, _aten.empty_like,
         _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view}
_SCOPE = re.compile(r"layer \d+\.\d+")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mm_flops(func, args) -> float:
    i, j = _MM[func]
    a, b = args[i], args[j]
    return 2.0 * a.numel() * b.shape[-1]


class _CostMode(TorchDispatchMode):
    """The dispatch mode, kernel hook and storage tracker behind
    :func:`record_cost`."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self.live = 0
        self.seen = WeakIdKeyDictionary()
        self.scope = ""

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self.seen:
            return
        n = st.nbytes()
        self.seen[st] = n
        self.live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _add(self, name: str, flops: float, ins, outs,
             table: bool = True) -> None:
        c = self.cost
        read = sum(_nbytes(t) for t in ins)
        wrote = sum(_nbytes(t) for t in outs)
        c.flops += flops
        c.bytes_accessed += read + wrote
        c.bytes_written += wrote
        if table:
            row = c.traffic.setdefault((name, self.scope), [0, 0])
            row[0] += read + wrote
            row[1] += 1

    def kernel(self, name, flops, operands, outputs) -> None:
        self._add(name, flops, operands, outputs)

    def collective(self, source: str) -> None:
        """The block the ops that follow run in: the latest collective's
        (``layer S.I``), or none."""
        m = _SCOPE.match(source)
        self.scope = m.group(0) if m else ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if not func.is_view and func.overloadpacket not in _FREE:
            # a collective's buffers count as the step's traffic, as in
            # the JAX package's bytes, but not in the table by op
            self._add(str(func.overloadpacket.__name__),
                      _mm_flops(func, args) if func in _MM else 0.0,
                      _tensors(kwargs, _tensors(args)), outs,
                      table=func.namespace != "c10d")
        return out


def record_cost(fn, args: tuple, *, donated: list[torch.Tensor], returned,
                names=None, watch: bool = False):
    """Call ``fn(*args)`` once under :func:`record_step` (its
    collectives and state storage; ``watch`` as there) and the cost
    recorder; returns ``(its result, StepLog, StepCost)``. The storage
    of ``args``' tensors and of ``donated`` is live as the step begins."""
    mode = _CostMode()
    for t in _tensors(args) + list(donated):
        mode.track(t)
    mode.cost.start_bytes = mode.live

    def run(*a):
        inner = collectives._recorder

        def both(op, tensors, group, source=""):
            mode.collective(source)
            inner(op, tensors, group, source)

        collectives._recorder = both
        ops.cost_hook = mode.kernel
        try:
            with mode:
                return fn(*a)
        finally:
            ops.cost_hook = None
            collectives._recorder = inner

    out, log = record_step(run, args, donated=donated, returned=returned,
                           names=names, watch=watch)
    cost = mode.cost
    for c in log.collectives:
        cost.collective_counts[c.op] = cost.collective_counts.get(c.op, 0) + 1
        cost.collective_bytes[c.op] = cost.collective_bytes.get(c.op, 0) \
            + c.moved
        key = (c.op, c.dtype)
        cost.collective_dtype_bytes[key] = \
            cost.collective_dtype_bytes.get(key, 0) + c.moved
    return out, log, cost
