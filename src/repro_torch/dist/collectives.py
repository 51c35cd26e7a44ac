"""Collective-communication helpers (weighted all-reduce, int8 EF
compression, bucketed gradient sync) over a ``torch.distributed`` group:
the PyTorch counterparts of ``repro.dist.collectives``.

SPARe's failure masking is, at the wire level, nothing but a *weighted*
gradient all-reduce: every (group, stack-slot) contributes its partial
gradient scaled by the supplier weight, so the collected gradient equals
vanilla DP's batch gradient for every survivor set (§3.1 invariant).

Two things differ from the JAX package, by the torch idiom:

* There is no ``psum_partial``, ``constrain_grad`` or
  ``shard_map_compat``: each rank's backward already gives its *local*
  partial gradient, which the one sync per step sums. A reported loss is
  a detached ``all_reduce`` of the local weighted losses
  (:func:`repro_torch.train.step.accumulate_grads`).
* The flat fp32 buckets of a :class:`BucketLayout` *are* the gradient
  accumulator: gradients are views into them
  (:func:`unflatten_grads`), and each bucket is synced in place. The
  tree a sync returns is a set of views, not a copy. A narrower
  accumulator (a bf16 one) is a tree of its own: ``sync_tree`` widens it
  bucket by bucket into one fp32 scratch bucket, syncs that, and rounds
  the result back into the tree's leaves, which is what the JAX
  package's flatten, sync and unflatten (cast to each leaf's dtype) give.

The int8 error-feedback compressor quantizes ``grad + residual`` to int8
with one fp32 scale per tensor (the K3a/K3b kernels on the card) and
carries the residual into the next step, so the *cumulative* transmitted
signal is unbiased (Seide et al. 2014; Karimireddy et al. 2019).

Every collective goes through :func:`collective`, which on gloo (CPU
tensors, or CUDA ones on a group of ranks that share a card) returns
only once the group's worker thread has let go of the tensors (see
there), and which is the one place a step's collectives are recorded
(:mod:`repro_torch.launch.steplog` sets :data:`_recorder` while it
records one step).

The FSDP x TP step (``make_train_step(model, grad_shardings=...)``)
spells out, as ``torch.autograd.Function`` s, the collectives GSPMD
derives from the rule table of :mod:`repro_torch.dist.sharding`:
:func:`gather` (all-gather forward, reduce-scatter of the gradient
backward: the FSDP gather of a block over the data group, and the gather
of a weight over the model group), Megatron's :func:`copy_to_model`
("f": identity forward, all-reduce over the model group backward) and
:func:`reduce_from_model` ("g": all-reduce forward, identity backward),
and :func:`gather_split` (all-gather forward, the rank's slice of the
gradient backward: an activation every model rank holds whole, whose
gradient each holds whole too). A ``None`` group, or one of a single
rank, makes each of them the identity.

Wire accounting (what the executor publishes as ``sync.*`` metrics): each
bucketed sync counts, per call (one call is one rank's sync of one
step), the collectives it calls and the bytes each moves per rank, at
the place it calls them, with the ring-algorithm multipliers of the
JAX package's HLO audit (``repro.launch.hlo``): an all-reduce moves
twice its buffer, an all-gather and an all-to-all their output once.
The count follows from the :class:`BucketLayout` and the protocol; it
is not read from a compiled program, so it is not the HLO audit's
number (it leaves out the reported loss's all-reduce, for one).
:class:`BucketedAllGather` (the tensor-parallel executor's gather of
its column blocks over the model group) counts the same way.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.obs.trace import maybe_span

__all__ = ["collective", "runs_on_gloo", "weighted_all_reduce", "compress_grad_int8",
           "decompress_grad_int8", "BucketLayout", "bucket_layout",
           "flatten_grads", "unflatten_grads", "bucket_views",
           "BucketedAllReduce", "BucketedAllGather",
           "CompressedBucketSync", "tree_leaves", "moved_bytes",
           "reduce_scatter", "gather", "copy_to_model", "reduce_from_model",
           "gather_split", "all_gather_dim", "reduce_scatter_dim"]


#: how long :func:`collective` waits for gloo to let go of its tensors
RELEASE_TIMEOUT_S = 60.0

#: the step recorder :func:`collective` reports every call to, ``(op,
#: tensors, group, source)``; None but while :mod:`repro_torch.launch.steplog`
#: records a step
_recorder = None


#: the reduce-scatter of one flat tensor: ``reduce_scatter_single``
#: where torch has it, ``reduce_scatter_tensor`` (its older name) before
reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def moved_bytes(op, out: torch.Tensor, group_size: int = 1) -> int:
    """Bytes ``op`` moves per rank for its output ``out``, with the ring
    multipliers of the JAX package's HLO audit: an all-reduce twice its
    buffer, a reduce-scatter its output times the group's size (its
    input), every other collective its output once."""
    mult = 2 if op is dist.all_reduce else \
        group_size if op is reduce_scatter else 1
    return mult * out.numel() * out.element_size()


def runs_on_gloo(group, device_type: str) -> bool:
    """Does ``group`` (``None``: the default group) hand tensors of
    ``device_type`` to gloo? A group of one backend hands it every
    tensor; a ``cpu:gloo,cuda:nccl`` group only its CPU ones."""
    backend = str(dist.get_backend(group))
    if ":" not in backend:
        return backend == "gloo"
    return dict(part.split(":") for part in backend.split(",")).get(
        device_type) == "gloo"


def collective(op, *tensors: torch.Tensor, group=None, source: str = "",
               reduce_op=None, record=None, **kwargs) -> None:
    """Run the blocking ``torch.distributed`` collective ``op(*tensors,
    group=group, **kwargs)``; where gloo runs it (:func:`runs_on_gloo`: CPU
    tensors, or CUDA ones on a gloo group), return only once the group's
    worker thread holds none of them any more.

    Gloo runs each collective on a worker thread of the process group,
    and that thread drops its references to the tensors only after the
    caller has been told the collective is done. If the caller drops a
    tensor first, the Python object of the tensor is left for the worker
    thread to free, which takes the GIL. When that happens while the
    interpreter is exiting, Python ends the thread (``pthread_exit``) and
    the unwinding through a C++ destructor aborts the process ("terminate
    called without an active exception"). A barrier before
    ``destroy_process_group`` does not prevent it: gloo's barrier holds
    weak references to the collectives before it, which then die with
    the barrier, on the same thread. So every collective here waits for
    the use counts of its tensors to fall back to what they were before
    the call (the thread lets go right after the collective completes),
    and the tensors are always freed by their owner. The wait keys on
    the backend, not on the tensor's device: gloo holds CUDA tensors on
    its worker thread as it holds CPU ones. On NCCL nothing waits: the
    work is asynchronous there. ``source`` names what the collective
    moves, for the step recorder only; ``reduce_op`` is a reduction's
    ``op`` (a sum by default); ``record`` (``(op, tensors)``) is what the
    recorder sees instead, where this backend spells a collective by
    another.
    """
    if reduce_op is not None:
        kwargs["op"] = reduce_op
    if _recorder is not None:
        _recorder(*(record or (op, tensors)), group, source)
    gloo = runs_on_gloo(group, tensors[0].device.type)
    before = [t._use_count() for t in tensors] if gloo else ()
    op(*tensors, group=group, **kwargs)
    deadline = time.monotonic() + RELEASE_TIMEOUT_S
    for t, n in zip(tensors, before):
        while t._use_count() > n:
            if time.monotonic() > deadline:
                raise RuntimeError("the process group's worker still holds "
                                   "a collective's tensor")
            time.sleep(0)


def weighted_all_reduce(values: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Supplier-weighted reduction ``Σ_i weights_i · values_i`` over the
    leading axes ``values`` shares with ``weights``: this rank's local,
    differentiable part. Each rank differentiates its own part, and the
    gradient sync sums the partials once per step; there is no
    differentiable collective (the JAX package's ``axis_name``).
    """
    w = weights.reshape(weights.shape + (1,) * (values.ndim - weights.ndim))
    return torch.sum(values * w.to(values.dtype),
                     dim=tuple(range(weights.ndim)))


# --------------------------------------------------------------------- #
# the FSDP x TP step's collectives                                      #
# --------------------------------------------------------------------- #
def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_dim(x: torch.Tensor, dim: int, group,
                   source: str = "") -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in the
    group's rank order (one ``all_gather_into_tensor``)."""
    n = _size(group)
    if n == 1:
        return x
    src = x.contiguous()
    buf = torch.empty(n * src.numel(), dtype=src.dtype, device=src.device)
    collective(dist.all_gather_into_tensor, buf, src.view(-1), group=group,
               source=source)
    buf = buf.view(n, *src.shape)
    dim = dim % x.dim()
    if dim == 0:
        return buf.view(n * src.shape[0], *src.shape[1:])
    return buf.movedim(0, dim).reshape(
        *src.shape[:dim], n * src.shape[dim], *src.shape[dim + 1:])


def reduce_scatter_dim(x: torch.Tensor, dim: int, group,
                       source: str = "") -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, of which this rank
    keeps its block along ``dim`` (the group's rank order; one
    reduce-scatter). ``x`` (a gradient the caller gives up) may be
    overwritten.

    Gloo has no reduce-scatter of its own: torch's gloo backend
    all-reduces a copy of the whole input, which on a card would add the
    input's size (a whole gathered leaf's gradient) to the step's peak.
    On gloo the reduce-scatter is therefore spelled as an all-reduce in
    place on the blocks and a copy of this rank's; the step's log records
    the reduce-scatter the program issues (NCCL's)."""
    n = _size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    blocks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    blocks = blocks.contiguous()
    out = torch.empty(blocks.shape[1:], dtype=x.dtype, device=x.device)
    flat = (out.view(-1), blocks.view(-1))
    if runs_on_gloo(group, x.device.type):
        collective(dist.all_reduce, flat[1], group=group, source=source,
                   record=(reduce_scatter, flat))
        out.copy_(blocks[dist.get_rank(group)])
    else:
        collective(reduce_scatter, *flat, group=group, source=source)
    return out


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; reduce-scatter of the gradient
    back to the block backward."""

    @staticmethod
    def forward(ctx, x, dim, group, source):
        ctx.dim, ctx.group, ctx.source = dim, group, source
        return all_gather_dim(x, dim, group, source)

    @staticmethod
    def backward(ctx, dy):
        return (reduce_scatter_dim(dy, ctx.dim, ctx.group, ctx.source),
                None, None, None)


class _GatherSplit(torch.autograd.Function):
    """All-gather along ``dim`` forward; the rank's block of the
    gradient backward (no collective)."""

    @staticmethod
    def forward(ctx, x, dim, group, source):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group, source)

    @staticmethod
    def backward(ctx, dy):
        n, r = _size(ctx.group), dist.get_rank(ctx.group)
        return dy.chunk(n, dim=ctx.dim)[r].contiguous(), None, None, None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group, source):
        ctx.group, ctx.source = group, source
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        collective(dist.all_reduce, dy, group=ctx.group, source=ctx.source)
        return dy, None, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward (in place on the partial sum),
    identity backward."""

    @staticmethod
    def forward(ctx, x, group, source):
        if x.is_contiguous():
            ctx.mark_dirty(x)
        else:
            x = x.contiguous()
        collective(dist.all_reduce, x, group=group, source=source)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


def gather(x: torch.Tensor, dim: int, group, source: str = ""
           ) -> torch.Tensor:
    """``x``'s blocks of ``group`` whole along ``dim``; the gradient goes
    back to each block summed over the group (reduce-scatter): the FSDP
    gather over the data group, and a weight's gather over the model
    group where each rank uses a part of the whole."""
    if _size(group) == 1:
        return x
    return _Gather.apply(x, dim, group, source)


def gather_split(x: torch.Tensor, dim: int, group, source: str = ""
                 ) -> torch.Tensor:
    """``x``'s blocks of ``group`` whole along ``dim``, for an activation
    every rank then holds whole: its gradient, whole on every rank too,
    goes back as the rank's block."""
    if _size(group) == 1:
        return x
    return _GatherSplit.apply(x, dim, group, source)


def copy_to_model(x: torch.Tensor, group, source: str = "") -> torch.Tensor:
    """Megatron's f before a column-parallel product: ``x`` as it is,
    its gradient (each rank's partial) all-reduced over ``group``."""
    if _size(group) == 1:
        return x
    return _CopyToModel.apply(x, group, source)


def reduce_from_model(x: torch.Tensor, group, source: str = ""
                      ) -> torch.Tensor:
    """Megatron's g after a row-parallel product: the partial sums ``x``
    all-reduced over ``group`` (in place); the gradient passes as it
    is."""
    if _size(group) == 1:
        return x
    return _ReduceFromModel.apply(x, group, source)


def compress_grad_int8(grad: torch.Tensor, error: torch.Tensor, *,
                       out_err: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Int8 error-feedback quantization of one gradient tensor:
    ``(q int8, scale fp32 0-d, new_error fp32)`` with
    ``decompress(q, scale) + new_error == grad + error`` exactly. Goes
    through the K3a/K3b kernels on the card (the plain version on the
    CPU); ``out_err`` may be ``error`` itself, for an in-place update."""
    return ops.int8_ef_quantize(grad, error, out_err=out_err)


def decompress_grad_int8(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """Inverse of :func:`compress_grad_int8`: ``q * scale`` in fp32."""
    return q.float() * scale


# --------------------------------------------------------------------- #
# trees: the JAX package's leaf order                                    #
# --------------------------------------------------------------------- #
def _flatten(tree) -> tuple[list, object]:
    """Leaves and skeleton of a tree of dicts, lists and tuples, in
    ``jax.tree.flatten``'s order: dict keys *sorted*, sequences in
    order. Bucket membership sets each bucket's int8 scale, so the
    order must be the JAX package's, not the dicts' insertion order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for p in parts for x in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree), None, [p[1] for p in parts]))
    return [tree], None


def _unflatten(skeleton, leaves):
    it = iter(leaves)

    def build(sk):
        if sk is None:
            return next(it)
        kind, keys, subs = sk
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, subs)}
        return kind(build(s) for s in subs)

    return build(skeleton)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the JAX package's order."""
    return _flatten(tree)[0]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --------------------------------------------------------------------- #
# bucketed flat gradient sync                                           #
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class BucketLayout:
    """Deterministic flat-bucket layout of a gradient tree.

    Leaves (in ``jax.tree`` order) are packed first-fit-in-order into
    contiguous fp32 buckets capped at ``max_bucket_elems`` (a leaf larger
    than the cap gets a bucket of its own), and every bucket is
    zero-padded up to a multiple of ``pad_to`` (the data-parallel chunk
    of the compressed sync). Every field but ``treedef`` (here the
    tree's skeleton) equals the JAX package's layout of the same tree.
    """

    treedef: object
    shapes: tuple[tuple[int, ...], ...]    # per leaf
    dtypes: tuple[str, ...]                # per leaf (original dtype name)
    bucket_of: tuple[int, ...]             # leaf -> bucket index
    offsets: tuple[int, ...]               # leaf -> element offset in bucket
    bucket_sizes: tuple[int, ...]          # padded element counts
    pad_to: int

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def n_elems(self) -> int:
        return sum(self.bucket_sizes)

    def zeros(self, device) -> list[torch.Tensor]:
        """One zeroed fp32 buffer per bucket on ``device``."""
        return [torch.zeros(s, dtype=torch.float32, device=device)
                for s in self.bucket_sizes]


def bucket_layout(tree, *, max_bucket_elems: int = 1 << 23,
                  pad_to: int = 1) -> BucketLayout:
    """Pack ``tree``'s leaves (tensors, or anything with ``shape`` and
    ``dtype``) into buckets."""
    leaves, skeleton = _flatten(tree)
    shapes, dtypes, bucket_of, offsets = [], [], [], []
    sizes: list[int] = []          # unpadded fill of each open bucket
    for leaf in leaves:
        shape = tuple(int(d) for d in leaf.shape)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        shapes.append(shape)
        dtypes.append(_dtype_name(leaf.dtype))
        if not sizes or sizes[-1] + n > max_bucket_elems and sizes[-1] > 0:
            sizes.append(0)
        bucket_of.append(len(sizes) - 1)
        offsets.append(sizes[-1])
        sizes[-1] += n
    padded = tuple(-(-s // pad_to) * pad_to for s in sizes)
    return BucketLayout(treedef=skeleton, shapes=tuple(shapes),
                        dtypes=tuple(dtypes), bucket_of=tuple(bucket_of),
                        offsets=tuple(offsets), bucket_sizes=padded,
                        pad_to=pad_to)


def flatten_grads(layout: BucketLayout, tree) -> list[torch.Tensor]:
    """Tree -> list of new contiguous fp32 1-D buckets (zero-padded)."""
    leaves = _flatten(tree)[0]
    bufs = layout.zeros(leaves[0].device)
    for i, leaf in enumerate(leaves):
        off = layout.offsets[i]
        bufs[layout.bucket_of[i]][off:off + leaf.numel()].copy_(
            leaf.reshape(-1))
    return bufs


def _views(layout: BucketLayout, bufs) -> list[torch.Tensor]:
    """Each leaf's fp32 view into its bucket, in the layout's order."""
    out = []
    for i, shape in enumerate(layout.shapes):
        b, off = layout.bucket_of[i], layout.offsets[i]
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out.append(bufs[b][off:off + n].view(shape))
    return out


def bucket_views(layout: BucketLayout, bufs) -> object:
    """The tree of fp32 views into ``bufs``, one a leaf, whatever dtype
    the layout records for it: an fp32 accumulator laid out as the
    buckets (the gradient oracles sum into it in fp32)."""
    return _unflatten(layout.treedef, _views(layout, bufs))


def unflatten_grads(layout: BucketLayout, bufs) -> object:
    """Inverse of :func:`flatten_grads`, bit-transparent: every fp32 leaf
    is a *view* into its bucket (so a tree of fp32 leaves is the
    accumulator itself, and writes to it land in the buckets); a bf16 or
    fp16 leaf is cast back into a new tensor (exactly, for a bucket
    flattened from such leaves and not reduced since)."""
    return _unflatten(layout.treedef, [
        v.to(getattr(torch, dt)) for v, dt in zip(_views(layout, bufs),
                                                    layout.dtypes)])


class _BucketSync:
    """What both bucketed syncs share: the wire tally of the last call
    and the deep-telemetry spans.

    ``wire_collectives`` and ``wire_bytes`` hold the collectives the
    last call made and the bytes they moved per rank (see the module
    doc), reset at the start of every call. ``tel`` (a
    :class:`repro_torch.obs.Telemetry`, set by the executor in deep
    mode) adds host spans ``grad_sync`` around the call and
    ``bucket/<i>`` around each bucket's sync on the ``sync`` track. On a
    card they bracket the launches, not the device's completion: the
    collectives and kernels run asynchronously.
    """

    tel = None

    def __init__(self, layout: BucketLayout, group=None):
        self.layout = layout
        self.group = group
        self.wire_collectives = 0
        self.wire_bytes = 0

    def _collective(self, op, out: torch.Tensor,
                    *tensors: torch.Tensor) -> None:
        """Run ``op(out, *tensors)`` and count it: :func:`moved_bytes`."""
        collective(op, out, *tensors, group=self.group)
        self.wire_collectives += 1
        self.wire_bytes += moved_bytes(op, out)

    def _sync_all(self, bufs, each) -> None:
        self.wire_collectives = self.wire_bytes = 0
        tel = self.tel
        with maybe_span(tel, "grad_sync", track="sync"):
            for i, args in enumerate(bufs):
                with maybe_span(tel, f"bucket/{i}", track="sync"):
                    each(*args)

    def _sync_leaves(self, tree, extra) -> None:
        """Sync a narrow accumulator ``tree`` (the layout's leaves, in a
        dtype narrower than fp32) in place, bucket by bucket through one
        fp32 scratch bucket: its leaves widened exactly into the bucket
        and the padding zeroed (the JAX package's ``flatten_grads``),
        ``_sync_bucket(bucket, *extra[b])``, then each leaf rounded back
        from its slice (``unflatten_grads``' cast to the leaf's dtype).
        The scratch is the largest bucket, not the whole layout: the fp32
        sum is never whole on the device at once."""
        lay = self.layout
        leaves = tree_leaves(tree)
        members: list[list[int]] = [[] for _ in lay.bucket_sizes]
        for i, b in enumerate(lay.bucket_of):
            members[b].append(i)
        scratch = torch.empty(max(lay.bucket_sizes), dtype=torch.float32,
                              device=leaves[0].device)

        def each(b, *rest):
            buf = scratch[:lay.bucket_sizes[b]]
            views = [(leaves[i], buf[lay.offsets[i]:lay.offsets[i]
                                     + leaves[i].numel()])
                     for i in members[b]]
            for leaf, view in views:
                view.copy_(leaf.reshape(-1))
            buf[lay.offsets[members[b][-1]] + leaves[members[b][-1]].numel():
                ].zero_()
            self._sync_bucket(buf, *rest)
            for leaf, view in views:
                leaf.copy_(view.view(leaf.shape))

        self._sync_all([(b, *e) for b, e in enumerate(extra)], each)


class BucketedAllReduce(_BucketSync):
    """O(1)-collective gradient sync: ``all_reduce`` (sum) each flat
    bucket once, in place.

    ``sync(bufs)`` takes the accumulator's buckets and returns the tree
    of views into them; the collective count per step is
    ``layout.n_buckets``, whatever the leaf count. Partials are summed,
    never averaged: the supplier weights already carry the ``1/N``.
    """

    stateful = False

    def _sync_bucket(self, buf: torch.Tensor) -> None:
        self._collective(dist.all_reduce, buf)

    def __call__(self, bufs: list[torch.Tensor]):
        self._sync_all([(buf,) for buf in bufs], self._sync_bucket)
        return unflatten_grads(self.layout, bufs)

    def sync_tree(self, tree):
        """Sync a narrow accumulator's tree in place (see
        ``_sync_leaves``); returns it."""
        self._sync_leaves(tree, [()] * self.layout.n_buckets)
        return tree


class CompressedBucketSync(_BucketSync):
    """Two-phase int8 error-feedback all-reduce over flat buckets, in
    place (the JAX package's wire protocol).

    Per bucket of ``B`` fp32 elements at data-parallel degree ``dp``, all
    arithmetic fp32 — int8 payloads are exchanged and dequant-accumulated,
    never summed as integers, so nothing overflows at any ``dp``:

    1. quantize the local partial bucket plus the stage-1 residual to
       int8 with one fp32 scale (K3a/K3b);
    2. ``all_to_all`` the int8 payload (rank ``i`` receives every rank's
       quantized chunk ``i``) and ``all_gather`` the ``dp`` scales;
    3. dequant-accumulate the chunk in fp32, in the JAX package's order
       (``s_0 q_0``, then one fused multiply-add per further rank);
    4. re-quantize the reduced chunk plus the stage-2 residual, owned by
       the same rank every step, and ``all_gather`` int8 chunks and
       scales back to everyone;
    5. dequantize into the bucket.

    The bucket is scratch once stage 1 has read it, so step 3 writes the
    chunk into it and step 5 overwrites it with the result: the sync
    needs int8 buffers beside the bucket and no fp32 one.

    The EF state is each rank's own: ``err1[b]`` its full-bucket stage-1
    residual (``B``), ``err2[b]`` its chunk's stage-2 residual
    (``B / dp``), both updated in place. (The JAX package's
    ``init_state`` gives the global view, ``dp`` of each, sharded.)
    """

    stateful = True

    def __init__(self, layout: BucketLayout, dp_degree: int, group=None):
        for b, size in enumerate(layout.bucket_sizes):
            if size % dp_degree:
                raise ValueError(
                    f"bucket {b} has {size} elements, not divisible by "
                    f"dp_degree={dp_degree}; build the layout with "
                    f"pad_to={dp_degree} (or a multiple)")
        super().__init__(layout, group)
        self.dp = dp_degree

    def init_state(self, device) -> dict:
        """This rank's zero EF residuals."""
        return {
            "err1": tuple(torch.zeros(s, dtype=torch.float32, device=device)
                          for s in self.layout.bucket_sizes),
            "err2": tuple(torch.zeros(s // self.dp, dtype=torch.float32,
                                      device=device)
                          for s in self.layout.bucket_sizes),
        }

    def _sync_bucket(self, buf, e1, e2) -> None:
        dp = self.dp
        q1, s1, _ = compress_grad_int8(buf, e1, out_err=e1)
        mine = torch.empty_like(q1)
        # (dp, B/dp): rank i receives every rank's chunk i
        self._collective(dist.all_to_all_single, mine, q1)
        scales = torch.empty(dp, dtype=torch.float32, device=buf.device)
        self._collective(dist.all_gather_into_tensor, scales, s1.reshape(1))
        mine = mine.view(dp, -1)
        chunk = buf[:mine.shape[1]]
        torch.mul(mine[0], scales[0], out=chunk)
        for j in range(1, dp):
            chunk.addcmul_(mine[j], scales[j])
        q2, s2, _ = compress_grad_int8(chunk, e2, out_err=e2)
        full_q = torch.empty(dp * q2.numel(), dtype=torch.int8,
                             device=buf.device)
        self._collective(dist.all_gather_into_tensor, full_q, q2)
        full_s = torch.empty(dp, dtype=torch.float32, device=buf.device)
        self._collective(dist.all_gather_into_tensor, full_s, s2.reshape(1))
        torch.mul(full_q.view(dp, -1), full_s[:, None], out=buf.view(dp, -1))

    def __call__(self, bufs: list[torch.Tensor], state: dict):
        """Sync the accumulator's buckets in place; returns ``(tree of
        views into them, state)`` with the residuals updated in place."""
        self._sync_all(list(zip(bufs, state["err1"], state["err2"])),
                       self._sync_bucket)
        return unflatten_grads(self.layout, bufs), state

    def sync_tree(self, tree, state: dict):
        """Sync a narrow accumulator's tree in place (see
        ``_sync_leaves``), the residuals updated in place; returns
        ``(tree, state)``."""
        self._sync_leaves(tree, list(zip(state["err1"], state["err2"])))
        return tree, state

    def sync_once(self, bufs: list[torch.Tensor]):
        """Stateless spelling (zero residuals) for verification paths —
        single-step quantization error only, bounded by
        :func:`repro_torch.exec.equivalence.int8_sweep_tolerance`."""
        reduced, _ = self(bufs, self.init_state(bufs[0].device))
        return reduced


class BucketedAllGather:
    """Rebuild whole leaves from their column blocks over a group in
    O(n_buckets) collectives, never one a leaf: the blocks of one dtype
    are packed first-fit-in-order into buckets capped at
    ``max_bucket_elems`` (:func:`bucket_layout`), each bucket is
    all-gathered once, and every rank's slice of it is copied into the
    last-dim columns ``[j * c, (j + 1) * c)`` of the leaves, ``j`` the
    rank's place in the group. The gather of the model group's ranks in
    the tensor-parallel executor (``repro_torch.exec``).

    ``wire_collectives`` and ``wire_bytes`` hold the last call's tally
    (an all-gather moves its output once a rank, as
    :class:`_BucketSync` counts); ``tel`` (deep telemetry) adds a host
    span ``param_gather`` on the ``sync`` track."""

    tel = None

    def __init__(self, group, max_bucket_elems: int = 1 << 23):
        self.group = group
        self.max_bucket_elems = int(max_bucket_elems)
        self.wire_collectives = 0
        self.wire_bytes = 0
        self._layouts: dict = {}

    def _layout(self, blocks: list[torch.Tensor]) -> dict:
        """Per dtype: ``(indices of its blocks, their BucketLayout, the
        layout's members of each bucket)``, memoised by the blocks'
        shapes and dtypes."""
        key = tuple((tuple(b.shape), b.dtype) for b in blocks)
        if key not in self._layouts:
            by_dtype: dict = {}
            for i, b in enumerate(blocks):
                by_dtype.setdefault(b.dtype, []).append(i)
            out = {}
            for dt, idx in by_dtype.items():
                lay = bucket_layout([blocks[i] for i in idx],
                                    max_bucket_elems=self.max_bucket_elems)
                members: list[list[int]] = [[] for _ in lay.bucket_sizes]
                for j, b in enumerate(lay.bucket_of):
                    members[b].append(j)
                out[dt] = (idx, lay, members)
            self._layouts[key] = out
        return self._layouts[key]

    def __call__(self, blocks: list[torch.Tensor],
                 fulls: list[torch.Tensor]) -> None:
        """Fill each ``fulls[i]`` (last dim ``n`` times ``blocks[i]``'s,
        ``n`` the group's size) with every rank's ``blocks[i]``, in
        place. A collective over the group."""
        self.wire_collectives = self.wire_bytes = 0
        n = dist.get_world_size(self.group)
        with maybe_span(self.tel, "param_gather", track="sync"):
            for dt, (idx, lay, of) in self._layout(blocks).items():
                for size, members in zip(lay.bucket_sizes, of):
                    dev = blocks[idx[members[0]]].device
                    send = torch.empty(size, dtype=dt, device=dev)
                    for j in members:
                        blk = blocks[idx[j]]
                        send[lay.offsets[j]:lay.offsets[j] + blk.numel()
                             ].copy_(blk.reshape(-1))
                    recv = torch.empty(n * size, dtype=dt, device=dev)
                    collective(dist.all_gather_into_tensor, recv, send,
                               group=self.group)
                    self.wire_collectives += 1
                    self.wire_bytes += moved_bytes(
                        dist.all_gather_into_tensor, recv)
                    recv = recv.view(n, size)
                    for j in members:
                        blk, full = blocks[idx[j]], fulls[idx[j]]
                        c = blk.shape[-1]
                        off = lay.offsets[j]
                        for r in range(n):
                            full[..., r * c:(r + 1) * c].copy_(
                                recv[r, off:off + blk.numel()].view(
                                    blk.shape))
