"""Device-side SPARe step functions (the counterpart of
``repro.train.step``).

``make_train_step(model)`` builds the training step

    (params, opt, batch) -> (params, opt, metrics)

``batch`` carries a leading *stack* axis (``S_A`` microbatches). The
SPARe failure-masking weights ride along as a per-example weight vector
— a dead group's slots weigh 0, the designated supplier of each shard
type weighs 1/N — so the accumulated gradient equals vanilla DP's batch
gradient for every survivor set (§3.1). Gradients accumulate over the
stack axis into an accumulator of the config's ``grad_accum_dtype``: in
fp32 its flat buckets are the gradient sync's buckets; in a narrower
dtype (deepseek-v3's bf16) it is a tree of leaves of that dtype, which
the sync widens into its fp32 buckets and rounds back, as the JAX
package's does. Activation memory is one microbatch deep whatever
``S_A``.

Where the JAX package returns new trees, this step updates ``params``
and the optimizer state in place (and returns them): at full width
there is no room for a second copy.

``make_train_step(model, grad_shardings=specs)`` on a model built on a
mesh (``build_model(cfg, mesh=groups)``) is the FSDP x TP step, the
program the JAX package's dry run compiles: ``params`` and the moments
are the rank's blocks under the rule table's ``specs``, the batch is
the rank's examples, and the gradients accumulate in fp32 blocks (each
block's gradient reduce-scattered to it inside the backward). A leaf the
table replicates takes its gradient summed over the data group once a
step, and the biases, of which each model rank uses a slice, over the
model group too. The gradient's norm is the whole gradient's over the
grid, each block counted once (:func:`grid_norm`); the reported loss is
summed over the data group.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import (bucket_layout, collective,
                                          tree_leaves, unflatten_grads,
                                          weighted_all_reduce)
from repro_torch.dist.sharding import replicas, spec_leaves
from repro_torch.models.model import Model, segments_of, unbind_layers
from repro_torch.optim import adamw_update, cosine_lr
from repro_torch.optim.adamw import global_norm

__all__ = ["weighted_loss", "make_train_step", "make_serve_step",
           "make_prefill", "grad_leaves", "accumulate_grads",
           "accumulator_specs", "grid_norm"]


def weighted_loss(model: Model, params, micro: dict) -> torch.Tensor:
    """Per-example-weighted CE over one microbatch.

    micro: tokens (b, S) or embeds (b, S, D), labels (b, S), weights
    (b,). Returns ``sum_b weights[b] * mean-CE(example b)`` in fp32: with
    SPARe weights the (1/N)-weighted mean over shard types, vanilla DP's
    loss. The
    supplier-weighted reduction is :func:`~repro_torch.dist.collectives.
    weighted_all_reduce`, this rank's local, differentiable part (the
    train step all-reduces the detached value it reports).
    """
    logits = model.forward(params, tokens=micro.get("tokens"),
                           embeds=micro.get("embeds"))
    ce = torch.mean(model.token_ce(logits, micro["labels"]), dim=-1)
    return weighted_all_reduce(ce, micro["weights"])   # (b,) mean CE


def _add_into(acc: torch.Tensor, leaf: torch.Tensor) -> None:
    # JAX's g_acc + g.astype(acc): fp32 += bf16 widens exactly; a narrower
    # accumulator adds the gradient rounded to its dtype, one rounding of
    # the sum a microbatch
    g = leaf.grad
    acc.add_(g if acc.dtype == torch.float32 else g.to(acc.dtype))
    leaf.grad = None


def grad_leaves(model: Model, params: dict, acc: dict) -> dict:
    """A view of ``params`` whose every weight is an autograd leaf of its
    own — each layer of a stacked leaf separately, by one ``unbind`` per
    leaf — sharing storage with ``params``. When the backward has
    produced a leaf's gradient it is added into the matching view of the
    accumulator ``acc`` and dropped, so one microbatch's gradients are
    never all alive at once."""
    def leaf(p, a):
        t = p.detach().requires_grad_()
        t.register_post_accumulate_grad_hook(partial(_add_into, a))
        return t

    def tree(p, a):
        if isinstance(p, dict):
            return {k: tree(p[k], a[k]) for k in p}
        if isinstance(p, (list, tuple)):
            return type(p)(tree(x, y) for x, y in zip(p, a))
        return leaf(p, a)

    out = {k: tree(v, acc[k]) for k, v in params.items() if k != "segments"}
    out["segments"] = [
        tree(unbind_layers(seg, n_rep), unbind_layers(aseg, n_rep))
        for (_, n_rep), seg, aseg in zip(segments_of(model.cfg),
                                         params["segments"],
                                         acc["segments"])]
    return out


def accumulate_grads(model: Model, params, batch: dict, grads,
                     group=None) -> torch.Tensor:
    """Forward and backward of every microbatch of the stacked ``batch``
    (leaves ``(n_micro, b, ...)``), each gradient added into the tree
    ``grads`` (zeroed by the caller; fp32, or a narrower accumulator's
    dtype, see :func:`_add_into`). Returns the summed loss, fp32;
    with ``group`` each microbatch's loss is all-reduced first, the
    value every rank reports."""
    loss = torch.zeros((), dtype=torch.float32,
                       device=batch["weights"].device)
    for j in range(batch["weights"].shape[0]):
        micro = {k: v[j] for k, v in batch.items()}
        local = weighted_loss(model, grad_leaves(model, params, grads),
                              micro)
        local.backward()
        reported = local.detach()
        if group is not None:
            reported = reported.clone()
            collective(dist.all_reduce, reported, group=group)
        loss += reported
    return loss


def make_train_step(model: Model, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    group=None, grad_sync=None, gather=None, own=None,
                    grad_shardings=None):
    """Build the train step.

    ``grad_shardings`` (the rule table's spec tree, ``model.specs``, on a
    model built on a mesh) builds the FSDP x TP step instead (see the
    module doc); ``step.grads(params, batch)`` then gives one step's
    loss and reduced gradient blocks, and ``step.update(params, opt,
    loss, grads)`` applies them: the step is the two in turn.

    ``group`` is the data-parallel spelling (the mesh executor): each
    rank computes its *local* supplier-weighted partial gradient over its
    slice of the stacked batch, the reported loss is all-reduced, and the
    accumulated partials are summed ONCE per step after the microbatch
    loop — the §3.1 weighted all-reduce. Because the masking weights
    ride in the batch, a failure re-weight changes neither the program
    nor its collectives.

    ``grad_sync`` is that one sync: :class:`~repro_torch.dist.collectives
    .BucketedAllReduce` (fp32 buckets) or
    :class:`~repro_torch.dist.collectives.CompressedBucketSync` (int8 EF
    over the wire). A *stateful* sync (``grad_sync.stateful``) changes
    the step signature to ``(params, opt, batch, ef_state) -> (params,
    opt, metrics, ef_state)``: the EF residuals are this rank's state,
    which the caller keeps (and snapshots) alongside params.

    The accumulator (``model.cfg.grad_accum_dtype``) is allocated at the
    first call and zeroed every step; ``step.buckets`` holds it. In fp32
    it is laid out as the sync's buckets (``"bufs"``), which the sync
    reduces in place. In a narrower dtype it is a tree of leaves like the
    params (``"tree"``), each microbatch's gradient rounded to that dtype
    and added (JAX's ``g_acc + g.astype(acc_dtype)``); the sync then
    widens it exactly into fp32 buckets and casts the reduced buckets
    back into it (``grad_sync.sync_tree``), so AdamW sees the rounding
    of the synced fp32 sum; without a sync it goes to AdamW as it is.
    """
    acc_dtype = getattr(torch, model.cfg.grad_accum_dtype)
    if grad_shardings is not None:
        return _fsdp_tp_step(model, grad_shardings, acc_dtype, base_lr,
                             warmup, total_steps, weight_decay, clip_norm)
    narrow = acc_dtype != torch.float32
    if group is not None and grad_sync is None:
        raise ValueError("a data-parallel group needs its grad_sync "
                         "(BucketedAllReduce or CompressedBucketSync)")
    stateful = getattr(grad_sync, "stateful", False)
    acc: dict = {}

    def buckets(params) -> tuple[list, object]:
        if "bufs" not in acc:
            layout = getattr(grad_sync, "layout", None)
            if layout is None:
                layout = bucket_layout(accumulator_specs(params))
            acc["layout"] = layout
            acc["bufs"] = layout.zeros(tree_leaves(params)[0].device)
        for buf in acc["bufs"]:
            buf.zero_()
        return acc["bufs"], unflatten_grads(acc["layout"], acc["bufs"])

    def accumulator(params):
        if "tree" not in acc:
            acc["tree"] = accumulator_specs(params, acc_dtype,
                                            tree_leaves(params)[0].device)
        for leaf in tree_leaves(acc["tree"]):
            leaf.zero_()
        return acc["tree"]

    def accumulate(params, batch):
        """The microbatches' loss and gradients: ``(loss, fp32 buckets,
        tree)`` (the buckets None for a narrow accumulator)."""
        if narrow:
            bufs, grads = None, accumulator(params)
        else:
            bufs, grads = buckets(params)
        return accumulate_grads(model, params, batch, grads, group), bufs, grads

    def update(params, opt_state, loss, grads):
        # step+1: opt.step counts *completed* updates; lr(0)=0 would make
        # the first update a silent no-op
        lr = cosine_lr(opt_state.step + 1, base_lr, warmup, total_steps)
        gnorm = None
        if own is not None:
            gnorm = global_norm(tree_leaves(grads))
            grads = own(grads)
        params, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr, weight_decay=weight_decay,
            clip_norm=clip_norm, gnorm=gnorm)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    def train_step(params, opt_state, batch):
        full = params if gather is None else gather(params)
        loss, bufs, grads = accumulate(full, batch)
        if grad_sync is not None:
            # the one gradient sync of the step: O(n_buckets) collectives
            grads = grad_sync.sync_tree(grads) if narrow else grad_sync(bufs)
        return update(params, opt_state, loss, grads)

    def train_step_ef(params, opt_state, batch, ef_state):
        loss, bufs, grads = accumulate(params, batch)
        grads, ef_state = (grad_sync.sync_tree(grads, ef_state) if narrow
                           else grad_sync(bufs, ef_state))
        return (*update(params, opt_state, loss, grads), ef_state)

    step = train_step_ef if stateful else train_step
    step.buckets = acc
    step.accumulate = accumulate
    return step


#: replicated leaves of which each model rank uses a slice: their
#: gradients are partial over the model group
_MODEL_PARTIAL = {"bq", "bk", "bv"}


def _named(tree, specs, name=None):
    """``(leaf name, leaf, spec)`` in the JAX package's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], specs[k], k)
    elif isinstance(tree, (list, tuple)):
        for t, sp in zip(tree, specs):
            yield from _named(t, sp, name)
    else:
        yield name, tree, specs


def grid_norm(grads, specs, mesh) -> torch.Tensor:
    """The whole gradient's global norm from this rank's blocks
    ``grads``: each block's sum of squares over the ranks that hold it
    (:func:`~repro_torch.dist.sharding.replicas`), summed over the model
    group and then the data group, so each block counts once."""
    sizes = mesh.axis_sizes()
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(grads)[0].device)
    for g, spec in zip(tree_leaves(grads), spec_leaves(specs, grads)):
        flat = g.reshape(-1).float()
        total += torch.dot(flat, flat) / replicas(spec, sizes)
    for grp in (mesh.model_group, mesh.data_group):
        if grp is not None and dist.get_world_size(grp) > 1:
            collective(dist.all_reduce, total, group=grp, source="grad norm")
    return torch.sqrt(total)


def _fsdp_tp_step(model: Model, specs, acc_dtype, base_lr, warmup,
                  total_steps, weight_decay, clip_norm):
    """The FSDP x TP step (see :func:`make_train_step`)."""
    mesh = model.mesh
    if mesh is None:
        raise ValueError("grad_shardings needs a model built on a mesh "
                         "(build_model(cfg, mesh=groups))")
    acc: dict = {}

    def accumulator(params):
        if "tree" not in acc:
            acc["tree"] = accumulator_specs(params, acc_dtype,
                                            tree_leaves(params)[0].device)
        for leaf in tree_leaves(acc["tree"]):
            leaf.zero_()
        return acc["tree"]

    def grads_of(params, batch):
        """The step's summed loss and reduced gradient blocks."""
        grads = accumulator(params)
        loss = accumulate_grads(model, params, batch, grads,
                                mesh.data_group)
        for name, g, spec in _named(grads, specs):
            if any(e is not None for e in spec):
                continue
            groups = [mesh.data_group]
            if name in _MODEL_PARTIAL:
                groups.append(mesh.model_group)
            for grp in groups:
                if grp is not None and dist.get_world_size(grp) > 1:
                    collective(dist.all_reduce, g, group=grp,
                               source=f"{name} grad")
        return loss, grads

    def update(params, opt_state, loss, grads):
        """AdamW on the blocks from :func:`grads_of`'s output."""
        lr = cosine_lr(opt_state.step + 1, base_lr, warmup, total_steps)
        params, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr, weight_decay=weight_decay,
            clip_norm=clip_norm, gnorm=grid_norm(grads, specs, mesh))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    def train_step(params, opt_state, batch):
        return update(params, opt_state, *grads_of(params, batch))

    train_step.buckets = acc
    train_step.grads = grads_of
    train_step.update = update
    return train_step


def make_serve_step(model: Model, *, paged: bool = False):
    """One-token decode step; greedy sampling is left to the caller.

    Default (dense): ``(params, state, pos, tokens/embeds) ->
    (next_token_logits (B, V), state)`` with a scalar ``pos`` (every row
    at the same position) over :meth:`Model.init_decode_state` caches,
    updated in place.

    ``paged=True``: ``(params, state, table, pos, tokens/embeds)`` with
    ``table (B, max_pages)`` page ids and ``pos (B,)`` per-row positions
    over :meth:`Model.init_paged_state` pools (updated in place) — the
    continuous-batching spelling, where admission and eviction are pure
    data.
    """
    if paged:
        @torch.no_grad()
        def serve_step_paged(params, state, table, pos, tokens=None,
                             embeds=None):
            logits, state = model.decode_step_paged(
                params, state, table, pos, tokens=tokens, embeds=embeds)
            return logits[:, -1, :], state

        return serve_step_paged

    @torch.no_grad()
    def serve_step(params, state, pos, tokens=None, embeds=None):
        logits, state = model.decode_step(params, state, pos, tokens=tokens,
                                          embeds=embeds)
        return logits[:, -1, :], state

    return serve_step


def make_prefill(model: Model, *, return_cache: bool = False):
    """Batched prefill.

    Default: the prompt through the training forward, returning the
    last position's logits ``(B, V)`` only (no cache is made).

    ``return_cache=True``: the fused cache-filling prefill, ``(params,
    tokens/embeds) -> (all_logits (B, S, V), state)`` where ``state``
    matches :meth:`Model.init_decode_state` leaf for leaf, so decode
    continues from position S without re-running the prompt. Prompts must be
    exact-length: the SSM recurrence runs through every input token.
    """
    if return_cache:
        @torch.no_grad()
        def prefill_cached(params, tokens=None, embeds=None):
            return model.prefill(params, tokens=tokens, embeds=embeds)

        return prefill_cached

    @torch.no_grad()
    def prefill(params, tokens=None, embeds=None):
        return model.forward(params, tokens=tokens, embeds=embeds)[:, -1, :]

    return prefill


def accumulator_specs(params, dtype=torch.float32, device="meta"):
    """Zeros like ``params`` in the accumulator's ``dtype``: by default
    storage-free (``meta``) fp32 stand-ins, what the layout of the
    gradient buckets is built over (in the accumulator's dtype, as the
    JAX package builds it); on a real ``device``, a narrow accumulator's
    own leaves."""
    if isinstance(params, dict):
        return {k: accumulator_specs(v, dtype, device)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(accumulator_specs(v, dtype, device)
                            for v in params)
    return torch.zeros(params.shape, dtype=dtype, device=device)
