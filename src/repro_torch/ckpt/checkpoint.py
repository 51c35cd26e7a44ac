"""Multi-tier checkpointing with the availability-optimal interval (the
PyTorch counterpart of ``repro.ckpt.checkpoint``).

Tiers:
  * **in-memory snapshot** — a host (CPU) copy of the last good
    ``(params, opt_state)`` tree. SPARe rolls back to it on a wipe-out
    without touching storage (GEMINI-style). A later snapshot of the
    same shapes is copied into the same host tensors, so the tier holds
    one host copy of the state, never two.
  * **disk** — one npz shard plus a JSON manifest, written by a
    background thread (training continues during the save; the manifest
    is committed last, so a crash mid-write leaves the previous
    checkpoint intact).

The on-disk format is the JAX package's ``npz-v1``, byte for byte: a
checkpoint written by either package restores in the other. Leaf names
spell the path through the tree as ``jax.tree`` does (dict keys in
sorted order, sequence items by index, the optimizer state's fields
``step``, ``mu``, ``nu`` by name, joined by ``/``); bf16 leaves are
stored as a ``uint16`` view with ``"bfloat16"`` in the manifest's
``dtypes``; the optimizer's ``step``, a Python ``int`` here, is stored
as the reference's 0-d ``int32`` array and read back as an ``int``.

The save *interval* comes from Eq. 1 (Saxena et al.): the trainer calls
:meth:`CheckpointManager.maybe_save` and the manager decides against
``T_c*`` computed from the SPARe-extended failure interval
``T_f = mu(N, r) * m`` — checkpointing co-designed with the redundancy,
the paper's SPARe+CKPT.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core.theory import mu, tc_star
from repro_torch.optim import AdamWState

__all__ = ["save_checkpoint", "restore_checkpoint", "sweep_stale_tmp",
           "CheckpointManager", "host_copy", "copy_into", "tree_tensors"]


# ------------------------------------------------------------------ #
# trees                                                              #
# ------------------------------------------------------------------ #
def _tree_map(fn, tree):
    """``fn`` over the tensors of a tree of dicts, lists, tuples and
    :class:`AdamWState`, keeping its structure and order; other leaves
    (the optimizer's step count) as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, AdamWState):
        return AdamWState(tree.step, _tree_map(fn, tree.mu),
                          _tree_map(fn, tree.nu))
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def tree_tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in :func:`_tree_map`'s order."""
    out: list[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def host_copy(tree, into=None):
    """A host (CPU) copy of every tensor of ``tree``; other leaves as
    they are. ``into``, an earlier host copy of a tree of the same
    shapes and dtypes, is overwritten in place and reused instead of
    allocating a second copy."""
    if into is not None:
        dst, src = tree_tensors(into), tree_tensors(tree)
        if len(dst) == len(src) and all(
                d.shape == s.shape and d.dtype == s.dtype
                and d.device.type == "cpu" for d, s in zip(dst, src)):
            it = iter(dst)

            def put(t):
                d = next(it)
                d.copy_(t)
                return d
            return _tree_map(put, tree)
    return _tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def copy_into(live, saved) -> None:
    """Copy the tensors of ``saved`` (a :func:`host_copy`) back into the
    matching tensors of ``live``, in place."""
    for dst, src in zip(tree_tensors(live), tree_tensors(saved)):
        dst.copy_(src)


def _named_children(tree) -> list[tuple[str, Any]] | None:
    """A node's children with the names ``jax.tree`` gives their key
    path; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, AdamWState):
        # the reference's step is a 0-d int32 array
        return [("step", np.asarray(tree.step, np.int32)),
                ("mu", tree.mu), ("nu", tree.nu)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(name, leaf)`` in ``jax.tree_util.tree_flatten_with_path``'s
    order and spelling; ``None`` is an empty subtree, as there."""
    if tree is None:
        return []
    kids = _named_children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, sub in kids:
        out += _flatten_with_names(sub, f"{prefix}/{name}" if prefix
                                   else name)
    return out


def _stored(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the npz stores it, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).cpu().numpy().view(np.uint16),
                    "bfloat16")
        leaf = t.cpu().numpy()
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _restored(a: np.ndarray, dt: str | None, like):
    """A stored array as a leaf like ``like`` (its dtype, shape and, for
    a tensor, its device)."""
    if isinstance(like, torch.Tensor):
        t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
             if dt == "bfloat16" else torch.from_numpy(a))
        return t.reshape(like.shape).to(device=like.device, dtype=like.dtype)
    if dt == "bfloat16":
        raise TypeError("a bfloat16 leaf restores only into a tensor")
    like = np.asarray(like)
    return np.asarray(a, dtype=like.dtype).reshape(like.shape)


# ------------------------------------------------------------------ #
# the disk tier                                                      #
# ------------------------------------------------------------------ #
def _tmp_dir(directory: Path, step: int) -> Path:
    """Staging directory for one save. Dot-prefixed so a crash leftover
    can never match the ``step_*`` glob that ``restore_checkpoint`` and
    ``CheckpointManager._gc`` scan."""
    return directory / f".tmp_step_{step:08d}"


def sweep_stale_tmp(directory: str | Path) -> list[Path]:
    """Clean up crash leftovers from interrupted saves.

    ``.tmp_step_*`` staging dirs and the legacy ``step_*.tmp`` form are
    removed (a crash may have left them half-written). A ``.old_step_*``
    dir is a *complete* checkpoint parked by the overwrite-safe commit:
    if the crash hit between parking the old copy and committing the new
    one, the committed name is missing — rename the parked copy back
    instead of deleting the only good copy. Returns the paths removed.
    """
    d = Path(directory)
    stale = [p for p in d.glob(".tmp_step_*") if p.is_dir()]
    stale += [p for p in d.glob("step_*.tmp") if p.is_dir()]
    stale += _recover_parked(d)
    for p in stale:
        shutil.rmtree(p, ignore_errors=True)
    return stale


def _recover_parked(d: Path) -> list[Path]:
    """Heal the overwrite-commit crash window: a ``.old_step_*`` dir is
    a complete checkpoint parked before the new copy committed. If the
    committed name is missing, rename the park back; otherwise return it
    as junk for the caller to delete."""
    junk = []
    for p in d.glob(".old_step_*"):
        if not p.is_dir():
            continue
        committed = d / p.name[len(".old_"):]
        if committed.exists():
            junk.append(p)              # commit finished; park is junk
        else:
            p.rename(committed)         # recover the previous checkpoint
    return junk


def save_checkpoint(directory: str | Path, step: int, tree: Any, *,
                    clock=time.time) -> Path:
    """Write one checkpoint: ``<dir>/step_<n>/{shard_0.npz,
    manifest.json}``, the JAX package's ``npz-v1`` layout.

    ``clock`` supplies the manifest's provenance timestamp (wall clock by
    default). The only other varying input is the time ``np.savez``
    stamps on the zip entries (two-second resolution): with a fixed
    clock, two saves of the same tree within one such tick are
    byte-identical, in either package.
    """
    d = Path(directory) / f"step_{step:08d}"
    tmp = _tmp_dir(Path(directory), step)
    if tmp.exists():                    # leftover of an interrupted save
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    names, dtypes, stored = [], [], {}
    for n, leaf in _flatten_with_names(tree):
        a, dt = _stored(leaf)
        names.append(n)
        dtypes.append(dt)
        stored[n] = a
    np.savez(tmp / "shard_0.npz", **stored)
    manifest = {
        "step": step,
        "leaves": names,
        "dtypes": dtypes,
        "time": clock(),
        "format": "npz-v1",
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # overwrite-safe commit: re-saving a step after a rollback replaces
    # the old directory. The old copy is parked under a dot-prefixed
    # name first so the commit point stays a single rename; a crash
    # inside the park->commit window is healed by sweep_stale_tmp
    if d.exists():
        old = d.with_name(f".old_{d.name}")
        if old.exists():
            shutil.rmtree(old)
        d.rename(old)
        tmp.rename(d)                   # atomic commit
        shutil.rmtree(old)
    else:
        tmp.rename(d)                   # atomic commit
    return d


def restore_checkpoint(directory: str | Path, tree_like: Any,
                       step: int | None = None) -> tuple[int, Any]:
    """Restore the latest (or given) step into the structure of
    ``tree_like``: each leaf takes the dtype and shape of its
    counterpart there and, for a tensor, its device (leaves are stored
    full-size, so a checkpoint restores onto any layout)."""
    d = Path(directory)
    # only committed checkpoints parse: staging dirs are dot-prefixed,
    # and leftovers of the legacy form (``step_<n>.tmp``) are skipped
    by_step = {int(p.name.split("_")[1]): p for p in d.glob("step_*")
               if p.is_dir() and p.name.split("_")[1].isdigit()}
    # a save that crashed inside the overwrite-commit window leaves the
    # previous (complete) checkpoint parked under ``.old_step_*``; read
    # it in place (sweep_stale_tmp heals the name on the next manager)
    for p in d.glob(".old_step_*"):
        s = p.name.rsplit("_", 1)[1]
        if p.is_dir() and s.isdigit() and int(s) not in by_step:
            by_step[int(s)] = p
    if not by_step:
        raise FileNotFoundError(f"no checkpoints under {d}")
    step = step if step is not None else max(by_step)
    if step not in by_step:
        raise FileNotFoundError(f"no checkpoint for step {step} under {d}")
    cdir = by_step[step]
    manifest = json.loads((cdir / "manifest.json").read_text())
    names = manifest["leaves"]
    dtypes = manifest.get("dtypes", [None] * len(names))
    flat = _flatten_with_names(tree_like)
    if len(flat) != len(names):
        raise ValueError(f"checkpoint has {len(names)} leaves, the tree "
                         f"expects {len(flat)}")
    with np.load(cdir / "shard_0.npz") as data:
        restored = iter([_restored(data[n], dt, like)
                         for n, dt, (_, like) in zip(names, dtypes, flat)])
    return step, _rebuild(tree_like, restored)


def _rebuild(tree, leaves):
    """``tree`` with its leaves (in :func:`_flatten_with_names` order)
    taken from the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, AdamWState):
        return AdamWState(int(next(leaves)), _rebuild(tree.mu, leaves),
                          _rebuild(tree.nu, leaves))
    if isinstance(tree, (list, tuple)):
        return type(tree)([_rebuild(v, leaves) for v in tree])
    return next(leaves)


# ------------------------------------------------------------------ #
# the manager                                                        #
# ------------------------------------------------------------------ #
class CheckpointManager:
    """Async two-tier manager with the Eq.-1 optimal interval.

    Background-save failures are never silent: the worker retries once
    (after ``retry_backoff`` seconds — transient storage hiccups are the
    common case), and a save that still fails is captured and re-raised
    from the next :meth:`wait` or :meth:`maybe_save` call on the
    training thread. ``saves`` counts only checkpoints that durably
    committed, and a failed save rewinds the interval clock so it
    re-arms immediately.

    ``clock`` stamps manifest provenance (wall time); ``monotonic``
    drives the save-interval decision — inject a fake for deterministic
    :meth:`due` tests, as ``clock=`` gives byte-stable saves.

    ``sweep`` (default True) removes crash leftovers of old runs from
    the directory as the manager is built (:func:`sweep_stale_tmp`).
    Ranks that share one directory must not all sweep it: two that list
    the same parked ``.old_step_*`` copy would both rename it back, and
    the later one fails. The rank that writes sweeps; the others open
    the directory after it, with ``sweep=False``
    (:class:`repro_torch.exec.MeshExecutor`).
    """

    def __init__(self, directory: str | Path, *, n_groups: int,
                 redundancy: int, mtbf: float, t_save: float,
                 t_restart: float, keep: int = 3, clock=time.time,
                 monotonic=time.monotonic, retry_backoff: float = 0.1,
                 sweep: bool = True):
        self.directory = Path(directory)
        self.clock = clock              # manifest provenance timestamps
        self.monotonic = monotonic      # save-interval clock (injectable)
        self.retry_backoff = float(retry_backoff)
        if sweep and self.directory.exists():
            sweep_stale_tmp(self.directory)  # crash leftovers of old runs
        self.keep = keep
        t_f = mu(n_groups, redundancy) * mtbf
        self.interval = tc_star(t_f, t_save, t_restart)
        self._last_save_wall = self.monotonic()
        self._thread: threading.Thread | None = None
        self._outcome: dict[str, Any] | None = None
        self._save_error: BaseException | None = None
        self._snapshot: tuple[int, Any] | None = None
        self.saves = 0                  # committed checkpoints only
        self.save_failures = 0          # saves that failed even the retry

    # ---------------- in-memory tier ---------------- #
    def snapshot(self, step: int, tree: Any) -> None:
        """Host snapshot (the memory tier): a real copy, since the live
        tensors are updated in place. A snapshot of the same shapes is
        copied into the previous one's host tensors, after any save
        that reads them has finished (its outcome is kept for
        :meth:`wait`)."""
        into = None
        if self._snapshot is not None:
            self._join()
            into = self._snapshot[1]
        self._snapshot = (step, host_copy(tree, into))

    def rollback(self) -> tuple[int, Any]:
        if self._snapshot is None:
            raise RuntimeError("no snapshot taken yet")
        return self._snapshot

    @property
    def last_snapshot(self) -> tuple[int, Any] | None:
        """The memory tier's ``(step, host tree)``, or None."""
        return self._snapshot

    # ---------------- disk tier ---------------- #
    def due(self, now: float | None = None) -> bool:
        self._fold()    # a finished failed save rewinds the clock here
        now = self.monotonic() if now is None else now
        return (now - self._last_save_wall) >= self.interval

    def maybe_save(self, step: int, tree: Any, *, block: bool = False,
                   force: bool = False) -> bool:
        """Save ``tree`` as step ``step`` in the background when the
        interval is due (or ``force``). The tree is copied to the host
        first, unless it is the memory tier's own tree
        (:attr:`last_snapshot`), which is written as it is: a later
        :meth:`snapshot` waits for the save before overwriting it."""
        if not force and not self.due():
            return False
        self.wait()                     # one in-flight save at a time;
        #                                 re-raises a prior failed save
        snap = self._snapshot
        host_tree = (tree if snap is not None and tree is snap[1]
                     else host_copy(tree))
        # advance the interval clock at dispatch so due() cannot refire
        # while this save is in flight; a failure rewinds it (in _fold)
        prev_wall, self._last_save_wall = self._last_save_wall, \
            self.monotonic()
        # one-shot result channel: the worker writes ONLY this local
        # dict; all manager bookkeeping folds in on the training thread
        outcome: dict[str, Any] = {"prev_wall": prev_wall}

        def work():
            try:
                try:
                    save_checkpoint(self.directory, step, host_tree,
                                    clock=self.clock)
                except Exception:
                    time.sleep(self.retry_backoff)   # transient hiccup?
                    save_checkpoint(self.directory, step, host_tree,
                                    clock=self.clock)
                self._gc()
            except BaseException as e:   # noqa: BLE001 - surfaced on wait()
                outcome["error"] = e
                return
            outcome["ok"] = True

        self._outcome = outcome
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()
        return True

    def _join(self) -> None:
        """Wait for an in-flight save and fold its outcome, raising
        nothing (a failure stays parked for :meth:`wait`)."""
        if self._thread is not None:
            self._thread.join()
        self._fold()

    def _fold(self) -> None:
        """Fold a *finished* background save's outcome into the manager
        (non-blocking): `saves` counts durable commits, never optimistic
        dispatches; a failure rewinds the interval clock so :meth:`due`
        re-arms, and parks the error for :meth:`wait` to raise."""
        t = self._thread
        if t is None or t.is_alive():
            return
        t.join()
        self._thread = None
        outcome, self._outcome = self._outcome, None
        if outcome is None:
            return
        if "error" in outcome:
            self._save_error = outcome["error"]
            self.save_failures += 1
            self._last_save_wall = outcome["prev_wall"]
        elif outcome.get("ok"):
            self.saves += 1

    def wait(self) -> None:
        self._join()
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise RuntimeError(
                "background checkpoint save failed "
                "(original attempt and one retry)") from err

    def _gc(self) -> None:
        dirs = sorted(p for p in self.directory.glob("step_*")
                      if p.name.split("_")[1].isdigit())
        for old in dirs[: -self.keep]:
            for f in old.iterdir():
                f.unlink()
            old.rmdir()

    def restore_latest(self, tree_like: Any) -> tuple[int, Any]:
        self.wait()
        return restore_checkpoint(self.directory, tree_like)
