"""Paged KV cache: block-table allocation over one physical pool (the
counterpart of ``repro.serve.kvcache``).

* every attention layer owns a **physical page pool** ``(n_rep, n_pages,
  page_size, KV, dh)`` (:meth:`Model.init_paged_state`); sequences of
  different lengths share it through a host-side **block table**
  ``(n_slots, max_pages)`` of physical page ids, one row per decode slot;
* **page 0 is the trash page**: never allocated, it absorbs the reads and
  writes of inactive decode slots (all-zero table rows, pos 0), so the
  decode step is total — admission and eviction are pure host-side data
  edits;
* stale pool contents after eviction are *unreachable*: the decode mask
  scores positions past ``pos`` at ``-2^20`` and the fp32 softmax
  underflows them to exactly ``0.0``;
* Mamba layers keep slot-dense caches ``(n_rep, n_slots, ...)`` (the
  SSD state is O(1) per sequence): admission overwrites the slot's conv
  window *and* SSD state from the prefill, which is what makes the
  inactive slots' spinning on garbage harmless.

:class:`BlockAllocator` is a tiny deterministic LIFO free-list: the same
alloc/free sequence hands out the same pages, and page *identity* never
affects gathered values, so a requeued request reproduces its output.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.model import Model
from repro_torch.models.ssm import MambaCache

__all__ = ["BlockAllocator", "pages_needed", "pool_pages_for",
           "make_cache_writer"]

TRASH_PAGE = 0


def pages_needed(total_len: int, page_size: int) -> int:
    """Pages covering ``total_len`` cache rows."""
    return max(1, math.ceil(total_len / page_size))


def pool_pages_for(n_slots: int, max_len: int, page_size: int) -> int:
    """Pool size (pages) so ``n_slots`` worst-case sequences always fit,
    plus the reserved trash page."""
    return n_slots * pages_needed(max_len, page_size) + 1


class BlockAllocator:
    """Deterministic page allocator over one physical pool.

    LIFO free list seeded with pages ``1 .. n_pages-1`` (page 0 is the
    trash page and is never handed out). Allocation is all-or-nothing:
    a request that doesn't fit stays in the queue rather than holding a
    partial reservation.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO with low pages on top: pop() returns 1, 2, 3, ...
        self._free = list(range(n_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, total_len: int) -> bool:
        return pages_needed(total_len, self.page_size) <= len(self._free)

    def alloc(self, total_len: int) -> list[int]:
        """Allocate pages for a sequence of ``total_len`` rows."""
        n = pages_needed(total_len, self.page_size)
        if n > len(self._free):
            raise MemoryError(
                f"need {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for pg in pages:
            if pg == TRASH_PAGE:
                raise ValueError("page 0 (trash) is not allocatable")
            if pg in self._free:
                raise ValueError(f"double free of page {pg}")
            self._free.append(pg)


def make_cache_writer(model: Model):
    """Build the prefill -> pool scatter for ``model``.

    Returns ``write(paged_state, dense_state, pages, slot) ->
    paged_state`` where ``dense_state`` is a batch-1
    :meth:`Model.prefill` state of prompt length L and ``pages`` is the
    ``(n_alloc,)`` page-id tensor of the sequence (``n_alloc * PS >= L``;
    the tail of the last page is zero-filled — masked, never read) and
    ``slot`` is the decode-slot index for the Mamba leaves. The pools are
    written in place (the JAX package donates them instead).
    """

    @torch.no_grad()
    def write(paged, dense, pages, slot):
        for seg_pool, seg_dense in zip(paged, dense):
            for pool_c, dense_c in zip(seg_pool, seg_dense):
                if isinstance(pool_c, MambaCache):
                    # slot-dense: drop the batch-1 axis, land in the slot
                    for pl, dn in zip(pool_c, dense_c):
                        pl[:, slot] = dn[:, 0]
                    continue
                for pl, dn in zip(pool_c, dense_c):
                    # pl (n_rep, NP, PS, *t); dn (n_rep, 1, L, *t)
                    n_rep, _, ps = pl.shape[:3]
                    length = dn.shape[2]
                    n_alloc = pages.shape[0]
                    d = torch.zeros((n_rep, n_alloc * ps, *pl.shape[3:]),
                                    dtype=pl.dtype, device=pl.device)
                    d[:, :length] = dn[:, 0]
                    pl[:, pages] = d.reshape(n_rep, n_alloc, ps,
                                             *pl.shape[3:])
        return paged

    return write
