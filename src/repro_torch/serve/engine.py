"""Continuous-batching decode engine over the paged KV cache (the
counterpart of ``repro.serve.engine``).

One :class:`ServeEngine` drives one serving replica: a queue of
:class:`~repro_torch.data.pipeline.ServeRequest`, a fixed set of decode
slots, and the paged pools from :meth:`Model.init_paged_state`. Per
:meth:`step`:

1. **admit** — while a slot and enough pages are free, pop a request,
   run the fused cache-filling prefill, scatter its dense cache into the
   pools (:func:`~repro_torch.serve.kvcache.make_cache_writer`), and seed
   the slot with the prefill's first generated token;
2. **decode** — one ``make_serve_step(paged=True)`` call advances every
   slot one token (inactive slots spin on the trash page);
3. **evict** — slots that reached ``max_new`` free their pages and emit
   a :class:`FinishedRequest`.

The step functions come from a shared :class:`ExecutableCache` with the
JAX package's keys: ``("decode",)`` and ``("prefill", L)`` /
``("write", L)`` per prompt-length bucket. PyTorch runs eagerly, so
there is no ahead-of-time compile: the cache holds the built step
callables, and its ``misses`` counter is still the no-recompile gate —
after :meth:`ServeEngine.warmup` it must stay frozen, because
admissions, evictions and replica re-weighting are host-side data.

Prompts are exact-length per bucket (no right-padding), as in the JAX
package.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.data.pipeline import ServeRequest
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.model import Model
from repro_torch.obs.metrics import Counter
from repro_torch.obs.trace import maybe_span
from repro_torch.train.step import make_prefill, make_serve_step

from .kvcache import BlockAllocator, make_cache_writer, pages_needed

__all__ = ["ExecutableCache", "FinishedRequest", "ServeEngine"]


def _cached_length(dense) -> int | None:
    """The sequence length a dense prefill state carries: that of its
    first attention cache (GQA's k, MLA's latent; leaves ``(n_rep, B, S,
    ...)``), or None where it has none (pure SSM)."""
    for seg in dense:
        for c in seg:
            if isinstance(c, KVCache):
                return c.k.shape[2]
            if isinstance(c, MLACache):
                return c.c_kv.shape[2]
    return None


class ExecutableCache:
    """Built step callables keyed by (kind, *bucket); shared across
    replicas.

    ``misses`` counts builds; after :meth:`ServeEngine.warmup` it must
    stay frozen through any failure/re-weight sequence (the acceptance
    gate). Pass a :class:`~repro_torch.obs.metrics.MetricsRegistry` and
    the counts ARE its ``serve.exec_cache.misses`` / ``.hits`` entries.

    Nothing is compiled ahead of time here, and the pools are updated in
    place rather than donated: the counterpart of the JAX package's
    ``programs()`` (compiled HLO text for its donation lint) is
    :meth:`ServeEngine.programs`, one recorded call of each built
    callable.
    """

    def __init__(self, metrics=None):
        self._exe: dict[tuple, object] = {}
        if metrics is None:
            self._misses = Counter()
            self._hits = Counter()
        else:
            self._misses = metrics.counter("serve.exec_cache.misses")
            self._hits = metrics.counter("serve.exec_cache.hits")

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def hits(self) -> int:
        return self._hits.value

    def get(self, key: tuple, build):
        exe = self._exe.get(key)
        if exe is None:
            self._misses.inc()
            exe = self._exe[key] = build()
        else:
            self._hits.inc()
        return exe

    @property
    def keys(self) -> list[tuple]:
        return sorted(self._exe)

    def items(self) -> list[tuple]:
        """``(key, callable)`` per built callable, in key order; counts
        neither a hit nor a miss."""
        return sorted(self._exe.items(), key=lambda kv: kv[0])


@dataclass
class FinishedRequest:
    """A completed request: generated ids + per-token latencies."""

    req_id: int
    prompt_len: int
    tokens: np.ndarray                    # (max_new,) int32 generated ids
    latencies: np.ndarray                 # (max_new,) seconds per token
    admitted_step: int
    finished_step: int


@dataclass
class _Slot:
    request: ServeRequest
    pages: list[int]
    generated: list[int] = field(default_factory=list)
    latencies: list[float] = field(default_factory=list)
    admitted_step: int = 0


class ServeEngine:
    """One replica's continuous-batching loop (host control plane)."""

    def __init__(self, model: Model, params, *, n_slots: int,
                 n_pages: int, page_size: int, max_new: int,
                 buckets: tuple[int, ...],
                 exec_cache: ExecutableCache | None = None,
                 telemetry=None, track: str = "serve"):
        self.model = model
        self.params = params
        self.device = model.device
        self.telemetry = telemetry      # repro_torch.obs.Telemetry | None
        self.track = track              # trace lane (replica/<r> under
        #                                 a ReplicaServer)
        self.n_slots = n_slots
        self.page_size = page_size
        self.max_new = max_new
        self.buckets = tuple(sorted(buckets))
        self.cache = exec_cache if exec_cache is not None else ExecutableCache()

        # worst case: longest bucket + full generation budget
        self.max_pages = pages_needed(self.buckets[-1] + max_new, page_size)
        self.alloc = BlockAllocator(n_pages, page_size)
        self.pools = model.init_paged_state(n_slots, n_pages, page_size)
        self._writer = make_cache_writer(model)

        # host-side slot arrays (the decode step's data plane)
        self.table = np.zeros((n_slots, self.max_pages), np.int64)
        self.pos = np.zeros((n_slots,), np.int64)
        self.next_tok = np.zeros((n_slots,), np.int64)
        self.slots: list[_Slot | None] = [None] * n_slots

        self.queue: deque[ServeRequest] = deque()
        self.step_idx = 0
        self.admitted = 0
        self.completed = 0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------- #
    # step functions                                                 #
    # ------------------------------------------------------------- #
    def _decode_exe(self):
        return self.cache.get(
            ("decode",), lambda: make_serve_step(self.model, paged=True))

    def _prefill_exe(self, length: int):
        if length not in self.buckets:
            raise ValueError(f"prompt length {length} not in buckets "
                             f"{self.buckets}")
        model = self.model
        return self.cache.get(
            ("prefill", length),
            lambda: make_prefill(model, return_cache=True))

    def _write_exe(self, length: int):
        n_alloc = pages_needed(length + self.max_new, self.page_size)
        writer = self._writer

        def build():
            def write(pools, dense, pages, slot):
                # the bucket's shapes are fixed, as the JAX package's
                # per-bucket executable fixes them; the prompt length is
                # carried by the attention caches (a Mamba cache is O(1))
                got = _cached_length(dense)
                if pages.shape != (n_alloc,) or got not in (None, length):
                    raise ValueError(
                        f"write for bucket {length} got pages "
                        f"{tuple(pages.shape)}, length {got}")
                return writer(pools, dense, pages, slot)
            return write
        return self.cache.get(("write", length), build)

    def _decode_args(self, pools, table, pos, next_tok) -> tuple:
        """The decode callable's arguments, from the host slot arrays."""
        return (self.params, pools, self._dev(table), self._dev(pos),
                self._dev(next_tok[:, None]))

    def _write_args(self, pools, dense, pages, slot: int) -> tuple:
        """A write callable's arguments: ``pages`` the slot's page ids."""
        return (pools, dense, self._dev(np.asarray(pages, np.int64)), slot)

    def programs(self):
        """``(key, StepLog)`` per built callable, in key order: one call
        of each, recorded (:func:`repro_torch.launch.steplog
        .record_step`), through the arguments :meth:`step` and
        :meth:`_admit` give it, on zero tokens and copies of the pools (a
        decode on the trash page, a write into pages ``1..n``). The pools
        a write or decode takes are the leaves it must update in place.
        The surface of the step passes (:mod:`repro_torch.analysis`);
        nothing is built and the engine is left as it was."""
        import copy

        from repro_torch.dist import tree_leaves
        from repro_torch.launch.steplog import record_step

        built = dict(self.cache.items())
        for key, fn in self.cache.items():
            if key[0] == "decode":
                pools = copy.deepcopy(self.pools)
                zeros = np.zeros_like(self.pos)
                args = self._decode_args(pools, np.zeros_like(self.table),
                                         zeros, zeros)
                _, log = record_step(fn, args, donated=tree_leaves(pools),
                                     returned=lambda o: tree_leaves(o[1]))
            else:
                length = key[1]
                tokens = self._dev(np.zeros((1, length), np.int64))
                prefill = built[("prefill", length)]
                if key[0] == "prefill":
                    _, log = record_step(prefill, (self.params, tokens),
                                         donated=[], returned=lambda o: [])
                else:
                    _, dense = prefill(self.params, tokens)
                    pools = copy.deepcopy(self.pools)
                    pages = np.arange(1, pages_needed(
                        length + self.max_new, self.page_size) + 1)
                    _, log = record_step(
                        fn, self._write_args(pools, dense, pages, 0),
                        donated=tree_leaves(pools), returned=tree_leaves)
            yield key, log

    def warmup(self) -> None:
        """Build every step function this engine can ever need. After
        this, ``cache.misses`` is frozen — any later build is a bug."""
        self._decode_exe()
        for length in self.buckets:
            self._prefill_exe(length)
            self._write_exe(length)

    # ------------------------------------------------------------- #
    # request flow                                                   #
    # ------------------------------------------------------------- #
    def submit(self, req: ServeRequest) -> None:
        if req.prompt_len not in self.buckets:
            raise ValueError(f"prompt length {req.prompt_len} not in "
                             f"buckets {self.buckets}")
        if req.max_new > self.max_new:
            raise ValueError(f"max_new {req.max_new} > engine budget "
                             f"{self.max_new}")
        self.queue.append(req)

    @property
    def in_flight(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue)

    def drain_requests(self) -> list[ServeRequest]:
        """Pull every queued AND in-flight request out of this engine
        (replica death): in-flight sequences restart from their prompt —
        greedy decode makes the requeued output bit-identical, so a
        failure costs latency, never correctness. Pages are freed; pools
        keep their (now unreachable) contents."""
        out = list(self.queue)
        self.queue.clear()
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            self.alloc.free(slot.pages)
            self._clear_slot(i)
            out.append(slot.request)
        out.sort(key=lambda r: r.req_id)
        return out

    def _clear_slot(self, i: int) -> None:
        self.slots[i] = None
        self.table[i] = 0
        self.pos[i] = 0
        self.next_tok[i] = 0

    # ------------------------------------------------------------- #
    # the loop                                                       #
    # ------------------------------------------------------------- #
    def _admit(self) -> None:
        tel = self.telemetry
        vocab = self.model.cfg.vocab
        for i in range(self.n_slots):
            if not self.queue or self.slots[i] is not None:
                continue
            req = self.queue[0]
            total = req.prompt_len + self.max_new
            if not self.alloc.can_alloc(total):
                break                      # FIFO: don't starve the head
            self.queue.popleft()
            pages = self.alloc.alloc(total)
            length = req.prompt_len

            with maybe_span(tel, "admit", self.track,
                            args=(None if tel is None else
                                  {"req": req.req_id, "len": length})):
                t0 = time.perf_counter()
                with maybe_span(tel, "prefill", self.track):
                    logits, dense = self._prefill_exe(length)(
                        self.params,
                        self._dev(req.tokens[None, :].astype(np.int64)))
                    self.pools = self._write_exe(length)(
                        *self._write_args(self.pools, dense, pages, i))
                    first = int(torch.argmax(logits[0, -1, :vocab]))
                dt = time.perf_counter() - t0

                slot = _Slot(request=req, pages=pages,
                             admitted_step=self.step_idx)
                slot.generated.append(first)
                slot.latencies.append(dt)
                self.slots[i] = slot
                self.table[i] = 0
                self.table[i, :len(pages)] = pages
                self.pos[i] = length
                self.next_tok[i] = first
                self.admitted += 1
            if tel is not None:
                tel.counter("serve.admitted").inc()
                tel.histogram("serve.prefill_latency_s").observe(dt)

    def _evict_finished(self) -> list[FinishedRequest]:
        tel = self.telemetry
        done = []
        for i, slot in enumerate(self.slots):
            if slot is None or len(slot.generated) < slot.request.max_new:
                continue
            with maybe_span(tel, "evict", self.track,
                            args=(None if tel is None else
                                  {"req": slot.request.req_id})):
                self.alloc.free(slot.pages)
                self._clear_slot(i)
            if tel is not None:
                tel.counter("serve.completed").inc()
            self.completed += 1
            done.append(FinishedRequest(
                req_id=slot.request.req_id,
                prompt_len=slot.request.prompt_len,
                tokens=np.asarray(
                    slot.generated[:slot.request.max_new], np.int32),
                latencies=np.asarray(
                    slot.latencies[:slot.request.max_new], np.float64),
                admitted_step=slot.admitted_step,
                finished_step=self.step_idx))
        return done

    def step(self) -> list[FinishedRequest]:
        """One engine tick: admit, decode one token everywhere, evict."""
        tel = self.telemetry
        self._admit()
        done = self._evict_finished()      # max_new == 1 finishes here

        active = [i for i, s in enumerate(self.slots) if s is not None]
        if active:
            with maybe_span(tel, "decode", self.track,
                            args=(None if tel is None else
                                  {"active": len(active)})):
                t0 = time.perf_counter()
                logits, self.pools = self._decode_exe()(
                    *self._decode_args(self.pools, self.table, self.pos,
                                       self.next_tok))
                toks = torch.argmax(
                    logits[:, :self.model.cfg.vocab], dim=-1).cpu().numpy()
                dt = time.perf_counter() - t0
            for i in active:
                slot = self.slots[i]
                slot.generated.append(int(toks[i]))
                slot.latencies.append(dt)
                self.pos[i] += 1
                self.next_tok[i] = int(toks[i])
            done += self._evict_finished()
            if tel is not None:
                tel.counter("serve.tokens").inc(len(active))
                tel.histogram("serve.token_latency_s").observe(dt)

        self.step_idx += 1
        if tel is not None:
            tel.gauge("serve.queue_depth").set(len(self.queue))
            tel.gauge("serve.kv_pages.free").set(self.alloc.free_pages)
            tel.gauge("serve.kv_pages.used").set(
                self.alloc.n_pages - 1 - self.alloc.free_pages)
        return done

    def run(self, max_steps: int = 10_000) -> list[FinishedRequest]:
        """Step until queue and slots drain (or ``max_steps``)."""
        out = []
        for _ in range(max_steps):
            if not self.queue and self.in_flight == 0:
                break
            out += self.step()
        return out
