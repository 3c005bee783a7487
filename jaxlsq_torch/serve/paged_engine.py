"""Paged continuous-batching decode engines (port of ``PagedPrefix``,
``PagedDecodeEngine`` and ``PagedSpeculativeDecodeEngine`` from
``jaxlsq/serve/paged_engine.py``).

:class:`PagedDecodeEngine` keeps :class:`~jaxlsq_torch.serve.decode.DecodeEngine`'s
dispatcher (token-level continuous batching, chunked admission, prefix
reuse, eos retirement) over the paged layout of ``serve/paged.py``:

* each layer's K/V live in page pools; one block table on the device maps
  (slot, logical page) to a pool page, so cache memory follows ``num_pages``,
  not ``max_batch * max_len``;
* an admission reserves every page its request will ever write (chunk
  padding and the ``n_new`` decode tail included) and retirement frees them,
  so the table changes only at those boundaries and never in a decode step;
* when the free pages cannot back the next queued request, admission DEFERS
  it, strictly FIFO, until retirements free pages;
* ``register_prefix`` prefills a shared prefix once into its own pages;
  admissions point their table rows at its complete pages (refcounted, no
  copy) and copy only a trailing partial page, which their suffix writes;
* admission chunks write straight into the slot's pages through a one-row
  table: there is no private slot cache and no final copy;
* windowed models (``attn_window``) free the pages that slid out of every
  future query's window while the request still runs.

One extra pool page (index ``num_pages``) is the DUMMY page: parked slots and
unreserved logical pages point at it.  Parked decode steps write finite
garbage there, and reads through it sit at key positions the causal mask
kills.  Paged and dense caches hold identical bytes for the same tokens and
the paged kernel gives the dense kernel's bits, so this engine gives
``DecodeEngine``'s tokens for the same request stream.

:class:`PagedSpeculativeDecodeEngine` is ``SpeculativeDecodeEngine`` over the
same machinery: the target and the draft decode in position lockstep, so one
allocator and ONE table tensor serve both models' pools.
"""

from __future__ import annotations

import queue
from typing import Optional

import numpy as np
import torch

from .decode import (DecodeEngine, Prefix, SpeculativeDecodeEngine, _GenRequest,
                     _PendingAdmit)
from .paged import PageAllocator, init_paged_cache, with_table

__all__ = ["PagedDecodeEngine", "PagedPrefix", "PagedSpeculativeDecodeEngine"]


class PagedPrefix(Prefix):
    """A shared prefix in its own pool pages: ``pages[: length // page_size]``
    are complete pages admissions point at (refcount-shared); a trailing
    partial page is copied per admission.  The handle keeps one reference to
    each page for the engine's lifetime."""

    __slots__ = ("pages", "page_size")

    def __init__(self, tokens, length, owner, pages, page_size):
        super().__init__(tokens, length, caches=(), owner=owner)
        self.pages = pages
        self.page_size = page_size


class PagedDecodeEngine(DecodeEngine):
    """``DecodeEngine`` over paged KV memory (see the module docstring).

    Args beyond :class:`DecodeEngine`'s: ``num_pages``, the pool pages a
    layer (one dummy page is added); the dense-equivalent count is
    ``max_batch * ceil(max_len / page_size)``, and provisioning fewer is the
    point of paging.  ``page_size``, positions a page: on the card it sets
    only the allocation grain (the kernel reads whole rows through the table
    at any page size).

    A request needing more pages than the whole pool is rejected at
    ``submit``; one needing more than are free waits (FIFO).  Prefix handles
    hold their pages until the engine is dropped, so handles that pin much of
    the pool can starve the head request.
    """

    _EXTRA_STATS = ("admissions_deferred", "prefix_pages_shared",
                    "window_pages_freed")

    def __init__(self, model, *, num_pages: int, page_size: int = 1024, **kwargs):
        self._init_pages(num_pages, page_size)
        self._window = model.attn_window
        super().__init__(model, **kwargs)

    def _init_pages(self, num_pages: int, page_size: int) -> None:
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if num_pages < 1:
            raise ValueError("num_pages must be >= 1")
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self._deferred: list = []  # FIFO of page-starved requests

    # --------------------------------------------------------- device state

    def _build_device_state(self, cache_dtype):
        """Page pools for every served model, all layers of all of them on
        one table tensor."""
        ps = self.page_size
        self._pps = -(-self.max_len // ps)  # table width (logical pages)
        self._dummy = self.num_pages
        self._alloc = PageAllocator(self.num_pages)
        self._table = np.full((self.max_batch, self._pps), self._dummy, np.int32)
        caches = []
        for m in self._served_models():
            c = init_paged_cache(m, self.max_batch, page_size=ps,
                                 num_pages=self.num_pages + 1, dtype=cache_dtype,
                                 max_len=self.max_len, table=self._table)
            caches.append(with_table(c, caches[0][0].table) if caches else c)
        self._cache = self._engine_cache(caches)
        self._dev_table = caches[0][0].table  # shared by every layer
        self._pos = np.full((self.max_batch,), self._park, np.int64)
        self._tok = torch.zeros((self.max_batch,), dtype=torch.int32,
                                device=self.device)

    def _layers(self) -> list:
        return [layer for c in self._model_caches(self._cache) for layer in c]

    def _sync_table(self):
        """Install the host table on the device (admission and retirement
        only; the decode step never changes it)."""
        self._dev_table.copy_(torch.from_numpy(self._table))

    def _row_cache(self, row: np.ndarray):
        """The engine's pools seen through a one-row table (a B=1 chunk)."""
        t = torch.as_tensor(row.reshape(1, self._pps)).to(self.device)
        return self._engine_cache([with_table(c, t)
                                   for c in self._model_caches(self._cache)])

    def _install(self, slot_cache, slot: int) -> None:
        """Nothing to copy: the admission's rows already sit in the slot's
        pages."""

    def _copy_page(self, src: int, dst: int):
        """pool[dst] = pool[src] in every pool of every layer (a partial
        prefix page materialized for one admission)."""
        for layer in self._layers():
            for pool in (layer.kp, layer.vp, layer.ks, layer.vs):
                if pool is not None:
                    pool[dst].copy_(pool[src])

    # ---------------------------------------------------------- page budget

    def _pages_needed(self, size: int, n_new: int, prefix) -> int:
        """Fresh pages an admission allocates: from the first page it does
        not share through the last position it will ever write (the
        verify headroom included)."""
        base = prefix.length if prefix is not None else 0
        end = base + max(self._padded_admit_len(size),
                         size + n_new + self._headroom())
        shared = base // self.page_size if prefix is not None else 0
        return -(-end // self.page_size) - shared

    # ------------------------------------------------------------------ API

    @torch.no_grad()
    def warmup(self):
        """Run the decode step and each chunk length once (first calls build
        the kernels); then zero the pools and park every slot.  Must run
        before requests are in flight."""
        with self._state_lock:
            if (any(s is not None for s in self._slots) or self._pending
                    or self._deferred):
                raise RuntimeError("warmup() must run before requests are in "
                                   "flight (it resets the KV cache)")
            self._run_step()
            # chunks go through an all-dummy row: their writes land in the
            # dummy page
            row = np.full(self._pps, self._dummy, np.int32)
            for c in sorted(c for c in {self._chunk_len(b) for b in self.buckets}
                            if c <= self.max_len):
                toks = torch.zeros((1, c), dtype=torch.int32, device=self.device)
                sc = self._run_chunk(self._row_cache(row), toks, 0)
                self._run_final_chunk(sc, toks, 0, 1, 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            for layer in self._layers():
                for pool in (layer.kp, layer.vp, layer.ks, layer.vs):
                    if pool is not None:
                        pool.zero_()
            self._pos[:] = self._park
            self._tok.zero_()

    @torch.no_grad()
    def register_prefix(self, tokens) -> PagedPrefix:
        """Prefill a shared prefix once into its own pool pages and return a
        zero-copy handle bound to this engine; raises when the pool cannot
        supply the pages.  Positions past the prefix in its padded chunks
        land in its partial page (copied per admission and overwritten
        before exposure) or in the dummy page, never in a complete page."""
        tokens, padded, c, n_chunks = self._stage_prefix_tokens(tokens)
        n_pages = -(-tokens.size // self.page_size)
        with self._state_lock:
            pages = self._alloc.alloc(n_pages)
        row = np.full(self._pps, self._dummy, np.int32)
        row[:n_pages] = pages
        try:
            sc = self._row_cache(row)
            for i in range(n_chunks):
                toks = torch.as_tensor(padded[:, i * c:(i + 1) * c]).to(self.device)
                with self._state_lock:
                    self._run_chunk(sc, toks, i * c)
        except Exception:
            with self._state_lock:
                self._alloc.free(pages)
            raise
        return PagedPrefix(tokens, int(tokens.size), self, pages, self.page_size)

    def _check_prefix(self, prefix):
        if not isinstance(prefix, PagedPrefix):
            raise ValueError(f"prefix must come from {type(self).__name__}."
                             "register_prefix()")
        if prefix.owner is not self:
            raise ValueError("prefix was registered on a different engine; call "
                             "register_prefix() on this one")
        if prefix.page_size != self.page_size:
            raise ValueError("prefix page_size does not match the engine's")

    def submit(self, prompt, n_new: int, *, prefix: Optional[Prefix] = None):
        """As :meth:`DecodeEngine.submit`; also rejects a request whose page
        reservation could never fit the pool (one that fits the pool but not
        the free pages waits)."""
        size = np.asarray(prompt).size
        if (0 < size <= self.buckets[-1]
                and (prefix is None or isinstance(prefix, PagedPrefix))):
            need = self._pages_needed(size, n_new, prefix)
            if need > self.num_pages:
                raise ValueError(
                    f"request needs {need} pages (> pool {self.num_pages}); "
                    "raise num_pages or shorten prompt/n_new")
        return super().submit(prompt, n_new, prefix=prefix)

    # ----------------------------------------------------------- dispatcher

    def _stage_admissions(self, reserved: set):
        """FIFO admission under page backpressure: a request whose
        reservation exceeds the free pages waits, and so does every request
        behind it."""
        free_slots = [s for s in range(self.max_batch)
                      if self._slots[s] is None and s not in reserved]
        while free_slots:
            if self._deferred:
                req, from_deferred = self._deferred[0], True
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
                from_deferred = False
            if req.future.done():  # cancelled while queued or deferred
                if from_deferred:
                    self._deferred.pop(0)
                continue
            need = self._pages_needed(req.prompt.size, req.n_new, req.prefix)
            if need > self._alloc.pages_free:
                if not from_deferred:
                    self._deferred.append(req)
                    self.stats["admissions_deferred"] += 1
                return
            if from_deferred:
                self._deferred.pop(0)
            slot = free_slots.pop(0)
            try:
                self._start_admit(req, slot)
                reserved.add(slot)
            except Exception as e:
                if not req.future.done():
                    req.future.set_exception(e)

    def _start_admit(self, req: _GenRequest, slot: int):
        """Reserve the slot and its pages; its table row is the shared
        prefix pages, a copied partial page, fresh pages, then the dummy."""
        ps = self.page_size
        c, n_chunks, padded = self._stage_prompt(req)
        base = req.prefix.length if req.prefix is not None else 0
        fresh = self._alloc.alloc(
            self._pages_needed(req.prompt.size, req.n_new, req.prefix))
        row = np.full(self._pps, self._dummy, np.int32)
        owned = list(fresh)
        if req.prefix is not None:
            shared = base // ps
            shared_pages = list(req.prefix.pages[:shared])
            self._alloc.share(shared_pages)
            owned += shared_pages
            row[:shared] = shared_pages
            row[shared:shared + len(fresh)] = fresh
            if base % ps:
                self._copy_page(req.prefix.pages[shared], fresh[0])
            self.stats["prefix_pages_shared"] += shared
        else:
            row[: len(fresh)] = fresh
        req.pages = owned
        req.slot = slot
        self._table[slot] = row
        self._sync_table()
        self._pending.append(_PendingAdmit(
            req=req, slot=slot, slot_cache=self._row_cache(row),
            n_chunks=n_chunks, padded=padded, c=c,
            steps_at_start=self.stats[self._STEP], base=base))

    def _advance_admission(self, p: _PendingAdmit):
        """One chunk into the slot's pages; a failed admission gives its
        pages back before the dispatcher fails the request."""
        try:
            super()._advance_admission(p)
        except Exception:
            self._release(p.req, p.slot)
            raise

    def _release(self, req: _GenRequest, slot: int) -> None:
        self._alloc.free(req.pages or ())
        req.pages = None
        self._table[slot] = self._dummy
        self._sync_table()

    def _retire_done(self):
        """Retire as the dense engine, give the pages back and park the
        slot's table row on the dummy page; windowed models also free pages
        that slid out of every future query's window."""
        before = list(self._slots)
        super()._retire_done()
        changed = False
        for slot, (b, a) in enumerate(zip(before, self._slots)):
            if b is not None and a is None:
                self._alloc.free(b.pages or ())
                b.pages = None
                self._table[slot] = self._dummy
                changed = True
        if self._window is not None:
            changed |= self._free_slid_pages()
        if changed:
            self._sync_table()

    def _free_slid_pages(self) -> bool:
        """A slot writing position ``pos`` never again reads below ``pos - W
        + 1``, so its logical page ``p`` is dead once ``(p + 1) * ps <= pos -
        W + 1``; shared prefix pages lose this slot's reference only."""
        ps = self.page_size
        changed = False
        for slot, req in enumerate(self._slots):
            if req is None or not req.pages:
                continue
            base = req.prefix.length if req.prefix is not None else 0
            pos = base + req.prompt.size + max(len(req.tokens) - 1, 0)
            last_dead = (pos - self._window + 1) // ps - 1
            if last_dead < 0:
                continue
            dead = []
            for p in range(min(last_dead + 1, self._pps)):
                pid = int(self._table[slot, p])
                if pid != self._dummy:
                    dead.append(pid)
                    self._table[slot, p] = self._dummy
            if dead:
                self._alloc.free(dead)
                req.pages = [x for x in req.pages if x not in set(dead)]
                self.stats["window_pages_freed"] += len(dead)
                changed = True
        return changed

    # ------------------------------------------------------------- shutdown

    def _fail_pending(self, exc):
        deferred, self._deferred = self._deferred, []
        for req in deferred:
            if not req.future.done():
                req.future.set_exception(exc)
        super()._fail_pending(exc)

    def _cancel_pending(self):
        for req in self._deferred:
            if not req.future.done():
                req.future.cancel()
        super()._cancel_pending()



class PagedSpeculativeDecodeEngine(PagedDecodeEngine, SpeculativeDecodeEngine):
    """:class:`SpeculativeDecodeEngine` over paged KV memory: every round
    advances all slots by a draft-propose / target-verify step, and both
    models' caches live in page pools.  The two decode in position
    lockstep, so ONE allocator and ONE table tensor serve both (page p backs
    the same positions in the target's and the draft's pools): sharing,
    deferral and retirement are :class:`PagedDecodeEngine`'s, and a prefix's
    pages and a partial page's copy cover both pools.  Needs
    ``target.max_len == draft.max_len`` (one table, one page grid).  A
    request reserves pages through ``prompt + n_new + k + 1`` rows.  Slid
    pages are not freed (the JAX package's engine frees none either).

    Args: ``target``, ``draft``, ``num_pages`` and ``page_size`` as
    :class:`PagedDecodeEngine`, the rest as :class:`SpeculativeDecodeEngine`.
    """

    _EXTRA_STATS = PagedDecodeEngine._EXTRA_STATS + SpeculativeDecodeEngine._EXTRA_STATS

    def __init__(self, target, draft, *, num_pages: int, page_size: int = 1024,
                 **kwargs):
        if target.max_len != draft.max_len:
            raise ValueError(
                "paged speculative serving shares ONE block table between the "
                f"target and draft pools: max_len must match (got "
                f"{target.max_len} vs {draft.max_len})")
        self._init_pages(num_pages, page_size)
        self._window = None
        SpeculativeDecodeEngine.__init__(self, target, draft, **kwargs)
