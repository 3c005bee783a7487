"""Paged KV cache: block-table indirection over page pools (port of
``jaxlsq/serve/paged.py``).

Each layer owns K/V **page pools**, ``(P, KVH, page_size, hd)`` tensors (plus
``(P, KVH, page_size)`` f32 scale pools when int8/int4), and all layers share
ONE **block table** ``(B, pages_per_slot) int32`` on the device: logical
position ``pos`` of slot ``b`` lives at pool page ``table[b, pos //
page_size]``, row ``pos % page_size``.  A pool page can back any (slot,
logical page) pair, so cache memory follows the pages in use and a shared
prefix is shared by pointing several tables at the same pages.

* :func:`paged_update` writes new rows through the table in place, quantized
  on write with the dense cache's own per-row scheme, so paged and dense
  caches hold identical bytes for the same tokens.
* :func:`paged_attention` attends through the table: on CPU tensors the plain
  version :func:`paged_attention_plain` (gather to the dense layout, then
  ``decode_attention_plain``); on CUDA tensors the paged instance of
  ``csrc/decode_attention.cu``'s span kernel (the dense kernel's body, only
  the row addresses differ) and its fold, which give the dense kernel's bits
  on the same contents at any page size, or raises.
* :class:`PageAllocator` is the engines' host-side page bookkeeping.

Differences from the JAX package: one table tensor is shared by every layer
(the JAX package gives each layer its own copy only so that a donated cache
holds no buffer twice); pools are updated in place; ``page_size`` has no
tiling meaning on the card (the kernel reads whole rows through the table at
any page size).  ``LAUNCHES`` counts the paged span kernel's launches and its fold's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import _build
from .attention import (_CARRIERS, _dtype_name, _q4, _q8, _qpos,
                        decode_attention_plain, span_workspace)

__all__ = ["PagedKVLayer", "init_paged_cache", "with_table", "paged_update",
           "paged_attention", "paged_attention_plain", "PageAllocator",
           "LAUNCHES"]

LAUNCHES = {"paged_attention": 0, "paged_attention_fold": 0}


@dataclasses.dataclass
class PagedKVLayer:
    """One layer's paged cache: ``kp``/``vp`` pools (P, KVH, ps, hd) float or
    int8, or (P, KVH, ps, hd // 2) uint8 nibble pairs; ``ks``/``vs`` (P, KVH,
    ps) f32 per-row scales (None for float pools); ``table`` (B, pps) int32
    pool page ids; ``page_size`` positions a page."""

    kp: torch.Tensor
    vp: torch.Tensor
    table: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None
    page_size: int = 1024

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def int4(self) -> bool:
        return self.quantized and self.kp.dtype == torch.uint8

    @property
    def length(self) -> int:
        """Logical positions a slot can address: pages_per_slot * page_size."""
        return self.table.shape[1] * self.page_size


def init_paged_cache(model, batch_size: int, *, page_size: int = 1024,
                     num_pages: Optional[int] = None, dtype=torch.float32,
                     max_len: Optional[int] = None, table=None):
    """Zero paged cache for a ``QuantTransformerLM``: a tuple of
    ``model.depth`` :class:`PagedKVLayer` with their own pools and ONE shared
    table tensor.

    The defaults give the dense-equivalent layout (``num_pages = batch_size
    * ceil(max_len / page_size)``, slot ``b``'s logical page ``j`` at pool
    page ``b * pages_per_slot + j``), so ``prefill`` and decode work on it as
    on ``init_kv_cache``'s.  Engines pass a smaller ``num_pages`` and their
    own table."""
    length = model.max_len if max_len is None else max_len
    ps = int(page_size)
    if ps < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    pps = -(-length // ps)
    n_pages = batch_size * pps if num_pages is None else int(num_pages)
    hd = model.dim // model.num_heads
    kvh = model.num_kv_heads or model.num_heads
    dev = model.device
    if table is None:
        if n_pages < batch_size * pps:
            raise ValueError(
                f"num_pages={n_pages} cannot back the default linear table "
                f"({batch_size} slots x {pps} pages); pass an explicit table")
        table = torch.arange(batch_size * pps, dtype=torch.int32,
                             device=dev).reshape(batch_size, pps)
    else:
        table = torch.as_tensor(np.asarray(table), dtype=torch.int32).to(dev)
        if tuple(table.shape) != (batch_size, pps):
            raise ValueError(f"table shape {tuple(table.shape)} != "
                             f"{(batch_size, pps)}")
    name = _dtype_name(dtype)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    def layer():
        pool = (n_pages, kvh, ps)
        if name == "int4":
            if hd % 2:
                raise ValueError("int4 paged cache needs an even head_dim "
                                 f"(got {hd}): values are nibble-packed in pairs")
            return PagedKVLayer(kp=zeros(pool + (hd // 2,), torch.uint8),
                                vp=zeros(pool + (hd // 2,), torch.uint8),
                                ks=zeros(pool, torch.float32),
                                vs=zeros(pool, torch.float32),
                                table=table, page_size=ps)
        if name == "int8":
            return PagedKVLayer(kp=zeros(pool + (hd,), torch.int8),
                                vp=zeros(pool + (hd,), torch.int8),
                                ks=zeros(pool, torch.float32),
                                vs=zeros(pool, torch.float32),
                                table=table, page_size=ps)
        if name not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"unsupported cache dtype {dtype!r}")
        return PagedKVLayer(kp=zeros(pool + (hd,), dtype),
                            vp=zeros(pool + (hd,), dtype), table=table,
                            page_size=ps)

    return tuple(layer() for _ in range(model.depth))


def with_table(cache, table: torch.Tensor) -> tuple:
    """``cache``'s layers re-pointed at ``table`` (the same pools, no copy):
    the engines pass a slot's one-row table to an admission chunk."""
    return tuple(dataclasses.replace(layer, table=table) for layer in cache)


def paged_update(layer: PagedKVLayer, k: torch.Tensor, v: torch.Tensor,
                 cache_index) -> PagedKVLayer:
    """Write ``t`` new K/V rows a slot through the table, in place.

    ``k``/``v``: (B, KVH, t, hd) float; ``cache_index``: int, 0-d or (B,)
    position of the first new row a slot.  Int pools quantize on write with
    the dense cache's scheme.  Slots must own the pages they write (shared
    prefix pages are read-only by the allocator's contract).  Returns the
    same layer."""
    b, kvh, t, _ = k.shape
    ps = layer.page_size
    dev = layer.kp.device
    pos = _qpos(cache_index, b, dev).to(torch.int64)[:, None] + torch.arange(
        t, device=dev)                                       # (B, t)
    page = torch.gather(layer.table.to(torch.int64), 1, pos // ps)[:, :, None]
    off = (pos % ps)[:, :, None]
    head = torch.arange(kvh, device=dev)[None, None, :]

    def scatter(pool, rows):  # rows (B, KVH, t, ...) -> pool[page, head, off]
        pool[page, head, off] = rows.transpose(1, 2).to(pool.dtype)

    if layer.quantized:
        quant = _q4 if layer.int4 else _q8
        kq, ks = quant(k)
        vq, vs = quant(v)
        for pool, rows in ((layer.kp, kq), (layer.ks, ks), (layer.vp, vq),
                           (layer.vs, vs)):
            scatter(pool, rows)
    else:
        scatter(layer.kp, k)
        scatter(layer.vp, v)
    return layer


def _gather_dense(layer: PagedKVLayer):
    """The pools gathered into the dense (B, KVH, L, ...) layout."""
    b, pps = layer.table.shape

    def g(pool):
        x = pool[layer.table.to(torch.int64)]          # (B, pps, KVH, ps, ...)
        x = x.movedim(2, 1)                            # (B, KVH, pps, ps, ...)
        return x.reshape(b, x.shape[1], pps * layer.page_size, *x.shape[4:])

    if layer.quantized:
        return (g(layer.kp), g(layer.ks)), (g(layer.vp), g(layer.vs))
    return g(layer.kp), g(layer.vp)


def paged_attention_plain(q, layer: PagedKVLayer, cache_index,
                          window: Optional[int] = None):
    """Gather to the dense layout, then ``decode_attention_plain`` (the JAX
    package's ``_gather_dense`` + ``_decode_attention_xla``)."""
    ck, cv = _gather_dense(layer)
    return decode_attention_plain(q, ck, cv, cache_index, window)


def _launch(q, layer: PagedKVLayer, cache_index, window):
    b, h, t, hd = q.shape
    n_pages, kvh, ps = layer.kp.shape[:3]
    carrier = _CARRIERS.get(layer.kp.dtype)
    if carrier is None or layer.vp.dtype != layer.kp.dtype:
        raise ValueError(f"paged_attention: unsupported pool dtypes "
                         f"{layer.kp.dtype}/{layer.vp.dtype}")
    if layer.quantized != (carrier >= 2):
        raise ValueError("paged_attention: int pools come with scale pools")
    if q.dtype != torch.float32:
        raise ValueError(f"paged_attention: the kernel takes f32 queries, got {q.dtype}")
    if hd > 128 or (carrier == 3 and hd % 2):
        raise ValueError(f"paged_attention: head_dim {hd} not supported "
                         "(<= 128, even for int4)")
    want = (n_pages, kvh, ps, hd // 2 if carrier == 3 else hd)
    if tuple(layer.kp.shape) != want or tuple(layer.vp.shape) != want:
        raise ValueError(f"paged_attention: pool shapes {tuple(layer.kp.shape)}/"
                         f"{tuple(layer.vp.shape)}, want {want}")
    if ps != layer.page_size:
        raise ValueError(f"paged_attention: pools hold pages of {ps} rows, "
                         f"the layer says {layer.page_size}")
    table = layer.table
    if table.dim() != 2 or table.shape[0] != b or table.dtype != torch.int32:
        raise ValueError(f"paged_attention: table must be int32 ({b}, pps), got "
                         f"{table.dtype} {tuple(table.shape)}")
    dev = q.device
    tensors = [q, layer.kp, layer.vp, table] + (
        [layer.ks, layer.vs] if layer.quantized else [])
    if any(x.device != dev for x in tensors):
        raise ValueError("paged_attention: q, the pools and the table must share "
                         "a device")
    kp, vp, tb = layer.kp.contiguous(), layer.vp.contiguous(), table.contiguous()
    if layer.quantized:
        ks = layer.ks.to(torch.float32).contiguous()
        vs = layer.vs.to(torch.float32).contiguous()
        if tuple(ks.shape) != want[:3] or tuple(vs.shape) != want[:3]:
            raise ValueError("paged_attention: scale pools must be (P, KVH, ps)")
        ks_ptr, vs_ptr = ks.data_ptr(), vs.data_ptr()
    else:
        ks_ptr = vs_ptr = 0
    qc = q.contiguous()
    qpos = _qpos(cache_index, b, dev).contiguous()
    out = torch.empty_like(qc)
    lib = _build.load_library()
    gt = (h // kvh) * t
    ws = span_workspace(lib, b * kvh, layer.length, gt, hd, dev)
    err = lib.jlt_paged_attention(
        qc.data_ptr(), kp.data_ptr(), ks_ptr, vp.data_ptr(), vs_ptr,
        qpos.data_ptr(), tb.data_ptr(), out.data_ptr(), ws.data_ptr(), b, kvh, ps,
        table.shape[1], hd, t, gt,
        0 if window is None else int(window), carrier, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["paged_attention"] += 1
    LAUNCHES["paged_attention_fold"] += 1
    _build.check(err, "paged_attention")
    return out


def paged_attention(q, layer: PagedKVLayer, cache_index,
                    window: Optional[int] = None):
    """Causal attention of ``q`` (B, H, t, hd) against a paged cache layer
    (already holding the new rows); returns (B, H, t, hd) f32.  Rows no slot
    wrote (a dummy page, positions past the frontier) sit at key positions
    the causal mask kills: their weight underflows to exactly 0."""
    b, h, t, hd = q.shape
    kvh = layer.kp.shape[1]
    if h % kvh:
        raise ValueError(f"num_heads {h} not divisible by kv heads {kvh}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return paged_attention_plain(q, layer, cache_index, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, layer, cache_index, window)


class PageAllocator:
    """Host-side page bookkeeping for the engines (numpy only).

    Pages carry a refcount so a shared prefix's pages can back many slots:
    ``share`` bumps, ``free`` decrements and returns a page to the free list
    at zero.  It hands out page ids; the engine installs them in its table."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._refs = np.zeros(self.num_pages, np.int32)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """``n`` fresh pages (refcount 1); raises when the pool runs short."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._refs[out] = 1
        return out

    def share(self, pages) -> None:
        """Bump refcounts (a new slot now points at these pages)."""
        for p in pages:
            if self._refs[p] <= 0:
                raise RuntimeError(f"page {p} is not live")
            self._refs[p] += 1

    def free(self, pages) -> None:
        for p in pages:
            if self._refs[p] <= 0:
                raise RuntimeError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(int(p))
