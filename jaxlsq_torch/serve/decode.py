"""Autoregressive decode on the quantized serving path (port of
``make_sampler``, ``init_kv_cache``, ``prefill``, ``make_generate``,
``make_beam_search``, ``make_speculative_generate``, ``Prefix``,
``DecodeEngine`` and ``SpeculativeDecodeEngine`` from
``jaxlsq/serve/decode.py``).  Every model may be a ``QuantTransformerLM`` in
QAT or serve mode.

Differences from the JAX package, all from PyTorch running eagerly:

* The cache is updated in place; ``prefill`` and the model return the same
  cache objects they were given.
* ``make_generate``'s decode loop is a Python loop (the JAX package scans).
  Positions stay Python ints, so no step waits on the card.
* Randomness is a ``torch.Generator`` (the JAX package folds keys by
  output position); the same seed gives other tokens than JAX's, from the
  same distributions.
* The engines keep slot positions on the host and upload them each step;
  JAX's ``dynamic_update_slice`` clamps a write that runs past the cache,
  the port refuses such requests at ``submit`` and never clamps.
* Beam search breaks ties in its top-k by the lower index, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` promises
  no order among equal values), and reorders the cache in place.
* A speculative round reads the accepted count on the host once (the JAX
  package keeps it in its ``while_loop``): the next round's position is a
  Python int.

``PagedDecodeEngine`` and ``PagedSpeculativeDecodeEngine``
(``serve/paged_engine.py``) are the engines over page pools.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .attention import _dtype_name
from .paged import PagedKVLayer

__all__ = ["init_kv_cache", "prefill", "make_generate", "make_sampler",
           "make_beam_search", "make_speculative_generate", "Prefix",
           "DecodeEngine", "SpeculativeDecodeEngine"]


def _greedy(logits: torch.Tensor, generator=None) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _filter_logits(logits: torch.Tensor, temperature: float,
                   top_k: Optional[int]) -> torch.Tensor:
    """Temperature + top-k filter over the last axis, in f32 (the transform
    :func:`make_sampler` samples from)."""
    scaled = logits.to(torch.float32) / temperature
    if top_k is not None:
        kth = torch.sort(scaled, dim=-1).values[..., -top_k][..., None]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    return scaled


def _sample(probs: torch.Tensor, generator) -> torch.Tensor:
    """One draw a row of ``probs`` (B, V), unnormalized: (B,) int32."""
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def make_sampler(temperature: float = 1.0, top_k: Optional[int] = None):
    """``pick(logits (B, V), generator) -> (B,) int32``: temperature +
    optional top-k sampling; temperature 0 is greedy."""
    if temperature <= 0.0:
        return _greedy

    def pick(logits, generator=None):
        return _sample(torch.softmax(_filter_logits(logits, temperature, top_k), -1),
                       generator)

    return pick


def init_kv_cache(model, batch_size: int, *, dtype=torch.float32,
                  max_len: Optional[int] = None):
    """Zero KV cache: ``model.depth`` per-layer ``(k, v)`` pairs.

    ``dtype`` float32/bfloat16: arrays (B, KVH, L, hd).  ``torch.int8``:
    ``(data int8 (B, KVH, L, hd), scales f32 (B, KVH, L))`` pairs.
    ``"int4"``: ``(data uint8 (B, KVH, L, hd // 2), scales)`` with two
    values per byte (needs an even head_dim)."""
    length = model.max_len if max_len is None else max_len
    hd = model.dim // model.num_heads
    kvh = model.num_kv_heads or model.num_heads
    shape = (batch_size, kvh, length, hd)
    dev = model.device
    name = _dtype_name(dtype)

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=dev)

    if name == "int4":
        if hd % 2:
            raise ValueError("int4 KV cache needs an even head_dim "
                             f"(got {hd}): values are nibble-packed in pairs")
        return tuple(((zeros(shape[:-1] + (hd // 2,), torch.uint8),
                       zeros(shape[:-1], torch.float32)),
                      (zeros(shape[:-1] + (hd // 2,), torch.uint8),
                       zeros(shape[:-1], torch.float32)))
                     for _ in range(model.depth))
    if name == "int8":
        return tuple(((zeros(shape, torch.int8), zeros(shape[:-1], torch.float32)),
                      (zeros(shape, torch.int8), zeros(shape[:-1], torch.float32)))
                     for _ in range(model.depth))
    if name not in ("float32", "bfloat16", "float16"):
        raise ValueError(f"unsupported cache dtype {dtype!r}")
    return tuple((zeros(shape, dtype), zeros(shape, dtype))
                 for _ in range(model.depth))


def _cache_len(cache) -> int:
    if isinstance(cache[0], PagedKVLayer):
        return cache[0].length
    lead = cache[0][0]
    return (lead[0] if isinstance(lead, (tuple, list)) else lead).shape[2]


@torch.no_grad()
def prefill(model, tokens: torch.Tensor, *, cache=None, cache_dtype=torch.float32):
    """Run the prompt (B, t) through the model, filling the cache (dense, or
    paged from ``init_paged_cache``).  Returns ``(last_logits (B, vocab),
    cache, index)`` with ``index`` = t, the next write position."""
    b, t = tokens.shape
    if cache is None:
        cache = init_kv_cache(model, b, dtype=cache_dtype)
    length = _cache_len(cache)
    if t > length:
        raise ValueError(f"prompt length {t} exceeds cache max_len {length}")
    logits, cache = model(tokens, cache=cache, cache_index=0)
    return logits[:, -1], cache, t


def make_generate(model, prompt_len: int, n_new: int, *,
                  cache_dtype=torch.float32,
                  logits_to_token: Optional[Callable] = None,
                  sampled: bool = False):
    """Build ``generate(prompt (B, prompt_len)) -> (B, n_new) int32``: prefill,
    then ``n_new - 1`` decode steps, greedy by default.  With ``sampled``,
    ``generate(prompt, generator)`` passes the generator to
    ``logits_to_token`` (e.g. :func:`make_sampler`)."""
    if prompt_len + n_new > model.max_len:
        raise ValueError(
            f"prompt_len + n_new = {prompt_len + n_new} exceeds model.max_len "
            f"= {model.max_len}")
    pick = logits_to_token or _greedy

    @torch.no_grad()
    def generate(prompt: torch.Tensor, generator=None) -> torch.Tensor:
        if prompt.shape[1] != prompt_len:
            raise ValueError(f"prompt length {prompt.shape[1]} != {prompt_len}")
        prompt = prompt.to(model.device)
        last, cache, index = prefill(model, prompt, cache_dtype=cache_dtype)
        tok = pick(last, generator) if sampled else pick(last)
        toks = [tok]
        for i in range(n_new - 1):
            logits, cache = model(tok[:, None], cache=cache, cache_index=index + i)
            tok = pick(logits[:, -1], generator) if sampled else pick(logits[:, -1])
            toks.append(tok)
        return torch.stack(toks, dim=1)

    return generate


def _top_k(x: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, ties
    broken by the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def make_beam_search(model, prompt_len: int, n_new: int, *, beams: int = 4,
                     cache_dtype=torch.float32, eos_id: Optional[int] = None,
                     length_penalty: float = 0.0):
    """Beam search: keep the ``beams`` (K) highest joint log-prob
    continuations at every step.

    The prompt is tiled beam-major and prefilled at B·K rows; the first step
    seeds the beams with the top K tokens (beams past the vocab start at
    -inf, so K >= V^n is exhaustive search).  Each step decodes all beams,
    takes the top K of the (B, K·V) joint scores, and reorders the token
    histories and every cache leaf (the int8/int4 ``(data, scale)`` pairs
    too) to the surviving parents in place.  With ``eos_id`` a beam that
    emitted it is frozen: its only continuation is a free eos.  The
    Google-NMT ``length_penalty`` (``score / ((5 + len) / 6) ** alpha``,
    ``len`` up to the first eos) applies at the final ranking only, and only
    with ``eos_id``.  ``beams=1`` is greedy decode.

    Returns ``search(prompt (B, prompt_len)) -> (tokens (B, n_new) int32,
    scores (B,) f32)``: the best beam a sample and its joint log-prob.  No
    step reads the device on the host.
    """
    if beams < 1:
        raise ValueError("beams must be >= 1")
    if prompt_len + n_new > model.max_len:
        raise ValueError(
            f"prompt_len + n_new = {prompt_len + n_new} exceeds model.max_len "
            f"= {model.max_len}")
    k = beams

    @torch.no_grad()
    def search(prompt: torch.Tensor):
        if prompt.shape[1] != prompt_len:
            raise ValueError(f"prompt length {prompt.shape[1]} != {prompt_len}")
        prompt = prompt.to(model.device)
        b = prompt.shape[0]
        last, cache, index = prefill(model, prompt.repeat_interleave(k, dim=0),
                                     cache_dtype=cache_dtype)
        logp0 = torch.log_softmax(last.reshape(b, k, -1)[:, 0].to(torch.float32), -1)
        v = logp0.shape[-1]
        k1 = min(k, v)
        scores, first = _top_k(logp0, k1)
        if k1 < k:
            scores = torch.cat([scores, scores.new_full((b, k - k1), float("-inf"))], 1)
            first = torch.cat([first, first.new_zeros((b, k - k1))], 1)
        tok = first.to(torch.int32)
        hist = torch.zeros((b, k, n_new), dtype=torch.int32, device=prompt.device)
        hist[:, :, 0] = tok
        finished = tok == eos_id if eos_id is not None else None
        if eos_id is not None:
            frozen = torch.full((v,), float("-inf"), device=prompt.device)
            frozen[eos_id] = 0.0
        base = torch.arange(b, device=prompt.device)[:, None] * k
        for i in range(1, n_new):
            logits, cache = model(tok.reshape(b * k, 1), cache=cache,
                                  cache_index=index + i - 1)
            logp = torch.log_softmax(logits[:, -1].to(torch.float32).reshape(b, k, v), -1)
            if eos_id is not None:
                logp = torch.where(finished[:, :, None], frozen, logp)
            scores, flat = _top_k((scores[:, :, None] + logp).reshape(b, k * v), k)
            parent = flat // v
            tok = (flat % v).to(torch.int32)
            hist = torch.gather(hist, 1, parent[:, :, None].expand(b, k, n_new))
            hist[:, :, i] = tok
            rows = (base + parent).reshape(-1)
            for leaf in _leaves(cache):
                leaf.copy_(leaf.index_select(0, rows))
            if eos_id is not None:
                finished = torch.gather(finished, 1, parent) | (tok == eos_id)
        ranked = scores
        if length_penalty > 0.0 and eos_id is not None:
            is_eos = (hist == eos_id).to(torch.int32)
            lens = torch.where(is_eos.any(-1), torch.argmax(is_eos, -1) + 1, n_new)
            ranked = scores / ((5.0 + lens.to(torch.float32)) / 6.0) ** length_penalty
        best = torch.argmax(ranked, dim=1)
        rows = torch.arange(b, device=prompt.device)
        return hist[rows, best], scores[rows, best]

    return search


def _spec_round(target, draft, tcache, dcache, last: torch.Tensor, pos, k: int,
                sample=None):
    """One speculative round over B rows at ``pos`` (an int, or a (B,)
    tensor of per-slot positions): k + 1 draft steps (the last only writes
    its cache row for the k-th proposal), then one target forward over the
    k + 1 rows ``[last, d_1 .. d_k]``.  Rejected rows stay in both caches
    beyond the accepted prefix; the next round overwrites them before any
    query reads them.

    Greedy (``sample`` None): proposal ``d_i`` is the draft's argmax, the
    target's argmax ``g`` is emitted, and ``m`` counts the leading ``d_i ==
    g_i``.  Sampled (``sample = (temperature, top_k, generator)``): ``d_i ~
    q``, accepted while ``u_i·q(d_i) < p(d_i)``; at the first rejection the
    token is drawn from ``max(p − q, 0)`` (from p where that is all zero),
    after k acceptances the bonus from p at row k + 1.

    Returns ``(emit (B, k + 1) int32, m (B,))``: the round emits
    ``emit[:, :m + 1]``."""
    tok, props, qlogits = last, [], []
    for j in range(k + 1):
        logits, dcache = draft(tok[:, None], cache=dcache, cache_index=pos + j)
        if j == k:
            break
        if sample is None:
            tok = _greedy(logits[:, -1])
        else:
            fl = _filter_logits(logits[:, -1], sample[0], sample[1])
            tok = _sample(torch.softmax(fl, -1), sample[2])
            qlogits.append(fl)
        props.append(tok)
    d = torch.stack(props, 1)
    logits, tcache = target(torch.cat([last[:, None], d], 1), cache=tcache,
                            cache_index=pos)
    if sample is None:
        g = _greedy(logits)
        return g, torch.cumprod((d == g[:, :k]).to(torch.int32), 1).sum(1)
    temperature, top_k, gen = sample
    b = d.shape[0]
    rows = torch.arange(b, device=d.device)
    p = torch.softmax(_filter_logits(logits, temperature, top_k), -1)
    q = torch.softmax(torch.stack(qlogits, 1), -1)
    idx = d.to(torch.int64)[..., None]
    p_d = torch.gather(p[:, :k], 2, idx)[..., 0]
    q_d = torch.gather(q, 2, idx)[..., 0]
    u = torch.rand((b, k), generator=gen, device=d.device)
    m = torch.cumprod((u * q_d < p_d).to(torch.int32), 1).sum(1)
    p_m = p[rows, m]
    q_m = torch.cat([q, torch.zeros_like(q[:, :1])], 1)[rows, m]
    resid = torch.clamp(p_m - q_m, min=0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 0.0, resid, p_m)
    z = torch.where(m == k, _sample(p[:, k], gen), _sample(resid, gen))
    emit = torch.cat([d, torch.zeros_like(d[:, :1])], 1)
    emit[rows, m] = z
    return emit, m


def make_speculative_generate(target, draft, prompt_len: int, n_new: int, *,
                              k: int = 4, cache_dtype=torch.float32,
                              temperature: float = 0.0,
                              top_k: Optional[int] = None,
                              return_stats: bool = False):
    """Speculative decoding at B = 1: the ``draft`` proposes ``k`` tokens a
    round and the ``target`` verifies them in one forward over k + 1 rows
    (:func:`_spec_round`); the accepted prefix and one target token are
    emitted.  Rollback is not advancing the position; the emit buffer is
    padded by k + 1 so each round writes its whole row.

    ``temperature <= 0``: greedy, the target's own greedy decode by
    construction.  ``temperature > 0``: accept/reject speculative sampling,
    distributed as the target's ``temperature``/``top_k`` sampling
    (:func:`make_sampler`'s transform) whatever the draft; ``generate``
    then takes a ``torch.Generator``.

    Needs ``prompt_len + n_new + k <= min(target.max_len, draft.max_len)``
    and a shared vocab.  Returns ``generate(prompt (1, prompt_len)[,
    generator]) -> (1, n_new) int32``, with ``return_stats`` also ``{"rounds",
    "accepted_per_round", "host_reads"}`` (one read a round, of the
    accepted count).
    """
    if k < 1:
        raise ValueError("k must be >= 1 (k draft tokens per verify round)")
    if target.vocab != draft.vocab:
        raise ValueError("target and draft must share a vocab")
    if prompt_len + n_new + k > min(target.max_len, draft.max_len):
        raise ValueError(
            f"prompt_len + n_new + k = {prompt_len + n_new + k} exceeds "
            f"max_len = {min(target.max_len, draft.max_len)} "
            "(speculative verification needs k tokens of cache headroom)")
    sampled = temperature > 0.0

    @torch.no_grad()
    def generate(prompt: torch.Tensor, generator=None):
        if tuple(prompt.shape) != (1, prompt_len):
            raise ValueError(f"speculative decode is B=1: prompt shape "
                             f"{tuple(prompt.shape)} != (1, {prompt_len})")
        if sampled and generator is None:
            raise ValueError("temperature > 0 needs a torch.Generator")
        prompt = prompt.to(target.device)
        sample = (temperature, top_k, generator) if sampled else None
        tlog, tcache, pos = prefill(target, prompt, cache_dtype=cache_dtype)
        _, dcache, _ = prefill(draft, prompt, cache_dtype=cache_dtype)
        last = (_sample(torch.softmax(_filter_logits(tlog, temperature, top_k), -1),
                        generator) if sampled else _greedy(tlog))
        out = torch.zeros((n_new + k + 1,), dtype=torch.int32, device=prompt.device)
        out[0] = last[0]
        count, rounds = 1, 0
        while count < n_new:
            emit, m = _spec_round(target, draft, tcache, dcache, last, pos, k, sample)
            out[count:count + k + 1] = emit[0]
            m = int(m[0])  # the round's one host read
            last = emit[:, m]
            count += m + 1
            pos += m + 1
            rounds += 1
        toks = out[:n_new][None]
        if return_stats:
            return toks, {"rounds": rounds, "host_reads": rounds,
                          "accepted_per_round": (count - 1) / max(rounds, 1)}
        return toks

    return generate


class _GenRequest:
    __slots__ = ("prompt", "n_new", "future", "tokens", "slot", "prefix",
                 "pages")

    def __init__(self, prompt: np.ndarray, n_new: int, prefix=None):
        self.prompt = prompt
        self.n_new = n_new
        self.future: Future = Future()
        self.tokens: list = []
        self.slot = -1
        self.prefix = prefix
        self.pages = None  # pool pages the request holds (paged engine)


def _warn_moe_capacity(model) -> None:
    """An MoE model routes the tokens of every co-batched slot together, so
    a capacity that can bind couples the requests (one's tokens depend on
    which others share its decode steps).  Warn when it can bind."""
    e = getattr(model, "moe_experts", 0) or 0
    if not e:
        return
    k = getattr(model, "moe_top_k", 1) or 1
    cf = getattr(model, "moe_capacity_factor", 0.0) or 0.0
    if cf < e / k:
        warnings.warn(
            f"QuantMoE capacity can bind under batched decode "
            f"(capacity_factor={cf} < num_experts/top_k={e}/{k}): capacity "
            "drops couple co-batched requests, making generations depend on "
            "batch composition. Serve with capacity_factor >= "
            "num_experts/top_k for per-token-exact routing.",
            stacklevel=3)


class Prefix:
    """A prefilled, immutable KV prefix (a shared system prompt), built by
    ``DecodeEngine.register_prefix``: the prefix tokens chunk-prefilled into
    a private B=1 cache at positions [0, length).  ``submit(suffix,
    prefix=handle)`` seeds each admission from a copy of it and prefills only
    the suffix.  ``caches`` holds one slot cache a model the engine drives;
    ``owner`` is the engine that built it (two engines may hold different
    weights behind the same cache layout, so a handle never crosses).  A
    speculative engine's handle holds the target's and the draft's."""

    __slots__ = ("tokens", "length", "caches", "owner")

    def __init__(self, tokens: np.ndarray, length: int, caches: tuple, owner=None):
        self.tokens = tokens
        self.length = length
        self.caches = caches
        self.owner = owner


class _PendingAdmit:
    """One in-flight chunked admission: the reserved slot, its private B=1
    cache (for the paged engine, the pools seen through the slot's one-row
    table), the chunk cursor and ``base``, the first suffix position (0, or
    the length of the request's Prefix)."""

    __slots__ = ("req", "slot", "slot_cache", "chunk_idx", "n_chunks", "padded",
                 "c", "steps_at_start", "base")

    def __init__(self, *, req, slot, slot_cache, n_chunks, padded, c,
                 steps_at_start, base=0):
        self.req = req
        self.slot = slot
        self.slot_cache = slot_cache
        self.chunk_idx = 0
        self.n_chunks = n_chunks
        self.padded = padded
        self.c = c
        self.steps_at_start = steps_at_start
        self.base = base


def _map_cache(fn, *caches):
    """Apply ``fn`` leaf-wise over matching cache pytrees (tuples of tensors)."""
    head = caches[0]
    if torch.is_tensor(head):
        return fn(*caches)
    return tuple(_map_cache(fn, *parts) for parts in zip(*caches))


def _leaves(cache):
    if torch.is_tensor(cache):
        return [cache]
    return [leaf for part in cache for leaf in _leaves(part)]


class DecodeEngine:
    """Token-level continuous batching: requests join the running batch at
    the next token boundary.

    One global cache (max_batch, KVH, max_len, hd) per layer; each slot holds
    one request at its own depth (the model's per-slot ``cache_index`` path).
    A new prompt is prefilled in ``prefill_chunk``-token chunks into a private
    B=1 cache, one chunk per dispatcher iteration, interleaved with the decode
    step; the final chunk emits the first token and copies the slot cache into
    the global cache.  Padded chunk rows past the prompt write k/v that no
    decode step reads before overwriting them.  Free slots decode parked at
    ``max_len - 1`` and their tokens are dropped.

    Prefix caching: ``register_prefix(tokens)`` prefills a shared prefix
    once; ``submit(suffix, n_new, prefix=handle)`` starts the admission from
    a copy of its cache and prefills only the suffix, at positions offset by
    the prefix length (the same tokens as the concatenated prompt).

    Args mirror the JAX package: ``max_batch``, ``prompt_buckets``
    (admission cap), ``cache_dtype``, ``prefill_chunk`` (None = whole-bucket
    chunks), ``max_wait_ms``, ``eos_id``, ``logits_to_token`` and ``rng`` (a
    ``torch.Generator``; set it to call ``logits_to_token(logits, rng)``).

    The engine state is laid out for the models it drives
    (:meth:`_served_models`): ``_cache`` is one cache here, the (target,
    draft) pair in :class:`SpeculativeDecodeEngine`, and a slot cache or a
    Prefix follows it; the subclasses change the hooks, not the dispatcher.
    """

    _EXTRA_STATS: tuple = ()  # counters a subclass adds to ``stats``
    _STEP = "steps"            # the stat that counts dispatcher steps

    def __init__(self, model, *, max_batch: int = 8,
                 prompt_buckets: Sequence[int] = (32, 128),
                 cache_dtype=torch.float32, prefill_chunk: Optional[int] = 32,
                 max_wait_ms: float = 2.0, eos_id: Optional[int] = None,
                 logits_to_token: Optional[Callable] = None,
                 rng: Optional[torch.Generator] = None):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 or None")
        self.model = model
        for m in self._served_models():
            _warn_moe_capacity(m)
        self.device = model.device
        self.max_batch = max_batch
        self.buckets = sorted(prompt_buckets)
        self.max_len = min(m.max_len for m in self._served_models())
        self._park = self._park_position()
        self.eos_id = eos_id
        self._rng = rng
        self._sampled = rng is not None
        self._pick = logits_to_token or _greedy
        self.prefill_chunk = prefill_chunk
        self._build_device_state(cache_dtype)

        self._queue: "queue.Queue[_GenRequest]" = queue.Queue()
        self._slots: list = [None] * max_batch
        self._pending: list = []
        self._lifecycle_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._stop = False
        self.max_wait_s = max_wait_ms / 1e3
        self.stats = {"requests": 0, self._STEP: 0, "slot_tokens": 0,
                      "active_token_sum": 0, "admission_chunks": 0,
                      "admission_interleave": deque(maxlen=1024),
                      **{k: 0 for k in self._EXTRA_STATS}}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ hooks

    def _served_models(self) -> tuple:
        """The models whose caches the engine keeps, the first emitting."""
        return (self.model,)

    def _park_position(self) -> int:
        """Where a free slot decodes (its writes reach no live row)."""
        return self.max_len - 1

    def _headroom(self) -> int:
        """Cache rows a request may write past its last token."""
        return 0

    def _model_caches(self, cache) -> tuple:
        """One cache a served model, of an engine-layout cache."""
        return (cache,)

    def _engine_cache(self, caches):
        """The engine layout of one cache a served model."""
        return caches[0]

    def _build_device_state(self, cache_dtype):
        """The KV cache, host slot positions and device tokens
        (``PagedDecodeEngine`` builds page pools instead)."""
        self._cache = self._engine_cache(
            [init_kv_cache(m, self.max_batch, dtype=cache_dtype)
             for m in self._served_models()])
        self._pos = np.full((self.max_batch,), self._park, np.int64)
        self._tok = torch.zeros((self.max_batch,), dtype=torch.int32,
                                device=self.device)

    # --------------------------------------------------------------- programs

    def _pick_tok(self, logits):
        return self._pick(logits, self._rng) if self._sampled else self._pick(logits)

    def _forward(self, cache, tokens, start):
        """The served models over ``tokens`` at ``start``: the first
        model's logits and the updated cache."""
        return self.model(tokens, cache=cache, cache_index=start)

    def _run_chunk(self, slot_cache, tokens, start: int):
        return self._forward(slot_cache, tokens, start)[1]

    def _run_final_chunk(self, slot_cache, tokens, start: int, true_len: int,
                         slot: int):
        logits, slot_cache = self._forward(slot_cache, tokens, start)
        first = self._pick_tok(logits[0, true_len - 1 - start][None])[0]
        self._install(slot_cache, slot)
        return first

    def _install(self, slot_cache, slot: int) -> None:
        """Copy an admitted slot cache into the engine's cache."""
        def copy(g, s):
            g[slot:slot + 1].copy_(s)
            return g

        _map_cache(copy, self._cache, slot_cache)

    def _run_step(self):
        """One step of every slot: ``(tokens (max_batch, n), counts
        (max_batch,))`` on the host, slot i emitting ``tokens[i, :counts[i]]``
        (one host read)."""
        pos = torch.as_tensor(self._pos, dtype=torch.int32).to(self.device)
        logits, _ = self._forward(self._cache, self._tok[:, None], pos)
        self._tok = self._pick_tok(logits[:, -1])
        self._pos = np.minimum(self._pos + 1, self._park)
        return self._tok.cpu().numpy()[:, None], np.ones(self.max_batch, np.int64)

    def _slot_cache(self):
        return _map_cache(lambda g: torch.zeros((1,) + tuple(g.shape[1:]),
                                                dtype=g.dtype, device=g.device),
                          self._cache)

    def _chunk_len(self, bucket: int) -> int:
        return bucket if self.prefill_chunk is None else min(self.prefill_chunk, bucket)

    def _padded_admit_len(self, size: int) -> int:
        """Rows a chunked admission of ``size`` tokens writes: whole chunks."""
        b = next(b for b in self.buckets if b >= size)
        c = self._chunk_len(b)
        return -(-size // c) * c

    def _stage_prompt(self, req: _GenRequest):
        """(chunk length, chunk count, the prompt zero-padded to whole
        chunks) of an admission."""
        b = next(b for b in self.buckets if b >= req.prompt.size)
        c = self._chunk_len(b)
        n_chunks = -(-req.prompt.size // c)
        padded = np.zeros((1, n_chunks * c), np.int32)
        padded[0, : req.prompt.size] = req.prompt
        return c, n_chunks, padded

    def _stage_prefix_tokens(self, tokens) -> tuple:
        """Validate a prefix and pad it to whole chunks of the largest
        bucket's chunk length, or to one chunk of exactly its length where
        that padding would write past ``max_len``."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or tokens.size == 0:
            raise ValueError("prefix must be a non-empty 1-D token array")
        if tokens.size >= self.max_len:
            raise ValueError(f"prefix length {tokens.size} must be < max_len "
                             f"{self.max_len} (no room left to decode)")
        with self._lifecycle_lock:
            if self._stop:
                raise RuntimeError(f"{type(self).__name__} is closed")
        c = self._chunk_len(self.buckets[-1])
        n_chunks = -(-tokens.size // c)
        if n_chunks * c > self.max_len:
            c, n_chunks = int(tokens.size), 1
        padded = np.zeros((1, n_chunks * c), np.int32)
        padded[0, : tokens.size] = tokens
        return tokens, padded, c, n_chunks

    # -------------------------------------------------------------------- API

    @torch.no_grad()
    def warmup(self):
        """Run the decode step and each chunk length once (first calls build
        the kernels).  Must run before requests are in flight: it resets the
        cache and positions."""
        with self._state_lock:
            if any(s is not None for s in self._slots) or self._pending:
                raise RuntimeError("warmup() must run before requests are in "
                                   "flight (it resets the KV cache)")
            self._run_step()
            # chunks longer than the cache can never be admitted
            for c in sorted(c for c in {self._chunk_len(b) for b in self.buckets}
                            if c <= self.max_len):
                toks = torch.zeros((1, c), dtype=torch.int32, device=self.device)
                sc = self._run_chunk(self._slot_cache(), toks, 0)
                self._run_final_chunk(sc, toks, 0, 1, 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            _map_cache(lambda g: g.zero_(), self._cache)
            self._pos[:] = self._park
            self._tok.zero_()

    @torch.no_grad()
    def register_prefix(self, tokens) -> Prefix:
        """Prefill a shared prompt prefix once into a private B=1 cache and
        return a reusable handle, bound to this engine.  The prefix may be
        longer than the largest bucket; only ``prefix + suffix + n_new <=
        max_len`` binds.  Each chunk runs under the engine's state lock, so
        registering mid-serving interleaves with decode steps."""
        tokens, padded, c, n_chunks = self._stage_prefix_tokens(tokens)
        sc = self._slot_cache()
        for i in range(n_chunks):
            toks = torch.as_tensor(padded[:, i * c:(i + 1) * c]).to(self.device)
            with self._state_lock:
                sc = self._run_chunk(sc, toks, i * c)
        # rows in [size, n_chunks * c) hold pad garbage that the suffix
        # admission overwrites before any decode step reads them
        return Prefix(tokens, int(tokens.size), self._model_caches(sc), owner=self)

    def _check_prefix(self, prefix):
        n_models = len(self._served_models())
        if not isinstance(prefix, Prefix) or len(prefix.caches) != n_models:
            raise ValueError("prefix must come from this engine kind's "
                             "register_prefix()")
        if prefix.owner is not self:
            raise ValueError("prefix was registered on a different engine; call "
                             "register_prefix() on this one")
        for mine, theirs in zip(self._model_caches(self._cache), prefix.caches):
            want = [tuple(g.shape[1:]) + (g.dtype,) for g in _leaves(mine)]
            got = [tuple(g.shape[1:]) + (g.dtype,) for g in _leaves(theirs)]
            if want != got:
                raise ValueError("prefix cache layout does not match this "
                                 "engine's (different model/max_len/cache_dtype?)")

    def submit(self, prompt, n_new: int, *, prefix: Optional[Prefix] = None
               ) -> Future:
        """Queue one request; the Future resolves to an (n_new,) int32 array
        (shorter when it emits ``eos_id``).  With ``prefix`` (from
        :meth:`register_prefix`), ``prompt`` is the suffix that continues it."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        if prompt.size > self.buckets[-1]:
            raise ValueError(f"prompt length {prompt.size} exceeds the largest "
                             f"bucket {self.buckets[-1]}")
        base = 0
        if prefix is not None:
            self._check_prefix(prefix)
            base = prefix.length
        extra = self._headroom()
        if base + prompt.size + n_new + extra > self.max_len:
            raise ValueError(
                "prefix + prompt + n_new " + (f"+ k + 1 = {extra} rows (speculative "
                                              "verification headroom) " if extra else "")
                + f"exceeds max_len {self.max_len}")
        if base + self._padded_admit_len(prompt.size) > self.max_len:
            raise ValueError(
                "the chunk-padded admission would write past max_len (prefix "
                f"{base} + padded prompt {self._padded_admit_len(prompt.size)} > "
                f"{self.max_len}); lower prefill_chunk or the bucket, or shorten "
                "the prefix")
        req = _GenRequest(prompt, n_new, prefix=prefix)
        with self._lifecycle_lock:
            if self._stop:
                raise RuntimeError(f"{type(self).__name__} is closed")
            self._queue.put(req)
        return req.future

    def close(self):
        with self._lifecycle_lock:
            self._stop = True
        self._thread.join(timeout=300)
        if not self._thread.is_alive():
            self._fail_pending(RuntimeError(f"{type(self).__name__} closed"))
        else:  # dispatcher stuck: cancel so callers do not block
            self._cancel_pending()

    def _cancel_pending(self):
        for req in (list(self._slots) + [p.req for p in self._pending]
                    + self._drain_queue()):
            if req is not None and not req.future.done():
                req.future.cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- dispatcher

    def _drain_queue(self):
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                return out

    def _fail_pending(self, exc):
        for req in self._slots:
            if req is not None and not req.future.done():
                req.future.set_exception(exc)
        self._slots = [None] * self.max_batch
        for p in self._pending:
            if not p.req.future.done():
                p.req.future.set_exception(exc)
        self._pending = []
        for req in self._drain_queue():
            if not req.future.done():
                req.future.set_exception(exc)

    def _finished(self, req: _GenRequest) -> bool:
        return (len(req.tokens) >= req.n_new
                or (self.eos_id is not None and len(req.tokens) > 0
                    and req.tokens[-1] == self.eos_id))

    def _start_admit(self, req: _GenRequest, slot: int):
        """Reserve the slot and stage the prompt; with a Prefix the slot
        cache starts as a copy of the prefix's and chunks run at offset
        positions."""
        c, n_chunks, padded = self._stage_prompt(req)
        if req.prefix is not None:
            base = req.prefix.length
            slot_cache = _map_cache(torch.clone, self._engine_cache(req.prefix.caches))
            self.stats["prefix_tokens_reused"] = (
                self.stats.get("prefix_tokens_reused", 0) + base)
        else:
            base, slot_cache = 0, self._slot_cache()
        req.slot = slot
        self._pending.append(_PendingAdmit(
            req=req, slot=slot, slot_cache=slot_cache, n_chunks=n_chunks,
            padded=padded, c=c, steps_at_start=self.stats[self._STEP], base=base))

    def _advance_admission(self, p: _PendingAdmit):
        """Run ONE chunk of the admission at the head of the queue."""
        i = p.chunk_idx
        toks = torch.as_tensor(p.padded[:, i * p.c:(i + 1) * p.c]).to(self.device)
        start = p.base + i * p.c
        if i < p.n_chunks - 1:
            p.slot_cache = self._run_chunk(p.slot_cache, toks, start)
            p.chunk_idx += 1
        else:
            first = self._run_final_chunk(p.slot_cache, toks, start,
                                          p.base + p.req.prompt.size, p.slot)
            self._tok[p.slot] = first
            self._pos[p.slot] = p.base + p.req.prompt.size
            p.req.tokens.append(int(first))
            self._slots[p.slot] = p.req
            self._pending.remove(p)
            self.stats["requests"] += 1
            self.stats["admission_interleave"].append(
                self.stats[self._STEP] - p.steps_at_start)
        self.stats["admission_chunks"] += 1

    def _retire_done(self):
        for slot, req in enumerate(self._slots):
            if req is not None and self._finished(req):
                if not req.future.done():
                    req.future.set_result(np.asarray(req.tokens[: req.n_new], np.int32))
                self._slots[slot] = None
                self._pos[slot] = self._park

    def _stage_admissions(self, reserved: set):
        for slot in range(self.max_batch):
            if self._slots[slot] is None and slot not in reserved:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._start_admit(req, slot)
                reserved.add(slot)

    def _loop(self):
        with torch.no_grad():
            while True:
                if self._stop:
                    self._fail_pending(RuntimeError(f"{type(self).__name__} closed"))
                    return
                with self._state_lock:
                    idle = self._iterate()
                if idle is None:
                    return
                if idle:
                    time.sleep(self.max_wait_s)

    def _iterate(self):
        """One dispatcher iteration; True when idle, None after a failure."""
        reserved = {p.slot for p in self._pending}
        self._stage_admissions(reserved)
        if self._pending:
            p = self._pending[0]
            try:
                self._advance_admission(p)
            except Exception as e:
                self._pending.remove(p)
                if not p.req.future.done():
                    p.req.future.set_exception(e)
        self._retire_done()
        active = [s for s in self._slots if s is not None]
        if not active:
            return not self._pending
        try:
            toks, counts = self._run_step()
        except Exception as e:  # device failure: fail fast
            with self._lifecycle_lock:
                self._stop = True
            self._fail_pending(e)
            return None
        emitted = 0
        for slot, req in enumerate(self._slots):
            for j in range(int(counts[slot]) if req is not None else 0):
                if self._finished(req):  # n_new reached or eos: drop the rest
                    break
                req.tokens.append(int(toks[slot, j]))
                emitted += 1
        if "accepted_tokens" in self.stats:
            self.stats["accepted_tokens"] += emitted
        self.stats[self._STEP] += 1
        self.stats["slot_tokens"] += self.max_batch
        self.stats["active_token_sum"] += len(active)
        self._retire_done()
        return False


class SpeculativeDecodeEngine(DecodeEngine):
    """Token-level continuous batching with speculative decoding: every
    dispatcher iteration advances all active slots by one draft-propose /
    target-verify round (:func:`_spec_round` over the slots, 1..k+1 tokens
    each) instead of one token.  Greedy (default): each request is exactly
    the target's greedy decode.  ``temperature > 0`` (with ``rng``, a
    ``torch.Generator``): accept/reject speculative sampling a slot, each
    request distributed as the target's ``temperature``/``top_k`` sampling.

    :class:`DecodeEngine`'s dispatcher, queue, chunked admission and prefix
    reuse run over both models: the engine cache is the (target, draft)
    pair, an admission chunk runs through both private slot caches, and a
    Prefix holds both.  Free slots park at ``max_len - k - 2`` and an active
    slot's position advances by ``min(pos + accepted, park)``, so a round's
    k + 1 rows never leave the cache (the model does not check a per-slot
    index).  ``submit`` keeps k + 1 rows of headroom.  With ``eos_id`` a
    request retires in the round it emits eos; later accepted tokens are
    dropped.  Slots join and retire at round boundaries; ``stats['rounds']``
    counts rounds and ``stats['accepted_tokens']`` the tokens they emitted.
    """

    _STEP = "rounds"
    _EXTRA_STATS = ("accepted_tokens",)

    def __init__(self, target, draft, *, max_batch: int = 4,
                 prompt_buckets: Sequence[int] = (32, 128), k: int = 4,
                 cache_dtype=torch.float32, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 rng: Optional[torch.Generator] = None,
                 prefill_chunk: Optional[int] = 32, eos_id: Optional[int] = None,
                 max_wait_ms: float = 2.0):
        if k < 1:
            raise ValueError("k must be >= 1")
        if temperature > 0.0 and rng is None:
            raise ValueError("temperature > 0 needs an rng (a torch.Generator)")
        if target.vocab != draft.vocab:
            raise ValueError("target and draft must share a vocab")
        if target.device != draft.device:
            raise ValueError("target and draft must be on one device")
        if k + 2 >= min(target.max_len, draft.max_len):
            raise ValueError(
                f"k = {k} too large for max_len = "
                f"{min(target.max_len, draft.max_len)}: need k + 2 < max_len "
                "(k+1 verify rows plus a parked row must fit)")
        self.target, self.draft, self.k = target, draft, k
        sampled = temperature > 0.0
        self._sample = (temperature, top_k, rng) if sampled else None
        super().__init__(target, max_batch=max_batch, prompt_buckets=prompt_buckets,
                         cache_dtype=cache_dtype, prefill_chunk=prefill_chunk,
                         max_wait_ms=max_wait_ms, eos_id=eos_id,
                         logits_to_token=make_sampler(temperature, top_k),
                         rng=rng if sampled else None)

    def _served_models(self) -> tuple:
        return (self.target, self.draft)

    def _park_position(self) -> int:
        return self.max_len - self.k - 2  # a round writes k + 1 rows from pos

    def _headroom(self) -> int:
        return self.k + 1

    def _model_caches(self, cache) -> tuple:
        return tuple(cache)

    def _engine_cache(self, caches):
        return tuple(caches)

    def _forward(self, cache, tokens, start):
        tcache, dcache = cache
        logits, tcache = self.target(tokens, cache=tcache, cache_index=start)
        _, dcache = self.draft(tokens, cache=dcache, cache_index=start)
        return logits, (tcache, dcache)

    def _run_step(self):
        """One speculative round of every slot, with one host read (the
        emitted rows and accepted counts)."""
        pos = torch.as_tensor(self._pos, dtype=torch.int32).to(self.device)
        emit, m = _spec_round(self.target, self.draft, *self._cache, self._tok,
                              pos, self.k, self._sample)
        self._tok = emit[torch.arange(self.max_batch, device=self.device), m]
        host = torch.cat([emit, m[:, None].to(emit.dtype)], 1).cpu().numpy()
        counts = host[:, -1].astype(np.int64) + 1
        self._pos = np.minimum(self._pos + counts, self._park)
        return host[:, :-1], counts
