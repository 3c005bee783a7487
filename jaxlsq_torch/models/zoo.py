"""Model zoo (port of ``jaxlsq/models/zoo.py``).

Conv nets: :class:`QuantMLP`, :class:`QuantCNN`, :class:`BasicBlock`,
:class:`QuantResNet`, :func:`resnet18_cifar`, :class:`InvertedResidual`,
:class:`QuantMobileNetV2` and :func:`mobilenetv2_cifar`, built from
``QuantDense``/``QuantConv`` and the flax-rule ``BatchNorm``, with the JAX
package's submodule names (its variables' paths); NCHW inputs.  In QAT mode
:func:`init_qat_variables` draws their seeded initial variables; in serve
mode (``qconfig.for_serving(...)``) their packed kernels, activation qparams,
biases and BatchNorm variables are loaded by ``jaxlsq_torch.interop``.

The quantized transformer LM (``QuantTransformerBlock``,
``QuantTransformerLM``, ``_rope`` and the dense-cache ``_cached_attention``)
in either mode of its qconfig:

* QAT mode (``qconfig.mode != 'serve'``): trainable kernels, biases,
  LayerNorm affine and ``pos_emb`` (``nn.Parameter``), LSQ quantizers in
  every dense layer and the embedding, drawn from ``seed`` by
  :func:`init_qat_variables`.  With a cache it runs as the JAX package's
  ``apply(training=False)`` with ``quant_state`` and ``qparams`` not
  mutable: the quantizers take the eval flag whatever ``model.training``
  says, an enabled observer re-derives qparams from the call's input for
  that call only, and nothing of the quantizers' state is kept
  (``layers.quant_state_frozen``).  ``train_attn_impl`` picks the no-cache
  attention: ``'xla'`` the plain einsum over the (t, t) scores,
  ``'flash'`` the flash-attention kernels (``ops.flash_attention``), or the
  banded formulation when a sliding window shorter than t is set.
* Serve mode: serve-mode buffers (packed kernels from
  ``jaxlsq_torch.serve.convert``, loaded by ``jaxlsq_torch.interop``).
  Without a cache: the full causal forward, attention as in QAT mode.

In either mode, with a cache, the new k/v are written into the cache IN
PLACE at ``cache_index`` (the JAX package returns a new cache; here the
returned cache is the same objects, updated) and attention runs through
``serve.attention.decode_attention`` — the CUDA kernel on the card — or, for
a paged cache (``serve.paged.PagedKVLayer`` entries), the writes go through
the block table and attention through ``serve.paged.paged_attention``.

Carriers: f32/bf16 caches (new k/v cast to the cache dtype on write, read back
as f32), and int8/int4 ``(data, scales)`` caches quantized per (b, head,
position) on write.  A scalar ``cache_index`` (int) is checked against the
cache length here (for a paged cache, pages_per_slot * page_size); a
per-slot (B,) index tensor is the caller's to keep in range (the engine
does), since checking it would stall on the card.

``moe_experts`` swaps each block's dense MLP for a :class:`QuantMoE` named
``moe`` (``moe_top_k`` routed experts of ``mlp_ratio * dim`` hidden units,
``moe_capacity_factor``), as the JAX package's MoE LM.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import _dist
from .._device import resolve_device
from ..ops.flash_attention import flash_attention
from ..serve.attention import MASK, _q4, _q8, decode_attention
from ..serve.paged import PagedKVLayer, paged_attention, paged_update
from .layers import (FakeQuantize, QuantConv, QuantDense, QuantEmbed, quant_state_frozen,
                     refresh_host_state)
from .moe import QuantMoE, _ExpertDense
from .norm import BatchNorm
from .qconfig import QConfig

__all__ = ["QuantMLP", "QuantCNN", "BasicBlock", "QuantResNet", "resnet18_cifar",
           "InvertedResidual", "QuantMobileNetV2", "mobilenetv2_cifar",
           "init_qat_variables", "QuantTransformerBlock", "QuantTransformerLM",
           "init_variables"]

_LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def _rope(x: torch.Tensor, pos: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the head dim, half-split layout.  x: (B, H, t, hd);
    pos: (t,) shared or (B, t) per-slot positions."""
    hd = x.shape[-1]
    half = hd // 2
    inv = 1.0 / (base ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = pos.to(torch.float32)[..., None] * inv
    if ang.dim() == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, None]
    sin = torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)


def _seq_part():
    """The part of the current split of the rows (``_dist.current()``) over
    the sequence (dim 1), or None."""
    split = _dist.current()
    if split is None:
        return None
    return next((p for p in split.parts if p.dim == 1), None)


def _is_scalar_index(cache_index) -> bool:
    return isinstance(cache_index, int) or (
        torch.is_tensor(cache_index) and cache_index.dim() == 0)


def _write(c: torch.Tensor, new: torch.Tensor, cache_index, t: int) -> None:
    """Write ``new`` (B, H, t, ...) into cache ``c`` (B, H, L, ...) at
    positions [idx, idx + t) — scalar idx, or per-slot (B,) idx."""
    new = new.to(c.dtype)
    if _is_scalar_index(cache_index):
        i = int(cache_index)
        c[:, :, i:i + t] = new
        return
    b = c.shape[0]
    pos = cache_index.to(torch.int64)[:, None] + torch.arange(t, device=c.device)
    bidx = torch.arange(b, device=c.device)[:, None]
    c[bidx, :, pos] = new.transpose(1, 2)


def _cached_attention(q, k, v, kv_cache, cache_index, attn_window=None):
    """Write fresh k/v (B, KVH, t, hd) into a cache entry (a dense ``(k, v)``
    pair, or a :class:`PagedKVLayer` written through its block table) and
    attend q (B, H, t, hd) to it; returns ``(y, cache_entry)``."""
    paged = isinstance(kv_cache, PagedKVLayer)
    if not paged and not (isinstance(kv_cache, (tuple, list)) and len(kv_cache) == 2):
        raise TypeError("a cache entry is a dense (k, v) pair or a PagedKVLayer, "
                        f"got {type(kv_cache).__name__}")
    t = q.shape[2]
    if paged:
        length = kv_cache.length
    else:
        ck, cv = kv_cache
        quantized = isinstance(ck, (tuple, list))
        length = (ck[0] if quantized else ck).shape[2]
    if _is_scalar_index(cache_index):
        i = int(cache_index)
        if i < 0 or i + t > length:
            raise ValueError(f"cache_index {i} + {t} new positions exceeds the "
                             f"cache length {length}")
    if paged:
        layer = paged_update(kv_cache, k, v, cache_index)
        return paged_attention(q, layer, cache_index, window=attn_window), layer
    if quantized:
        quant = _q4 if ck[0].dtype == torch.uint8 else _q8
        kq, ks = quant(k)
        vq, vs = quant(v)
        _write(ck[0], kq, cache_index, t)
        _write(ck[1], ks, cache_index, t)
        _write(cv[0], vq, cache_index, t)
        _write(cv[1], vs, cache_index, t)
    else:
        _write(ck, k, cache_index, t)
        _write(cv, v, cache_index, t)
    y = decode_attention(q, ck, cv, cache_index, window=attn_window)
    return y, (ck, cv)


def _layer_norm(dim: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=_LN_EPS, device=device)


def _repeat_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, KVH, t, hd) -> (B, KVH * g, t, hd), each kv head repeated for its
    group of g query heads (``jnp.repeat(x, g, axis=1)``).  An expand, so
    the backward sums the group's gradients with a reduction, not atomics."""
    b, kvh, t, hd = x.shape
    return x[:, :, None].expand(b, kvh, g, t, hd).reshape(b, kvh * g, t, hd)


def _flash_train_attention(q, k, v):
    """Causal attention through the flash kernels (``ops.flash_attention``):
    no (t, t) scores are held, forward or backward.  GQA repeats the kv heads
    to the query heads first, as the JAX package does; any t."""
    h, hd = q.shape[1], q.shape[3]
    if k.shape[1] != h:
        k, v = (_repeat_kv(x, h // k.shape[1]) for x in (k, v))
    return flash_attention(q, k, v, 1.0 / math.sqrt(hd))


def _banded_train_attention(q, k, v, window: int):
    """Sliding-window attention with O(t·W) scores (plain PyTorch, as the
    JAX package's chunked einsums): keys in blocks of W, each query block
    attends its own and the previous block, masked to ``0 <= qpos - kpos <
    W``; t padded up to a multiple of W (padded keys are reachable only from
    padded queries, whose rows are sliced away)."""
    b, h, t, hd = q.shape
    if k.shape[1] != h:
        k, v = (_repeat_kv(x, h // k.shape[1]) for x in (k, v))
    w = int(window)
    nb = -(-t // w)
    pt = nb * w
    if pt != t:
        q, k, v = (F.pad(a, (0, 0, 0, pt - t)) for a in (q, k, v))
    qb, kb, vb = (a.reshape(b, h, nb, w, hd) for a in (q, k, v))

    def with_prev(x):  # (B, H, nb, 2W, hd): [block i-1 | block i]
        return torch.cat([F.pad(x[:, :, :-1], (0, 0, 0, 0, 1, 0)), x], dim=3)

    k2, v2 = with_prev(kb), with_prev(vb)
    att = torch.einsum("bhnqd,bhnkd->bhnqk", qb, k2) / math.sqrt(hd)
    ar = torch.arange(2 * w, device=q.device)
    kpos = ar[None, :] - w                      # relative to the block's start
    diff = ar[:w, None] - kpos
    ok = ((diff >= 0) & (diff < w))[None] & (
        torch.arange(nb, device=q.device)[:, None, None] * w + kpos[None] >= 0)
    att = torch.softmax(torch.where(ok[None, None], att, MASK), dim=-1)
    y = torch.einsum("bhnqk,bhnkd->bhnqd", att, v2).reshape(b, h, pt, hd)
    return y[:, :, :t] if pt != t else y


class QuantTransformerBlock(nn.Module):
    """Pre-LN block: fused q|k|v projection, attention, output projection,
    GELU (tanh form, as flax ``nn.gelu``) MLP — every matmul quantized; with
    ``moe_experts`` the MLP is a routed :class:`QuantMoE` (``moe``)."""

    def __init__(self, dim: int, num_heads: int, qconfig: QConfig, *,
                 mlp_ratio: int = 4, num_kv_heads: Optional[int] = None,
                 rope: bool = False, attn_window: Optional[int] = None,
                 train_attn_impl: str = "xla", moe_experts: Optional[int] = None,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 path=(), device=None):
        super().__init__()
        if attn_window is not None and attn_window < 1:
            raise ValueError(f"attn_window must be >= 1 or None, got {attn_window}")
        if train_attn_impl not in ("xla", "flash"):
            raise ValueError(f"train_attn_impl must be 'xla' or 'flash', "
                             f"got {train_attn_impl!r}")
        self.train_attn_impl = train_attn_impl
        kvh = num_kv_heads or num_heads
        if num_heads % kvh:
            raise ValueError(f"num_heads {num_heads} not divisible by num_kv_heads {kvh}")
        self.dim, self.num_heads, self.kvh = dim, num_heads, kvh
        self.hd = dim // num_heads
        self.rope, self.attn_window = rope, attn_window
        path = tuple(path)
        self.ln1 = _layer_norm(dim, device)
        self.qkv = QuantDense(dim, dim + 2 * kvh * self.hd, qconfig,
                              path=path + ("qkv",), device=device)
        self.proj = QuantDense(dim, dim, qconfig, path=path + ("proj",), device=device)
        self.ln2 = _layer_norm(dim, device)
        self.hidden = mlp_ratio * dim
        if moe_experts:
            self.moe = QuantMoE(dim, self.hidden, moe_experts, qconfig, top_k=moe_top_k,
                                capacity_factor=moe_capacity_factor,
                                path=path + ("moe",), device=device)
            return
        self.moe = None
        self.mlp_up = QuantDense(dim, self.hidden, qconfig,
                                 path=path + ("mlp_up",), device=device)
        self.mlp_down = QuantDense(self.hidden, dim, qconfig,
                                   path=path + ("mlp_down",), device=device)

    def _attention(self, q, k, v, seq=None):
        """No-cache causal attention: ``'flash'`` takes the flash kernels, or
        the banded formulation under a window shorter than t (the JAX
        package's routing); ``'xla'`` the plain einsum over (t, t) scores.
        Under sequence parallelism (``seq``, the split's dim-1 part) q is
        this process's chunk of the sequence and k, v are gathered whole
        (with a backward); the 'xla' mask is then offset by the chunk's
        start."""
        b, h, t, hd = q.shape
        off = 0
        if seq is not None:
            if self.train_attn_impl == "flash":
                raise ValueError("sequence parallelism takes train_attn_impl='xla'")
            k = _dist.all_gather_grad(k, seq.group, seq.size, 2)
            v = _dist.all_gather_grad(v, seq.group, seq.size, 2)
            off = seq.rank * t
        elif self.train_attn_impl == "flash":
            if self.attn_window is not None and self.attn_window < t:
                return _banded_train_attention(q, k, v, self.attn_window)
            return _flash_train_attention(q, k, v)
        g = h // self.kvh
        span = (torch.arange(t, device=q.device)[:, None] + off
                - torch.arange(k.shape[2], device=q.device)[None, :])
        mask = span >= 0
        if self.attn_window is not None:
            mask = mask & (span < self.attn_window)
        q5 = q.reshape(b, self.kvh, g, t, hd)
        att = torch.einsum("bkgqd,bkld->bkgql", q5, k) / math.sqrt(hd)
        att = torch.softmax(torch.where(mask, att, MASK), dim=-1)
        return torch.einsum("bkgql,bkld->bkgqd", att, v).reshape(b, h, t, hd)

    def forward(self, x, kv_cache=None, cache_index=None):
        b, t, d = x.shape
        h, kvh, hd = self.num_heads, self.kvh, self.hd
        y = self.ln1(x)
        qkv = self.qkv(y)
        q = qkv[..., :d].reshape(b, t, h, hd).transpose(1, 2)
        k = qkv[..., d:d + kvh * hd].reshape(b, t, kvh, hd).transpose(1, 2)
        v = qkv[..., d + kvh * hd:].reshape(b, t, kvh, hd).transpose(1, 2)
        seq = _seq_part() if kv_cache is None else None
        if self.rope:
            ar = torch.arange(t, device=x.device)
            if kv_cache is None:
                rpos = ar if seq is None else ar + seq.rank * t
            elif _is_scalar_index(cache_index):
                rpos = ar + int(cache_index)
            else:
                rpos = cache_index.to(torch.int64)[:, None] + ar
            q = _rope(q, rpos)
            k = _rope(k, rpos)
        new_kv = None
        if kv_cache is None:
            y = self._attention(q, k, v, seq)
        else:
            y, new_kv = _cached_attention(q, k, v, kv_cache, cache_index,
                                          self.attn_window)
        y = y.transpose(1, 2).reshape(b, t, d)
        x = x + self.proj(y)
        y = self.ln2(x)
        if self.moe is not None:
            y = self.moe(y)
        else:
            y = self.mlp_down(F.gelu(self.mlp_up(y), approximate="tanh"))
        out = x + y
        if kv_cache is None:
            return out
        return out, new_kv


class QuantTransformerLM(nn.Module):
    """Embedding -> ``depth`` quantized blocks -> LayerNorm -> LM head (no
    bias).  QAT mode (parameters drawn from ``seed``) or serve mode (pass
    ``qconfig.for_serving(...)``; buffers loaded by ``interop``).

    ``model(tokens)`` gives logits (B, t, vocab); ``model(tokens,
    cache=..., cache_index=...)`` gives ``(logits, cache)`` with the cache
    updated in place, in either mode (a QAT-mode call with a cache is an
    eval forward that keeps no quantizer state).  Runs on CUDA unless
    ``device`` says otherwise; with no card and no ``device``, construction
    raises.
    """

    def __init__(self, vocab: int, dim: int, depth: int, num_heads: int,
                 qconfig: QConfig, *, max_len: int = 256,
                 num_kv_heads: Optional[int] = None, pos_embedding: str = "learned",
                 attn_window: Optional[int] = None, train_attn_impl: str = "xla",
                 moe_experts: Optional[int] = None, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, device=None, seed: int = 0):
        super().__init__()
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(f"pos_embedding must be 'learned' or 'rope', "
                             f"got {pos_embedding!r}")
        self.moe_experts, self.moe_top_k = moe_experts, moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.device = resolve_device(device)
        self.vocab, self.dim, self.depth = vocab, dim, depth
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.qconfig, self.max_len = qconfig, max_len
        self.pos_embedding, self.attn_window = pos_embedding, attn_window
        self.train_attn_impl = train_attn_impl
        self.qat = qconfig.mode != "serve"
        dev = self.device
        self.tok_emb = QuantEmbed(vocab, dim, qconfig, path=("tok_emb",), device=dev)
        if pos_embedding == "learned":
            pos = torch.zeros(max_len, dim, device=dev)
            if self.qat:
                self.pos_emb = nn.Parameter(pos)
            else:
                self.register_buffer("pos_emb", pos)
        for i in range(depth):
            self.add_module(f"block{i}", QuantTransformerBlock(
                dim, num_heads, qconfig, num_kv_heads=num_kv_heads,
                rope=pos_embedding == "rope", attn_window=attn_window,
                train_attn_impl=train_attn_impl, moe_experts=moe_experts,
                moe_top_k=moe_top_k, moe_capacity_factor=moe_capacity_factor,
                path=(f"block{i}",), device=dev))
        self.ln_f = _layer_norm(dim, dev)
        self.lm_head = QuantDense(dim, vocab, qconfig, use_bias=False,
                                  path=("lm_head",), device=dev)
        if self.qat:
            init_qat_variables(self, seed)
        else:
            self.requires_grad_(False)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def forward(self, tokens: torch.Tensor, cache=None, cache_index=None):
        if cache is None or not self.qat:
            return self._forward(tokens, cache, cache_index)
        # the JAX package's apply(training=False) with the quantizers'
        # collections not mutable
        fqs = [m for m in self.modules() if isinstance(m, FakeQuantize)]
        refresh_host_state(fqs)
        modes = [m.training for m in fqs]
        try:
            for m in fqs:
                m.training = False
            with quant_state_frozen(fqs):
                return self._forward(tokens, cache, cache_index)
        finally:
            for m, mode in zip(fqs, modes):
                m.training = mode

    def _forward(self, tokens: torch.Tensor, cache, cache_index):
        b, t = tokens.shape
        x = self.tok_emb(tokens)
        if self.pos_embedding == "learned":
            if cache is None:
                seq = _seq_part()
                off = 0 if seq is None else seq.rank * t  # this chunk's start
                if off + t > self.max_len:
                    raise ValueError(f"sequence length {off + t} exceeds max_len "
                                     f"{self.max_len}")
                x = x + self.pos_emb[None, off:off + t]
            elif _is_scalar_index(cache_index):
                i = int(cache_index)
                if i < 0 or i + t > self.max_len:
                    raise ValueError(f"positions [{i}, {i + t}) exceed max_len "
                                     f"{self.max_len}")
                x = x + self.pos_emb[None, i:i + t]
            else:
                positions = (cache_index.to(torch.int64)[:, None]
                             + torch.arange(t, device=tokens.device))
                x = x + self.pos_emb[positions]
        new_cache = []
        for i, block in enumerate(self.blocks()):
            if cache is None:
                x = block(x)
            else:
                x, kv = block(x, kv_cache=cache[i], cache_index=cache_index)
                new_cache.append(kv)
        logits = self.lm_head(self.ln_f(x))
        if cache is None:
            return logits
        return logits, tuple(new_cache)


def _lecun_normal(shape, gen, device, fan_in: Optional[int] = None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal (±2σ) with variance 1/fan_in
    (default ``shape[0]``, a (K, N) kernel's), σ corrected for the truncation."""
    std = math.sqrt(1.0 / (fan_in or shape[0])) / 0.87962566103423978
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_variables(model: QuantTransformerLM, seed: int = 0) -> dict:
    """A seeded QAT-mode variables tree for ``model``, with the JAX package's
    structure and distributions (``params`` + ``qparams``): lecun-normal dense
    kernels and zero biases, normal(0.02) embedding and ``pos_emb``, LayerNorm
    ones/zeros, static mean ± 3σ weight scales and the activation quantizers'
    initial qparams.  The observer counters of ``quant_state`` are left out:
    conversion never reads them.  Same distributions as flax ``init``, not
    the same bits."""
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qc = model.qconfig
    params, qparams = {}, {}

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def qp(state):
        return {"qp": {"scale": state.scale, "shift": state.shift}}

    def quantizers(path, w, axis):
        qcfg = qc.resolve(path)
        node = {"weight_fq": qp(qcfg.weight_for_axis(axis).init(w))}
        acfg = qcfg.activation_for_axis(-1)
        if acfg is not None and axis == 1:
            node["act_fq"] = qp(acfg.init(num_channels=w.shape[0], device=dev))
        return node

    def dense(path, k, n, bias=True):
        w = _lecun_normal((k, n), gen, dev)
        p = {"kernel": w}
        if bias:
            p["bias"] = torch.zeros(n, device=dev)
        return p, quantizers(path, w, 1)

    def experts(path, e, k, n):  # flax lecun_normal(batch_axis=(0,)): fan-in k
        w = _lecun_normal((e, k, n), gen, dev, fan_in=k)
        qcfg = qc.resolve(path)
        node = {"weight_fq": qp(qcfg.weight_for_axis(0).init(w))}
        acfg = qcfg.activation_for_axis(-1)
        if acfg is not None:
            node["act_fq"] = qp(acfg.init(num_channels=k, device=dev))
        return {"kernel": w, "bias": torch.zeros(n, device=dev)}, node

    def ln():
        return {"scale": torch.ones(model.dim, device=dev),
                "bias": torch.zeros(model.dim, device=dev)}

    emb = normal((model.vocab, model.dim), 0.02)
    params["tok_emb"] = {"embedding": emb}
    qparams["tok_emb"] = quantizers(("tok_emb",), emb, 0)
    if model.pos_embedding == "learned":
        params["pos_emb"] = normal((model.max_len, model.dim), 0.02)
    d = model.dim
    for i, blk in enumerate(model.blocks()):
        name = f"block{i}"
        bp, bq = {"ln1": ln(), "ln2": ln()}, {}
        n_qkv = d + 2 * blk.kvh * blk.hd
        hidden = blk.hidden
        subs = [("qkv", d, n_qkv), ("proj", d, d)]
        if blk.moe is None:
            subs += [("mlp_up", d, hidden), ("mlp_down", hidden, d)]
        for sub, k, n in subs:
            bp[sub], bq[sub] = dense((name, sub), k, n)
        if blk.moe is not None:
            e = blk.moe.num_experts
            mp = {"router": {"kernel": _lecun_normal((d, e), gen, dev)}}
            mq = {}
            for sub, k, n in (("experts_up", d, hidden), ("experts_down", hidden, d)):
                mp[sub], mq[sub] = experts((name, "moe", sub), e, k, n)
            bp["moe"], bq["moe"] = mp, mq
        params[name], qparams[name] = bp, bq
    params["ln_f"] = ln()
    params["lm_head"], qparams["lm_head"] = dense(("lm_head",), d, model.vocab,
                                                  bias=False)
    return {"params": params, "qparams": qparams}


# ---------------------------------------------------------------------------
# QAT conv nets
# ---------------------------------------------------------------------------

class QuantMLP(nn.Module):
    """Dense layers with ReLU between them: ``dense_0 … head``."""

    def __init__(self, in_features: int, features: Sequence[int], qconfig: QConfig,
                 *, device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.qconfig = qconfig
        dims = (in_features,) + tuple(features)
        names = [f"dense_{i}" for i in range(len(features) - 1)] + ["head"]
        self.names = names
        for name, k, n in zip(names, dims[:-1], dims[1:]):
            self.add_module(name, QuantDense(k, n, qconfig, path=(name,),
                                             device=self.device))
        init_qat_variables(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names[:-1]:
            x = F.relu(getattr(self, name)(x))
        return self.head(x)


def _init_or_freeze(model: nn.Module, qconfig: QConfig, seed: int) -> None:
    """A QAT-mode net draws its variables from ``seed``; a serve-mode one
    takes no gradient and waits for ``interop.load_variables``."""
    if qconfig.mode != "serve":
        init_qat_variables(model, seed)
    else:
        model.requires_grad_(False)


class QuantCNN(nn.Module):
    """Small conv net: per width a 3x3 ``conv_{i}`` (with bias), relu and a
    2x2 average pool, then the ``head`` over the features flattened in the
    JAX package's NHWC order, so its (K, N) kernel carries across as it is.
    ``image_size`` (square) fixes the head's K, which flax infers."""

    def __init__(self, num_classes: int, qconfig: QConfig, *,
                 widths: Sequence[int] = (32, 64), in_channels: int = 3,
                 image_size: int = 32, device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.qconfig = qconfig
        self.widths = tuple(widths)
        cin, size = in_channels, image_size
        for i, w in enumerate(self.widths):
            self.add_module(f"conv_{i}", QuantConv(cin, w, (3, 3), qconfig,
                                                   path=(f"conv_{i}",),
                                                   device=self.device))
            cin, size = w, size // 2
        self.head = QuantDense(cin * size * size, num_classes, qconfig,
                               path=("head",), device=self.device)
        _init_or_freeze(self, qconfig, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.widths)):
            x = F.avg_pool2d(F.relu(getattr(self, f"conv_{i}")(x)), 2, 2)
        return self.head(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class BasicBlock(nn.Module):
    """ResNet-v1 basic block: conv1 (3x3, ``strides``) → bn1 → relu → conv2
    → bn2, plus the residual, a 1x1 ``downsample`` conv and ``bn_down`` when
    the shape changes; relu of the sum."""

    def __init__(self, in_features: int, features: int, qconfig: QConfig, *,
                 strides: int = 1, path: Sequence[str] = (), device=None):
        super().__init__()
        path = tuple(path)
        self.conv1 = QuantConv(in_features, features, (3, 3), qconfig,
                               strides=strides, use_bias=False,
                               path=path + ("conv1",), device=device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = QuantConv(features, features, (3, 3), qconfig, use_bias=False,
                               path=path + ("conv2",), device=device)
        self.bn2 = BatchNorm(features, device=device)
        self.downsample = self.bn_down = None
        if strides != 1 or in_features != features:
            self.downsample = QuantConv(in_features, features, (1, 1), qconfig,
                                        strides=strides, use_bias=False,
                                        path=path + ("downsample",), device=device)
            self.bn_down = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.bn_down(self.downsample(x))
        return F.relu(y + residual)


class QuantResNet(nn.Module):
    """ResNet-18-class network with the CIFAR stem (one 3x3 conv, no pooling)
    and LSQ quantizers in every conv and the head.  Takes NCHW images and
    returns logits (B, num_classes).  Runs on CUDA unless ``device`` says
    otherwise; with no card and no ``device``, construction raises.
    Parameters are drawn from ``seed`` (:func:`init_qat_variables`)."""

    def __init__(self, num_classes: int, qconfig: QConfig, *,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.qconfig = qconfig
        dev = self.device
        self.stem = QuantConv(in_channels, widths[0], (3, 3), qconfig,
                              use_bias=False, path=("stem",), device=dev)
        self.bn_stem = BatchNorm(widths[0], device=dev)
        self.block_names = []
        cin = widths[0]
        for si, (n_blocks, w) in enumerate(zip(stage_sizes, widths)):
            for bi in range(n_blocks):
                name = f"stage{si}_block{bi}"
                self.add_module(name, BasicBlock(
                    cin, w, qconfig, strides=2 if (si > 0 and bi == 0) else 1,
                    path=(name,), device=dev))
                self.block_names.append(name)
                cin = w
        self.head = QuantDense(cin, num_classes, qconfig, path=("head",), device=dev)
        _init_or_freeze(self, qconfig, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn_stem(self.stem(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)))


def resnet18_cifar(num_classes: int, qconfig: QConfig, *, device=None,
                   seed: int = 0) -> QuantResNet:
    """ResNet-18 for 32x32 inputs: stages (2, 2, 2, 2), widths 64-512."""
    return QuantResNet(num_classes, qconfig, device=device, seed=seed)


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted-residual block: a 1x1 ``expand`` conv (when the
    ratio is not 1) → ``bn_expand`` → relu6, a 3x3 ``depthwise`` conv
    (``feature_group_count == hidden``: an OIHW kernel (hidden, 1, 3, 3),
    per-channel axis 0) → ``bn_dw`` → relu6, a 1x1 ``project`` conv →
    ``bn_proj``, plus the input when stride 1 keeps the width."""

    def __init__(self, in_features: int, features: int, qconfig: QConfig, *,
                 strides: int = 1, expand: int = 6, path: Sequence[str] = (),
                 device=None):
        super().__init__()
        path = tuple(path)
        hidden = in_features * expand
        self.expand = self.bn_expand = None
        if expand != 1:
            self.expand = QuantConv(in_features, hidden, (1, 1), qconfig, use_bias=False,
                                    path=path + ("expand",), device=device)
            self.bn_expand = BatchNorm(hidden, device=device)
        self.depthwise = QuantConv(hidden, hidden, (3, 3), qconfig, strides=strides,
                                   use_bias=False, feature_group_count=hidden,
                                   path=path + ("depthwise",), device=device)
        self.bn_dw = BatchNorm(hidden, device=device)
        self.project = QuantConv(hidden, features, (1, 1), qconfig, use_bias=False,
                                 path=path + ("project",), device=device)
        self.bn_proj = BatchNorm(features, device=device)
        self.residual = strides == 1 and in_features == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = F.relu6(self.bn_expand(self.expand(y)))
        y = F.relu6(self.bn_dw(self.depthwise(y)))
        y = self.bn_proj(self.project(y))
        return y + x if self.residual else y


class QuantMobileNetV2(nn.Module):
    """MobileNetV2-class network with the CIFAR stem: ``stem`` (3x3) →
    ``bn_stem`` → relu6, the ``stage{si}_block{bi}`` inverted residuals of
    ``stages`` ((expand, features, repeats, stride) each; the stride on a
    stage's first block), ``head_conv`` (1x1) → ``bn_head`` → relu6, the
    spatial mean and the ``classifier``.  Takes NCHW images, returns logits
    (B, num_classes); runs on CUDA unless ``device`` says otherwise."""

    def __init__(self, num_classes: int, qconfig: QConfig, *,
                 stages: Sequence[Tuple[int, int, int, int]] = (
                     (1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 2, 2), (6, 64, 2, 2)),
                 stem_width: int = 32, head_width: int = 256, in_channels: int = 3,
                 device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.qconfig = qconfig
        dev = self.device
        self.stem = QuantConv(in_channels, stem_width, (3, 3), qconfig, use_bias=False,
                              path=("stem",), device=dev)
        self.bn_stem = BatchNorm(stem_width, device=dev)
        self.block_names = []
        cin = stem_width
        for si, (e, f, r, st) in enumerate(stages):
            for bi in range(r):
                name = f"stage{si}_block{bi}"
                self.add_module(name, InvertedResidual(
                    cin, f, qconfig, strides=st if bi == 0 else 1, expand=e,
                    path=(name,), device=dev))
                self.block_names.append(name)
                cin = f
        self.head_conv = QuantConv(cin, head_width, (1, 1), qconfig, use_bias=False,
                                   path=("head_conv",), device=dev)
        self.bn_head = BatchNorm(head_width, device=dev)
        self.classifier = QuantDense(head_width, num_classes, qconfig,
                                     path=("classifier",), device=dev)
        _init_or_freeze(self, qconfig, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.bn_stem(self.stem(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = F.relu6(self.bn_head(self.head_conv(x)))
        return self.classifier(x.mean(dim=(2, 3)))


def mobilenetv2_cifar(num_classes: int, qconfig: QConfig, *, device=None,
                      seed: int = 0) -> QuantMobileNetV2:
    """MobileNetV2 for 32x32 inputs at the JAX package's widths: stem 32,
    stages (1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 2, 2), (6, 64, 2, 2), head 256."""
    return QuantMobileNetV2(num_classes, qconfig, device=device, seed=seed)


@torch.no_grad()
def init_qat_variables(model: nn.Module, seed: int = 0) -> None:
    """Draw ``model``'s QAT variables in place from ``seed`` with flax's
    distributions: lecun-normal kernels (fan-in = all but the output axis),
    zero biases, BatchNorm scale 1, bias 0, mean 0, var 1; LayerNorm scale
    1, bias 0; normal(0.02) embedding tables and learned ``pos_emb``; each
    weight quantizer's static mean ± 3σ scale from its kernel or table, each
    activation quantizer's initial state.  Same distributions as flax
    ``init``, not the same bits; flax's ``init`` also runs one eval-mode
    forward that feeds the activation observers, which this does not."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, QuantMoE):  # the float router: a (d, E) kernel
            mod.router.weight.copy_(_lecun_normal((mod.dim, mod.num_experts), gen, dev).T)
        elif isinstance(mod, (QuantConv, QuantDense, _ExpertDense)) and getattr(mod, "qat", True):
            k = mod.kernel
            if isinstance(mod, QuantConv):  # OIHW: fan-in is I * kh * kw
                k.copy_(_lecun_normal(k.shape, gen, dev, fan_in=k[0].numel()))
            elif isinstance(mod, _ExpertDense):  # (E, K, N): fan-in K
                k.copy_(_lecun_normal(k.shape, gen, dev, fan_in=k.shape[1]))
            else:
                k.copy_(_lecun_normal(k.shape, gen, dev))
            if mod.bias is not None:
                mod.bias.zero_()
            if mod.weight_fq is not None:
                mod.weight_fq.load_quant_state(mod.weight_fq.cfg.init(k))
            if mod.act_fq is not None:
                fq = mod.act_fq
                fq.load_quant_state(fq.cfg.init(num_channels=fq.scale.shape[0],
                                                device=dev))
        elif isinstance(mod, QuantEmbed) and mod.qat:
            mod.embedding.copy_(torch.randn(mod.embedding.shape, generator=gen,
                                            device=dev) * 0.02)
            if mod.weight_fq is not None:
                mod.weight_fq.load_quant_state(mod.weight_fq.cfg.init(mod.embedding))
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
        elif isinstance(mod, QuantTransformerLM) and mod.pos_embedding == "learned":
            mod.pos_emb.copy_(torch.randn(mod.pos_emb.shape, generator=gen,
                                          device=dev) * 0.02)
