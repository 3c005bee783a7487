"""Decode attention over the dense KV cache (port of ``jaxlsq/serve/attention.py``).

``decode_attention(q, ck, cv, cache_index, window=None)`` attends the new
queries ``q`` (B, H, t, hd) to the UPDATED cache: a float array
(B, KVH, L, hd), an int8 pair ``(data (B, KVH, L, hd), scales (B, KVH, L))``
or an int4 pair ``(uint8 (B, KVH, L, hd//2), scales)`` with interleaved
nibbles.  ``cache_index`` is an int, a 0-d tensor or a (B,) tensor: the
position of q's first row per slot; keys at positions <= cache_index + row
are attended (and, with a window W, only those > cache_index + row - W).

While a program is traced (``torch.export``, ``torch.compile``) it calls the
``jaxlsq_torch::decode_attention`` operator (``serve.custom_ops``), whose
implementations are the two below; eager code calls them directly:

* On CPU tensors it runs :func:`decode_attention_plain`, the einsum
  formulation of ``_decode_attention_xla`` (the models' own program).
* On CUDA tensors it launches ``csrc/decode_attention.cu`` or raises: a
  kernel that walks the cache in 256-key spans, one block each, and a light
  kernel that folds the spans' softmax states in span order (a workspace of
  ``B * KVH * ceil(L / 256) * g * t * (hd + 2)`` floats between them).

``LAUNCHES`` counts the span kernel's launches and the fold's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build
from .pack import true_div

__all__ = ["decode_attention", "decode_attention_plain", "LAUNCHES", "MASK"]

LAUNCHES = {"decode_attention": 0, "decode_attention_fold": 0}
MASK = -1e9  # additive mask value, as the JAX package's attention


def _qpos(cache_index, b: int, device) -> torch.Tensor:
    if isinstance(cache_index, int):
        return torch.full((b,), cache_index, dtype=torch.int32, device=device)
    idx = cache_index.to(device=device, dtype=torch.int32)
    return idx.expand(b) if idx.dim() == 0 else idx


def _dtype_name(dtype) -> str:
    """A cache dtype as a name: ``torch.int8`` -> "int8", "int4" as it is."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).replace("torch.", "")


def _q8(a: torch.Tensor):
    """Quantize-on-write of int8 caches: per-(b, h, position) symmetric int8,
    scales floored at f32 tiny; the same bits on the card as on the CPU."""
    s = true_div(a.abs().amax(dim=-1), 127.0)
    s = torch.clamp_min(s, torch.finfo(torch.float32).tiny)
    data = torch.clamp(torch.round(a / s[..., None]), -127, 127)
    return data.to(torch.int8), s.to(torch.float32)


def _q4(a: torch.Tensor):
    """The same scheme at 4 bits ([-7, 7]), two values per byte along
    head_dim: low nibble = even index, high nibble = odd index."""
    s = true_div(a.abs().amax(dim=-1), 7.0)
    s = torch.clamp_min(s, torch.finfo(torch.float32).tiny)
    data = torch.clamp(torch.round(a / s[..., None]), -7, 7).to(torch.int32)
    n = data & 0xF
    packed = n[..., 0::2] | (n[..., 1::2] << 4)
    return packed.to(torch.uint8), s.to(torch.float32)


def _unpack4(p: torch.Tensor, dt) -> torch.Tensor:
    """uint8 nibble pairs (low = even index, high = odd) -> values."""
    b32 = p.to(torch.int32)
    lo = ((b32 & 0xF) ^ 8) - 8
    hi = ((b32 >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], 2 * p.shape[-1]).to(dt)


def decode_attention_plain(q, ck, cv, cache_index, window: Optional[int] = None):
    """Einsum formulation: scores, -1e9 mask, softmax, weighted sum; the
    quantized carriers fold the key scale after QK and the value scale into
    the softmax weights before AV."""
    b, h, t, hd = q.shape
    quantized = isinstance(ck, (tuple, list))
    kdata = ck[0] if quantized else ck
    kvh, length = kdata.shape[1], kdata.shape[2]
    g = h // kvh
    qpos = (_qpos(cache_index, b, q.device).to(torch.int64)[:, None]
            + torch.arange(t, device=q.device))[:, None, None, :, None]
    kpos = torch.arange(length, device=q.device)[None, None, None, None, :]
    ok = kpos <= qpos
    if window is not None:
        ok = ok & (kpos > qpos - window)
    q5 = q.reshape(b, kvh, g, t, hd)
    if quantized:
        int4 = kdata.dtype == torch.uint8
        ckf = _unpack4(kdata, q.dtype) if int4 else kdata.to(q.dtype)
        cvf = _unpack4(cv[0], q.dtype) if int4 else cv[0].to(q.dtype)
        att = (torch.einsum("bkgqd,bkld->bkgql", q5, ckf)
               * ck[1].to(q.dtype)[:, :, None, None, :] / math.sqrt(hd))
        att = torch.softmax(torch.where(ok, att, MASK), dim=-1)
        y = torch.einsum("bkgql,bkld->bkgqd",
                         att * cv[1].to(q.dtype)[:, :, None, None, :], cvf)
    else:
        att = torch.einsum("bkgqd,bkld->bkgql", q5, ck.to(q.dtype)) / math.sqrt(hd)
        att = torch.softmax(torch.where(ok, att, MASK), dim=-1)
        y = torch.einsum("bkgql,bkld->bkgqd", att, cv.to(q.dtype))
    return y.reshape(b, h, t, hd)


_CARRIERS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}


def span_workspace(lib, bkv: int, length: int, gt: int, hd: int, device):
    """The kernels' span states: (m, l) and acc[hd] of each of ``gt`` rows a
    (batch, kv head) and 256-key span of the ``length`` keys."""
    spans = -(-length // lib.span_keys)
    return torch.empty((bkv * spans * gt * (hd + 2),), dtype=torch.float32,
                       device=device)


def _launch(q, ck, cv, cache_index, window):
    b, h, t, hd = q.shape
    quantized = isinstance(ck, (tuple, list))
    kdata, vdata = (ck[0], cv[0]) if quantized else (ck, cv)
    kvh, length = kdata.shape[1], kdata.shape[2]
    carrier = _CARRIERS.get(kdata.dtype)
    if carrier is None or vdata.dtype != kdata.dtype:
        raise ValueError(f"decode_attention: unsupported cache dtypes "
                         f"{kdata.dtype}/{vdata.dtype}")
    if quantized != (carrier >= 2):
        raise ValueError("decode_attention: int caches come as (data, scales) pairs")
    if q.dtype != torch.float32:
        raise ValueError(f"decode_attention: the kernel takes f32 queries, got {q.dtype}")
    if hd > 128 or (carrier == 3 and hd % 2):
        raise ValueError(f"decode_attention: head_dim {hd} not supported "
                         "(<= 128, even for int4)")
    hq = hd // 2 if carrier == 3 else hd
    want = (b, kvh, length, hq)
    if tuple(kdata.shape) != want or tuple(vdata.shape) != want:
        raise ValueError(f"decode_attention: cache shapes {tuple(kdata.shape)}/"
                         f"{tuple(vdata.shape)}, want {want}")
    dev = q.device
    tensors = [q, kdata, vdata] + ([ck[1], cv[1]] if quantized else [])
    if any(x.device != dev for x in tensors):
        raise ValueError("decode_attention: q and the cache must share a device")
    qc = q.contiguous()
    kd, vd = kdata.contiguous(), vdata.contiguous()
    if quantized:
        ks = ck[1].to(torch.float32).contiguous()
        vs = cv[1].to(torch.float32).contiguous()
        if tuple(ks.shape) != (b, kvh, length) or tuple(vs.shape) != (b, kvh, length):
            raise ValueError("decode_attention: scales must be (B, KVH, L)")
        ks_ptr, vs_ptr = ks.data_ptr(), vs.data_ptr()
    else:
        ks_ptr = vs_ptr = 0
    qpos = _qpos(cache_index, b, dev).contiguous()
    out = torch.empty_like(qc)
    lib = _build.load_library()
    gt = (h // kvh) * t
    ws = span_workspace(lib, b * kvh, length, gt, hd, dev)
    err = lib.jlt_decode_attention(
        qc.data_ptr(), kd.data_ptr(), ks_ptr, vd.data_ptr(), vs_ptr,
        qpos.data_ptr(), out.data_ptr(), ws.data_ptr(), b, kvh, length, hd, t, gt,
        0 if window is None else int(window), carrier, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["decode_attention"] += 1
    LAUNCHES["decode_attention_fold"] += 1
    _build.check(err, "decode_attention")
    return out


def decode_attention(q, ck, cv, cache_index, window: Optional[int] = None):
    """Causal attention of ``q`` (B, H, t, hd) against the full cache; returns
    (B, H, t, hd) f32."""
    b, h, t, hd = q.shape
    kdata = ck[0] if isinstance(ck, (tuple, list)) else ck
    if h % kdata.shape[1]:
        raise ValueError(f"num_heads {h} not divisible by kv heads {kdata.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if torch.compiler.is_compiling():
        quantized = isinstance(ck, (tuple, list))
        kd, ks = (ck[0], ck[1]) if quantized else (ck, None)
        vd, vs = (cv[0], cv[1]) if quantized else (cv, None)
        return torch.ops.jaxlsq_torch.decode_attention(
            q, kd, ks, vd, vs, _qpos(cache_index, b, q.device), window or 0)
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, cache_index, window)
    return _launch(q, ck, cv, cache_index, window)
