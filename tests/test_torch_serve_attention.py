"""jaxlsq_torch ``decode_attention`` (its plain version, which CPU tensors
take) against the JAX package: ``_decode_attention_xla`` (the models' own
einsum program) and the Pallas ``_attn_kernel`` in interpret mode, on the
same numpy caches.

Covers the f32, bf16, int8 and int4 carriers, MHA and GQA (g = 2), scalar
and per-slot ``cache_index``, t in {1, 3}, and sliding windows both much
shorter than the cache and longer than it.  Tolerance atol 1e-5 (f32, other
summation order; the JAX kernel's online softmax differs from the einsum in
the same way)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.serve.attention import _decode_attention_xla
from jaxlsq.serve.attention import decode_attention as j_decode_attention

from jaxlsq_torch.serve.attention import LAUNCHES, decode_attention

ATOL = 1e-5


def _cache(carrier, b, kvh, length, hd, r):
    """numpy (k, v) cache entries in the given carrier."""
    if carrier in ("f32", "bf16"):
        return r.randn(b, kvh, length, hd).astype(np.float32), \
            r.randn(b, kvh, length, hd).astype(np.float32)
    if carrier == "int8":
        def one():
            return (r.randint(-127, 128, (b, kvh, length, hd)).astype(np.int8),
                    (r.rand(b, kvh, length) * 0.03).astype(np.float32))
        return one(), one()

    def one4():
        return (r.randint(0, 256, (b, kvh, length, hd // 2)).astype(np.uint8),
                (r.rand(b, kvh, length) * 0.3).astype(np.float32))
    return one4(), one4()


def _to(side, carrier, entry):
    if isinstance(entry, tuple):
        return tuple(_to(side, carrier, e) for e in entry)
    if side == "jax":
        a = jnp.asarray(entry)
        return a.astype(jnp.bfloat16) if carrier == "bf16" else a
    t = torch.as_tensor(entry)
    return t.to(torch.bfloat16) if carrier == "bf16" else t


def _run(carrier, b, h, kvh, length, t, per_slot, window, seed):
    hd = 8
    r = np.random.RandomState(seed)
    q = r.randn(b, h, t, hd).astype(np.float32)
    ck, cv = _cache(carrier, b, kvh, length, hd, r)
    if per_slot:
        idx = r.randint(0, length - t + 1, size=b).astype(np.int32)
    else:
        idx = np.int32(r.randint(0, length - t + 1))
    before = dict(LAUNCHES)
    tidx = torch.as_tensor(idx) if per_slot else int(idx)
    got = decode_attention(torch.as_tensor(q), _to("t", carrier, ck),
                           _to("t", carrier, cv), tidx, window=window).numpy()
    assert LAUNCHES == before  # CPU tensors take the plain version
    jq = jnp.asarray(q)
    jck, jcv = _to("jax", carrier, ck), _to("jax", carrier, cv)
    xla = np.asarray(_decode_attention_xla(jq, jck, jcv, jnp.asarray(idx),
                                           window=window))
    kern = np.asarray(j_decode_attention(jq, jck, jcv, jnp.asarray(idx),
                                         impl="pallas", interpret=True,
                                         window=window))
    assert got.shape == (b, h, t, hd)
    np.testing.assert_allclose(got, xla, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, kern, rtol=0, atol=ATOL)


LAYOUTS = {
    # name: (b, h, kvh, length, t, per_slot)
    "mha_scalar_t1": (2, 4, 4, 24, 1, False),
    "gqa_perslot_t3": (3, 4, 2, 24, 3, True),
    "mha_perslot_t3": (2, 2, 2, 20, 3, True),
    "gqa_scalar_t1": (1, 4, 2, 16, 1, False),
}


@pytest.mark.parametrize("carrier", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_attention_matches_jax(carrier, layout):
    b, h, kvh, length, t, per_slot = LAYOUTS[layout]
    _run(carrier, b, h, kvh, length, t, per_slot, None,
         seed=zlib.crc32(f"{carrier}/{layout}".encode()) % 1000)


# window much shorter than the cache (L >> W) and longer than it (L < W)
@pytest.mark.parametrize("carrier", ["f32", "int8", "int4"])
@pytest.mark.parametrize("length,window", [(64, 5), (12, 40)])
def test_decode_attention_window_matches_jax(carrier, length, window):
    _run(carrier, 2, 4, 2, length, 3, True, window, seed=length + window)


def test_decode_attention_rejects_bad_window_and_heads():
    q = torch.zeros(1, 3, 1, 8)
    ck = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="divisible"):
        decode_attention(q, ck, ck, 0)
    with pytest.raises(ValueError, match="window"):
        decode_attention(torch.zeros(1, 2, 1, 8), ck, ck, 0, window=0)
