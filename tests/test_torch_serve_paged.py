"""jaxlsq_torch's paged KV cache (``serve/paged.py``) against the JAX
package's, on the same numpy inputs:

* ``paged_update``: the pools hold the JAX package's bytes for the same
  table (f32 and bf16 rows copied, int8/int4 rows quantized on write with
  the same per-row scheme; the quantized rows compared bit for bit);
* ``paged_attention_plain`` (which CPU tensors take) within rtol = atol =
  1e-5 of the JAX package's XLA gather path and within its own 2e-5 of its
  Pallas kernel in interpret mode (f32, other summation orders);
* a permuted table only relabels pages, stale pool rows never leak into the
  output, and the ``PageAllocator`` keeps its refcounts;
* the LM through a paged cache gives the dense cache's logits bit for bit,
  and the JAX package's paged logits within atol = rtol = 1e-4 (the LM
  tolerance of ``test_torch_serve_lm.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as j_default_qconfig
from jaxlsq.serve import convert as j_convert
from jaxlsq.serve import init_paged_cache as j_init_paged_cache
from jaxlsq.serve.paged import PagedKVLayer as JLayer
from jaxlsq.serve.paged import paged_attention as j_paged_attention
from jaxlsq.serve.paged import paged_update as j_paged_update

from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
from jaxlsq_torch.serve import init_kv_cache, init_paged_cache, prefill
from jaxlsq_torch.serve.paged import (LAUNCHES, PageAllocator, PagedKVLayer,
                                      paged_attention, paged_attention_plain,
                                      paged_update, with_table)

from _torch_port import torch_tree_to_np

LAYOUTS = ["f32", "bf16", "int8", "int4"]


def _pools(layout, n_pages, kvh, ps, hd):
    """Zero (kp, vp, ks, vs) pools of a layout, as numpy."""
    width, dt = ((hd // 2, np.uint8) if layout == "int4" else
                 (hd, np.int8) if layout == "int8" else (hd, np.float32))
    z = np.zeros((n_pages, kvh, ps, width), dt)
    s = np.zeros((n_pages, kvh, ps), np.float32) if layout in ("int8", "int4") else None
    return z, z.copy(), s, None if s is None else s.copy()


def _layers(layout, table, ps, pools):
    kp, vp, ks, vs = pools
    tdt = torch.bfloat16 if layout == "bf16" else None
    t = PagedKVLayer(kp=torch.as_tensor(kp).to(tdt or torch.as_tensor(kp).dtype),
                     vp=torch.as_tensor(vp).to(tdt or torch.as_tensor(vp).dtype),
                     table=torch.as_tensor(table),
                     ks=None if ks is None else torch.as_tensor(ks),
                     vs=None if vs is None else torch.as_tensor(vs), page_size=ps)
    jdt = jnp.bfloat16 if layout == "bf16" else None
    j = JLayer(kp=jnp.asarray(kp, jdt), vp=jnp.asarray(vp, jdt),
               table=jnp.asarray(table), ks=None if ks is None else jnp.asarray(ks),
               vs=None if vs is None else jnp.asarray(vs), page_size=ps)
    return t, j


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


# the update runs op by op, as the JAX package's own tests run it: under jit
# XLA may fold the scale's division by 127 into a reciprocal multiply
_j_attention = jax.jit(j_paged_attention, static_argnames=("impl", "interpret"))

# B, H, KVH, t, hd, ps, written, idx kind
CASES = [(2, 4, 2, 2, 32, 8, 30, "vector"), (2, 8, 2, 3, 64, 4, 24, "scalar")]


def _case(layout, case, seed):
    b, h, kvh, t, hd, ps, written, kind = case
    pps = -(-written // ps) + 1
    n_pages = b * pps + 3
    r = np.random.RandomState(seed)
    table = r.permutation(n_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    tl, jl = _layers(layout, table, ps, _pools(layout, n_pages, kvh, ps, hd))
    kk = r.randn(b, kvh, written, hd).astype(np.float32)
    vv = r.randn(b, kvh, written, hd).astype(np.float32)
    q = r.randn(b, h, t, hd).astype(np.float32)
    idx = (written - t if kind == "scalar" else
           r.randint(t - 1, written - t, size=(b,)).astype(np.int32))
    return tl, jl, kk, vv, q, idx


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES, ids=[f"B{c[0]}H{c[1]}kv{c[2]}t{c[3]}ps{c[5]}{c[7]}"
                                             for c in CASES])
def test_paged_update_and_attention_match_jax(layout, case):
    tl, jl, kk, vv, q, idx = _case(layout, case, seed=len(layout) + case[5])
    # prefill-style write at 0, then a per-slot or scalar write over it
    tl = paged_update(tl, torch.as_tensor(kk), torch.as_tensor(vv), 0)
    jl = j_paged_update(jl, jnp.asarray(kk), jnp.asarray(vv), jnp.int32(0))
    t_new = q.shape[2]
    kn = np.random.RandomState(1).randn(*kk.shape[:2], t_new, kk.shape[3]).astype(np.float32)
    ti = idx if np.ndim(idx) == 0 else torch.as_tensor(idx)
    tl = paged_update(tl, torch.as_tensor(kn), torch.as_tensor(-kn), ti)
    jl = j_paged_update(jl, jnp.asarray(kn), jnp.asarray(-kn), jnp.asarray(idx, jnp.int32))
    for name in ("kp", "vp", "ks", "vs"):
        a, b_ = getattr(tl, name), getattr(jl, name)
        if a is not None:
            np.testing.assert_array_equal(_np(a), _np(b_), err_msg=name)
    before = dict(LAUNCHES)
    got = paged_attention(torch.as_tensor(q), tl, ti).numpy()
    assert LAUNCHES == before  # CPU tensors take the plain version
    jidx = jnp.asarray(idx, jnp.int32)
    xla = np.asarray(_j_attention(jnp.asarray(q), jl, jidx, impl="xla"))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)
    if layout in ("f32", "int4"):  # the Pallas kernel, as tests/test_paged.py runs it
        pallas = np.asarray(_j_attention(jnp.asarray(q), jl, jidx,
                                         impl="pallas", interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_page_permutation_is_relabeling(window):
    """Two tables over different pool pages, the same rows written through
    each: the same attention output, bit for bit."""
    b, kvh, h, hd, ps, pps = 2, 2, 4, 16, 4, 5
    r = np.random.RandomState(2)
    kk = torch.as_tensor(r.randn(b, kvh, 17, hd).astype(np.float32))
    q = torch.as_tensor(r.randn(b, h, 1, hd).astype(np.float32))
    outs = []
    for table in (np.arange(b * pps).reshape(b, pps),
                  r.permutation(b * pps + 4)[:b * pps].reshape(b, pps)):
        layer, _ = _layers("int8", table.astype(np.int32), ps,
                           _pools("int8", b * pps + 4, kvh, ps, hd))
        paged_update(layer, kk, -kk, 0)
        outs.append(paged_attention(q, layer, torch.tensor([16, 12], dtype=torch.int32),
                                    window=window))
    assert torch.equal(outs[0], outs[1])


def test_stale_pages_never_leak():
    """Pool rows no slot wrote (unreferenced pages, rows past the frontier)
    full of garbage do not change the output: their weight is exactly 0."""
    b, h, hd, ps = 1, 2, 16, 8
    r = np.random.RandomState(7)
    table = np.asarray([[5, 1, 3]], np.int32)
    kk = torch.as_tensor(r.randn(b, h, 10, hd).astype(np.float32))
    q = torch.as_tensor(r.randn(b, h, 1, hd).astype(np.float32))
    clean, _ = _layers("f32", table, ps, _pools("f32", 8, h, ps, hd))
    dirty, _ = _layers("f32", table, ps, _pools("f32", 8, h, ps, hd))
    dirty.kp.fill_(777.0)
    dirty.vp.fill_(-777.0)
    for layer in (clean, dirty):
        paged_update(layer, kk, -kk, 0)
    assert torch.equal(paged_attention(q, clean, 9), paged_attention(q, dirty, 9))


@pytest.mark.parametrize("case", ["cycle", "refcounts", "exhaustion"])
def test_page_allocator(case):
    a = PageAllocator(4)
    if case == "cycle":
        p = a.alloc(3)
        assert len(set(p)) == 3 and a.pages_free == 1
        a.free(p[:2])
        assert a.pages_free == 3
        with pytest.raises(RuntimeError, match="exhausted"):
            a.alloc(4)
        a.alloc(3)
        assert a.pages_free == 0
    elif case == "refcounts":
        p = a.alloc(2)
        a.share(p)
        a.free(p)
        assert a.pages_free == 2  # still referenced once
        a.free(p)
        assert a.pages_free == 4
        with pytest.raises(RuntimeError, match="double free"):
            a.free(p)
        with pytest.raises(RuntimeError, match="not live"):
            a.share(p)
    else:
        a.alloc(4)
        with pytest.raises(RuntimeError):
            a.alloc(1)
        assert a.pages_free == 0


@pytest.fixture(scope="module")
def lm():
    """The port's LM (f32, int8 weights) with seeded variables, and the JAX
    package's LM serving the same converted tree."""
    jqc = j_default_qconfig(8, 8, init_batches=1)
    jm = JLM(vocab=64, dim=32, depth=2, num_heads=4, qconfig=jqc, max_len=24)
    tm = QuantTransformerLM(64, 32, 2, 4, default_qconfig(8, 8).for_serving("none"),
                            max_len=24, device="cpu")
    variables = torch_tree_to_np(init_variables(tm, seed=0))
    interop.load_variables(tm, variables)
    sv = j_convert(jax.tree.map(jnp.asarray, variables), jqc)
    jsm = dataclasses.replace(jm, qconfig=jqc.for_serving("none", "xla"))
    toks = np.random.RandomState(0).randint(0, 64, size=(2, 12)).astype(np.int32)
    return tm, jsm, sv, toks


@pytest.mark.parametrize("layout", ["float32", "int8", "int4"])
def test_lm_paged_equals_dense(lm, layout):
    """Prefill then per-slot decode across a page boundary: the paged cache
    (linear table and a scrambled one) gives the dense cache's logits bit
    for bit."""
    tm, _, _, toks = lm
    dt = getattr(torch, layout, layout)
    tt = torch.as_tensor(toks)
    linear = init_paged_cache(tm, 2, page_size=4, dtype=dt)
    perm = np.random.RandomState(3).permutation(12).reshape(2, 6).astype(np.int32)
    scrambled = with_table(init_paged_cache(tm, 2, page_size=4, dtype=dt),
                           torch.as_tensor(perm))
    outs = []
    for cache in (init_kv_cache(tm, 2, dtype=dt), linear, scrambled):
        last, cache, _ = prefill(tm, tt[:, :6], cache=cache)
        steps = [last]
        idx = torch.tensor([6, 6], dtype=torch.int32)
        with torch.no_grad():
            for s in range(3):  # crosses the page boundary at position 8
                logits, cache = tm(tt[:, 6 + s:7 + s], cache=cache, cache_index=idx)
                steps.append(logits[:, 0])
                idx = idx + 1
        outs.append(torch.stack(steps))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_lm_paged_logits_match_jax(lm):
    """Nine tokens written through a scrambled table at per-slot index 0
    (three pages of 4): every position's logits."""
    tm, jsm, sv, toks = lm
    perm = np.random.RandomState(4).permutation(12).reshape(2, 6).astype(np.int32)
    jcache = j_init_paged_cache(jsm, 2, page_size=4, table=perm)
    want, _ = jax.jit(lambda v, t, c: jsm.apply(v, t, cache=c, cache_index=jnp.zeros(
        (2,), jnp.int32)))(sv, jnp.asarray(toks[:, :9]), jcache)
    tcache = init_paged_cache(tm, 2, page_size=4, table=perm)
    with torch.no_grad():
        got, _ = tm(torch.as_tensor(toks[:, :9]), cache=tcache,
                    cache_index=torch.zeros((2,), dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_paged_cache_validation(lm):
    tm, _, _, _ = lm
    with pytest.raises(ValueError, match="table shape"):
        init_paged_cache(tm, 2, page_size=4, table=np.zeros((3, 6), np.int32))
    with pytest.raises(ValueError, match="cannot back"):
        init_paged_cache(tm, 2, page_size=4, num_pages=3)
    with pytest.raises(ValueError, match="even head_dim"):
        init_paged_cache(QuantTransformerLM(8, 6, 1, 2, default_qconfig(8, 8).for_serving(),
                                            device="cpu"), 1, page_size=4, dtype="int4")
    cache = init_paged_cache(tm, 1, page_size=4, max_len=8)  # L = 8
    with pytest.raises(ValueError, match="cache length 8"):
        tm(torch.zeros((1, 2), dtype=torch.int32), cache=cache, cache_index=7)
