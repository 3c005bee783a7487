"""jaxlsq_torch ``PagedDecodeEngine`` (continuous batching over block-table
page pools) and the prefix caching it shares with ``DecodeEngine``:

* staggered and lockstep request streams give the port's dense
  ``DecodeEngine`` tokens exactly (f32 and int8 pools; paged and dense
  caches hold the same bytes), with the pool underprovisioned so admissions
  defer, strictly FIFO;
* a registered prefix is shared with no copy (refcounts, not pages, go up;
  a partial trailing page is copied), and gives the concatenated prompt's
  tokens, as ``DecodeEngine.register_prefix`` does;
* eos retirement and a sliding window free pages; a request that could never
  fit the pool and a prefix from another engine are rejected;
* greedy tokens equal the JAX package's ``PagedDecodeEngine`` and
  ``DecodeEngine.register_prefix`` on the same converted variables (f32).

Every wait on a Future has a timeout, and page counts are polled against a
deadline, so a stuck dispatcher fails the test in seconds.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as j_default_qconfig
from jaxlsq.serve import DecodeEngine as JDecodeEngine
from jaxlsq.serve import PagedDecodeEngine as JPagedDecodeEngine
from jaxlsq.serve import convert as j_convert

from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
from jaxlsq_torch.serve import DecodeEngine, PagedDecodeEngine, prefill

from _torch_port import torch_tree_to_np

VOCAB, DIM, DEPTH, HEADS, MAXLEN = 64, 32, 2, 4, 16
PS = 4  # page_size: MAXLEN / PS = 4 logical pages a slot
WAIT = 60  # seconds a Future or a page count may take


def _lm(seed, **kw):
    m = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS,
                           default_qconfig(8, 8).for_serving("none"),
                           max_len=MAXLEN, device="cpu", **kw)
    variables = init_variables(m, seed=seed)
    interop.load_variables(m, variables)
    return m, variables


@pytest.fixture(scope="module")
def model():
    return _lm(2)[0]


def _results(futs):
    return [f.result(timeout=WAIT) for f in futs]


def _wait_pages(eng, want):
    """Pages return one dispatcher beat after the Future resolves: poll."""
    deadline = time.time() + WAIT
    while eng._alloc.pages_free != want and time.time() < deadline:
        time.sleep(0.005)
    return eng._alloc.pages_free


def _lockstep(model, prompt, n_new, cache_dtype=torch.float32):
    last, cache, idx = prefill(model, torch.as_tensor(prompt)[None],
                               cache_dtype=cache_dtype)
    tok = torch.argmax(last, -1).to(torch.int32)
    toks = [int(tok[0])]
    with torch.no_grad():
        for _ in range(n_new - 1):
            logits, cache = model(tok[:, None], cache=cache, cache_index=idx)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
            toks.append(int(tok[0]))
            idx += 1
    return np.asarray(toks, np.int32)


class _Recording(PagedDecodeEngine):
    """Records the order in which requests are admitted."""

    def _start_admit(self, req, slot):
        self.admitted = getattr(self, "admitted", []) + [int(req.prompt[0])]
        super()._start_admit(req, slot)


@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("stagger", [True, False])
def test_paged_engine_equals_dense_engine(model, cache, stagger):
    """9 pages back 1-2 requests of up to 3 pages at a time across 3 slots:
    admissions defer, FIFO, and the tokens equal the dense engine's."""
    dt = getattr(torch, cache)
    r = np.random.RandomState(6)
    reqs = [(np.concatenate([[i], r.randint(0, VOCAB, size=r.randint(1, 7))]),
             int(r.randint(2, 6))) for i in range(7)]

    def run(eng):
        futs = []
        for i, (p, n) in enumerate(reqs):
            futs.append(eng.submit(p, n))
            if stagger and i % 2 == 0:
                time.sleep(0.01)  # land mid-flight of earlier requests
        return _results(futs)

    with DecodeEngine(model, max_batch=3, prompt_buckets=(4, 8), prefill_chunk=2,
                      cache_dtype=dt) as eng:
        want = run(eng)
    with _Recording(model, num_pages=5, page_size=PS, max_batch=3,
                    prompt_buckets=(4, 8), prefill_chunk=2, cache_dtype=dt) as eng:
        got = run(eng)
        stats = dict(eng.stats)
        free_after = _wait_pages(eng, 5)
        admitted = eng.admitted
    assert stats["requests"] == len(reqs) and stats["admissions_deferred"] > 0
    assert admitted == list(range(len(reqs)))  # FIFO, no request jumped the head
    assert free_after == 5  # every retired request gave its pages back
    for (p, n), a, b in zip(reqs, want, got):
        np.testing.assert_array_equal(b, a)
        if not stagger:
            np.testing.assert_array_equal(b, _lockstep(model, p, n, dt))


@pytest.mark.parametrize("plen", [8, 6])  # 2 full pages / 1 full + a partial
def test_prefix_shared_without_copy(model, plen):
    r = np.random.RandomState(8)
    prefix = r.randint(0, VOCAB, size=plen)
    suffixes = [(r.randint(0, VOCAB, size=2), 3) for _ in range(3)]
    with PagedDecodeEngine(model, num_pages=12, page_size=PS, max_batch=3,
                           prompt_buckets=(4,)) as eng:
        h = eng.register_prefix(prefix)
        assert len(h.pages) == -(-plen // PS)
        free0 = eng._alloc.pages_free
        got = _results([eng.submit(s, n, prefix=h) for s, n in suffixes])
        shared = eng.stats["prefix_pages_shared"]
        free_after = _wait_pages(eng, free0)
        # the handle still holds one reference to each of its pages
        assert all(eng._alloc._refs[p] == 1 for p in h.pages)
    with DecodeEngine(model, max_batch=3, prompt_buckets=(4,)) as eng:
        hd = eng.register_prefix(prefix)
        dense = _results([eng.submit(s, n, prefix=hd) for s, n in suffixes])
    assert shared == 3 * (plen // PS)  # shared, not copied
    assert free_after == free0
    for (s, n), a, b in zip(suffixes, got, dense):
        want = _lockstep(model, np.concatenate([prefix, s]), n)
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)


def test_prefix_longer_than_bucket_and_rejections(model):
    """The dense engine's prefix may outrun the largest bucket; handles do
    not cross engines or kinds, and the page budget binds at submit."""
    r = np.random.RandomState(9)
    prefix, suffix = r.randint(0, VOCAB, size=9), r.randint(0, VOCAB, size=2)
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4,)) as a, \
            PagedDecodeEngine(model, num_pages=6, page_size=PS, max_batch=2,
                              prompt_buckets=(4,)) as b:
        ha = a.register_prefix(prefix)
        out = a.submit(suffix, 3, prefix=ha).result(timeout=WAIT)
        np.testing.assert_array_equal(
            out, _lockstep(model, np.concatenate([prefix, suffix]), 3))
        with pytest.raises(ValueError, match="max_len"):
            a.submit(suffix, 6, prefix=ha)  # 9 + 2 + 6 > 16
        with pytest.raises(ValueError, match="PagedDecodeEngine"):
            b.submit(suffix, 2, prefix=ha)
        with pytest.raises(ValueError, match="register_prefix"):
            a.submit(suffix, 2, prefix=b.register_prefix(prefix[:4]))
        with pytest.raises(ValueError, match="must be < max_len"):
            a.register_prefix(np.zeros(MAXLEN, np.int32))
    with PagedDecodeEngine(model, num_pages=6, page_size=PS, max_batch=1,
                           prompt_buckets=(4,)) as c, \
            PagedDecodeEngine(model, num_pages=6, page_size=PS, max_batch=1,
                              prompt_buckets=(4,)) as d:
        h = c.register_prefix(np.zeros(4, np.int32))
        with pytest.raises(ValueError, match="different engine"):
            d.submit(np.zeros(2, np.int32), 2, prefix=h)


def test_rejects_pool_overflow(model):
    with PagedDecodeEngine(model, num_pages=2, page_size=PS, max_batch=2,
                           prompt_buckets=(4, 8)) as eng:
        with pytest.raises(ValueError, match="pages"):
            eng.submit(np.zeros(8, np.int32), 6)  # 4 pages > pool of 2
        out = eng.submit(np.zeros(4, np.int32), 2).result(timeout=WAIT)
        assert out.shape == (2,)
    with pytest.raises(ValueError, match="num_pages"):
        PagedDecodeEngine(model, num_pages=0, page_size=PS)


def test_eos_frees_pages(model):
    prompt = np.random.RandomState(10).randint(0, VOCAB, size=4)
    ref = _lockstep(model, prompt, 8)
    eos = int(ref[1])  # retire after two tokens
    with PagedDecodeEngine(model, num_pages=4, page_size=PS, max_batch=1,
                           prompt_buckets=(4,), eos_id=eos) as eng:
        out = eng.submit(prompt, 8).result(timeout=WAIT)
        assert _wait_pages(eng, 4) == 4
    np.testing.assert_array_equal(out, ref[:int(np.argmax(ref == eos)) + 1])


def test_window_frees_slid_pages():
    """A windowed model frees pages that slid out of every future query's
    window while the request runs, so a deferred request gets in before the
    long one retires; tokens as the windowed lockstep decode."""
    model, _ = _lm(4, attn_window=4)
    r = np.random.RandomState(12)
    long_p, short_p = r.randint(0, VOCAB, size=4), r.randint(0, VOCAB, size=2)
    with PagedDecodeEngine(model, num_pages=6, page_size=2, max_batch=2,
                           prompt_buckets=(4,)) as eng:
        fa = eng.submit(long_p, 8)   # 4 + 8 positions: the whole pool
        fb = eng.submit(short_p, 2)  # waits for slid-out pages
        outs = _results([fa, fb])
        freed = eng.stats["window_pages_freed"]
        assert _wait_pages(eng, 6) == 6
    assert freed >= 2
    np.testing.assert_array_equal(outs[0], _lockstep(model, long_p, 8))
    np.testing.assert_array_equal(outs[1], _lockstep(model, short_p, 2))


def test_warmup_keeps_tokens(model):
    p = np.random.RandomState(11).randint(0, VOCAB, size=5)
    with PagedDecodeEngine(model, num_pages=9, page_size=PS, max_batch=3,
                           prompt_buckets=(4, 8)) as eng:
        eng.warmup()
        out = eng.submit(p, 4).result(timeout=WAIT)
    np.testing.assert_array_equal(out, _lockstep(model, p, 4))


def test_greedy_tokens_equal_jax_engines():
    """The JAX package's PagedDecodeEngine and DecodeEngine.register_prefix
    on the same converted variables (f32 caches): the same greedy tokens."""
    tm, variables = _lm(5)
    jqc = j_default_qconfig(8, 8, init_batches=1)
    jm = JLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
             qconfig=jqc.for_serving("none", "xla"), max_len=MAXLEN)
    sv = j_convert(jax.tree.map(jnp.asarray, torch_tree_to_np(variables)), jqc)
    r = np.random.RandomState(13)
    prefix = r.randint(0, VOCAB, size=6)
    suffixes = [(r.randint(0, VOCAB, size=r.randint(1, 4)), 3) for _ in range(3)]
    outs = {}
    for name, j_eng, t_eng in (
            ("paged", JPagedDecodeEngine(jm, sv, num_pages=10, page_size=PS,
                                         max_batch=2, prompt_buckets=(4,)),
             PagedDecodeEngine(tm, num_pages=10, page_size=PS, max_batch=2,
                               prompt_buckets=(4,))),
            ("dense", JDecodeEngine(jm, sv, max_batch=2, prompt_buckets=(4,)),
             DecodeEngine(tm, max_batch=2, prompt_buckets=(4,)))):
        with j_eng, t_eng:
            jh, th = j_eng.register_prefix(prefix), t_eng.register_prefix(prefix)
            outs[name] = (_results([j_eng.submit(s, n, prefix=jh) for s, n in suffixes]),
                          _results([t_eng.submit(s, n, prefix=th) for s, n in suffixes]))
    for name, (want, got) in outs.items():
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a, err_msg=name)
