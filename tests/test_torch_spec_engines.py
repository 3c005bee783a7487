"""The port's speculative engines and ``ServingEngine`` on the CPU, held to
the port's own B = 1 greedy decode and plain calls (mirrors jaxlsq's
``tests/test_decode.py`` speculative-engine cases,
``tests/test_paged_spec_engine.py`` and ``tests/test_engine.py``; jaxlsq's
threaded engines are not run here).

* ``SpeculativeDecodeEngine`` and ``PagedSpeculativeDecodeEngine``: staggered
  requests with a weak draft (rejections) and a perfect one, chunked
  admission, prefix reuse through both models' caches, eos retirement, the
  sampled rounds, warm-up, the headroom and one-table checks, page
  reservation with the verify headroom, and backpressure; every greedy
  request equals its own ``make_generate`` at B = 1 token for token.
* ``ServingEngine``: results, continuous batching, shape validation, error
  propagation, close and its races, and a converted conv net served.
"""

import threading
import time

import numpy as np
import pytest
import torch

from jaxlsq_torch import interop
from jaxlsq_torch.models import (QuantCNN, QuantTransformerLM, default_qconfig,
                                 disable_observer, init_variables)
from jaxlsq_torch.parallel import make_train_step
from jaxlsq_torch.serve import (PagedSpeculativeDecodeEngine, Prefix, ServingEngine,
                                SpeculativeDecodeEngine, make_generate)

VOCAB, MAXLEN, PS = 64, 32, 4
ENGINES = {
    "dense": lambda t, d, **kw: SpeculativeDecodeEngine(t, d, **kw),
    "paged": lambda t, d, **kw: PagedSpeculativeDecodeEngine(
        t, d, num_pages=kw.pop("num_pages", 16), page_size=PS, **kw),
}


def _served(dim, depth, heads, seed, max_len=MAXLEN):
    m = QuantTransformerLM(VOCAB, dim, depth, heads,
                           default_qconfig(8, 8).for_serving("none"),
                           max_len=max_len, device="cpu")
    interop.load_variables(m, init_variables(m, seed=seed))
    return m


@pytest.fixture(scope="module")
def pair():
    return _served(32, 2, 4, seed=2), _served(16, 1, 2, seed=3)


_GREEDY = {}


def _greedy(model, prompt, n_new):
    key = (id(model), tuple(int(x) for x in prompt), n_new)
    if key not in _GREEDY:
        _GREEDY[key] = make_generate(model, len(prompt), n_new)(
            torch.as_tensor(np.asarray(prompt))[None])[0].numpy()
    return _GREEDY[key]


def _run(eng, reqs, stagger=True, prefix=None):
    futs = []
    for i, (p, n) in enumerate(reqs):
        futs.append(eng.submit(p, n, prefix=prefix))
        if stagger and i % 2:
            time.sleep(0.02)  # land mid-flight of earlier requests
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("kind", sorted(ENGINES))
@pytest.mark.parametrize("perfect", [False, True])
def test_staggered_requests_equal_greedy(pair, kind, perfect):
    target, draft = pair
    r = np.random.RandomState(41)
    reqs = [(r.randint(0, VOCAB, size=r.randint(2, 7)), int(r.randint(2, 8)))
            for _ in range(6)]
    with ENGINES[kind](target, target if perfect else draft, max_batch=3,
                       prompt_buckets=(4, 8), k=3) as eng:
        outs = _run(eng, reqs)
        stats = dict(eng.stats)
    assert stats["requests"] == len(reqs) and stats["rounds"] >= 1
    assert stats["accepted_tokens"] == sum(n - 1 for _, n in reqs)
    for (p, n), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _greedy(target, p, n))


def test_perfect_draft_accepts_k_plus_one(pair):
    target, _ = pair
    p = np.random.RandomState(42).randint(0, VOCAB, size=5)
    with SpeculativeDecodeEngine(target, target, max_batch=2, prompt_buckets=(8,),
                                 k=4) as eng:
        out = eng.submit(p, 9).result(timeout=120)
        rounds = eng.stats["rounds"]
    np.testing.assert_array_equal(out, _greedy(target, p, 9))
    assert rounds <= 2  # 8 tokens after the first at k + 1 = 5 a round


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_multichunk_admission_and_prefix_equal_greedy(pair, kind):
    """Prompts chunked 3 tokens at a time through both models, and suffixes
    on a registered 6-token prefix (held for both models)."""
    target, draft = pair
    r = np.random.RandomState(81)
    reqs = [(r.randint(0, VOCAB, size=r.randint(2, 8)), int(r.randint(2, 6)))
            for _ in range(4)]
    pref = r.randint(0, VOCAB, size=6)
    with ENGINES[kind](target, draft, max_batch=2, prompt_buckets=(4, 8), k=2,
                       prefill_chunk=3) as eng:
        outs = _run(eng, reqs)
        h = eng.register_prefix(pref)
        pouts = _run(eng, [(p[:4], n) for p, n in reqs], prefix=h)
        stats = dict(eng.stats)
    assert stats["admission_chunks"] > stats["requests"]
    assert stats["prefix_tokens_reused" if kind == "dense" else
                 "prefix_pages_shared"] > 0
    for (p, n), got, pgot in zip(reqs, outs, pouts):
        np.testing.assert_array_equal(got, _greedy(target, p, n))
        np.testing.assert_array_equal(pgot, _greedy(target, np.concatenate([pref, p[:4]]), n))


def test_prefix_checks_every_models_cache(pair):
    target, draft = pair
    with SpeculativeDecodeEngine(target, draft, max_batch=2, prompt_buckets=(8,),
                                 k=2) as eng:
        h = eng.register_prefix(np.arange(5))
        assert len(h.caches) == 2
        bad = Prefix(h.tokens, h.length,
                     (h.caches[0], tuple((k.to(torch.bfloat16), v) for k, v in h.caches[1])),
                     owner=eng)
        with pytest.raises(ValueError, match="layout"):
            eng.submit(np.arange(3), 2, prefix=bad)
        with pytest.raises(ValueError, match="register_prefix"):
            eng.submit(np.arange(3), 2, prefix=Prefix(h.tokens, h.length, h.caches[:1],
                                                      owner=eng))


def test_eos_retires_early(pair):
    target, draft = pair
    p = np.random.RandomState(44).randint(0, VOCAB, size=5)
    full = _greedy(target, p, 9)
    eos = int(full[3])
    stop = int(np.argmax(full == eos)) + 1
    with SpeculativeDecodeEngine(target, draft, max_batch=2, prompt_buckets=(8,), k=3,
                                 eos_id=eos) as eng:
        out = eng.submit(p, 9).result(timeout=120)
    np.testing.assert_array_equal(out, full[:stop])
    assert out[-1] == eos


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_sampled_engine_completes(pair, kind):
    target, draft = pair
    r = np.random.RandomState(60)
    with ENGINES[kind](target, draft, max_batch=2, prompt_buckets=(4, 8), k=3,
                       temperature=0.9, top_k=8,
                       rng=torch.Generator().manual_seed(21)) as eng:
        reqs = [(r.randint(0, VOCAB, size=r.randint(2, 7)), int(r.randint(2, 7)))
                for _ in range(5)]
        outs = _run(eng, reqs, stagger=False)
        assert eng.stats["requests"] == 5
    for (_, n), out in zip(reqs, outs):
        assert out.dtype == np.int32 and out.shape == (n,)
        assert np.all((out >= 0) & (out < VOCAB))


def test_engine_checks(pair):
    target, draft = pair
    with pytest.raises(ValueError, match="rng"):
        SpeculativeDecodeEngine(target, draft, temperature=0.5)
    with pytest.raises(ValueError, match="k .* too large"):
        SpeculativeDecodeEngine(target, draft, max_batch=2, prompt_buckets=(8,), k=30)
    with pytest.raises(ValueError, match="max_len must match"):
        PagedSpeculativeDecodeEngine(target, _served(16, 1, 2, 3, max_len=16),
                                     num_pages=8, page_size=PS, k=2)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeDecodeEngine(target, QuantTransformerLM(
            16, 16, 1, 2, default_qconfig(8, 8).for_serving("none"), device="cpu"))
    with SpeculativeDecodeEngine(target, draft, max_batch=2, prompt_buckets=(8,),
                                 k=4) as eng:
        with pytest.raises(ValueError, match="headroom"):
            eng.submit(np.zeros(8, np.int32), 25)  # 8 + 25 + 5 > 32
        eng.submit(np.zeros(8, np.int32), 19).result(timeout=120)  # 8 + 19 + 5 = 32
    eng2 = SpeculativeDecodeEngine(target, draft, max_batch=2, prompt_buckets=(8,))
    eng2.close()
    with pytest.raises(RuntimeError, match="SpeculativeDecodeEngine is closed"):
        eng2.submit(np.zeros(3, np.int32), 2)


def test_paged_reservation_includes_verify_headroom(pair):
    target, draft = pair
    with PagedSpeculativeDecodeEngine(target, draft, num_pages=2, page_size=PS,
                                      max_batch=1, prompt_buckets=(4,), k=2) as eng:
        # 4 + 4 + (k + 1) = 11 positions: 3 pages > a pool of 2
        with pytest.raises(ValueError, match="pages"):
            eng.submit(np.zeros(4, np.int32), 4)
        assert eng._pages_needed(4, 4, None) == 3


def test_paged_backpressure_defers_and_completes(pair):
    target, draft = pair
    r = np.random.RandomState(8)
    reqs = [(r.randint(0, VOCAB, size=4), 4) for _ in range(4)]
    with PagedSpeculativeDecodeEngine(target, draft, num_pages=4, page_size=PS,
                                      max_batch=3, prompt_buckets=(4,), k=2) as eng:
        outs = _run(eng, reqs, stagger=False)
        deferred = eng.stats["admissions_deferred"]
        deadline = time.time() + 60
        while eng._alloc.pages_free != 4 and time.time() < deadline:
            time.sleep(0.01)
        free_after = eng._alloc.pages_free
    assert deferred > 0 and free_after == 4
    for (p, n), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _greedy(target, p, n))


def test_paged_one_table_for_both_pools(pair):
    target, draft = pair
    with PagedSpeculativeDecodeEngine(target, draft, num_pages=8, page_size=PS,
                                      max_batch=2, prompt_buckets=(4,), k=2) as eng:
        tables = {id(layer.table) for layer in eng._layers()}
        assert tables == {id(eng._dev_table)}
        assert len(eng._layers()) == target.depth + draft.depth


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_warmup_then_exact(pair, kind):
    target, draft = pair
    p = np.random.RandomState(9).randint(0, VOCAB, size=3)
    with ENGINES[kind](target, draft, max_batch=2, prompt_buckets=(4,), k=2) as eng:
        eng.warmup()
        out = eng.submit(p, 4).result(timeout=120)
    np.testing.assert_array_equal(out, _greedy(target, p, 4))


def test_qat_mode_pair_equals_greedy():
    """The engine over QAT-mode models (observers off): the cache branch
    with a per-slot index."""
    qc = default_qconfig(8, 8, init_batches=1)
    target = disable_observer(QuantTransformerLM(VOCAB, 32, 2, 4, qc, max_len=MAXLEN,
                                                 device="cpu", seed=4))
    draft = disable_observer(QuantTransformerLM(VOCAB, 16, 1, 2, qc, max_len=MAXLEN,
                                                device="cpu", seed=5))
    r = np.random.RandomState(10)
    reqs = [(r.randint(0, VOCAB, size=r.randint(2, 7)), int(r.randint(2, 7)))
            for _ in range(3)]
    with SpeculativeDecodeEngine(target, draft, max_batch=2, prompt_buckets=(8,),
                                 k=2) as eng:
        outs = _run(eng, reqs, stagger=False)
    for (p, n), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _greedy(target, p, n))


# -------------------------------------------------------------- ServingEngine

def test_serving_engine_results():
    with ServingEngine(lambda x: 2.0 * x + 1.0, (8,), max_batch=4, device="cpu") as eng:
        xs = [np.full((8,), float(i), np.float32) for i in range(11)]
        futs = eng.submit_many(xs)
        for i, fut in enumerate(futs):
            np.testing.assert_allclose(fut.result(timeout=30), 2.0 * xs[i] + 1.0)
    assert eng.stats["requests"] == 11
    assert eng.stats["batches"] >= 3
    assert sum(eng.stats["batch_sizes"]) == 11
    assert eng.stats["padded_examples"] == sum(
        eng._bucket_for(n) - n for n in eng.stats["batch_sizes"])


def test_serving_engine_batches_continuously():
    w = torch.ones(16, 16)
    with ServingEngine(lambda x: torch.tanh(x @ w), (16,), max_batch=32,
                       device="cpu") as eng:
        eng.warmup()
        futs = eng.submit_many([np.random.randn(16).astype(np.float32) for _ in range(64)])
        [f.result(timeout=30) for f in futs]
    assert eng.stats["requests"] == 64
    assert eng.stats["batches"] < 64


def test_serving_engine_shape_validation():
    with ServingEngine(lambda x: x, (4,), device="cpu") as eng:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((5,), np.float32))


def test_serving_engine_error_reaches_every_waiter():
    def g(x):
        raise RuntimeError("boom")

    with ServingEngine(g, (4,), device="cpu") as eng:
        futs = eng.submit_many([np.zeros((4,), np.float32)] * 3)
        for fut in futs:
            with pytest.raises(RuntimeError, match="boom"):
                fut.result(timeout=30)


def test_serving_engine_submit_after_close_raises():
    eng = ServingEngine(lambda x: x, (2,), device="cpu")
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.zeros((2,), np.float32))


def test_serving_engine_close_flushes_pending():
    eng = ServingEngine(lambda x: x + 1.0, (2,), max_batch=2, device="cpu")
    futs = eng.submit_many([np.full((2,), float(i), np.float32) for i in range(6)])
    eng.close()
    for i, fut in enumerate(futs):
        np.testing.assert_allclose(fut.result(timeout=30), i + 1.0)


def test_serving_engine_close_submit_race_never_hangs():
    futures = []

    def hammer(engine, stop):
        while not stop.is_set():
            try:
                futures.append(engine.submit(np.ones((3,), np.float32)))
            except RuntimeError:
                return

    for _ in range(5):
        eng = ServingEngine(lambda x: x * 2.0, (3,), max_batch=4, max_wait_ms=0.5,
                            device="cpu")
        stop = threading.Event()
        t = threading.Thread(target=hammer, args=(eng, stop))
        t.start()
        time.sleep(0.02)
        eng.close()
        stop.set()
        t.join(timeout=5)
        assert not t.is_alive()
    for f in futures:
        np.testing.assert_allclose(f.result(timeout=10), 2.0)


def test_serving_engine_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(lambda x: x, (2,))


def test_serving_engine_serves_converted_conv_net():
    """A narrow ``QuantCNN`` after three QAT steps, converted and served at
    w8a8 (static activations): each request equals the served model's own
    call on the batch."""
    qc = default_qconfig(8, 8, init_batches=1)
    model = QuantCNN(4, qc, widths=(8,), image_size=8, device="cpu", seed=0)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                           jit=False)
    r = np.random.RandomState(0)
    for _ in range(3):
        step({"image": torch.as_tensor(r.randn(4, 3, 8, 8).astype(np.float32)),
              "label": torch.as_tensor(r.randint(0, 4, size=4))})
    served = QuantCNN(4, qc.for_serving("static"), widths=(8,), image_size=8,
                      device="cpu")
    interop.load_variables(served, interop.qat_variables(model))
    x = r.randn(5, 3, 8, 8).astype(np.float32)
    with torch.no_grad():
        want = served(torch.as_tensor(x)).numpy()
    with ServingEngine(served, (3, 8, 8), max_batch=8, device="cpu") as eng:
        got = np.stack([f.result(timeout=60) for f in eng.submit_many(list(x))])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
