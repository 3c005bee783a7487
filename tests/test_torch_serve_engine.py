"""jaxlsq_torch ``DecodeEngine`` (token-level continuous batching): staggered
requests of different prompt and generation lengths join the running batch
at token boundaries and must reproduce the port's own lockstep greedy decode
exactly — across chunked admission, slot reuse and every cache carrier —
and the engine rejects what would write past the cache (mirrors the JAX
package's tests/test_decode.py engine tests)."""

import time

import numpy as np
import pytest
import torch

from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
from jaxlsq_torch.serve import DecodeEngine, make_sampler, prefill

VOCAB, DIM, DEPTH, HEADS, MAXLEN = 64, 32, 2, 4, 16


@pytest.fixture(scope="module")
def model():
    m = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS,
                           default_qconfig(8, 8).for_serving("none"),
                           max_len=MAXLEN, device="cpu")
    interop.load_variables(m, init_variables(m, seed=2))
    return m


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


def test_staggered_requests_match_lockstep(model):
    r = np.random.RandomState(6)
    reqs = [(r.randint(0, VOCAB, size=r.randint(2, 7)), int(r.randint(2, 6)))
            for _ in range(7)]
    with DecodeEngine(model, max_batch=3, prompt_buckets=(4, 8)) as eng:
        futs = []
        for i, (p, n) in enumerate(reqs):
            futs.append(eng.submit(p, n))
            if i % 2 == 0:
                time.sleep(0.02)  # land mid-flight of earlier requests
        outs = [f.result(timeout=120) for f in futs]
        stats = dict(eng.stats)
    assert stats["requests"] == len(reqs)
    for (p, n), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _lockstep(model, p, n))


@pytest.mark.parametrize("cache", ["bfloat16", "int8", "int4"])
def test_engine_cache_carriers_match_lockstep(model, cache):
    dt = cache if cache == "int4" else getattr(torch, cache)
    r = np.random.RandomState(70)
    reqs = [(r.randint(0, VOCAB, size=r.randint(2, 7)), int(r.randint(2, 6)))
            for _ in range(4)]
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4, 8),
                      cache_dtype=dt) as eng:
        outs = [f.result(timeout=120) for f in [eng.submit(p, n) for p, n in reqs]]
    for (p, n), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _lockstep(model, p, n, dt))


def test_multichunk_admission_matches_lockstep(model):
    r = np.random.RandomState(81)
    reqs = [(r.randint(0, VOCAB, size=r.randint(2, 9)), int(r.randint(2, 6)))
            for _ in range(5)]
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4, 8),
                      prefill_chunk=3) as eng:
        outs = [f.result(timeout=120) for f in [eng.submit(p, n) for p, n in reqs]]
        stats = dict(eng.stats)
    assert stats["admission_chunks"] > stats["requests"]
    for (p, n), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _lockstep(model, p, n))


def test_decode_steps_interleave_with_admission(model):
    r = np.random.RandomState(82)
    pa, pb = r.randint(0, VOCAB, size=2), r.randint(0, VOCAB, size=8)
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4, 8),
                      prefill_chunk=2) as eng:
        eng.warmup()
        a = eng.submit(pa, 10)
        b = eng.submit(pb, 2)
        ra, rb = a.result(timeout=120), b.result(timeout=120)
        interleave = list(eng.stats["admission_interleave"])
    assert interleave[-1] >= 8 // 2 - 1, interleave
    np.testing.assert_array_equal(ra, _lockstep(model, pa, 10))
    np.testing.assert_array_equal(rb, _lockstep(model, pb, 2))


def test_more_requests_than_slots(model):
    r = np.random.RandomState(7)
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4,)) as eng:
        futs = [eng.submit(r.randint(0, VOCAB, size=3), 3) for _ in range(6)]
        outs = [f.result(timeout=120) for f in futs]
    assert all(o.shape == (3,) and o.dtype == np.int32 for o in outs)


def test_rejects_oversized(model):
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4,)) as eng:
        with pytest.raises(ValueError, match="bucket"):
            eng.submit(np.zeros(9, np.int32), 2)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.zeros(4, np.int32), MAXLEN)
        with pytest.raises(ValueError, match="non-empty"):
            eng.submit(np.zeros(0, np.int32), 2)
    with DecodeEngine(model, max_batch=1, prompt_buckets=(4, 24),
                      prefill_chunk=None) as eng:
        # a 5-token prompt fits max_len, but its 24-row padded chunk would not
        with pytest.raises(ValueError, match="past max_len"):
            eng.submit(np.zeros(5, np.int32), 2)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.zeros(2, np.int32), 2)
    with pytest.raises(ValueError, match="prefill_chunk"):
        DecodeEngine(model, prefill_chunk=0)


def test_eos_retires_early(model):
    p = np.random.RandomState(9).randint(0, VOCAB, size=4)
    full = _lockstep(model, p, 6)
    eos = int(full[1])
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4,), eos_id=eos) as eng:
        out = eng.submit(p, 6).result(timeout=120)
    stop = int(np.argmax(full == eos)) + 1
    np.testing.assert_array_equal(out, full[:stop])


def test_sampled_engine(model):
    p = np.random.RandomState(10).randint(0, VOCAB, size=4)
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4,),
                      logits_to_token=make_sampler(1.0, top_k=16),
                      rng=torch.Generator().manual_seed(3)) as eng:
        outs = [eng.submit(p, 5).result(timeout=120) for _ in range(3)]
    assert all(o.shape == (5,) and ((o >= 0) & (o < VOCAB)).all() for o in outs)
    assert any((outs[0] != o).any() for o in outs[1:])


def test_warmup_does_not_perturb(model):
    p = np.random.RandomState(12).randint(0, VOCAB, size=4)
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4, 8)) as eng:
        cold = eng.submit(p, 4).result(timeout=120)
    with DecodeEngine(model, max_batch=2, prompt_buckets=(4, 8)) as eng:
        eng.warmup()
        warm = eng.submit(p, 4).result(timeout=120)
    np.testing.assert_array_equal(cold, warm)
