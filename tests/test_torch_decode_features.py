"""The port's decode features against jaxlsq on the same variables: the QAT
LM's cache branch, ``make_beam_search`` and ``make_speculative_generate``
(greedy and sampled), and the speculative-decoding lab's Markov corpus.

The variables are drawn by the port (``QuantTransformerLM(seed=...)``, one
eval forward feeding the activation observers as flax's ``init`` does) and
carried into jaxlsq's tree through ``interop.qat_variables`` on the structure
of ``jax.eval_shape(model.init)`` (a jitted ``init`` would cost seconds of
compile a model).  Each jaxlsq program is compiled once.

Tolerances: logits and beam scores 1e-4 (f32 on both sides; sums in another
order and LayerNorm's variance formula); tokens exact.  The sampled
speculative generator is held to the port's plain sampled ``make_generate``
in distribution: per-position token histograms over 256 draws a side lie
within a total variation of 0.25 (two N = 256 draws of one V = 16
distribution differ by at most ~0.14 on average; the draft's own sampling
lies further than the bound, as a draft-shaped bias would).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as j_default_qconfig
from jaxlsq.serve import prefill as j_prefill
from jaxlsq.serve.decode import make_beam_search as j_make_beam_search
from jaxlsq.serve.decode import make_speculative_generate as j_make_spec

from jaxlsq_torch import interop
from jaxlsq_torch.lab import speculative_decode as lab
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, disable_observer
from jaxlsq_torch.serve import (make_beam_search, make_generate, make_sampler,
                                make_speculative_generate, prefill)

VOCAB, MAXLEN = 64, 32
TARGET = dict(dim=32, depth=2, num_heads=4)
DRAFT = dict(dim=16, depth=1, num_heads=2)
TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_lm(vocab, dim, depth, num_heads, seed, observer=False, max_len=MAXLEN,
             **kw):
    """A seeded QAT LM whose activation observers saw one eval batch; with
    ``observer`` False they are then switched off."""
    m = QuantTransformerLM(vocab, dim, depth, num_heads,
                           default_qconfig(8, 8, init_batches=1), max_len=max_len,
                           device="cpu", seed=seed, **kw)
    m.eval()
    with torch.no_grad():
        m(torch.as_tensor(np.random.RandomState(seed).randint(0, vocab, (2, 8))))
    m.train()
    if not observer:
        disable_observer(m)
    return m


def _jax_twin(model, **kw):
    """jaxlsq's LM of ``model``'s shape and its variables, carried over."""
    jm = JLM(vocab=model.vocab, dim=model.dim, depth=model.depth,
             num_heads=model.num_heads, qconfig=j_default_qconfig(8, 8, init_batches=1),
             max_len=model.max_len, **kw)
    tmpl = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32),
                                          training=False))
    tree = interop.qat_variables(model)

    def leaf(path, s):
        node = tree
        for k in path:
            node = node[getattr(k, "key", None) or getattr(k, "name")]
        return jnp.asarray(node, s.dtype)

    return jm, jax.tree_util.tree_map_with_path(leaf, tmpl)


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_state_equal(model, before):
    after = model.state_dict()
    assert before.keys() == after.keys()
    for k, v in before.items():
        assert torch.equal(v, after[k]), k


@pytest.fixture(scope="module")
def pair():
    """Port target and draft (observers off) and their jaxlsq twins."""
    target = _port_lm(VOCAB, **TARGET, seed=5)
    draft = _port_lm(VOCAB, **DRAFT, seed=6)
    jt, tvars = _jax_twin(target)
    jd, dvars = _jax_twin(draft)
    return target, draft, jt, tvars, jd, dvars


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(20).randint(0, VOCAB, (2, 12)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_decode():
    """jaxlsq's prefill of t0 tokens and its decode steps over the rest, as
    one jitted program per model: (B, 1 + T - t0, V) logits."""
    progs = {}

    def run(jm, variables, toks, t0):
        if jm not in progs:
            def fn(v, x):
                last, cache, idx = j_prefill(jm, v, x[:, :t0])

                def step(carry, tok):
                    cache, i = carry
                    logits, cache = jm.apply(v, tok[:, None], cache=cache, cache_index=i)
                    return (cache, i + 1), logits[:, 0]

                _, rest = jax.lax.scan(step, (cache, idx), x[:, t0:].T)
                return jnp.concatenate([last[:, None], jnp.moveaxis(rest, 0, 1)], 1)
            progs[jm] = jax.jit(fn)
        return np.asarray(progs[jm](variables, jnp.asarray(toks)))
    return run


def _port_decode(model, toks, t0, cache_dtype=torch.float32):
    tt = torch.as_tensor(toks)
    last, cache, idx = prefill(model, tt[:, :t0], cache_dtype=cache_dtype)
    outs = [last]
    with torch.no_grad():
        for t in range(t0, tt.shape[1]):
            logits, cache = model(tt[:, t:t + 1], cache=cache, cache_index=idx)
            outs.append(logits[:, 0])
            idx += 1
    return torch.stack(outs, 1).numpy()


# ------------------------------------------------------------ QAT cache branch

@pytest.mark.parametrize("observer", [False, True])
def test_qat_decode_logits_match_jax(pair, tokens, jax_decode, observer):
    """Prefill and decode steps of a QAT-mode LM: jaxlsq's ``prefill`` on QAT
    variables, observers off and on (an enabled observer re-derives each
    call's qparams, for that call only); no buffer or qparam changes."""
    target = pair[0] if not observer else _port_lm(VOCAB, **TARGET, seed=5, observer=True)
    jm, variables = (pair[2], pair[3]) if not observer else _jax_twin(target)
    before = _state(target)
    got = _port_decode(target, tokens, 4)
    np.testing.assert_allclose(got, jax_decode(jm, variables, tokens, 4), **TOL)
    make_generate(target, 6, 8)(torch.as_tensor(tokens[:, :6]))
    _assert_state_equal(target, before)
    assert target.training  # the caller's mode is kept


def test_qat_decode_matches_full_forward_rope_gqa_window():
    """With observers off, a QAT LM's decode logits equal its full eval
    forward, with rope positions, grouped kv heads and a window through the
    cache."""
    m = _port_lm(VOCAB, 32, 2, 4, seed=9, num_kv_heads=2, pos_embedding="rope",
                 attn_window=6)
    toks = np.random.RandomState(9).randint(0, VOCAB, (2, 12))
    m.eval()
    with torch.no_grad():
        full = m(torch.as_tensor(toks)).numpy()
    m.train()
    before = _state(m)
    np.testing.assert_allclose(_port_decode(m, toks, 5), full[:, 4:], **TOL)
    _assert_state_equal(m, before)


# ----------------------------------------------------------------- beam search

@pytest.mark.parametrize("cache", ["float32", "int8", "int4"])
def test_beam1_equals_greedy(pair, tokens, cache):
    target = pair[0]
    dt = cache if cache == "int4" else getattr(torch, cache)
    prompt = torch.as_tensor(tokens[:, :6])
    toks, scores = make_beam_search(target, 6, 8, beams=1, cache_dtype=dt)(prompt)
    assert torch.equal(toks, make_generate(target, 6, 8, cache_dtype=dt)(prompt))
    assert torch.isfinite(scores).all()


@pytest.mark.parametrize("eos,penalty", [(None, 0.0), (3, 0.6)])
def test_beam3_matches_jax(pair, tokens, eos, penalty):
    target, _, jt, tvars, _, _ = pair
    prompt = tokens[:, :6]
    jtoks, jscores = j_make_beam_search(jt, 6, 10, beams=3, eos_id=eos,
                                        length_penalty=penalty)(tvars, jnp.asarray(prompt))
    toks, scores = make_beam_search(target, 6, 10, beams=3, eos_id=eos,
                                    length_penalty=penalty)(torch.as_tensor(prompt))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **TOL)


@pytest.fixture(scope="module")
def tiny():
    return _port_lm(4, 16, 1, 2, seed=13, max_len=16)


def test_wide_beam_is_exhaustive(tiny):
    """vocab 4, 3 new tokens, 16 beams: step 1 keeps 4 prefixes (12 beams at
    -inf), step 2 all 16, step 3 ranks all 64, so the beam is exhaustive
    search: its best sequence is the brute-force best under one
    teacher-forced forward, and its score that sequence's joint log-prob."""
    prompt = np.random.RandomState(90).randint(0, 4, (2, 5))
    toks, scores = make_beam_search(tiny, 5, 3, beams=16)(torch.as_tensor(prompt))
    cands = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    tiny.eval()
    for b in range(2):
        seqs = np.concatenate([np.repeat(prompt[b][None], len(cands), 0), cands], 1)
        with torch.no_grad():
            logp = torch.log_softmax(tiny(torch.as_tensor(seqs)), -1).numpy()
        sc = sum(logp[np.arange(len(cands)), t - 1, cands[:, t - 5]] for t in range(5, 8))
        best = int(np.argmax(sc))
        np.testing.assert_array_equal(toks[b].numpy(), cands[best])
        assert abs(float(scores[b]) - sc[best]) < 1e-4
    tiny.train()


def test_eos_freezes_beam(tiny):
    prompt = torch.as_tensor(np.random.RandomState(90).randint(0, 4, (2, 5)))
    for eos in range(4):
        toks = make_beam_search(tiny, 5, 6, beams=3, eos_id=eos)(prompt)[0].numpy()
        for row in toks:
            hits = np.nonzero(row == eos)[0]
            if hits.size:
                assert np.all(row[hits[0]:] == eos), (eos, row)


def test_beam_search_checks():
    m = _port_lm(VOCAB, 16, 1, 2, seed=1)
    with pytest.raises(ValueError, match="beams"):
        make_beam_search(m, 4, 4, beams=0)
    with pytest.raises(ValueError, match="max_len"):
        make_beam_search(m, 20, 20)


# --------------------------------------------------------- speculative decode

def test_speculative_greedy_matches_jax_and_greedy(pair, tokens):
    target, draft, jt, tvars, jd, dvars = pair
    prompt = tokens[:1, :6]
    jtoks, jstats = j_make_spec(jt, jd, 6, 14, k=3, return_stats=True)(
        tvars, dvars, jnp.asarray(prompt))
    toks, stats = make_speculative_generate(target, draft, 6, 14, k=3,
                                            return_stats=True)(torch.as_tensor(prompt))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert stats["rounds"] == int(jstats["rounds"])
    assert stats["accepted_per_round"] == pytest.approx(float(jstats["accepted_per_round"]))
    assert stats["host_reads"] == stats["rounds"]
    assert torch.equal(toks, make_generate(target, 6, 14)(torch.as_tensor(prompt)))


@pytest.mark.parametrize("k", [1, 4])
def test_speculative_greedy_exact_any_k(pair, tokens, k):
    target, draft = pair[:2]
    prompt = torch.as_tensor(tokens[1:, :6])
    want = make_generate(target, 6, 12)(prompt)
    assert torch.equal(make_speculative_generate(target, draft, 6, 12, k=k)(prompt), want)
    toks, stats = make_speculative_generate(target, target, 6, 12, k=k,
                                            return_stats=True)(prompt)
    assert torch.equal(toks, want)
    assert stats["accepted_per_round"] == k + 1


def test_temperature0_is_greedy(pair, tokens):
    target, draft = pair[:2]
    prompt = torch.as_tensor(tokens[:1, :6])
    t0 = make_speculative_generate(target, draft, 6, 10, k=3, temperature=0.0)
    assert torch.equal(t0(prompt), make_speculative_generate(target, draft, 6, 10, k=3)(prompt))


def test_speculative_checks(pair):
    target, draft = pair[:2]
    with pytest.raises(ValueError, match="headroom"):
        make_speculative_generate(target, draft, 6, 25, k=4)
    with pytest.raises(ValueError, match="vocab"):
        make_speculative_generate(target, _port_lm(16, 16, 1, 2, seed=1), 6, 8)
    gen = make_speculative_generate(target, draft, 6, 8, k=2)
    with pytest.raises(ValueError, match="B=1"):
        gen(torch.zeros((2, 6), dtype=torch.int64))
    with pytest.raises(ValueError, match="Generator"):
        make_speculative_generate(target, draft, 6, 8, temperature=0.5)(
            torch.zeros((1, 6), dtype=torch.int64))


@pytest.fixture(scope="module")
def small_vocab():
    """A vocab-16 target and weak draft, one block each, converted to int8
    serving (a sampled call costs a third of the QAT models')."""
    def served(qat):
        m = QuantTransformerLM(16, qat.dim, qat.depth, qat.num_heads,
                               qat.qconfig.for_serving("none"), max_len=MAXLEN,
                               device="cpu")
        interop.load_variables(m, interop.qat_variables(qat))
        return m
    return (served(_port_lm(16, 32, 1, 4, seed=11)), served(_port_lm(16, 16, 1, 2, seed=12)),
            torch.as_tensor(np.random.RandomState(50).randint(0, 16, (1, 4))))


@pytest.mark.parametrize("k,top_k", [(3, None), (2, 5)])
def test_sampled_self_draft_accepts_every_proposal(small_vocab, k, top_k):
    """draft == target: p == q at every proposal, so every round accepts all
    k and draws the bonus: k + 1 tokens a round; tokens lie in the vocab."""
    target, _, prompt = small_vocab
    spec = make_speculative_generate(target, target, 4, 12, k=k, temperature=0.8,
                                     top_k=top_k, return_stats=True)
    for seed in range(3):
        toks, stats = spec(prompt, torch.Generator().manual_seed(100 + seed))
        assert toks.shape == (1, 12) and ((toks >= 0) & (toks < 16)).all()
        assert stats["accepted_per_round"] == k + 1


def test_sampled_weak_draft_keeps_target_distribution(small_vocab):
    """Accept/reject keeps the target's distribution whatever the draft:
    per-position histograms over 256 draws against 256 of the plain sampled
    ``make_generate`` lie within a total variation of 0.25 (two N = 256
    draws of one V = 16 distribution differ by at most ~0.14 on average, at
    the uniform one).  The draft's own sampling lies further than the bound
    from the target's, so a draft-shaped bias would fail."""
    target, draft, prompt = small_vocab
    n, n_new = 256, 4
    spec = make_speculative_generate(target, draft, 4, n_new, k=3, temperature=1.0)
    gen = torch.Generator().manual_seed(7)
    got = np.stack([spec(prompt, gen)[0].numpy() for _ in range(n)])

    def plain(model, seed):
        return make_generate(model, 4, n_new, sampled=True, logits_to_token=make_sampler(1.0))(
            prompt.repeat(n, 1), torch.Generator().manual_seed(seed)).numpy()

    def tv(a, b, pos):
        return 0.5 * np.abs(np.bincount(a[:, pos], minlength=16)
                            - np.bincount(b[:, pos], minlength=16)).sum() / n

    want, drafted = plain(target, 8), plain(draft, 9)
    for pos in range(n_new):
        assert tv(got, want, pos) < 0.25, pos
    assert max(tv(drafted, want, pos) for pos in range(n_new)) > 0.25


# ------------------------------------------------------------- Markov corpus

def test_markov_chain_on_jax_draws():
    """The lab's chain formula on jaxlsq's own start tokens and noise gives
    ``corpus_batch``'s tokens."""
    spec = importlib.util.spec_from_file_location(
        "_jax_speculative_decode", os.path.join(REPO, "examples", "speculative_decode.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    key = jax.random.key(3)
    want = np.asarray(ex.corpus_batch(key, 5))
    k1, k2 = jax.random.split(key)
    start = np.asarray(jax.random.randint(k1, (5, 1), 0, ex.VOCAB))
    noise = np.asarray(jax.random.randint(k2, (5, ex.T), 0, 10) == 0).astype(np.int32)
    got = lab.markov_chain(torch.from_numpy(start.copy()), torch.from_numpy(noise))
    assert (ex.VOCAB, ex.T) == (lab.VOCAB, lab.T)
    np.testing.assert_array_equal(got.numpy(), want)
    draws = lab.corpus_draws(4000, torch.Generator().manual_seed(0), "cpu")
    assert 0.08 < float(draws["noise"].float().mean()) < 0.12
