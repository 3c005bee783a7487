"""The serving slice end to end: the JAX package's ``QuantTransformerLM``
variables (from ``model.init``) are carried into the port through
``jaxlsq_torch.interop.load_variables``, and the two serve-mode models are
compared on the same tokens.

* full-forward and prefill-then-decode logits: atol = rtol = 1e-4 (f32 on
  both sides; the differences are summation order and LayerNorm's variance
  formula);
* ``make_generate`` greedy tokens: equal, for the f32 and bf16 caches;
* int8 / int4 caches: logits at 1e-3.  These caches quantize each new k/v
  row on write (round to the nearest step of a per-row abs-max scale), so a
  last-ulp difference upstream can move a value across a rounding midpoint
  and change one cache entry by a whole step; 1e-3 covers that, tokens are
  not compared.
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
from jaxlsq.serve import make_generate as j_make_generate
from jaxlsq.serve import prefill as j_prefill

from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
from jaxlsq_torch.serve import init_kv_cache, make_generate, prefill

from _torch_port import np_tree

VOCAB, DIM, DEPTH, HEADS, MAXLEN = 64, 32, 2, 4, 32
VARIANTS = {
    "base": {},
    "gqa_rope_window": {"num_kv_heads": 2, "pos_embedding": "rope",
                        "attn_window": 6},
}
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(wbits, act_mode, variant, seed=0):
    kw = VARIANTS[variant]
    jqc = j_default_qconfig(wbits, 8, init_batches=1)
    jm = JLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS, qconfig=jqc,
             max_len=MAXLEN, **kw)
    tokens = np.random.RandomState(seed).randint(0, VOCAB, (2, 12)).astype(np.int32)
    variables = jm.init(jax.random.key(seed), jnp.asarray(tokens), training=False)
    sv = j_convert(variables, jqc)
    jsm = dataclasses.replace(jm, qconfig=jqc.for_serving(act_mode, "xla"))
    tm = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS,
                            default_qconfig(wbits, 8).for_serving(act_mode),
                            max_len=MAXLEN, device="cpu", **kw)
    interop.load_variables(tm, np_tree(variables))
    return jsm, sv, tm, tokens, variables


def _jax_decode_logits(model, variables, tokens, t0, cache_dtype=jnp.float32):
    last, cache, idx = j_prefill(model, variables, jnp.asarray(tokens[:, :t0]),
                                 cache_dtype=cache_dtype)
    step = jax.jit(lambda v, tok, c, i: model.apply(v, tok, cache=c, cache_index=i))
    outs = [np.asarray(last)]
    for t in range(t0, tokens.shape[1]):
        logits, cache = step(variables, jnp.asarray(tokens[:, t:t + 1]), cache, idx)
        outs.append(np.asarray(logits[:, 0]))
        idx = idx + 1
    return np.stack(outs, 1)


def _port_decode_logits(model, tokens, t0, cache_dtype=torch.float32):
    tt = torch.as_tensor(tokens)
    last, cache, idx = prefill(model, tt[:, :t0], cache_dtype=cache_dtype)
    outs = [last.numpy()]
    with torch.no_grad():
        for t in range(t0, tokens.shape[1]):
            logits, cache = model(tt[:, t:t + 1], cache=cache, cache_index=idx)
            outs.append(logits[:, 0].numpy())
            idx += 1
    return np.stack(outs, 1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("act_mode", ["none", "static"])
@pytest.mark.parametrize("wbits", [8, 4])
def test_logits_match_jax(wbits, act_mode, variant):
    jsm, sv, tm, tokens, _ = _models(wbits, act_mode, variant)
    want = np.asarray(jsm.apply(sv, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(_port_decode_logits(tm, tokens, 5),
                               _jax_decode_logits(jsm, sv, tokens, 5), **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_greedy_tokens_equal_jax(cache, variant):
    jsm, sv, tm, tokens, _ = _models(8, "none", variant, seed=3)
    want = np.asarray(j_make_generate(jsm, 6, 10, cache_dtype=getattr(jnp, cache))(
        sv, jnp.asarray(tokens[:, :6])))
    got = make_generate(tm, 6, 10, cache_dtype=getattr(torch, cache))(
        torch.as_tensor(tokens[:, :6])).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("cache", ["int8", "int4"])
def test_quantized_cache_logits_match_jax(cache, variant):
    jsm, sv, tm, tokens, _ = _models(8, "none", variant, seed=4)
    jdt = jnp.int8 if cache == "int8" else "int4"
    tdt = torch.int8 if cache == "int8" else "int4"
    np.testing.assert_allclose(_port_decode_logits(tm, tokens, 5, tdt),
                               _jax_decode_logits(jsm, sv, tokens, 5, jdt),
                               rtol=1e-3, atol=1e-3)


def test_converted_tree_loads_like_qat_tree():
    """Loading the JAX-converted tree (PackedWeights as field dicts) gives the
    same model as loading the QAT tree through the port's convert."""
    jsm, sv, tm, tokens, _ = _models(4, "static", "base", seed=5)
    tm2 = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS,
                             default_qconfig(4, 8).for_serving("static"),
                             max_len=MAXLEN, device="cpu")
    interop.load_variables(tm2, np_tree(sv))
    for (name, a), (_, b) in zip(tm.state_dict().items(), tm2.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_load_rejects_missing_and_extra_variables():
    _, sv, tm, _, _ = _models(8, "none", "base", seed=6)
    tree = np_tree(sv)
    del tree["params"]["block0"]["ln1"]
    with pytest.raises(KeyError, match="ln1"):
        interop.load_variables(tm, tree)
    tree = np_tree(sv)
    tree["params"]["block1"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        interop.load_variables(tm, tree)


def test_per_slot_index_equals_scalar_index():
    """The per-slot (B,) cache_index path (continuous batching) gives the
    same logits as the scalar path when all slots sit at one position."""
    _, _, tm, tokens, _ = _models(8, "none", "gqa_rope_window", seed=7)
    tt = torch.as_tensor(tokens)
    _, c1, idx = prefill(tm, tt[:, :5])
    _, c2, _ = prefill(tm, tt[:, :5])
    with torch.no_grad():
        a, _ = tm(tt[:, 5:7], cache=c1, cache_index=idx)
        b, _ = tm(tt[:, 5:7], cache=c2,
                  cache_index=torch.full((2,), idx, dtype=torch.int32))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_init_variables_mirrors_flax_init():
    """The port's seeded initializer builds the QAT tree flax builds: same
    structure and shapes, lecun-normal kernels, N(0, 0.02) embeddings,
    LayerNorm ones/zeros, and it converts and serves."""
    jqc = j_default_qconfig(8, 8, per_channel_weights=True)
    jm = JLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS, qconfig=jqc,
             max_len=MAXLEN)
    jv = np_tree(jm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))
    qc = default_qconfig(8, 8, per_channel_weights=True)
    tm = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, qc.for_serving("none"),
                            max_len=MAXLEN, device="cpu")
    tv = init_variables(tm, seed=0)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(tv["params"]) == shapes(jv["params"])
    assert shapes(tv["qparams"]) == shapes(jv["qparams"])
    k = tv["params"]["block0"]["mlp_up"]["kernel"]
    assert abs(float(k.std()) - DIM ** -0.5) < 0.1 * DIM ** -0.5
    assert float(k.abs().max()) <= 2 * DIM ** -0.5 / 0.87962566103423978 + 1e-6
    assert abs(float(tv["params"]["tok_emb"]["embedding"].std()) - 0.02) < 0.002
    assert torch.equal(tv["params"]["ln_f"]["scale"], torch.ones(DIM))
    interop.load_variables(tm, tv)
    logits = make_generate(tm, 4, 3)(torch.zeros((1, 4), dtype=torch.int32))
    assert logits.shape == (1, 3)


def test_unported_paths_raise():
    qc = default_qconfig(8, 8)
    qat = QuantTransformerLM(VOCAB, DIM, 1, HEADS, qc, max_len=8, device="cpu")
    # the QAT-mode cache branch is ported: an eval forward that keeps no state
    tok = torch.zeros((1, 1), dtype=torch.int32)
    logits, _ = qat(tok, cache=init_kv_cache(qat, 1), cache_index=0)
    qat.eval()
    torch.testing.assert_close(logits, qat(tok), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="top_k"):
        QuantTransformerLM(VOCAB, DIM, 1, HEADS, qc.for_serving(), device="cpu",
                           moe_experts=4, moe_top_k=5)
    w4 = QuantTransformerLM(VOCAB, DIM, 1, HEADS, default_qconfig(4, 8).for_serving(
        "static_int8"), max_len=8, device="cpu")
    with pytest.raises(ValueError, match="int8-packed"):  # int4 packs: no int8 product
        w4(torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown act_observer"):
        default_qconfig(8, 8, act_observer="kl")
    tm = QuantTransformerLM(VOCAB, DIM, 1, HEADS, qc.for_serving(), max_len=8,
                            device="cpu")
    with pytest.raises(TypeError, match="PagedKVLayer"):
        tm(torch.zeros((1, 1), dtype=torch.int32), cache=(object(),), cache_index=0)
    cache = init_kv_cache(tm, 1)
    with pytest.raises(ValueError, match="max_len"):
        tm(torch.zeros((1, 2), dtype=torch.int32), cache=cache, cache_index=7)
    with pytest.raises(ValueError, match="even head_dim"):
        init_kv_cache(QuantTransformerLM(VOCAB, 12, 1, 4, qc.for_serving(),
                                         device="cpu"), 1, dtype="int4")
    with pytest.raises(ValueError, match="max_len"):
        make_generate(tm, 5, 4)
