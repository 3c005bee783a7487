"""LSQ QAT of the transformer LM in the port against the JAX package, and
train-then-serve, on the same seeded numpy inputs.

The JAX side: ``QuantTransformerLM`` (vocab 64, d64, depth 2, 2 heads,
rope, t = 128) under ``default_qconfig(8, 8, per_channel_weights=True,
init_batches=1)``, its variables from ``create_train_state`` (flax
``init``), carried into the port's QAT-mode LM with
``interop.load_qat_variables``; SGD (lr 1e-2, momentum 0.9); B = 2 seeded
token rows, labels shifted by one.  Every JAX program is compiled once per
module (module-scoped fixture).

* Logits of the eval forward against jaxlsq's (its einsum attention): the
  port's ``'xla'`` within 1e-5 and ``'flash'`` (the kernels' plain versions
  here) within 2e-5 of the largest magnitude.
* Three ``make_train_step`` steps, ``jit=False`` and ``jit=True``, through
  the one-batch observer window into LSQ, against jaxlsq's jitted step,
  ``train_attn_impl='xla'`` on both sides: tests/test_torch_train.py's
  harness and tolerances (loss within 1e-5 relative; every leaf within 2e-5
  of its largest magnitude; counters, flags and observer counts equal).
  Then the port's ``'flash'`` step against its own ``'xla'`` step, every
  float leaf within 5e-4 · max(1, max|leaf|).
* The LM's ``qat_variables`` round trip (rope and learned positions).
* Train-then-serve: the port's trained variables, served by a serve-mode LM
  through ``interop.load_variables``, against jaxlsq ``convert`` plus its
  serve-mode LM on the same tree, logits within 1e-4 (the serving tests'
  tolerance).
* ``cross_entropy_loss`` over the last axis, as optax's.

Moved elements: rope's cos/sin differ in the last ulp between XLA and
PyTorch on the CPU, so an activation can land on the other side of a
rounding boundary of the next quantizer.  As in tests/test_torch_train.py,
JAX's activation-quantizer outputs are recorded and handed to the port where
the two differ by more than half a quant step (checked to be at most one
step), at most 1e-4 of the elements.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from _torch_port import Recorder, get_path, leaves, np_tree
from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.parallel import create_train_state
from jaxlsq.parallel import cross_entropy_loss as j_cross_entropy_loss
from jaxlsq.parallel import make_train_step as jmake_train_step
from jaxlsq.serve import convert as j_convert
from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig
from jaxlsq_torch.parallel import cross_entropy_loss, make_eval_step, make_train_step

VOCAB, DIM, DEPTH, HEADS, T, B, STEPS = 64, 64, 2, 2, 128, 2, 3
KW = dict(max_len=T, pos_embedding="rope")
MAX_MOVED = 1e-4


def _qc():
    return default_qconfig(8, 8, per_channel_weights=True, init_batches=1)


def _port_lm(tree, **kw):
    model = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS, _qc(), device="cpu",
                               **{**KW, **kw})
    interop.load_qat_variables(model, tree)
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_run():
    """jaxlsq's initial tree, eval logits and three jitted steps, with every
    activation quantizer's output recorded."""
    jqc = jdefault_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    jm = JLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS, qconfig=jqc, **KW)
    r = np.random.RandomState(0)
    toks = [r.randint(0, VOCAB, (B, T + 1)).astype(np.int32) for _ in range(STEPS)]
    batches = [{"input": x[:, :-1], "label": x[:, 1:]} for x in toks]
    tx = optax.sgd(1e-2, momentum=0.9)
    state = create_train_state(jm, tx, jnp.asarray(batches[0]["input"]))
    init = np_tree({**state.params, **state.model_state})
    rec = Recorder()
    with fnn.intercept_methods(rec.intercept):
        logits = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, training=False))(
            {**state.params, **state.model_state}, jnp.asarray(batches[0]["input"])))
    jax.effects_barrier()
    eval_out = rec.jax_out
    rec = Recorder()
    jstep = jmake_train_step(jm, tx, donate=False)
    trees, losses = [], []
    for batch in batches:
        with fnn.intercept_methods(rec.intercept):
            state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax.effects_barrier()
        trees.append(np_tree({**state.params, **state.model_state}))
        losses.append(float(metrics["loss"]))
    return {"jqc": jqc, "jm": jm, "init": init, "batches": batches, "logits": logits,
            "eval_out": eval_out, "step_out": rec.jax_out, "trees": trees,
            "losses": losses}


def _recorder(recorded):
    rec = Recorder()
    rec.jax_out = copy.deepcopy(recorded)
    return rec


@pytest.mark.parametrize("impl,tol", [("xla", 1e-5), ("flash", 2e-5)])
def test_qat_lm_logits_match_jax(jax_run, impl, tol):
    model = _port_lm(jax_run["init"], train_attn_impl=impl)
    rec = _recorder(jax_run["eval_out"])
    rec.attach(model)
    got = make_eval_step(model)(_torch_batch(jax_run["batches"][0])).numpy()
    want = jax_run["logits"]
    assert got.shape == (B, T, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()))
    assert rec.total > 0 and rec.moved <= MAX_MOVED * rec.total, (rec.moved, rec.total)


def _assert_tree_close(mine, want, tol, where):
    for path, w in leaves(want):
        got = get_path(mine, path)
        at = f"{where}: {'/'.join(path)}"
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(got, w, err_msg=at)
        else:
            assert got.shape == w.shape, at
            assert float(np.abs(got - w).max()) <= tol(w), (at, got, w)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_train_steps_match_jax_jitted_step(jax_run, jit):
    model = _port_lm(jax_run["init"])
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2,
                                                  momentum=0.9), jit=jit)
    rec = _recorder(jax_run["step_out"])
    rec.attach(model)
    for i, batch in enumerate(jax_run["batches"]):
        loss = float(step(_torch_batch(batch))["loss"])
        want = jax_run["losses"][i]
        assert abs(loss - want) <= 1e-5 * abs(want), (i, loss, want)
        _assert_tree_close(interop.qat_variables(model), jax_run["trees"][i],
                           lambda w: 2e-5 * max(1e-30, float(np.abs(w).max())),
                           f"step {i}")
    assert rec.total > 0 and rec.moved <= MAX_MOVED * rec.total, (rec.moved, rec.total)


def test_flash_step_matches_xla_step(jax_run):
    """The port's 'flash' training step against its own 'xla' step from one
    state, three steps across the observer window."""
    runs = []
    for impl in ("xla", "flash"):
        model = _port_lm(jax_run["init"], train_attn_impl=impl)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2,
                                                      momentum=0.9), jit=False)
        losses = [float(step(_torch_batch(b))["loss"]) for b in jax_run["batches"]]
        runs.append((losses, interop.qat_variables(model)))
    (lx, tx), (lf, tf) = runs
    np.testing.assert_allclose(lf, lx, rtol=1e-5)
    _assert_tree_close(tf, tx, lambda w: 5e-4 * max(1.0, float(np.abs(w).max())),
                       "flash vs xla")


@pytest.mark.parametrize("pos", ["rope", "learned"])
def test_qat_variables_round_trip(jax_run, pos):
    if pos == "rope":
        tree = jax_run["init"]
    else:  # jaxlsq's tree structure, shapes and types (abstract init), seeded values
        jm = dataclasses.replace(jax_run["jm"], pos_embedding="learned")
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(1),
                                                jnp.zeros((1, 8), jnp.int32),
                                                training=False))
        r = np.random.RandomState(1)
        tree = jax.tree_util.tree_map(
            lambda s: (r.randn(*s.shape) if s.dtype.kind == "f"
                       else r.randint(0, 2, s.shape)).astype(s.dtype), shapes)
        tree = np_tree(tree)
        assert tree["params"]["pos_emb"].shape == (T, DIM)
    model = _port_lm(tree, pos_embedding=pos)
    back = interop.qat_variables(model)
    assert sorted(back) == sorted(tree)
    assert len(list(leaves(back))) == len(list(leaves(tree)))
    for path, want in leaves(tree):
        got = get_path(back, path)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg="/".join(path))
    again = interop.qat_variables(_port_lm(back, pos_embedding=pos))
    for path, want in leaves(back):
        np.testing.assert_array_equal(get_path(again, path), want)
    extra = copy.deepcopy(tree)
    extra["params"]["block0"]["ln1"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="stray"):
        _port_lm(extra, pos_embedding=pos)


def test_trained_lm_serves_as_jax_does(jax_run):
    """Train the port's LM three steps, then serve its variables: the port's
    serve-mode LM (``load_variables`` converts the QAT tree) against jaxlsq's
    ``convert`` and serve-mode LM on the same tree."""
    model = _port_lm(jax_run["init"])
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2,
                                                  momentum=0.9), jit=False)
    for batch in jax_run["batches"]:
        step(_torch_batch(batch))
    tree = interop.qat_variables(model)
    served = QuantTransformerLM(VOCAB, DIM, DEPTH, HEADS,
                                _qc().for_serving("none"), device="cpu", **KW)
    interop.load_variables(served, tree)
    toks = jax_run["batches"][1]["input"]
    with torch.no_grad():
        got = served(torch.from_numpy(toks).long()).numpy()
    jqc = jax_run["jqc"]
    jserved = dataclasses.replace(jax_run["jm"], qconfig=jqc.for_serving("none", "xla"))
    sv = j_convert(jax.tree_util.tree_map(jnp.asarray, tree), jqc)
    want = np.asarray(jax.jit(lambda v, x: jserved.apply(v, x))(sv, jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 5, 7), (4, 10)], ids=["lm_BtV", "classes_BC"])
def test_cross_entropy_over_last_axis_matches_optax(shape):
    r = np.random.RandomState(len(shape))
    logits = r.randn(*shape).astype(np.float32)
    labels = r.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(j_cross_entropy_loss(jnp.asarray(logits), {"label": jnp.asarray(labels)}))
    got = float(cross_entropy_loss(torch.from_numpy(logits),
                                   {"label": torch.from_numpy(labels).long()}))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_train_attn_impl_is_checked():
    with pytest.raises(ValueError, match="train_attn_impl"):
        QuantTransformerLM(VOCAB, DIM, 1, HEADS, _qc(), train_attn_impl="bogus",
                           device="cpu")
