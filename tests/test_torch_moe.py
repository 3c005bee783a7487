"""jaxlsq_torch's quantized MoE (``route``, ``load_balance_loss``,
``QuantMoE``, the MoE LM) against the JAX package's, on the same numpy
inputs, variables drawn by the port and carried into the JAX package's
trees (on the structure of ``jax.eval_shape`` of its ``init``):

* ``route``: dispatch and combine equal, ties (to the lower expert index)
  and capacity drops included, and the JAX package's fuzz invariants;
  ``load_balance_loss`` within 1e-6;
* ``QuantMoE`` in QAT mode: the forward within 1e-5 of max|ref|, the
  gradients of the router, the expert stacks, biases and quantizer scales
  within 2e-5 of their largest magnitude (f32 on both sides, other
  summation orders);
* one MoE LM train step with the aux loss: the loss within 1e-5 and every
  leaf within 2e-5 of its largest magnitude (tests/test_torch_train_lm.py's
  tolerances);
* ``convert`` at w8 and w4 stacks byte for byte, served ``'none'``,
  ``'static'`` and ``'static_int8'`` within 1e-5 (the CPU's plain einsum
  against jaxlsq's ``serve_precision='highest'`` path);
* the MoE LM's decode against its full forward (2e-4, jaxlsq's own
  tolerance), the capacity warning of the engines, and the toggles reaching
  the expert quantizers.
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jaxlsq.models import QuantMoE as JQuantMoE
from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as j_default_qconfig
from jaxlsq.models.moe import load_balance_loss as j_load_balance_loss
from jaxlsq.models.moe import route as j_route
from jaxlsq.parallel import make_train_step as j_make_train_step
from jaxlsq.parallel.train import QATTrainState
from jaxlsq.serve import convert as j_convert

from jaxlsq_torch import interop
from jaxlsq_torch.models import (QConfig, QuantMoE, QuantTransformerLM, default_qconfig,
                                 disable_fake_quant, load_balance_loss, route)
from jaxlsq_torch.models.layers import collect_losses
from jaxlsq_torch.models.zoo import init_qat_variables
from jaxlsq_torch.parallel import make_train_step
from jaxlsq_torch.serve import DecodeEngine, convert, prefill

from _torch_port import get_path, leaves, np_tree, torch_tree_to_np

D, H, E = 8, 12, 4


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (err, rel)


def _carry(template, tree):
    """The port's tree on the JAX package's structure (its ``losses``
    collection, which the port keeps no variable of, as zeros)."""
    def leaf(path, s):
        keys = [getattr(k, "key", None) or getattr(k, "name") for k in path]
        if keys[0] == "losses":
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(get_path(tree, keys), s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, template)


def _set_act_qparams(tree, scale=0.05, zp=64):
    def walk(node):
        for key, val in node.items():
            if key == "act_fq":
                val["qp"]["scale"] = np.full_like(val["qp"]["scale"], scale)
                val["qp"]["shift"] = np.full_like(val["qp"]["shift"], -zp * scale)
            elif isinstance(val, dict):
                walk(val)
    walk(tree["qparams"])
    return tree


def _moe_pair(qc, jqc, seed, **kw):
    """A QAT QuantMoE drawn by the port, its tree (realistic activation
    qparams, loaded back) and the JAX package's twin and variables."""
    moe = QuantMoE(D, H, E, qc, device="cpu", **kw)
    init_qat_variables(moe, seed)
    tree = _set_act_qparams(interop.qat_variables(moe))
    interop.load_qat_variables(moe, tree)
    jkw = {"top_k": kw.get("top_k", 2), "capacity_factor": kw.get("capacity_factor", 1.25)}
    jmoe = JQuantMoE(hidden=H, num_experts=E, qconfig=jqc, **jkw)
    tmpl = jax.eval_shape(lambda: jmoe.init(jax.random.key(0), jnp.zeros((4, D))))
    return moe, tree, jmoe, _carry(tmpl, tree)


# --- routing ---------------------------------------------------------------------------------

@pytest.mark.parametrize("n,e,k,c,ties", [(12, 4, 2, 6, False), (16, 4, 1, 2, True),
                                          (9, 5, 3, 4, True), (7, 3, 2, 7, False)])
def test_route_matches_jax(n, e, k, c, ties):
    r = np.random.RandomState(n * e + k)
    logits = (r.randn(n, e) * 2).astype(np.float32)
    if ties:  # equal gates: the lower index wins, as jax.lax.top_k
        logits[::2, 1] = logits[::2, 0]
        logits[1::3, :] = 0.5
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jd, jc = j_route(jnp.asarray(gates), k, c)
    d, cmb = route(torch.as_tensor(gates.copy()), k, c)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    _close(cmb.numpy(), jc, 1e-6)
    if c < n:
        assert d.sum() < n * k  # something was dropped


def test_route_invariants_fuzz():
    """The JAX package's fuzz (tests/test_moe.py:650) on the port's route."""
    r = np.random.RandomState(123)
    for trial in range(25):
        n = int(r.randint(1, 33))
        e = int(r.randint(1, 9))
        k = int(r.randint(1, e + 1))
        c = int(r.randint(1, n + 3))
        gates = torch.softmax(torch.as_tensor(r.randn(n, e).astype(np.float32)) * 2.0, -1)
        d, cmb = (a.numpy() for a in route(gates, k, c))
        assert d.shape == (n, e, c)
        assert (d.sum(axis=0) <= 1 + 1e-6).all(), (trial, n, e, k, c)
        assert (d.sum(axis=(0, 2)) <= c + 1e-6).all()
        np.testing.assert_array_equal(cmb > 0, d > 0)
        rows = cmb.sum(axis=(1, 2))
        assert (rows <= 1 + 1e-5).all() and (rows >= -1e-6).all()
        if c >= n:
            np.testing.assert_allclose(rows, np.ones(n), rtol=1e-5)


def test_load_balance_loss_matches_jax():
    r = np.random.RandomState(3)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(r.randn(64, E).astype(np.float32)), -1))
    top1 = gates.argmax(-1)
    want = float(j_load_balance_loss(jnp.asarray(gates), jnp.asarray(top1)))
    got = float(load_balance_loss(torch.as_tensor(gates.copy()), torch.as_tensor(top1)))
    assert abs(got - want) <= 1e-6 * abs(want)
    uniform = torch.full((64, E), 1.0 / E)
    assert abs(float(load_balance_loss(uniform, torch.arange(64) % E)) - 1.0) <= 1e-6
    with pytest.raises(ValueError, match="top_k"):
        QuantMoE(D, H, E, QConfig(), top_k=5, device="cpu")


# --- QAT ----------------------------------------------------------------------------------------

def test_qat_moe_forward_and_gradients_match_jax():
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=0)
    jqc = j_default_qconfig(8, 8, per_channel_weights=True, init_batches=0)
    moe, tree, jmoe, jvars = _moe_pair(qc, jqc, 1, capacity_factor=1.0)
    r = np.random.RandomState(4)
    x = r.randn(3, 5, D).astype(np.float32)
    g = r.randn(3, 5, D).astype(np.float32)

    def jloss(params, qparams):
        v = {**jvars, "params": params, "qparams": qparams}
        out, _ = jmoe.apply(v, jnp.asarray(x), training=True,
                            mutable=["quant_state", "qparams", "losses"])
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgq) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jvars["params"], jvars["qparams"])
    moe.train()
    out = moe(torch.as_tensor(x))
    (out * torch.as_tensor(g)).sum().backward()
    _close(out.detach().numpy(), jout, 1e-5)
    grads = {"router/kernel": moe.router.weight.grad.T}
    for sub in ("experts_up", "experts_down"):
        layer = getattr(moe, sub)
        grads[f"{sub}/kernel"] = layer.kernel.grad
        grads[f"{sub}/bias"] = layer.bias.grad
        for fq in ("act_fq", "weight_fq"):
            grads[f"{sub}/{fq}/scale"] = getattr(layer, fq).scale.grad
    jg = np_tree(jgp)
    jq = np_tree(jgq)
    for name, got in grads.items():
        parts = name.split("/")
        want = get_path(jq, parts[:2] + ["qp", parts[2]]) if "_fq" in name else \
            get_path(jg, parts)
        _close(got.numpy(), want, 2e-5)


VOCAB, LDIM, MAXLEN = 32, 16, 16


def _lm_pair(seed=0, cf=2.0, wbits=8, depth=2):
    qc = default_qconfig(wbits, 8, per_channel_weights=True, init_batches=1)
    jqc = j_default_qconfig(wbits, 8, per_channel_weights=True, init_batches=1)
    kw = dict(moe_experts=E, moe_top_k=2, moe_capacity_factor=cf)
    lm = QuantTransformerLM(VOCAB, LDIM, depth, 4, qc, max_len=MAXLEN, device="cpu",
                            seed=seed, **kw)
    jlm = JLM(vocab=VOCAB, dim=LDIM, depth=depth, num_heads=4, qconfig=jqc, max_len=MAXLEN,
              **kw)
    return lm, qc, jlm, jqc


def test_moe_lm_train_step_with_aux_loss_matches_jax():
    """One step (observers on, capacity 1.25: tokens drop) of a depth-1 MoE
    LM from the port's drawn variables against jaxlsq's jitted step."""
    lm, qc, jlm, jqc = _lm_pair(seed=2, cf=1.25, depth=1)
    r = np.random.RandomState(5)
    toks = r.randint(0, VOCAB, (2, MAXLEN + 1)).astype(np.int32)
    batch = {"input": toks[:, :-1], "label": toks[:, 1:]}
    tmpl = jax.eval_shape(lambda: jlm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))
    jvars = _carry(tmpl, interop.qat_variables(lm))
    tx = optax.sgd(1e-2, momentum=0.9)
    params = {"params": jvars["params"], "qparams": jvars["qparams"]}
    state = QATTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          model_state={k: v for k, v in jvars.items() if k not in params},
                          opt_state=tx.init(params))
    jstate, metrics = j_make_train_step(jlm, tx, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(lm, torch.optim.SGD(lm.parameters(), lr=1e-2, momentum=0.9),
                           jit=False)
    probe = copy.deepcopy(lm)  # a training forward writes the observers
    with collect_losses() as terms, torch.no_grad():  # each block records its aux term
        probe(torch.as_tensor(batch["input"]).long())
    assert len(terms) == 1 and float(terms[0]) > 0
    loss = float(step({k: torch.from_numpy(v).long() for k, v in batch.items()})["loss"])
    want = float(metrics["loss"])
    assert abs(loss - want) <= 1e-5 * abs(want), (loss, want)
    mine = interop.qat_variables(lm)
    for path, w in leaves(np_tree({**jstate.params, **jstate.model_state})):
        if path[0] == "losses":
            continue
        got = get_path(mine, path)
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(got, w, err_msg="/".join(path))
        else:
            _close(got, w, 2e-5)


# --- convert and serve ---------------------------------------------------------------------

@pytest.mark.parametrize("wbits", [8, 4])
def test_convert_and_serve_match_jax(wbits):
    qc = default_qconfig(wbits, 8, per_channel_weights=True, init_batches=1)
    jqc = j_default_qconfig(wbits, 8, per_channel_weights=True, init_batches=1)
    moe, tree, jmoe, jvars = _moe_pair(qc, jqc, 6, capacity_factor=float(E))
    jserved = j_convert(jvars, jqc)
    served = convert(tree, qc)
    for sub in ("experts_up", "experts_down"):
        wp = np_tree(jserved)["quantized"][sub]["kernel"]
        gp = torch_tree_to_np(served)["quantized"][sub]["kernel"]
        assert gp["bits"] == wbits == wp["bits"] and gp["axis"] == 0 and gp["k_axis"] == 1
        for f in ("data", "scale", "zero_point"):
            assert gp[f].tobytes() == wp[f].tobytes(), (sub, f)
    x = np.random.RandomState(7).randn(12, D).astype(np.float32)
    outs = {}
    for mode in ("none", "static", "static_int8"):
        jm = JQuantMoE(hidden=H, num_experts=E, capacity_factor=float(E),
                       qconfig=jqc.for_serving(mode, "xla", "highest"))
        want = np.asarray(jm.apply(jserved, jnp.asarray(x), training=False))
        m = QuantMoE(D, H, E, qc.for_serving(mode), capacity_factor=float(E), device="cpu")
        interop.load_variables(m, tree)
        with torch.no_grad():
            outs[mode] = m(torch.as_tensor(x)).numpy()
        _close(outs[mode], want, 1e-5)
    np.testing.assert_allclose(outs["static_int8"], outs["static"], rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="dynamic"):
        m = QuantMoE(D, H, E, qc.for_serving("dynamic"), device="cpu")
        interop.load_variables(m, tree)
        m(torch.as_tensor(x))


@pytest.mark.parametrize("mode", ["static", "static_int8"])
def test_moe_lm_serve_and_decode(mode):
    """The served MoE LM's logits against the JAX package's (1e-4), and its
    decode against its own full forward (capacity E / top_k: no drops)."""
    lm, qc, jlm, jqc = _lm_pair(seed=4, cf=E / 2.0)
    tree = _set_act_qparams(interop.qat_variables(lm))
    tmpl = jax.eval_shape(lambda: jlm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))
    jserved = j_convert(_carry(tmpl, tree), jqc)
    toks = np.random.RandomState(8).randint(0, VOCAB, (2, 10)).astype(np.int32)
    jm = JLM(vocab=VOCAB, dim=LDIM, depth=2, num_heads=4, max_len=MAXLEN, moe_experts=E,
             moe_top_k=2, moe_capacity_factor=E / 2.0,
             qconfig=jqc.for_serving(mode, "xla", "highest"))
    want = np.asarray(jax.jit(jm.apply)(jserved, jnp.asarray(toks)))
    sm = QuantTransformerLM(VOCAB, LDIM, 2, 4, qc.for_serving(mode), max_len=MAXLEN,
                            moe_experts=E, moe_top_k=2, moe_capacity_factor=E / 2.0,
                            device="cpu")
    interop.load_variables(sm, np_tree(jserved))
    tt = torch.as_tensor(toks)
    with torch.no_grad():
        full = sm(tt)
        np.testing.assert_allclose(full.numpy(), want, rtol=1e-4, atol=1e-4)
        last, cache, idx = prefill(sm, tt[:, :4])
        rows = [last]
        for t in range(4, 10):
            logits, cache = sm(tt[:, t:t + 1], cache=cache, cache_index=idx)
            rows.append(logits[:, 0])
            idx += 1
    dec = torch.stack(rows[:-1], 1)
    np.testing.assert_allclose(dec.numpy(), full[:, 3:9].numpy(), rtol=2e-4, atol=2e-4)


def test_engines_warn_on_binding_capacity():
    qc = default_qconfig(8, 8, init_batches=1).for_serving("static")
    for cf, warns in ((1.25, True), (4.0, False)):
        lm = QuantTransformerLM(VOCAB, LDIM, 1, 2, qc, max_len=12, moe_experts=E,
                                moe_top_k=1, moe_capacity_factor=cf, device="cpu")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            DecodeEngine(lm, max_batch=2).close()
        hit = [w for w in rec if "capacity can bind" in str(w.message)]
        assert bool(hit) == warns, cf


def test_toggles_reach_expert_quantizers():
    """With fake quantization off, the QAT MoE equals the float MoE (no
    quantizers) sharing its parameters."""
    qc = default_qconfig(8, 8, init_batches=0)
    moe = QuantMoE(D, H, E, qc, capacity_factor=float(E), device="cpu")
    init_qat_variables(moe, 9)
    fmoe = QuantMoE(D, H, E, QConfig(), capacity_factor=float(E), device="cpu")
    fmoe.load_state_dict({k: v for k, v in moe.state_dict().items() if "_fq." not in k})
    disable_fake_quant(moe)
    assert all(not m.fake_quant_enabled for m in moe.modules()
               if type(m).__name__ == "FakeQuantize")
    x = torch.as_tensor(np.random.RandomState(81).randn(10, D).astype(np.float32))
    moe.eval()
    with torch.no_grad():
        torch.testing.assert_close(moe(x), fmoe(x), rtol=1e-5, atol=1e-6)
