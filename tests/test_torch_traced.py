"""The port's traced regime against the JAX package's, on the same seeded
numpy inputs: ``fake_quant_traced`` (forward and VJP, against
``jaxlsq.fake_quant_traced`` with ``impl='reference'`` and with the Pallas
kernels #6/#7 in interpret mode), the traced golden functions against the
static ones, ``LSQQuantizer.forward_traced`` against the JAX package's
``_forward_traced`` through the observer window and the switch to LSQ, and
the model-wide toggles against ``jaxlsq.models.toggles``.

Tolerances: the forward and dX are bit-exact (the same rounded f32
operations; ``assert_array_equal`` takes -0.0 and +0.0 as equal, and the JAX
package's golden blends ``init·x + (1 − init)·fq`` where the port selects).
dS/dB are sums taken in another order: rtol 2e-5, atol 1e-6, as
tests/test_traced.py holds the JAX package's own traced path.  The
quantizer's state (qparams, observer range, counters, flags) is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import get_path, leaves, np_tree
from jaxlsq import fake_quant_traced as jfake_quant_traced
from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.models import QuantResNet as JQuantResNet
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.models import toggles as jtoggles
from jaxlsq.observers.quantizer import LSQQuantizer as JQuantizer
from jaxlsq_torch import interop
from jaxlsq_torch.core import golden as tgolden
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.models import QuantResNet, default_qconfig
from jaxlsq_torch.models import toggles
from jaxlsq_torch.observers import LSQQuantizer
from jaxlsq_torch.ops import fake_quant_traced

SPECS = [  # tests/test_traced.py's four
    dict(quant_min=0, quant_max=255),
    dict(quant_min=-128, quant_max=127, symmetric=True),
    dict(quant_min=0, quant_max=255, per_channel=True, axis=1),
    dict(quant_min=-64, quant_max=63, type_min=-128, type_max=127,
         symmetric=True, per_channel=True, axis=0),
]
FLAGS = [(0, 0), (1, 0), (0, 1), (1, 1)]


def _inputs(kw, shape=(16, 24), seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    c = shape[kw["axis"]] if kw.get("per_channel") else 1
    scale = (0.05 + 0.1 * r.rand(c)).astype(np.float32)
    shift = (np.zeros(c) if kw.get("symmetric") else 0.1 * r.randn(c)).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    return x, scale, shift, g


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("ev,ini", FLAGS)
@pytest.mark.parametrize("kw", SPECS)
def test_fake_quant_traced_matches_jax(kw, ev, ini, impl):
    x, scale, shift, g = _inputs(kw)
    jspec, spec = JSpec(**kw), QuantSpec(**kw)
    out_j, vjp = jax.vjp(
        lambda a, s, b: jfake_quant_traced(a, s, b, jspec, eval_flag=jnp.float32(ev),
                                           init_flag=jnp.float32(ini), impl=impl),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    dx_j, ds_j, db_j = vjp(jnp.asarray(g))

    xt, st, bt = _t(x, scale, shift, grad=True)
    out = fake_quant_traced(xt, st, bt, spec, eval_flag=torch.tensor(float(ev)),
                            init_flag=torch.tensor([float(ini)]))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_j))
    for got, want in ((st.grad, ds_j), (bt.grad, db_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)
    if ev:
        assert not st.grad.any() and not bt.grad.any()


def test_flags_get_no_gradient():
    kw = SPECS[0]
    x, scale, shift, g = _inputs(kw)
    ev = torch.tensor(0.0, requires_grad=True)
    ini = torch.tensor([0.0], requires_grad=True)
    xt, st, bt = _t(x, scale, shift, grad=True)
    out = fake_quant_traced(xt, st, bt, QuantSpec(**kw), eval_flag=ev, init_flag=ini)
    out.backward(torch.from_numpy(g))
    assert ev.grad is None and ini.grad is None
    assert st.grad is not None and xt.grad is not None


@pytest.mark.parametrize("ev,ini", FLAGS)
@pytest.mark.parametrize("kw", SPECS)
def test_golden_traced_equals_static(kw, ev, ini):
    """For flags in {0, 1} the traced twins give the static functions'
    values: forward and dX the same bits, dS/dB the same sums."""
    spec = QuantSpec(**kw)
    x, scale, shift, g = _t(*_inputs(kw, shape=(6, 5, 7) if kw.get("axis") == 1
                                     else (16, 24)))
    evf, inif = torch.tensor(float(ev)), torch.tensor(float(ini))
    out = tgolden.golden_forward_traced(x, scale, shift, spec, evf, inif)
    np.testing.assert_array_equal(
        out.numpy(), tgolden.golden_forward(x, scale, shift, spec,
                                            init_mode=bool(ini)).numpy())
    got = tgolden.golden_backward_traced(g, x, scale, shift, spec, evf, inif)
    want = tgolden.golden_backward(g, x, scale, shift, spec, eval_mode=bool(ev),
                                   init_mode=bool(ini))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _batches(shape, n, seed):
    r = np.random.RandomState(seed)
    return [(r.randn(*shape) * (1.0 + i) + 0.3 * i).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("init_mode", ["observer", "learnable"])
@pytest.mark.parametrize("kw", [dict(quant_min=0, quant_max=127, type_min=0, type_max=255),
                                dict(quant_min=-63, quant_max=63, type_min=-128,
                                     type_max=127, symmetric=True)])
def test_quantizer_forward_traced_matches_jax(kw, init_mode):
    """One quantizer, n_batches = 2, six calls (the window, the switch to
    LSQ, an eval call, then LSQ): outputs, the state each call leaves and
    the qparams' gradients."""
    tq = LSQQuantizer(QuantSpec(**kw), init_mode=init_mode, n_batches=2, init_scale=0.05)
    jq = JQuantizer(JSpec(**kw), init_mode=init_mode, n_batches=2, init_scale=0.05,
                    impl="reference")
    ts, js = tq.init(device="cpu").on_device(), jq.init()
    assert ts.traced and ts.current_batch.dtype == torch.int32
    r = np.random.RandomState(9)
    for i, x in enumerate(_batches((8, 16), 6, seed=2)):
        training = i != 3
        cot = r.randn(8, 16).astype(np.float32)

        def f(scale, shift, js=js, x=x, training=training):
            out, new = jq._forward_traced(js.replace(scale=scale, shift=shift),
                                          jnp.asarray(x), training)
            return jnp.sum(out * cot), (out, new)

        (_, (jout, js)), (gs_j, gb_j) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(js.scale, js.shift)
        scale = ts.scale.detach().clone().requires_grad_(True)
        shift = ts.shift.detach().clone().requires_grad_(True)
        tout, ts = tq(ts.replace(scale=scale, shift=shift), torch.from_numpy(x),
                      training=training)
        (tout * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
        np.testing.assert_allclose(scale.grad.numpy(), np.asarray(gs_j), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(shift.grad.numpy(), np.asarray(gb_j), rtol=2e-5, atol=1e-6)
        ts = ts.replace(scale=ts.scale.detach(), shift=ts.shift.detach())
        for name in ("scale", "shift"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
        for f_ in ("current_batch", "n_batches", "fake_quant_enabled",
                   "observer_enabled", "learning_enabled"):
            got, want = getattr(ts, f_), np.asarray(getattr(js, f_))
            assert got.shape == () and got.numpy().dtype == want.dtype, f_
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f_)
        for f_ in ("min_val", "max_val", "seen"):
            np.testing.assert_array_equal(getattr(ts.obs, f_).numpy(),
                                          np.asarray(getattr(js.obs, f_)), err_msg=f_)
    assert int(ts.current_batch) == 3 and not bool(ts.observer_enabled)


def _toggle_cases():
    names = [n for n in jtoggles.__all__ if n != "map_quant_state"]
    return names + ["map_quant_state"]


@pytest.mark.parametrize("name", _toggle_cases())
def test_toggles_match_jax(name):
    """Each toggle on a small QuantResNet against the JAX package's on the
    same variables; map_quant_state with a function that rewinds the act
    quantizers' counters."""
    jmodel = JQuantResNet(10, jdefault_qconfig(8, 8, per_channel_weights=True,
                                               init_batches=1),
                          stage_sizes=(1,), widths=(8,))
    variables = jmodel.init(jax.random.key(0), jnp.zeros((2, 8, 8, 3)), training=False)
    model = QuantResNet(10, default_qconfig(8, 8, per_channel_weights=True,
                                            init_batches=1),
                        stage_sizes=(1,), widths=(8,), device="cpu")
    interop.load_qat_variables(model, np_tree(variables))
    # make every flag differ between quantizers before toggling
    variables = jtoggles.disable_observer_on_weights(
        jtoggles.disable_fake_quant_on_act(variables))
    toggles.disable_observer_on_weights(toggles.disable_fake_quant_on_act(model))
    if name == "map_quant_state":
        def jfn(qs):
            return {**qs, "current_batch": qs["current_batch"] + 5}

        def tfn(qs):
            return {**qs, "current_batch": qs["current_batch"] + 5,
                    "obs": {**qs["obs"], "seen": 7}}

        want = jtoggles.map_quant_state(variables, jfn, name_filter="act_fq")
        want = jtoggles.map_quant_state(
            want, lambda qs: {**qs, "obs": qs["obs"].replace(seen=jnp.int32(7))},
            name_filter="act_fq")
        assert toggles.map_quant_state(model, tfn, name_filter="act_fq") is model
    else:
        want = getattr(jtoggles, name)(variables)
        assert getattr(toggles, name)(model) is model
    got = interop.qat_variables(model)
    n = 0
    for path, w in leaves(np_tree(dict(want["quant_state"]))):
        np.testing.assert_array_equal(get_path(got["quant_state"], path), w,
                                      err_msg="/".join(path))
        n += 1
    assert n > 0
    # the eager regime's host mirror follows the buffers
    for m in model.modules():
        if isinstance(m, toggles.FakeQuantize):
            h = m.host_state()
            assert h["fake_quant_enabled"] == bool(m.fake_quant_enabled)
            assert h["current_batch"] == int(m.current_batch)
