"""jaxlsq_torch's min/max observers and the LSQQuantizer phase machine
against the JAX package, step for step, on the same seeded numpy inputs.

Tolerances: min/max, the qparams derived from them and every fake-quant
output are exact (the same rounded f32 operations in the same order).  The
weight quantizer's static scale comes from a mean and a standard deviation,
sums taken in another order by torch and XLA: 1e-6 relative.  Counters and
flags are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.observers import minmax as jminmax
from jaxlsq.observers.quantizer import LSQQuantizer as JQuantizer
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.observers import (LSQQuantizer, MinMaxObserver,
                                    MovingAverageMinMaxObserver, observer_qparams)

ACT = dict(quant_min=0, quant_max=127, type_min=0, type_max=255)
SYM_SIGNED = dict(quant_min=-63, quant_max=63, type_min=-128, type_max=127,
                  symmetric=True)
SYM_UNSIGNED = dict(quant_min=0, quant_max=255, symmetric=True)
W_PC = dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True, axis=0)


def _batches(shape, n, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(*shape) * (1.0 + i) + 0.3 * i).astype(np.float32)
            for i in range(n)]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("averaging", [None, 0.01, 0.3])
def test_observer_updates_match_jax(per_channel, averaging):
    tobs = MinMaxObserver(per_channel=per_channel, axis=1,
                          averaging_constant=averaging)
    jobs = jminmax.MinMaxObserver(per_channel=per_channel, axis=1,
                                  averaging_constant=averaging)
    ts, js = tobs.init(6), jobs.init(6)
    for x in _batches((4, 6, 5), 4):
        ts = tobs.update(ts, torch.from_numpy(x))
        js = jobs.update(js, jnp.asarray(x))
        _eq(ts.min_val, js.min_val)
        _eq(ts.max_val, js.max_val)
        assert ts.seen == int(js.seen)
    assert MovingAverageMinMaxObserver() == MinMaxObserver(averaging_constant=0.01)


@pytest.mark.parametrize("kw", [ACT, SYM_SIGNED, SYM_UNSIGNED])
def test_observer_qparams_match_jax(kw):
    r = np.random.RandomState(1)
    lo = np.concatenate([-np.abs(r.randn(5)), np.abs(r.randn(2)), [0.0, -1e-12]])
    hi = np.concatenate([np.abs(r.randn(5)), -np.abs(r.randn(2)), [0.0, 1e-12]])
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    ts, tz = observer_qparams(torch.from_numpy(lo), torch.from_numpy(hi), QuantSpec(**kw))
    js, jz = jminmax.observer_qparams(jnp.asarray(lo), jnp.asarray(hi), JSpec(**kw))
    _eq(ts, js)
    _eq(tz, jz)
    assert float(ts.min()) >= np.finfo(np.float32).eps  # the eps floor


def _compare_state(ts, js):
    _eq(ts.scale, js.scale)
    _eq(ts.shift, js.shift)
    for f in ("current_batch", "n_batches", "fake_quant_enabled",
              "observer_enabled", "learning_enabled"):
        assert getattr(ts, f) == getattr(js, f).item(), f
    _eq(ts.obs.min_val, js.obs.min_val)
    _eq(ts.obs.max_val, js.obs.max_val)
    assert ts.obs.seen == int(js.obs.seen)


@pytest.mark.parametrize("init_mode", ["observer", "learnable"])
@pytest.mark.parametrize("kw", [ACT, SYM_SIGNED])
def test_quantizer_schedule_step_for_step(init_mode, kw):
    """n_batches = 2, five training calls and an eval call: the window, the
    switch to full LSQ, the observer's writes, counters and flags."""
    tq = LSQQuantizer(QuantSpec(**kw), otype="activation", init_mode=init_mode,
                      n_batches=2, init_scale=0.05)
    jq = JQuantizer(JSpec(**kw), otype="activation", init_mode=init_mode,
                    n_batches=2, init_scale=0.05, impl="reference")
    ts, js = tq.init(device="cpu"), jq.init()
    _compare_state(ts, js)
    for i, x in enumerate(_batches((8, 16), 6, seed=2)):
        training = i != 3
        tout, ts = tq(ts, torch.from_numpy(x), training=training)
        jout, js = jq(js, jnp.asarray(x), training=training)
        _eq(tout, jout)
        _compare_state(ts, js)
    assert ts.current_batch == 3 and not ts.observer_enabled


@pytest.mark.parametrize("init_mode", ["observer", "learnable"])
def test_quantizer_modes_match_jax(init_mode):
    """The phases the schedule reports per call: (eval_mode, init_mode) of
    the fake-quant, against the JAX package's gradients."""
    import jax

    tq = LSQQuantizer(QuantSpec(**ACT), init_mode=init_mode, n_batches=2,
                      init_scale=0.05)
    jq = JQuantizer(JSpec(**ACT), init_mode=init_mode, n_batches=2,
                    init_scale=0.05, impl="reference")
    ts, js = tq.init(device="cpu"), jq.init()
    for x in _batches((8, 16), 5, seed=3):
        prev = js
        ts, modes = tq.advance(ts, torch.from_numpy(x), True)
        _, js = jq(js, jnp.asarray(x), training=True)

        def f(scale, shift):
            st = prev.replace(scale=scale, shift=shift)
            return jnp.sum(jq(st, jnp.asarray(x), training=True)[0])

        gs, gb = jax.grad(f, argnums=(0, 1))(prev.scale, prev.shift)
        eval_mode, init = modes
        # eval mode <=> zero qparam gradients; init mode <=> the identity
        assert eval_mode == (not np.any(np.asarray(gs)) and not np.any(np.asarray(gb)))
        assert init == (init_mode == "learnable" and ts.current_batch <= 2)


def test_quantizer_switches_and_qparams_match_jax():
    tq = LSQQuantizer(QuantSpec(**ACT), n_batches=5, init_scale=0.1, init_shift=-0.2)
    jq = JQuantizer(JSpec(**ACT), n_batches=5, init_scale=0.1, init_shift=-0.2)
    ts, js = tq.init(device="cpu"), jq.init()
    steps = [
        ("enable_param_learning", (), ()),
        ("disable_fake_quant", (), ()),
        ("enable_fake_quant", (), ()),
        ("enable_static_estimate", (), ()),
        ("disable_observer", (), ()),
        ("enable_observer", (), ()),
    ]
    for name, targs, jargs in steps:
        ts, js = getattr(tq, name)(ts, *targs), getattr(jq, name)(js, *jargs)
        _compare_state(ts, js)
    ts = tq.set_qparams(ts, scale=np.float32(0.03), zero_point=np.float32(7))
    js = jq.set_qparams(js, scale=np.float32(0.03), zero_point=np.float32(7))
    _compare_state(ts, js)
    ts = tq.set_qparams(ts, shift=np.float32(0.5))
    js = jq.set_qparams(js, shift=np.float32(0.5))
    _compare_state(ts, js)
    (a, b), (c, d) = tq.calculate_qparams(ts), jq.calculate_qparams(js)
    _eq(a, c)
    _eq(b, d)
    assert b.dtype == torch.int32


def test_weight_quantizer_static_init_matches_jax():
    r = np.random.RandomState(4)
    w = (r.randn(16, 8, 3, 3) * 0.05 + 0.01).astype(np.float32)
    tq = LSQQuantizer(QuantSpec(**W_PC), otype="weight")
    jq = JQuantizer(JSpec(**W_PC), otype="weight")
    ts, js = tq.init(torch.from_numpy(w)), jq.init(jnp.asarray(w))
    np.testing.assert_allclose(ts.scale.numpy(), np.asarray(js.scale), rtol=1e-6)
    _eq(ts.shift, js.shift)
    assert ts.n_batches == -1 and not ts.observer_enabled and ts.learning_enabled
    # a weight quantizer goes straight to full LSQ
    _, modes = tq.advance(ts, torch.from_numpy(w), True)
    assert modes == (False, False)


def test_quantizer_init_needs_a_device_or_x():
    tq = LSQQuantizer(QuantSpec(**ACT))
    with pytest.raises(ValueError, match="device"):
        tq.init()
    assert tq.init(torch.zeros(3)).scale.device.type == "cpu"
    assert tq.init(device="meta").scale.device.type == "meta"
