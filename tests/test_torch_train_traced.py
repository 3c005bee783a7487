"""The port's single-program train step, ``make_train_step(jit=True)``, on
the CPU (the traced regime, run eagerly: there is no capture without a
card) against the JAX package's jitted ``make_train_step``, and against the
port's own eager step.

The JAX side: a small ``QuantResNet`` (stages (1, 1), widths (8, 16), 8x8
inputs, B = 4, ``init_batches=1``) from ``create_train_state``, carried
across with ``interop.load_qat_variables``; both take three SGD steps (lr
1e-2, momentum 0.9) on the same seeded batches, across the observer window:
as they are, with ``accum_steps=2`` on both sides, and with
``disable_fake_quant_on_act`` (both packages' toggles) applied between steps
2 and 3.  Harness and tolerances are tests/test_torch_train.py's: the loss
within 1e-5 relative; every leaf within 2e-5 of its largest magnitude;
counters, flags and observer counts equal; at most 1e-4 of the activation
elements handed over where a rounding boundary fell the other way.

The port's ``jit=False`` and ``jit=True`` steps from one state run the same
operations in the same order on the CPU (the traced flags select what the
host branches select), so they are held equal leaf by leaf, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from _torch_port import Recorder, get_path, leaves, np_tree
from jaxlsq.models import QuantResNet as JQuantResNet
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.models import toggles as jtoggles
from jaxlsq.parallel import create_train_state, make_train_step as jmake_train_step
from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantResNet, default_qconfig, toggles
from jaxlsq_torch.parallel import make_train_step

B, HW, STEPS = 4, 8, 3
MAX_MOVED = 1e-4


def _batches(seed=0):
    r = np.random.RandomState(seed)
    xs = [r.randn(B, HW, HW, 3).astype(np.float32) for _ in range(STEPS)]
    ys = [r.randint(0, 10, size=B).astype(np.int32) for _ in range(STEPS)]
    return xs, ys


def _torch_batch(x, y):
    return {"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
            "label": torch.from_numpy(y).long()}


def _port_model():
    return QuantResNet(10, default_qconfig(8, 8, per_channel_weights=True,
                                           init_batches=1),
                       stage_sizes=(1, 1), widths=(8, 16), device="cpu")


@pytest.mark.parametrize("accum_steps,toggle_at", [(1, None), (2, None), (1, 2)],
                         ids=["plain", "accum2", "act_fq_off_at_step3"])
def test_jit_step_matches_jax_jitted_step(accum_steps, toggle_at):
    xs, ys = _batches()
    jmodel = JQuantResNet(10, jdefault_qconfig(8, 8, per_channel_weights=True,
                                               init_batches=1),
                          stage_sizes=(1, 1), widths=(8, 16))
    tx = optax.sgd(1e-2, momentum=0.9)
    state = create_train_state(jmodel, tx, jnp.asarray(xs[0]))
    jstep = jmake_train_step(jmodel, tx, donate=False, accum_steps=accum_steps)

    model = _port_model()
    interop.load_qat_variables(model, np_tree({**state.params, **state.model_state}))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2,
                                                  momentum=0.9),
                           jit=True, accum_steps=accum_steps)
    rec = Recorder()
    hooks = rec.attach(model)
    for i in range(STEPS):
        if i == toggle_at:
            state = state.replace(
                model_state=jtoggles.disable_fake_quant_on_act(state.model_state))
            toggles.disable_fake_quant_on_act(model)
        with fnn.intercept_methods(rec.intercept):
            state, metrics = jstep(state, {"image": jnp.asarray(xs[i]),
                                           "label": jnp.asarray(ys[i])})
        jax.effects_barrier()
        out = step(_torch_batch(xs[i], ys[i]))
        want_loss = float(metrics["loss"])
        assert abs(float(out["loss"]) - want_loss) <= 1e-5 * abs(want_loss), (
            i, float(out["loss"]), want_loss)
        mine = interop.qat_variables(model)
        for path, want in leaves(np_tree({**state.params, **state.model_state})):
            got = get_path(mine, path)
            where = f"step {i}: {'/'.join(path)}"
            if want.dtype.kind in "bi":
                np.testing.assert_array_equal(got, want, err_msg=where)
            else:
                tol = 2e-5 * max(1e-30, float(np.abs(want).max()))
                assert got.shape == want.shape, where
                assert float(np.abs(got - want).max()) <= tol, (where, got, want)
    assert all(not v for v in rec.jax_out.values())  # every output was compared
    assert rec.total > 0 and rec.moved <= MAX_MOVED * rec.total, (rec.moved, rec.total)
    for h in hooks:
        h.remove()
    if toggle_at is not None:
        assert not any(bool(m.fake_quant_enabled) for n, m in model.named_modules()
                       if n.endswith("act_fq"))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_eager_and_jit_steps_agree_bit_for_bit(accum_steps):
    """Five steps from one state (the window, the switch, LSQ), the act
    observers switched back on for step 4 (they write the qparams while LSQ
    learns, so no gradient reaches them) and the act fake-quant off for
    step 5: losses, every variable and SGD's momentum buffers equal."""
    models = [_port_model(), _port_model()]
    interop.load_qat_variables(models[1], interop.qat_variables(models[0]))
    opts = [torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9) for m in models]
    steps = [make_train_step(m, o, jit=jit, accum_steps=accum_steps)
             for m, o, jit in zip(models, opts, (False, True))]
    r = np.random.RandomState(3)
    for i in range(5):
        for m in models:
            if i == 3:
                toggles.enable_observer(m)
            if i == 4:
                toggles.disable_fake_quant_on_act(m)
        x = r.randn(B, HW, HW, 3).astype(np.float32)
        y = r.randint(0, 10, size=B).astype(np.int32)
        losses = [s(_torch_batch(x, y))["loss"] for s in steps]
        assert torch.equal(losses[0], losses[1]), (i, losses)
        trees = [dict(leaves(interop.qat_variables(m))) for m in models]
        assert trees[0].keys() == trees[1].keys()
        for path, v in trees[0].items():
            np.testing.assert_array_equal(trees[1][path], v, err_msg=f"step {i} {path}")
    for p0, p1 in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(opts[0].state[p0]["momentum_buffer"],
                           opts[1].state[p1]["momentum_buffer"])


def test_jit_step_rejects_a_batch_that_does_not_split():
    model = _port_model()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                           accum_steps=3)
    xs, ys = _batches()
    with pytest.raises(ValueError, match="microbatches"):
        step(_torch_batch(xs[0], ys[0]))
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                        accum_steps=0)
