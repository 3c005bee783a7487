"""The port's eager QAT train step (``jit=False``: the quantizers' host phase
machine and the static fake-quant kernels) against the JAX package's
``make_train_step``:
a small ``QuantResNet`` (stages (1, 1), widths (8, 16), 8x8 inputs, B = 4,
``init_batches=1``) is created with ``create_train_state`` in JAX, carried
across with ``interop.load_qat_variables``, and both take three steps of SGD
(lr 1e-2, momentum 0.9) on the same seeded batches: the observer window,
then full LSQ.

Moved elements.  The convolutions and BatchNorm sums run in another order in
torch and in XLA, so a value can land on the other side of a rounding
boundary of the next activation quantizer and come out one quant step away.
Left alone, that one element moves BatchNorm's batch statistics, hence the
observer's range and every element after it.  So the test records every
activation quantizer's output in the JAX step (``jax.debug.callback``) and,
where the port's output differs by more than half a quant step, checks that
it differs by at most one quant step (plus 1e-5 of a step), counts it, and
hands on JAX's value (the gradient still flows through the port's own
fake-quant).  At most 1e-4 of the three steps' activation elements may move
(3 of 30,144; one moves), so a fake-quant that rounds one step wrong on a
share of its elements fails.

Tolerances, everything else: the loss within 1e-5 relative; every leaf of
``qat_variables`` within 2e-5 of the largest magnitude of that leaf (the
sums taken in another order), counters, flags and observer counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import linen as fnn

from _torch_port import Recorder, get_path as _get, leaves as _leaves, np_tree
from jaxlsq.models import QuantResNet as JQuantResNet
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.parallel import create_train_state, make_train_step as jmake_train_step
from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantResNet, default_qconfig
from jaxlsq_torch.parallel import make_eval_step, make_train_step

B, HW, STEPS = 4, 8, 3
MAX_MOVED = 1e-4


def test_resnet_trajectory_matches_jax_make_train_step():
    r = np.random.RandomState(0)
    xs = [r.randn(B, HW, HW, 3).astype(np.float32) for _ in range(STEPS)]
    ys = [r.randint(0, 10, size=B).astype(np.int32) for _ in range(STEPS)]

    jmodel = JQuantResNet(10, jdefault_qconfig(8, 8, per_channel_weights=True,
                                               init_batches=1),
                          stage_sizes=(1, 1), widths=(8, 16))
    tx = optax.sgd(1e-2, momentum=0.9)
    state = create_train_state(jmodel, tx, jnp.asarray(xs[0]))
    jstep = jmake_train_step(jmodel, tx, donate=False)

    model = QuantResNet(10, default_qconfig(8, 8, per_channel_weights=True,
                                            init_batches=1),
                        stage_sizes=(1, 1), widths=(8, 16), device="cpu")
    interop.load_qat_variables(model, np_tree({**state.params, **state.model_state}))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2,
                                                  momentum=0.9), jit=False)
    rec = Recorder()
    hooks = rec.attach(model)

    for i in range(STEPS):
        with fnn.intercept_methods(rec.intercept):
            state, metrics = jstep(state, {"image": jnp.asarray(xs[i]),
                                           "label": jnp.asarray(ys[i])})
        jax.effects_barrier()
        out = step({"image": torch.from_numpy(xs[i].transpose(0, 3, 1, 2).copy()),
                    "label": torch.from_numpy(ys[i]).long()})
        want_loss = float(metrics["loss"])
        assert abs(float(out["loss"]) - want_loss) <= 1e-5 * abs(want_loss), (
            i, float(out["loss"]), want_loss)
        mine = interop.qat_variables(model)
        for path, want in _leaves(np_tree({**state.params, **state.model_state})):
            got = _get(mine, path)
            where = f"step {i}: {'/'.join(path)}"
            if want.dtype.kind in "bi":
                np.testing.assert_array_equal(got, want, err_msg=where)
            else:
                tol = 2e-5 * max(1e-30, float(np.abs(want).max()))
                assert got.shape == want.shape, where
                assert float(np.abs(got - want).max()) <= tol, (where, got, want)
    assert rec.total > 0 and rec.moved <= MAX_MOVED * rec.total, (rec.moved, rec.total)
    for h in hooks:
        h.remove()

    # the eval step: running statistics, the qparams as trained, no state kept
    before = interop.qat_variables(model)
    logits = make_eval_step(model)({"image": torch.from_numpy(
        xs[0].transpose(0, 3, 1, 2).copy())})
    from jaxlsq.parallel import make_eval_step as jmake_eval_step

    want = np.asarray(jmake_eval_step(jmodel)(state, {"image": jnp.asarray(xs[0])}))
    assert logits.shape == (B, 10)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    after = interop.qat_variables(model)
    for path, v in _leaves(before):
        np.testing.assert_array_equal(_get(after, path), v)
