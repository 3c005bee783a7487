"""Weight decay on the quantizers' qparams across the observer window: the
port's train step against the JAX package's ``make_train_step``, whose
update is computed from the pre-step params and applied on top of the
observer-written qparams (``apply_updates(observer_params, update(grads,
old_params))``).

The harness is tests/test_torch_train.py's: a small ``QuantResNet`` (stages
(1, 1), widths (8, 16), 8x8 inputs, B = 4) from ``create_train_state``,
carried across with ``interop.load_qat_variables``, the same seeded batches,
activation-quantizer outputs handed over where a rounding boundary fell the
other way (at most 1e-4 of the elements), the loss within 1e-5 relative and
every leaf within 2e-5 of its largest magnitude; a qparam shift (``-zp·scale``,
0 for a zero point of 0) within 2e-5 of the larger of that and its
quantizer's scale: a shift of 4e-8 learned from 0 by one LSQ step carries
the summation-order noise of its gradient's cancelling sum, 1.6e-12 here.  The port's eager
(``jit=False``) and traced (``jit=True``, run eagerly on the CPU) steps
both run beside one JAX trajectory.  ``create_train_state`` runs the
observers on its batch, and a first step on that batch would move no
qparam: the state is made from a dim batch (0.1 x the first) with the
observers' counts set back to 0, so the window's step writes every
activation range anew (its scale about 10x).

* ``torch.optim.SGD(lr=1e-2, momentum=0.9, weight_decay=1e-1)`` against
  ``optax.chain(add_decayed_weights(1e-1), sgd(1e-2, momentum=0.9))`` over
  the one-batch observer window and 2 LSQ steps.  lr·wd = 1e-3 times the
  observer's move of each qparam is far outside the tolerance, so a step
  that decays the observer-written value fails.
* ``torch.optim.AdamW(lr=1e-3, weight_decay=1e-1)`` against
  ``optax.adamw(1e-3, weight_decay=1e-1)`` over the one-batch observer
  window only.  Adam's normalised step turns a near-zero gradient's
  summation-order noise into a step of up to lr (ROADMAP queue A item 1),
  so the noise grows with lr and with the steps: at lr 1e-2 one conv
  kernel element lands 1.0e-5 apart (5e-5 of its leaf), and a second
  window step leaves a BatchNorm bias, which starts at 0, 5e-4 of its
  leaf apart.  lr·wd = 1e-4 times the observer's move still puts a step
  that decays the observer-written value far outside the tolerance.
* Outside the window the step is the optimizer's own, bit for bit.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from _torch_port import Recorder, get_path, leaves, np_tree
from jaxlsq.models import QuantResNet as JQuantResNet
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.observers.minmax import ObserverState
from jaxlsq.parallel import create_train_state, make_train_step as jmake_train_step
from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantResNet, default_qconfig
from jaxlsq_torch.models.layers import refresh_host_state
from jaxlsq_torch.parallel import make_train_step

B, HW = 4, 8
MAX_MOVED = 1e-4
LR, WD = 1e-2, 1e-1
ADAM_LR = 1e-3


def _port_model(init_batches):
    return QuantResNet(10, default_qconfig(8, 8, per_channel_weights=True,
                                           init_batches=init_batches),
                       stage_sizes=(1, 1), widths=(8, 16), device="cpu")


def _torch_batch(x, y):
    return {"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
            "label": torch.from_numpy(y).long()}


def _fresh_observers(tree):
    if isinstance(tree, dict):
        return {k: _fresh_observers(v) for k, v in tree.items()}
    if isinstance(tree, ObserverState):
        return tree.replace(seen=jnp.zeros_like(tree.seen))
    return tree


def _trajectory(tx, make_opt, init_batches, steps):
    r = np.random.RandomState(0)
    xs = [r.randn(B, HW, HW, 3).astype(np.float32) for _ in range(steps)]
    ys = [r.randint(0, 10, size=B).astype(np.int32) for _ in range(steps)]
    jmodel = JQuantResNet(10, jdefault_qconfig(8, 8, per_channel_weights=True,
                                               init_batches=init_batches),
                          stage_sizes=(1, 1), widths=(8, 16))
    state = create_train_state(jmodel, tx, jnp.asarray(0.1 * xs[0]))
    state = state.replace(model_state=_fresh_observers(state.model_state))
    jstep = jmake_train_step(jmodel, tx, donate=False)
    ports = []
    for jit in (False, True):
        model = _port_model(init_batches)
        interop.load_qat_variables(model, np_tree({**state.params, **state.model_state}))
        rec = Recorder()
        rec.attach(model)
        ports.append((jit, make_train_step(model, make_opt(model), jit=jit), model, rec))
    for i in range(steps):
        with contextlib.ExitStack() as stack:
            for *_, rec in ports:
                stack.enter_context(fnn.intercept_methods(rec.intercept))
            state, metrics = jstep(state, {"image": jnp.asarray(xs[i]),
                                           "label": jnp.asarray(ys[i])})
        jax.effects_barrier()
        want_loss = float(metrics["loss"])
        jtree = np_tree({**state.params, **state.model_state})
        want = list(leaves(jtree))
        for jit, step, model, _ in ports:
            loss = float(step(_torch_batch(xs[i], ys[i]))["loss"])
            assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (jit, i, loss, want_loss)
            mine = interop.qat_variables(model)
            for path, w in want:
                got = get_path(mine, path)
                where = f"jit={jit} step {i}: {'/'.join(path)}"
                if w.dtype.kind in "bi":
                    np.testing.assert_array_equal(got, w, err_msg=where)
                else:
                    mag = float(np.abs(w).max())
                    if path[-1] == "shift":  # -zp * scale: held at the scale's size
                        mag = max(mag, float(np.abs(get_path(jtree, path[:-1] + ("scale",))).max()))
                    tol = 2e-5 * max(1e-30, mag)
                    assert float(np.abs(got - w).max()) <= tol, (where, got, w)
    for *_, rec in ports:
        assert rec.total > 0 and rec.moved <= MAX_MOVED * rec.total, (rec.moved, rec.total)


def test_sgd_weight_decay_across_the_observer_window_matches_jax():
    _trajectory(optax.chain(optax.add_decayed_weights(WD), optax.sgd(LR, momentum=0.9)),
                lambda m: torch.optim.SGD(m.parameters(), lr=LR, momentum=0.9,
                                          weight_decay=WD),
                init_batches=1, steps=3)


def test_adamw_in_the_observer_window_matches_jax():
    _trajectory(optax.adamw(ADAM_LR, weight_decay=WD),
                lambda m: torch.optim.AdamW(m.parameters(), lr=ADAM_LR, weight_decay=WD),
                init_batches=1, steps=1)


@pytest.mark.parametrize("jit", [False, True])
def test_step_outside_the_window_is_the_optimizers_own(jit):
    """After the window, ``make_train_step``'s step equals a plain forward,
    backward and ``optimizer.step()`` from the same state, bit for bit."""
    r = np.random.RandomState(5)
    batches = [_torch_batch(r.randn(B, HW, HW, 3).astype(np.float32),
                            r.randint(0, 10, size=B).astype(np.int32))
               for _ in range(3)]
    model = _port_model(init_batches=1)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9, weight_decay=WD)
    step = make_train_step(model, opt, jit=jit)
    step(batches[0])  # the observer window
    step(batches[1])
    ref = copy.deepcopy(model)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=LR, momentum=0.9, weight_decay=WD)
    ref_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    step(batches[2])
    refresh_host_state(list(ref.modules()))
    ref.train()
    loss = F.cross_entropy(ref(batches[2]["image"]), batches[2]["label"])
    ref_opt.zero_grad(set_to_none=True)
    loss.backward()
    for p in ref.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    ref_opt.step()
    mine, want = model.state_dict(), ref.state_dict()
    assert mine.keys() == want.keys()
    for k in mine:
        assert torch.equal(mine[k], want[k]), k
