"""The port's multi-device QAT step against the JAX package's one-device step
on the global batch, on four gloo ranks (``tests/_torch_dist.py``'s
``leg_parallel``: one group of processes for the module, every leg in it).

jaxlsq's step under a mesh is its one-device step on the global batch
(GSPMD traces it at the global shapes), so the reference here is jaxlsq's
jitted ``make_train_step`` without a mesh, on the global batch, from the
port's initial state carried across with ``interop`` (on the structure of
``jax.eval_shape`` of jaxlsq's ``init``).

* The mesh: ``make_mesh()`` is (4, 1), ``make_mesh(model=2)`` (2, 2), and
  jaxlsq's errors (``tests/test_parallel.py:32-38``).
* The observers' windows: ``tests/test_torch_parallel_observers.py``.
* ``accum_steps=2``: the MLP of that file (16 -> 32 -> 4, w8a8, a 2-batch
  window, four steps of 16 rows) takes jaxlsq's microbatches of the global
  batch, in both regimes: the loss within 1e-5, every leaf within 2e-5 of
  its largest magnitude, counters, flags and observer counts equal.
* BatchNorm: a narrow ``QuantResNet`` (widths 4 and 8, 8x8 images, 8 rows)
  for two steps in both regimes, the batch moments global, every leaf
  within 2e-5 of its largest magnitude.  No hand-over (deviation 14) is
  applied: at this size no activation lands a quant step away from
  jaxlsq's, and one that did would fail the bound (at resnet18_cifar's
  width it does: phase 19's gloo leg on the card hands such elements over
  and counts them).
* The eval step: the ranks' rows of the logits, concatenated, within 1e-5
  of jaxlsq's eval on the global batch (an observer still in its window
  reads the global range).
* The gradient scale (``tests/test_parallel.py:66-93``): the same 32 rows
  twice over, spread over the ranks, give a dS √2 times the once-over one,
  each within 1e-5 of jaxlsq's on the global array.
* Sequence parallelism (``tests/test_parallel.py:186-233``): the LM's
  tokens over ('data', 'model') of a 2 x 2 mesh, learned and rope
  positions, one step: the loss within 1e-6, the leaves within rtol 2e-5
  / atol 2e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _torch_dist as td
from _torch_mesh import (assert_trees_close, carry_state, jax_mlp_run, jax_variables, mlp_qc,
                         port_variables, tree_leaves)
from jaxlsq import QuantSpec as JQuantSpec
from jaxlsq import fake_quant as jfake_quant
from jaxlsq.models import QuantMLP as JQuantMLP
from jaxlsq.models import QuantResNet as JQuantResNet
from jaxlsq.models import QuantTransformerLM as JQuantTransformerLM
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.parallel import make_eval_step as jmake_eval_step
from jaxlsq.parallel import make_train_step as jmake_train_step
from jaxlsq_torch.models import QuantMLP, QuantResNet, QuantTransformerLM, default_qconfig

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.Ranks("parallel", WORLD, str(tmp_path_factory.mktemp("parallel")))


def _jax_eval():
    model = QuantMLP(16, td.MLP_FEATURES, mlp_qc("minmax"), device="cpu", seed=1)
    jmodel = JQuantMLP(features=td.MLP_FEATURES, qconfig=mlp_qc("minmax", jaxlsq=True))
    state = carry_state(model, jmodel, jnp.zeros((1, 16)), optax.sgd(0.1))
    b = td.mlp_batches(1, seed=9)[0]
    return np.asarray(jmake_eval_step(jmodel)(state, {k: jnp.asarray(v) for k, v in b.items()}))


def _jax_bn():
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    model = QuantResNet(10, qc, stage_sizes=(1, 1), widths=(4, 8), device="cpu")
    jmodel = JQuantResNet(10, jdefault_qconfig(8, 8, per_channel_weights=True, init_batches=1),
                          stage_sizes=(1, 1), widths=(4, 8))
    tx = optax.sgd(0.01, momentum=0.9)
    state = carry_state(model, jmodel, jnp.zeros((1, 8, 8, 3)), tx)
    step = jmake_train_step(jmodel, tx, donate=False)
    losses = []
    for b in td.image_batches(2):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return model, losses, jax_variables(state)


def _jax_grad_scale():
    half = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    spec = JQuantSpec(quant_min=0, quant_max=15)
    grad = jax.jit(jax.grad(
        lambda a, s, b: jnp.sum(jfake_quant(a, s, b, spec, impl="reference")), argnums=1))
    return [float(grad(jnp.asarray(x), jnp.array([0.1]), jnp.array([0.0]))[0])
            for x in (half, np.concatenate([half, half]))]


def _jax_sp(case):
    kw = td.SP_CASES[case]
    model = QuantTransformerLM(64, 32, 1, 4, default_qconfig(8, 8, init_batches=1),
                               max_len=16, device="cpu", seed=5, **kw)
    jmodel = JQuantTransformerLM(vocab=64, dim=32, depth=1, num_heads=4,
                                 qconfig=jdefault_qconfig(8, 8, init_batches=1), max_len=16,
                                 **kw)
    tx = optax.sgd(1e-2)
    tokens = jnp.asarray(td.token_batches(1, 4, 16, 64, seed=0)[0])
    state = carry_state(model, jmodel, tokens[:1], tx)

    def loss_fn(logits, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], batch["label"][:, 1:]).mean()

    step = jax.jit(jmake_train_step(jmodel, tx, loss_fn=loss_fn, jit=False))
    state, m = step(state, {"input": tokens, "label": tokens})
    return model, float(m["loss"]), jax_variables(state)


@pytest.fixture(scope="module")
def refs(ranks):
    """Every jaxlsq reference, computed while the ranks run."""
    out = {"accum": jax_mlp_run("minmax", accum=2)}
    out["eval"] = _jax_eval()
    out["bn"] = _jax_bn()
    out["grad_scale"] = _jax_grad_scale()
    for case in td.SP_CASES:
        out[("sp", case)] = _jax_sp(case)
    return out


def test_mesh_shapes_and_errors(ranks, refs):
    out = ranks.results()[0]
    assert out["mesh_shapes"] == [(4, 1), (2, 2)]
    assert out["mesh_errors"] == ["mesh 5x3 needs 15 devices, have 4",
                                  "4 devices not divisible by model=3"]


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "traced"])
def test_dp_accum_steps_take_jaxlsq_global_microbatches(ranks, refs, jit):
    model, want_losses, want = refs["accum"]
    got = ranks.results()[0][("accum", jit)]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert_trees_close(port_variables(model, got["state"]), want)


def test_eval_step_rows_equal_jaxlsq_global_eval(ranks, refs):
    got = np.concatenate([out["eval"] for out in ranks.results()])
    np.testing.assert_allclose(got, refs["eval"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "traced"])
def test_dp_batchnorm_moments_are_global(ranks, refs, jit):
    model, losses, want = refs["bn"]
    got = ranks.results()[0][("bn", jit)]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert_trees_close(port_variables(model, got["state"]), want)


def test_grad_scale_uses_the_global_numel(ranks, refs):
    for out in ranks.results():
        np.testing.assert_allclose(out["grad_scale"], refs["grad_scale"], rtol=1e-5)
        np.testing.assert_allclose(out["grad_scale"][1],
                                   2 * out["grad_scale"][0] / math.sqrt(2), rtol=1e-5)


@pytest.mark.parametrize("pe", ["learned", "rope", "window"])
def test_sequence_parallel_lm_step_equals_jaxlsq(ranks, refs, pe):
    model, loss, want = refs[("sp", pe)]
    got = ranks.results()[0][("sp", pe)]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
    port = port_variables(model, got["state"])
    for col in ("params", "qparams"):
        for (pa, a), (pb, b) in zip(tree_leaves(port[col]), tree_leaves(want[col])):
            assert pa == pb
            np.testing.assert_allclose(np.asarray(a).reshape(np.shape(b)), b,
                                       rtol=2e-5, atol=2e-6, err_msg=str(pa))


def test_sequence_parallel_refuses_flash_and_windows(ranks):
    """Deviation 61: under a sequence split the LM attends through the
    gathered k/v with the causal offset ('xla'); 'flash' raises. A window
    takes the same masked path (``pe='window'`` above)."""
    for msg in ranks.results()[0]["sp_refusals"]:
        assert msg is not None and "train_attn_impl='xla'" in msg


def test_donate_is_accepted_and_changes_nothing():
    """Deviation 59: ``donate`` is jaxlsq's argument; the step updates the
    model in place either way."""
    import torch

    from jaxlsq_torch.parallel import make_train_step

    states = []
    for donate in (True, False):
        model = QuantMLP(16, td.MLP_FEATURES, mlp_qc("minmax"), device="cpu", seed=1)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.05),
                               jit=False, donate=donate)
        for b in td.mlp_batches(2):
            step({k: torch.from_numpy(v) for k, v in b.items()})
        states.append(model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k
