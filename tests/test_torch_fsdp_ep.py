"""The port's FSDP and expert-parallel placements and steps against the JAX
package's, on four gloo ranks (``tests/_torch_dist.py``'s ``leg_fsdp_ep``).

* ``fsdp_sharding`` on a ``QuantMLP`` (16 -> 64 -> 32 -> 4) and a narrow
  ``QuantResNet`` (widths 8 and 16), ``min_size`` 64: every leaf's placement
  is jaxlsq's ``fsdp_sharding`` on the carried tree, over a (4, 1) mesh of
  its virtual CPU devices (the sharded dim mapped from jaxlsq's layout,
  HWIO for a conv kernel, to the port's), and each rank's shard of each
  sharded parameter is byte for byte the ``addressable_shards`` entry
  jaxlsq puts on device r.  Three FSDP steps equal the replicated DP steps
  within 1e-6 of each leaf's largest magnitude (``tests/test_fsdp.py:88-116``),
  and a rank holds a quarter of every sharded parameter and its momentum;
  the eval step (the sharded weights all-gathered) gives the DP model's
  logits within 1e-6.
* ``moe_sharding`` on the bare ``QuantMoE`` (E = 4) and the MoE LM over a
  (data 2, expert 2) mesh: placements and shards as jaxlsq's.  One
  expert-parallel step equals jaxlsq's one-device step on the global batch
  (the loss within 1e-5, the leaves within 2e-5 of their largest magnitude:
  ``tests/test_moe.py:322-360, :428-460``), and no expert stack is ever
  all-gathered (a counting wrapper around
  ``torch.distributed.all_gather_into_tensor`` records each gathered
  tensor's storage: only the routing counts and the experts' float outputs
  are gathered, none of them a stack's).
* Expert-parallel serving of the converted MoE (``'static'``): each rank's
  rows equal the unsharded forward's within 1e-5 (``tests/test_moe.py:517-542``),
  with no int8 tensor gathered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import _torch_dist as td
from _torch_mesh import (assert_trees_close, carry, carry_state, jax_path, jax_variables,
                         get_leaf, port_variables, spec_dims)
from jaxlsq.models import QuantMLP as JQuantMLP
from jaxlsq.models import QuantMoE as JQuantMoE
from jaxlsq.models import QuantResNet as JQuantResNet
from jaxlsq.models import QuantTransformerLM as JQuantTransformerLM
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.parallel import fsdp_sharding as jfsdp_sharding
from jaxlsq.parallel import make_train_step as jmake_train_step
from jaxlsq.parallel import moe_sharding as jmoe_sharding
from jaxlsq_torch.models import default_qconfig

WORLD = 4
QKW = dict(per_channel_weights=True, init_batches=1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.Ranks("fsdp_ep", WORLD, str(tmp_path_factory.mktemp("fsdp_ep")))


def _jax_twin(kind):
    jqc = jdefault_qconfig(8, 8, **QKW)
    if kind == "mlp":
        return JQuantMLP(features=(64, 32, 4), qconfig=jqc), jnp.zeros((1, 16))
    if kind == "resnet":
        return (JQuantResNet(10, jqc, stage_sizes=(1, 1), widths=(8, 16)),
                jnp.zeros((1, 8, 8, 3)))
    if kind == "moe":
        return (JQuantMoE(hidden=td.MOE_H, num_experts=td.MOE_E, qconfig=jqc,
                          capacity_factor=float(td.MOE_E)), jnp.zeros((4, td.MOE_D)))
    return (JQuantTransformerLM(vocab=32, dim=16, depth=2, num_heads=4, qconfig=jqc,
                                max_len=16, moe_experts=td.MOE_E, moe_top_k=2,
                                moe_capacity_factor=td.MOE_E / 2.0),
            jnp.zeros((1, 4), jnp.int32))


def _expected(model, tree, jsh, axis, names):
    """The placement jaxlsq's sharding tree gives each port leaf, and the
    jaxlsq leaves placed under it."""
    placed = jax.device_put(tree, jsh)
    want, leaves = {}, {}
    for name in names:
        path, perm = jax_path(model, name)
        spec = get_leaf(jsh, path).spec
        dims = spec_dims(spec, axis)
        want[name] = [f"S({perm[dims[0]]})" if dims and a == axis else "R"
                      for a in ("data", "expert" if axis == "expert" else "model")]
        leaves[name] = (get_leaf(placed, path), perm)
    return want, leaves


@pytest.fixture(scope="module")
def refs(ranks):
    """jaxlsq's placements, shards and one-device steps, computed while the
    ranks run."""
    qc = default_qconfig(8, 8, **QKW)
    devs = np.asarray(jax.devices()[:WORLD])
    out = {}
    fmesh = Mesh(devs.reshape(WORLD, 1), ("data", "model"))
    for kind in ("mlp", "resnet"):
        model = td.fsdp_models(qc)[kind]
        jmodel, x0 = _jax_twin(kind)
        tree = carry(model, jmodel, x0)
        jsh = jfsdp_sharding(fmesh, tree, min_size=td.FSDP_MIN)
        out[("fsdp", kind)] = (model, fmesh) + _expected(model, tree, jsh, "data",
                                                         model.state_dict().keys())
    emesh = Mesh(devs.reshape(2, WORLD // 2), ("data", "expert"))
    for lm in (False, True):
        model = td.moe_models(qc, lm)
        jmodel, x0 = _jax_twin("lm" if lm else "moe")
        tree = carry(model, jmodel, x0)
        tree.pop("losses", None)
        jsh = jmoe_sharding(emesh, tree, num_experts=td.MOE_E, axis="expert")
        want, leaves = _expected(model, tree, jsh, "expert", model.state_dict().keys())
        tx = optax.sgd(1e-2)

        def loss_fn(out, b, lm=lm):
            if lm:
                return optax.softmax_cross_entropy_with_integer_labels(
                    out[:, :-1], b["label"][:, 1:]).mean()
            return jnp.mean((out - b["label"]) ** 2)

        state = carry_state(model, jmodel, x0, tx)
        state, m = jmake_train_step(jmodel, tx, loss_fn=loss_fn, donate=False)(
            state, {k: jnp.asarray(v.numpy()) for k, v in td.moe_batch(lm).items()})
        out[("ep", lm)] = (model, emesh, want, leaves, float(m["loss"]),
                           jax_variables(state))
    return out


def _assert_shards(rank, shards, leaves, mesh):
    dev = mesh.devices.flat[rank]
    for name, local in shards.items():
        leaf, perm = leaves[name]
        (shard,) = [s for s in leaf.addressable_shards if s.device == dev]
        np.testing.assert_array_equal(np.transpose(local, perm), np.asarray(shard.data),
                                      err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_fsdp_placement_and_shards_equal_jaxlsq(ranks, refs, kind):
    model, mesh, want, leaves = refs[("fsdp", kind)]
    results = ranks.results()
    assert results[0][("fsdp_placement", kind)] == want
    assert any(v[0] != "R" for v in want.values())
    for rank, out in enumerate(results):
        shards = out[("fsdp_shards", kind)]
        assert set(shards) == {n for n, v in want.items() if v[0] != "R"}
        _assert_shards(rank, shards, leaves, mesh)


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_fsdp_step_equals_dp_step_with_a_quarter_of_the_bytes(ranks, refs, kind):
    model, _, want, _ = refs[("fsdp", kind)]
    for out in ranks.results():
        dp, fs = out[("fsdp", kind)][False], out[("fsdp", kind)][True]
        np.testing.assert_allclose(fs["losses"], dp["losses"], rtol=1e-6)
        assert_trees_close(fs["state"], dp["state"], tol=1e-6)
        # the eval step gathers the sharded weights too
        assert_trees_close(fs["eval"], dp["eval"], tol=1e-6)
        params = dict(model.named_parameters())
        sharded = sum(p.numel() for n, p in params.items() if want[n][0] != "R")
        whole = sum(p.numel() for p in params.values())
        # each parameter and its momentum buffer, a quarter of the sharded ones
        assert dp["numel"] == 2 * whole
        assert fs["numel"] == 2 * (whole - sharded + sharded // WORLD)
        assert sharded >= 0.9 * whole


@pytest.mark.parametrize("lm", [False, True], ids=["moe", "moe_lm"])
def test_ep_placement_shards_and_step_equal_jaxlsq(ranks, refs, lm):
    model, mesh, want, leaves, loss, jvars = refs[("ep", lm)]
    results = ranks.results()
    assert results[0][("ep_placement", lm)] == want
    for rank, out in enumerate(results):
        _assert_shards(rank, out[("ep_shards", lm)], leaves, mesh)
        got = out[("ep", lm)]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert_trees_close(port_variables(model, got["state"]), jvars)
        gathers = out[("ep_gathers", lm)]
        assert gathers and not any(stack for _, _, stack in gathers), gathers


@pytest.mark.parametrize("lm", [False, True], ids=["moe", "moe_lm"])
def test_ep_over_the_data_axis_step_equals_jaxlsq(ranks, refs, lm):
    """The experts placed over 'data' (``moe_sharding(axis='data')``): each
    process runs its E/2 experts on the global slots, and the step is
    jaxlsq's one-device step on the global batch."""
    model, _, _, _, loss, jvars = refs[("ep", lm)]
    for out in ranks.results():
        got = out[("ep_data", lm)]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert_trees_close(port_variables(model, got["state"]), jvars)


def test_all_gather_backward_keeps_the_gradient_layout(ranks):
    """A one-process all-gather's backward hands the gradient back with its
    strides and bits, so a sum over it (a shared bias's gradient) is the
    meshless sum bit for bit."""
    for out in ranks.results():
        assert out["gather_grad_layout"] == (True, True, True)


def test_ep_serving_equals_unsharded_and_gathers_no_stack(ranks):
    for out in ranks.results():
        np.testing.assert_allclose(out["ep_serve"][True], out["ep_serve"][False],
                                   rtol=0, atol=1e-5)
        for dtype, shape, stack in out["ep_serve_gathers"]:
            assert dtype != "torch.int8" and not stack, (dtype, shape)
        assert out["ep_serve_counts"] == {"all_gather": 2, "all_reduce": 1}


def test_fsdp_step_refuses_jit(ranks):
    """Deviation 60: an FSDP-sharded state takes the eager step only."""
    msg = ranks.results()[0]["fsdp_jit"]
    assert msg is not None and "jit=False" in msg
