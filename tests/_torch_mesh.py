"""JAX-side helpers of the port's multi-device tests: carry a port model's
variables into the JAX package's trees and compare trees."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import _torch_dist as td
from _torch_port import np_tree
from jaxlsq.models import QuantMLP as JQuantMLP
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.observers import MinMaxObserver as JMinMaxObserver
from jaxlsq.core.spec import QuantSpec as JQuantSpec
from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models.qconfig import QConfig as JQConfig
from jaxlsq.observers import LSQQuantizer as JLSQQuantizer
from jaxlsq.parallel import QATTrainState
from jaxlsq.parallel import make_pipeline_train_step as jmake_pipeline_train_step
from jaxlsq.parallel import pipeline_mesh as jpipeline_mesh
from jaxlsq.parallel import pipeline_sharding as jpipeline_sharding
from jaxlsq.parallel import stack_pipeline_variables as jstack
from jaxlsq.parallel import unstack_pipeline_variables as junstack
from jaxlsq.parallel import make_train_step as jmake_train_step
from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantMLP, default_qconfig
from jaxlsq_torch.observers import MinMaxObserver


def carry(model, jmodel, x0):
    """The port model's variables on the structure of ``jax.eval_shape`` of
    jaxlsq's ``init`` (its ``losses`` collection as zeros)."""
    tmpl = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), x0, training=False))
    tree = interop.qat_variables(model)

    def leaf(path, s):
        keys = [getattr(k, "key", None) or getattr(k, "name") for k in path]
        if keys[0] == "losses":  # the port keeps no variable of it
            return jnp.zeros(s.shape, s.dtype)
        node = tree
        for k in keys:
            node = node[k]
        return jnp.asarray(node, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tmpl)


def carry_state(model, jmodel, x0, tx):
    """The port model's variables as a jaxlsq ``QATTrainState``."""
    v = carry(model, jmodel, x0)
    params = {"params": v["params"], "qparams": v.get("qparams", {})}
    rest = {k: x for k, x in v.items() if k not in ("params", "qparams")}
    return QATTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=rest,
                         opt_state=tx.init(params))


def jax_variables(state):
    """A ``QATTrainState``'s variables as numpy (without ``losses``)."""
    v = np_tree({**state.params, **state.model_state})
    v.pop("losses", None)
    return v


def port_variables(model, state_dict):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return interop.qat_variables(model)


def assert_trees_close(got, want, tol=2e-5, where=""):
    """Float leaves within ``tol`` of the leaf's largest magnitude, integer
    and bool leaves equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_trees_close(got[k], want[k], tol, f"{where}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape or g.size == w.size, (where, g.shape, w.shape)
    g = g.reshape(w.shape)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=where)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1.0, float(np.abs(w).max())),
                                   err_msg=where)


def tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def jax_path(model, name):
    """The JAX package's variables path of the port state-dict leaf
    ``name``, and for each dim of the JAX layout the port's dim that holds
    it."""
    from torch import nn

    from jaxlsq_torch.models.layers import FakeQuantize
    from jaxlsq_torch.models.norm import BatchNorm
    from jaxlsq_torch.parallel.fsdp import jax_layout

    mname, _, leaf = name.rpartition(".")
    owner = model.get_submodule(mname) if mname else model
    mpath = tuple(mname.split(".")) if mname else ()
    t = owner.get_parameter(leaf) if leaf in dict(owner.named_parameters(recurse=False)) \
        else owner.get_buffer(leaf)
    perm = jax_layout(owner, leaf, t.dim())
    if isinstance(owner, FakeQuantize):
        if leaf in ("scale", "shift"):
            return ("qparams",) + mpath + ("qp", leaf), perm
        fields = {b: f for f, b in FakeQuantize.OBS_BUFFERS.items()}
        if leaf in fields:
            return ("quant_state",) + mpath + ("qs", "obs", fields[leaf]), perm
        return ("quant_state",) + mpath + ("qs", leaf), perm
    if isinstance(owner, BatchNorm) and leaf in ("mean", "var"):
        return ("batch_stats",) + mpath + (leaf,), perm
    if isinstance(owner, nn.LayerNorm):
        return ("params",) + mpath + ({"weight": "scale"}.get(leaf, leaf),), perm
    if isinstance(owner, nn.Linear) and leaf == "weight":
        return ("params",) + mpath + ("kernel",), perm
    return ("params",) + mpath + (leaf,), perm


def spec_dims(spec, axis):
    """The JAX dims a ``PartitionSpec`` shards over mesh ``axis``."""
    return [d for d, a in enumerate(tuple(spec)) if a == axis]


def get_leaf(tree, path):
    """The leaf at ``path`` of a tree of dicts and flax structs."""
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
    return tree


def mlp_qc(obs, jaxlsq=False):
    if jaxlsq:
        return td.mlp_qconfig(obs, jdefault_qconfig, JMinMaxObserver)
    return td.mlp_qconfig(obs, default_qconfig, MinMaxObserver)


def jax_mlp_run(obs, accum=1):
    """jaxlsq's jitted step on the MLP legs' global batches: the port
    model (for its layout), the losses and the final variables."""
    qc = mlp_qc(obs)
    model = QuantMLP(16, td.MLP_FEATURES, qc, device="cpu", seed=1)
    jmodel = JQuantMLP(features=td.MLP_FEATURES, qconfig=mlp_qc(obs, jaxlsq=True))
    tx = optax.sgd(0.05, momentum=0.9)
    state = carry_state(model, jmodel, jnp.zeros((1, 16)), tx)
    step = jmake_train_step(jmodel, tx, donate=False, accum_steps=accum)
    losses = []
    for b in td.mlp_batches(td.MLP_STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return model, losses, jax_variables(state)


# ---------------------------------------------------------------- pipeline

def pp_jmodel(kind, case="learned", **kw):
    qc = td.pp_qconfig(kind, jdefault_qconfig, JLSQQuantizer, JQuantSpec, JQConfig)
    return JLM(vocab=td.PP_VOCAB, dim=td.PP_DIM, depth=kw.pop("depth", td.PP_DEPTH),
               num_heads=td.PP_HEADS, qconfig=qc, max_len=td.PP_T,
               **{**td.PP_CASES[case], **kw})


def jax_pipeline_state(kind, case, data, stage, tx):
    """jaxlsq's stacked pipeline state on a (data, stage) mesh of the
    virtual devices, carried from the port's seeded LM."""
    jm = pp_jmodel(kind, case)
    v = carry(td.pp_model(kind, case), jm, jnp.zeros((2, td.PP_T), jnp.int32))
    v.pop("losses", None)
    params = {c: jstack(v[c], td.PP_DEPTH, stage) for c in ("params", "qparams")}
    rest = {k: jstack(x, td.PP_DEPTH, stage) for k, x in v.items()
            if k not in ("params", "qparams")}
    state = QATTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=rest,
                          opt_state=tx.init(params))
    mesh = jpipeline_mesh(stage=stage, data=data)
    return jm, mesh, jax.tree.map(jax.device_put, state, jpipeline_sharding(mesh, state))


@functools.lru_cache(maxsize=None)
def jax_pipeline(kind, case="learned", data=1, stage=td.PP_WORLD, steps=td.PP_STEPS, seed=11):
    """jaxlsq's pipeline trained as ``td.pp_run`` trains the port's: the
    losses and the unstacked variables, as numpy and as they are."""
    tx = optax.sgd(td.PP_LR, momentum=0.9)
    jm, mesh, state = jax_pipeline_state(kind, case, data, stage, tx)
    step = jmake_pipeline_train_step(jm, tx, mesh, num_microbatches=td.PP_MB, donate=False)
    losses = []
    for b in td.pp_batches(seed, steps):
        state, m = step(state, {"input": jnp.asarray(b), "label": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    host = jax.device_get(state)
    tree = {"params": host.params["params"], "qparams": host.params["qparams"],
            "quant_state": host.model_state["quant_state"]}
    raw = {c: junstack(t, td.PP_DEPTH) for c, t in tree.items()}
    return losses, np_tree(raw), raw


def assert_tree_close(got, want, rtol, atol, where=""):
    """Float leaves within ``atol + rtol·|want|``, integer and bool leaves
    equal, over the same keys."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], rtol, atol, f"{where}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.size == w.size, (where, g.shape, w.shape)
    g = g.reshape(w.shape)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=where)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=where)


def assert_matches_jaxlsq(res, losses, want):
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    got = res["gathered"]
    assert set(got) == set(want)
    for col in ("params", "qparams"):
        assert_tree_close(got[col], want[col], 2e-5, 2e-6, col)
    assert_tree_close(got["quant_state"], want["quant_state"], 1e-5, 1e-6, "quant_state")
