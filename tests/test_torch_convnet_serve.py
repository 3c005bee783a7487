"""The port's conv nets against the JAX package's, train to serve:
``QuantMobileNetV2`` (the narrow one of ``tests/test_zoo_models.py``: stages
(1, 8, 1, 1), (6, 16, 1, 2), stem 8, head 32, 4 classes), ``QuantCNN``
(widths (8, 16)) and a narrow ``QuantResNet`` (stages (1, 1), widths (8,
16)), on 16x16 seeded numpy images at B = 2.  The JAX package's variables
(its own jitted ``model.init``, its trained state, its ``convert``) are
carried across with ``jaxlsq_torch.interop``.

* QAT forward, training and eval mode: logits within 1e-5 of the largest
  reference magnitude (the convolution and BatchNorm sums run in another
  order; the fake-quantized operands are the same bits); in training mode
  the JAX forward's activation is handed over where a rounding boundary
  fell the other way, as in the steps below.
* Three SGD steps of the MobileNetV2 (``init_batches=1``: the observer
  window, then LSQ) leaf by leaf as ``tests/test_torch_train.py`` holds the
  resnet: the loss within 1e-5 relative, every leaf within 2e-5 of its
  largest magnitude, the JAX step's activation handed over where a rounding
  boundary fell the other way (deviation 14 of ROADMAP.md), at most 1e-4 of
  the elements.  A leaf whose values all lie below 1e-4 is held to 2e-9
  absolute instead: such a leaf (a BatchNorm bias next to 1e-5, an
  activation shift next to 1e-8) is lr times a sum of gradient terms that
  nearly cancel, and another summation order moves it by more than 2e-5 of
  itself.
* ``serve.convert`` of the trained w8a8 tree and of a w4a8 tree (drawn by
  the port) byte for byte against the JAX package's: data, scale and zero point of every pack,
  including the int4 depthwise (in axis 1, padded to 2) and stem (in axis 3,
  padded to 4) packs.
* Served logits (``for_serving('static')``, the converted tree through
  ``load_variables``) within 1e-4 of the JAX package's served apply, for the
  three nets; ``'dynamic'`` raises ``ValueError``; ``'static_int8'``
  serves within 5e-3 of ``'static'`` (the JAX package's own tolerance).
* ``reestimate_batch_stats`` over 4 batches, inside the observer window and
  after it: every BatchNorm statistic within 1e-5 of its largest magnitude
  of the JAX package's (the activations handed over as in the steps), and
  every quantizer parameter and buffer bit-equal to what it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from _torch_port import Recorder, get_path, leaves, np_tree, torch_tree_to_np
from jaxlsq.models import QuantCNN as JQuantCNN
from jaxlsq.models import QuantMobileNetV2 as JQuantMobileNetV2
from jaxlsq.models import QuantResNet as JQuantResNet
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.parallel import make_train_step as jmake_train_step
from jaxlsq.parallel.train import QATTrainState
from jaxlsq.serve import convert as jconvert
from jaxlsq.utils import reestimate_batch_stats as jreestimate
from jaxlsq_torch import interop
from jaxlsq_torch.models import (QuantCNN, QuantMobileNetV2, QuantResNet,
                                 default_qconfig)
from jaxlsq_torch.models.layers import FakeQuantize
from jaxlsq_torch.parallel import make_eval_step, make_train_step
from jaxlsq_torch.serve import convert
from jaxlsq_torch.utils import reestimate_batch_stats

B, HW, CLASSES, STEPS = 4, 16, 4, 3
MUTABLE = ["quant_state", "qparams", "batch_stats"]
MNV2 = dict(stages=((1, 8, 1, 1), (6, 16, 1, 2)), stem_width=8, head_width=32)
NETS = {
    "mnv2": (lambda qc: JQuantMobileNetV2(num_classes=CLASSES, qconfig=qc, **MNV2),
             lambda qc: QuantMobileNetV2(CLASSES, qc, device="cpu", **MNV2)),
    "cnn": (lambda qc: JQuantCNN(num_classes=CLASSES, qconfig=qc, widths=(8, 16)),
            lambda qc: QuantCNN(CLASSES, qc, widths=(8, 16), image_size=HW, device="cpu")),
    "resnet": (lambda qc: JQuantResNet(CLASSES, qc, stage_sizes=(1, 1), widths=(8, 16)),
               lambda qc: QuantResNet(CLASSES, qc, stage_sizes=(1, 1), widths=(8, 16),
                                      device="cpu")),
}


def _qcs(wbits):
    kw = dict(per_channel_weights=True, init_batches=1)
    return jdefault_qconfig(wbits, 8, **kw), default_qconfig(wbits, 8, **kw)


def _jconvert(tree, jqc):
    """The JAX package's ``convert``, jitted (op by op it compiles each op)."""
    return jax.jit(lambda v: jconvert(v, jqc))(tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, rel, what):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


@pytest.fixture(scope="module")
def data():
    r = np.random.RandomState(0)
    return {"x": [r.randn(B, HW, HW, 3).astype(np.float32) for _ in range(STEPS + 4)],
            "y": [r.randint(0, CLASSES, size=B).astype(np.int32) for _ in range(STEPS)]}


@pytest.fixture(scope="module")
def jinit(data):
    """Jitted ``model.init`` variables per (net, weight bits), made once."""
    cache = {}

    def get(net, wbits):
        if (net, wbits) not in cache:
            jmodel = NETS[net][0](_qcs(wbits)[0])
            cache[net, wbits] = jax.jit(lambda x: jmodel.init(
                jax.random.key(0), x, training=False))(jnp.asarray(data["x"][0]))
        return cache[net, wbits]
    return get


@pytest.fixture(scope="module")
def drawn(data):
    """A QAT tree drawn by the port per (net, weight bits): ``init_qat_variables``
    and one eval forward that feeds the activation observers, as flax's
    ``init`` does; as JAX arrays, without ``quant_state`` (convert reads none)."""
    cache = {}

    def get(net, wbits):
        if (net, wbits) not in cache:
            model = NETS[net][1](_qcs(wbits)[1])
            model.eval()
            with torch.no_grad():
                model(_nchw(data["x"][0]))
            tree = interop.qat_variables(model)
            del tree["quant_state"]
            cache[net, wbits] = jax.tree.map(jnp.asarray, tree)
        return cache[net, wbits]
    return get


@pytest.fixture(scope="module")
def trained(data, jinit):
    """The narrow MobileNetV2 at w8a8: three jitted JAX SGD steps from
    ``create_train_state`` and the port's three eager steps from the same
    variables, each step's loss and state on both sides."""
    jqc, qc = _qcs(8)
    jmodel = NETS["mnv2"][0](jqc)
    tx = optax.sgd(1e-2, momentum=0.9)
    variables = jinit("mnv2", 8)  # create_train_state's, from the jitted init
    params = {"params": variables["params"], "qparams": variables["qparams"]}
    state = QATTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          model_state={k: v for k, v in variables.items()
                                       if k not in params},
                          opt_state=tx.init(params))
    jstep = jmake_train_step(jmodel, tx, donate=False)
    model = NETS["mnv2"][1](qc)
    interop.load_qat_variables(model, np_tree({**state.params, **state.model_state}))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2,
                                                  momentum=0.9), jit=False)
    rec = Recorder()
    hooks = rec.attach(model)
    out = []
    for i in range(STEPS):
        with fnn.intercept_methods(rec.intercept):
            state, metrics = jstep(state, {"image": jnp.asarray(data["x"][i]),
                                           "label": jnp.asarray(data["y"][i])})
        jax.effects_barrier()
        loss = step({"image": _nchw(data["x"][i]),
                     "label": torch.from_numpy(data["y"][i]).long()})["loss"]
        out.append((float(metrics["loss"]), float(loss),
                    np_tree({**state.params, **state.model_state}),
                    interop.qat_variables(model)))
    for h in hooks:
        h.remove()
    return {"steps": out, "moved": rec.moved, "total": rec.total,
            "final": {**state.params, **state.model_state}}


@pytest.mark.parametrize("net", ["mnv2", "cnn"])
def test_qat_forward_matches_jax(net, data, jinit):
    jqc, qc = _qcs(8)
    jmodel, model = NETS[net][0](jqc), NETS[net][1](qc)
    variables = jinit(net, 8)
    interop.load_qat_variables(model, np_tree(variables))
    x = data["x"][1]
    rec = Recorder()
    for training in (False, True):
        with fnn.intercept_methods(rec.intercept):
            want, _ = jax.jit(lambda v, x: jmodel.apply(v, x, training=training,
                                                        mutable=MUTABLE))(variables, x)
        jax.effects_barrier()
        if training:
            hooks = rec.attach(model)
            model.train()
            with torch.no_grad():
                got = model(_nchw(x))
            for h in hooks:
                h.remove()
        else:  # the eval step keeps no state, as the JAX apply's is dropped
            got = make_eval_step(model)({"image": _nchw(x)})
            rec.jax_out.clear()
        _close(got.numpy(), want, 1e-5, f"{net} training={training}")
    assert rec.total > 0 and rec.moved <= 1e-4 * rec.total, (rec.moved, rec.total)


def test_mnv2_steps_match_jax(trained):
    for i, (want_loss, loss, want, mine) in enumerate(trained["steps"]):
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (i, loss, want_loss)
        for path, w in leaves(want):
            got = get_path(mine, path)
            where = f"step {i}: {'/'.join(path)}"
            if w.dtype.kind in "bi":
                np.testing.assert_array_equal(got, w, err_msg=where)
            else:
                tol = 2e-5 * max(1e-4, float(np.abs(w).max()))
                assert float(np.abs(got - w).max()) <= tol, (where, got, w)
    assert trained["total"] > 0 and trained["moved"] <= 1e-4 * trained["total"], (
        trained["moved"], trained["total"])


def _packs(tree, prefix=()):
    """``(path, pack dict)`` of every PackedWeight in a numpy tree."""
    if isinstance(tree, dict) and "bits" in tree:
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packs(v, prefix + (k,))


@pytest.mark.parametrize("wbits", [8, 4])
def test_convert_matches_jax_byte_for_byte(wbits, trained, drawn):
    jqc, qc = _qcs(wbits)
    jtree = trained["final"] if wbits == 8 else drawn("mnv2", 4)
    want = np_tree(_jconvert(jtree, jqc))
    got = torch_tree_to_np(convert(interop._to_torch(np_tree(jtree), "cpu"), qc))
    assert sorted(got) == sorted(want) == ["batch_stats", "params", "quantized"]
    wpacks, gpacks = dict(_packs(want["quantized"])), dict(_packs(got["quantized"]))
    assert sorted(wpacks) == sorted(gpacks) and len(wpacks) == 8
    for path, w in wpacks.items():
        g = gpacks[path]
        for f in ("bits", "axis", "k_axis", "group_size"):
            assert g[f] == w[f], (path, f)
        assert tuple(g["orig_shape"]) == tuple(w["orig_shape"]), path
        for f in ("data", "scale", "zero_point"):
            assert g[f].dtype == w[f].dtype and g[f].shape == w[f].shape, (path, f)
            assert g[f].tobytes() == w[f].tobytes(), (path, f)
    if wbits == 4:  # the odd in axes: depthwise 1 -> 1 byte row, stem 3 -> 2
        assert wpacks[("stage0_block0", "depthwise", "kernel")]["data"].shape == (3, 3, 1, 8)
        assert wpacks[("stem", "kernel")]["data"].shape == (3, 3, 2, 8)
    for col in ("params", "batch_stats"):
        for path, w in leaves(want[col]):
            assert get_path(got[col], path).tobytes() == w.tobytes(), (col, path)
    for path, w in leaves({k: v for k, v in want["quantized"].items()}):
        if path[-1] in ("act_scale", "act_zp"):
            assert get_path(got["quantized"], path).tobytes() == w.tobytes(), path


@pytest.mark.parametrize("net,wbits", [("mnv2", 8), ("mnv2", 4), ("cnn", 8),
                                       ("resnet", 4)])
def test_served_logits_match_jax(net, wbits, data, jinit, drawn, trained):
    jqc, qc = _qcs(wbits)
    if net == "cnn":
        jtree = jinit("cnn", 8)
    else:
        jtree = trained["final"] if wbits == 8 else drawn(net, wbits)
    served = _jconvert(jtree, jqc)
    jserve = NETS[net][0](jqc.for_serving("static", "xla"))
    x = data["x"][STEPS]
    want = np.asarray(jax.jit(lambda v, x: jserve.apply(v, x, training=False))(served, x))
    model = NETS[net][1](qc.for_serving("static"))
    interop.load_variables(model, np_tree(served))
    model.eval()
    with torch.no_grad():
        got = model(_nchw(x))
    _close(got.numpy(), want, 1e-4, f"{net} w{wbits}a8 served")
    again = NETS[net][1](qc.for_serving("static"))  # the QAT tree, converted here
    interop.load_variables(again, np_tree(jtree))
    again.eval()
    with torch.no_grad():
        assert torch.equal(again(_nchw(x)), got)


def test_serve_modes_and_leftovers():
    qc = default_qconfig(8, 8, per_channel_weights=True)
    with pytest.raises(ValueError, match="dynamic"):
        QuantMobileNetV2(CLASSES, qc.for_serving("dynamic"), device="cpu", **MNV2)
    model = QuantCNN(CLASSES, qc.for_serving("static"), widths=(8,), image_size=4,
                     device="cpu")
    qat = QuantCNN(CLASSES, qc, widths=(8,), image_size=4, device="cpu")
    tree = interop.qat_variables(qat)
    # 'static_int8' serves the integer conv and matmul, close to 'static'
    int8 = QuantCNN(CLASSES, qc.for_serving("static_int8"), widths=(8,), image_size=4,
                    device="cpu")
    interop.load_variables(int8, tree)
    interop.load_variables(model, tree)
    x = torch.as_tensor(np.random.RandomState(1).randn(2, 3, 4, 4).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(int8(x), model(x), rtol=5e-3, atol=5e-3)
    tree["batch_stats"] = {"bn": {"mean": np.zeros(8, np.float32)}}
    with pytest.raises(ValueError, match="batch_stats/bn/mean"):
        interop.load_variables(model, tree)
    with pytest.raises(ValueError, match="serve-mode"):
        interop.load_variables(qat, interop.qat_variables(qat))


def _quantizer_state(model):
    return {f"{n}.{k}": v.detach().clone() for n, m in model.named_modules()
            if isinstance(m, FakeQuantize)
            for k, v in list(m.named_parameters()) + list(m.named_buffers())}


@pytest.mark.parametrize("when", ["window", "after"])
def test_bn_reestimation_matches_jax(when, data, jinit, trained):
    jqc, qc = _qcs(8)
    jtree = jinit("mnv2", 8) if when == "window" else trained["final"]
    tree = np_tree(jtree)
    jmodel = NETS["mnv2"][0](jqc)
    xs = np.stack(data["x"][STEPS:STEPS + 4])
    rec = Recorder()
    with fnn.intercept_methods(rec.intercept):
        want = np_tree(jreestimate(jmodel, jtree, jnp.asarray(xs))["batch_stats"])
    jax.effects_barrier()
    model = NETS["mnv2"][1](qc)
    interop.load_qat_variables(model, tree)
    model.eval()
    before = _quantizer_state(model)
    hooks = rec.attach(model)
    reestimate_batch_stats(model, torch.from_numpy(xs.transpose(0, 1, 4, 2, 3).copy()))
    for h in hooks:
        h.remove()
    assert rec.total > 0 and rec.moved <= 1e-4 * rec.total, (rec.moved, rec.total)
    assert not model.training
    after = _quantizer_state(model)
    assert before.keys() == after.keys() and len(before) == 8 * 2 * 10
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    got = interop.qat_variables(model)["batch_stats"]
    moved = 0
    for path, w in leaves(want):
        _close(get_path(got, path), w, 1e-5, "/".join(path))
        moved += int(not np.array_equal(w, get_path(tree["batch_stats"], path)))
    assert moved == len(list(leaves(want)))  # every statistic was refreshed
