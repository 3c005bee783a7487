"""``jaxlsq_torch.models.quantize_model`` (a module swap of stock ``nn.Linear``
/ ``nn.Conv2d`` / ``nn.Embedding``) and ``QuantDenseGeneral`` against the
JAX package's ``quantize_model`` (flax method interception) and
``QuantDenseGeneral``, on the same seeded numpy inputs.

* Stock twins: torch twins of ``tests/test_quantize_model.py``'s
  ``StockMLP``, ``StockCNN`` and ``StockSetupModel`` (same names, same
  module names; the CNN flattens NHWC-ordered features, as flax does).  The
  JAX package's jitted ``init`` variables carry across and come out again
  unchanged; three SGD steps across the 2-batch observer window, eager and
  traced, leaf by leaf (the tolerances of ``tests/test_torch_convnet_serve.py``:
  the loss within 1e-5 relative, every leaf within 2e-5 of its largest
  magnitude or 2e-9 absolute below 1e-4, integers equal, the JAX step's
  activation handed over where a rounding boundary fell the other way,
  at most 1e-4 of the elements); ``convert`` and the served logits for
  ``act_mode`` 'none' and 'static' at w8 and w4 within 1e-4 of the largest
  reference magnitude (the packs byte for byte).
* The swapped ``StockMLP``/``StockCNN`` against the port's hand-built
  ``QuantMLP``/``QuantCNN`` with the same variables: each layer's
  fake-quantized weight (a Linear's transposed) and its quantizers'
  outputs, qparams and buffers bit for bit.
* ``QuantDenseGeneral`` (``axis=(1, 2)``, features (4, 2)) against the JAX
  package's: the QAT forward, one step, the ``dg_flat`` pack byte for byte
  and the served logits.
* ``skip``, overrides, the stock layout, and every refusal naming the
  layer's path, each lifted by ``skip``.
* The ``losses`` hook of ``make_train_step`` (``models.sow_loss``): a toy
  layer recording ``0.1 * mean(y²)`` against a flax layer writing its
  ``losses`` collection as ``QuantMoE`` does, one step equal (eager, traced,
  and under ``accum_steps=2``, each microbatch's term counting); a term
  recorded by an eval forward is not added.

The narrow stock ResNet-18 against its flax twin is in
``tests/test_torch_distill_ckpt.py``, beside distillation and checkpoints.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from torch import nn

from _torch_port import Recorder, get_path, leaves, np_tree, torch_tree_to_np
from jaxlsq.models import QuantDense as JQuantDense
from jaxlsq.models import QuantDenseGeneral as JQuantDenseGeneral
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.models import quantize_model as jquantize_model
from jaxlsq.parallel import make_train_step as jmake_train_step
from jaxlsq.parallel.train import QATTrainState
from jaxlsq.serve import convert as jconvert
from jaxlsq_torch import interop
from jaxlsq_torch.lab.stock_resnet import StockResNet18, stock_resnet18
from jaxlsq_torch.models import (QuantCNN, QuantDense, QuantDenseGeneral, QuantMLP,
                                 default_qconfig, quantize_model, sow_loss)
from jaxlsq_torch.models.layers import FakeQuantize, collect_losses
from jaxlsq_torch.models.quantize import QuantConv2d, QuantEmbedding, QuantLinear
from jaxlsq_torch.parallel import make_eval_step, make_train_step
from jaxlsq_torch.serve import convert
from test_quantize_model import StockCNN as FlaxStockCNN
from test_quantize_model import StockMLP as FlaxStockMLP
from test_quantize_model import StockSetupModel as FlaxStockSetupModel

B, STEPS, WINDOW = 4, 3, 2
MUTABLE = ["quant_state", "qparams", "batch_stats"]


# --- torch twins: nothing of the port in their definitions ----------------

class StockMLP(nn.Module):
    def __init__(self, in_features=12, features=(16, 16, 4)):
        super().__init__()
        dims = (in_features,) + tuple(features)
        self.names = [f"dense_{i}" for i in range(len(features) - 1)] + ["head"]
        for name, k, n in zip(self.names, dims[:-1], dims[1:]):
            self.add_module(name, nn.Linear(k, n))

    def forward(self, x):
        for name in self.names[:-1]:
            x = torch.relu(getattr(self, name)(x))
        return self.head(x)


class StockCNN(nn.Module):
    def __init__(self, num_classes=4, widths=(8, 16), image_size=8):
        super().__init__()
        cin, size = 3, image_size
        for i, w in enumerate(widths):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, w, 3, padding="same"))
            cin, size = w, size // 2
        self.widths = widths
        self.head = nn.Linear(cin * size * size, num_classes)

    def forward(self, x):
        for i in range(len(self.widths)):
            x = nn.functional.avg_pool2d(torch.relu(getattr(self, f"conv_{i}")(x)), 2, 2)
        return self.head(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class StockSetupModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = nn.Embedding(32, 16)
        self.out = nn.Linear(16, 8)

    def forward(self, tokens):
        return self.out(self.embed(tokens).mean(dim=1))


def _images(r, hw=8):
    return r.randn(B, hw, hw, 3).astype(np.float32)


TWINS = {  # flax stock model, torch twin, input draw, classes
    "mlp": (FlaxStockMLP, StockMLP, lambda r: r.randn(B, 12).astype(np.float32), 4),
    "cnn": (FlaxStockCNN, StockCNN, _images, 4),
    "setup": (FlaxStockSetupModel, StockSetupModel,
              lambda r: r.randint(0, 32, (B, 6)).astype(np.int32), 8),
}


def _qcs(wbits):
    kw = dict(per_channel_weights=True, init_batches=WINDOW)
    return jdefault_qconfig(wbits, 8, **kw), default_qconfig(wbits, 8, **kw)


def _torch_x(x):
    if x.dtype.kind == "i":
        return torch.from_numpy(x).long()
    if x.ndim == 4:  # NHWC -> NCHW
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return torch.from_numpy(x)


def _close(got, want, rel, what):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _leaf_close(got, w, where):
    if w.dtype.kind in "bi":
        np.testing.assert_array_equal(got, w, err_msg=where)
    elif float(np.abs(w).max()) < 1e-4:
        assert float(np.abs(got - w).max()) <= 2e-9, (where, got, w)
    else:
        assert float(np.abs(got - w).max()) <= 2e-5 * float(np.abs(w).max()), (where, got, w)


def _jinit(jmodel, x):
    return jax.jit(lambda x: jmodel.init(jax.random.key(0), x, training=False))(x)


@pytest.fixture(scope="module")
def data():
    r = np.random.RandomState(0)
    return {name: {"x": [draw(r) for _ in range(STEPS + 1)],
                   "y": [r.randint(0, c, size=B).astype(np.int32) for _ in range(STEPS)]}
            for name, (_, _, draw, c) in TWINS.items()}


@pytest.fixture(scope="module")
def jinit(data):
    cache = {}

    def get(name, wbits):
        if (name, wbits) not in cache:
            jm = jquantize_model(TWINS[name][0](), _qcs(wbits)[0])
            cache[name, wbits] = _jinit(jm, jnp.asarray(data[name]["x"][0]))
        return cache[name, wbits]
    return get


def _train_state(variables, tx):
    params = {"params": variables["params"], "qparams": variables.get("qparams", {})}
    return QATTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         model_state={k: v for k, v in variables.items() if k not in params},
                         opt_state=tx.init(params))


def _swapped(stock, qc, tree):
    model = quantize_model(stock, qc, device="cpu")
    interop.load_qat_variables(model, tree)
    return model


def _run_steps(jmodel, variables, models, xs, ys, jit_flags, to_torch=_torch_x):
    """The JAX package's jitted SGD steps from ``variables`` beside the port's
    ``models`` (one step function each, ``jit`` by ``jit_flags``) from the
    same state; the JAX activations handed to each port model.  Returns per
    step the JAX loss and tree and each model's loss and tree, and the
    hand-over counts."""
    tx = optax.sgd(1e-2, momentum=0.9)
    state = _train_state(variables, tx)
    jstep = jmake_train_step(jmodel, tx, donate=False)
    steps = [make_train_step(m, torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9),
                             jit=jit) for m, jit in zip(models, jit_flags)]
    recs = [Recorder() for _ in models]
    hooks = [h for rec, m in zip(recs, models) for h in rec.attach(m)]
    out = []
    for x, y in zip(xs, ys):
        with fnn.intercept_methods(recs[0].intercept):
            state, metrics = jstep(state, {"input": jnp.asarray(x), "label": jnp.asarray(y)})
        jax.effects_barrier()
        for rec in recs[1:]:
            rec.jax_out = copy.deepcopy(recs[0].jax_out)
        losses = [float(s({"input": to_torch(x), "label": torch.from_numpy(y).long()})["loss"])
                  for s in steps]
        out.append((float(metrics["loss"]), np_tree({**state.params, **state.model_state}),
                    losses, [interop.qat_variables(m) for m in models]))
    for h in hooks:
        h.remove()
    return out, sum(r.moved for r in recs), sum(r.total for r in recs)


@pytest.fixture(scope="module")
def trained(data, jinit):
    """Per twin: the JAX package's three steps at w8a8 beside the port's
    eager and traced ones from its init variables."""
    out = {}
    for name, (jcls, tcls, _, _) in TWINS.items():
        jqc, qc = _qcs(8)
        variables = jinit(name, 8)
        tree = np_tree(variables)
        models = [_swapped(tcls(), qc, tree) for _ in range(2)]
        steps, moved, total = _run_steps(jquantize_model(jcls(), jqc), variables, models,
                                         data[name]["x"][:STEPS], data[name]["y"],
                                         (False, True))
        out[name] = {"steps": steps, "moved": moved, "total": total}
    return out


@pytest.mark.parametrize("name", list(TWINS))
def test_init_variables_carry_across(name, jinit):
    tree = np_tree(jinit(name, 8))
    model = _swapped(TWINS[name][1](), _qcs(8)[1], tree)
    back = interop.qat_variables(model)
    want, got = dict(leaves(tree)), dict(leaves(back))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].tobytes() == w.tobytes(), path


@pytest.mark.parametrize("name", list(TWINS))
def test_qat_steps_match_jax(name, trained):
    run = trained[name]
    for i, (want_loss, want, losses, trees) in enumerate(run["steps"]):
        for side, loss, mine in zip(("eager", "traced"), losses, trees):
            assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (i, side, loss, want_loss)
            assert sorted(dict(leaves(mine))) == sorted(dict(leaves(want))), (i, side)
            for path, w in leaves(want):
                _leaf_close(get_path(mine, path), w, f"{side} step {i}: {'/'.join(path)}")
    # the window's end: the activation observers ran two batches, then stopped
    qs = run["steps"][-1][1]["quant_state"]
    first = next(iter(qs))
    if "act_fq" in qs[first]:
        assert int(qs[first]["act_fq"]["qs"]["current_batch"]) == WINDOW + 1
    assert run["moved"] <= 1e-4 * max(run["total"], 1), (run["moved"], run["total"])


def _packs(tree, prefix=()):
    if isinstance(tree, dict) and "bits" in tree:
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packs(v, prefix + (k,))


def _drawn_w4(name, data, jinit):
    """A w4a8 QAT tree drawn by the port: the float twin holding the JAX
    package's init weights, swapped under w4a8 (its weight quantizers'
    scales drawn from those weights), one eval forward feeding the
    activation observers."""
    stock = TWINS[name][1]()
    interop.load_qat_variables(stock, {"params": np_tree(jinit(name, 8))["params"]})
    model = quantize_model(stock, _qcs(4)[1], device="cpu")
    model.eval()
    with torch.no_grad():
        model(_torch_x(data[name]["x"][0]))
    return interop.qat_variables(model)


@pytest.mark.parametrize("name", list(TWINS))
@pytest.mark.parametrize("wbits", [8, 4])
def test_convert_and_serve_match_jax(name, wbits, data, jinit, trained):
    jqc, qc = _qcs(wbits)
    jcls, tcls = TWINS[name][:2]
    tree = trained[name]["steps"][-1][1] if wbits == 8 else _drawn_w4(name, data, jinit)
    jtree = jax.tree.map(jnp.asarray, tree)
    served = jax.jit(lambda v: jconvert(v, jqc))(jtree)
    want_packs = dict(_packs(np_tree(served)["quantized"]))
    got_tree = torch_tree_to_np(convert(interop._to_torch(tree, "cpu"), qc))
    got_packs = dict(_packs(got_tree["quantized"]))
    assert sorted(got_packs) == sorted(want_packs) and want_packs
    for path, w in want_packs.items():
        for f in ("data", "scale", "zero_point"):
            assert got_packs[path][f].tobytes() == w[f].tobytes(), (path, f)
        assert got_packs[path]["bits"] == w["bits"] == (4 if wbits == 4 and path[-1] ==
                                                         "kernel" else 8)
    x = data[name]["x"][STEPS]
    for mode in ("none", "static"):
        jserve = jquantize_model(jcls(), jqc.for_serving(mode, "xla"))
        want = np.asarray(jax.jit(lambda v, x: jserve.apply(v, x, training=False))(served, x))
        model = quantize_model(tcls(), qc.for_serving(mode), device="cpu")
        interop.load_variables(model, np_tree(served))
        model.eval()
        with torch.no_grad():
            got = model(_torch_x(x))
        _close(got.numpy(), want, 1e-4, f"{name} w{wbits} {mode}")
        again = quantize_model(tcls(), qc.for_serving(mode), device="cpu")
        interop.load_variables(again, convert(tree, qc))  # the port's convert
        again.eval()
        with torch.no_grad():
            assert torch.equal(again(_torch_x(x)), got)


# --- the swap against the port's hand-built layers -------------------------

def _fq_state(fq):
    return {k: v.detach().clone() for k, v in
            list(fq.named_parameters()) + list(fq.named_buffers())}


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_swap_equals_hand_built(name, jinit):
    qc = _qcs(8)[1]
    tree = np_tree(jinit(name, 8))
    if name == "mlp":
        hand = QuantMLP(12, (16, 16, 4), qc, device="cpu")
        names = ["dense_0", "dense_1", "head"]
    else:
        hand = QuantCNN(4, qc, widths=(8, 16), image_size=8, device="cpu")
        names = ["conv_0", "conv_1", "head"]
    interop.load_qat_variables(hand, tree)
    swapped = _swapped(TWINS[name][1](), qc, tree)
    hand.train(), swapped.train()
    g = torch.Generator().manual_seed(9)
    for n in names:
        h, s = getattr(hand, n), getattr(swapped, n)
        fw_h = h.weight_fq(h.kernel)
        fw_s = s.weight_fq(s.weight)
        if isinstance(s, QuantLinear):
            fw_s = fw_s.T
        assert torch.equal(fw_h, fw_s), n
        shape = (B,) + ((h.kernel.shape[0],) if isinstance(s, QuantLinear)
                        else (h.kernel.shape[1], 6, 6))
        for _ in range(WINDOW + 1):  # across the observer window
            x = torch.randn(shape, generator=g) * 3
            assert torch.equal(h.act_fq(x), s.act_fq(x)), n
        for fq in ("act_fq", "weight_fq"):
            a, b = _fq_state(getattr(h, fq)), _fq_state(getattr(s, fq))
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), (n, fq, k)


# --- QuantDenseGeneral ------------------------------------------------------

class JDG(fnn.Module):
    qc: object

    @fnn.compact
    def __call__(self, x, *, training=False):
        return JQuantDenseGeneral((4, 2), qconfig=self.qc, axis=(1, 2), name="dg")(
            x, training=training)


class DG(nn.Module):
    def __init__(self, qc):
        super().__init__()
        self.dg = QuantDenseGeneral((3, 5), (4, 2), qc, axis=(1, 2), path=("dg",),
                                    device="cpu")

    def forward(self, x):
        return self.dg(x)


def test_dense_general_matches_jax():
    jqc, qc = _qcs(8)
    r = np.random.RandomState(5)
    x = r.randn(2, 3, 5, 7).astype(np.float32)
    y = r.randint(0, 2, size=(2, 7, 4)).astype(np.int32)
    variables = _jinit(JDG(jqc), jnp.asarray(x))
    tree = np_tree(variables)
    assert tree["params"]["dg"]["kernel"].shape == (3, 5, 4, 2)
    assert tree["quant_state"]["dg"]["dg_flat"].tolist() == [15, 8]
    model = DG(qc)
    interop.load_qat_variables(model, tree)
    back = dict(leaves(interop.qat_variables(model)))
    assert sorted(back) == sorted(dict(leaves(tree)))
    # the QAT forward, training mode (observers write), then one step
    want, _ = JDG(jqc).apply(variables, x, training=True, mutable=MUTABLE)
    probe = DG(qc)
    interop.load_qat_variables(probe, tree)
    probe.train()
    with torch.no_grad():
        got = probe(torch.from_numpy(x))
    assert got.shape == (2, 7, 4, 2)
    _close(got.numpy(), want, 1e-5, "dg forward")
    steps, moved, total = _run_steps(JDG(jqc), variables, [model], [x], [y], (False,),
                                     torch.from_numpy)
    want_loss, want_tree, (loss,), (mine,) = steps[0]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for path, w in leaves(want_tree):
        _leaf_close(get_path(mine, path), w, "/".join(path))
    # served through the dg_flat pack
    # op by op: the JAX package's convert reads the dg_flat marker as a value
    served = jconvert(jax.tree.map(jnp.asarray, want_tree), jqc)
    wpack = np_tree(served)["quantized"]["dg"]["kernel"]
    gpack = torch_tree_to_np(convert(interop._to_torch(mine, "cpu"), qc))["quantized"]["dg"][
        "kernel"]
    assert wpack["data"].shape == (15, 8)
    for f in ("data", "scale", "zero_point"):
        assert gpack[f].tobytes() == wpack[f].tobytes(), f
    sx = r.randn(2, 3, 5, 7).astype(np.float32)
    want = JDG(jqc.for_serving("static", "xla")).apply(served, sx, training=False)
    smodel = DG(qc.for_serving("static"))
    interop.load_variables(smodel, np_tree(served))
    with torch.no_grad():
        got = smodel(torch.from_numpy(sx))
    _close(got.numpy(), want, 1e-4, "dg served")


# --- the swap's rules --------------------------------------------------------

def test_stock_layout_and_float_checkpoint():
    stock = StockResNet18(10, widths=(8, 16), stage_sizes=(1, 1))
    before = {k: v.clone() for k, v in stock.state_dict().items()}
    qc = _qcs(8)[1]
    model = quantize_model(stock, qc, device="cpu")
    swapped = [m for m in model.modules() if isinstance(m, (QuantConv2d, QuantLinear))]
    assert len(swapped) == 7 and all(m.act_fq is not None for m in swapped)
    keys = [k for k in model.state_dict() if "_fq." not in k]
    assert keys == list(stock.state_dict())
    res = model.load_state_dict(stock.state_dict(), strict=False)
    assert not res.unexpected_keys
    assert res.missing_keys and all("_fq." in k for k in res.missing_keys)
    assert model.head.weight.shape == (10, 16) and model.stem.weight.shape == (8, 3, 3, 3)
    assert model.head.weight_fq.scale.shape == (10,)  # per channel over axis 0
    make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), jit=False)(
        {"image": torch.randn(2, 3, 8, 8), "label": torch.tensor([1, 2])})
    for k, v in stock.state_dict().items():  # the stock model is not touched
        assert torch.equal(v, before[k]), k
    assert all(type(m) is not QuantConv2d for m in stock.modules())
    # a subclass of a stock type is left as it is
    sub = type("MyLinear", (nn.Linear,), {})
    m = quantize_model(nn.Sequential(sub(4, 4), nn.Linear(4, 2)), qc, device="cpu")
    assert type(m[0]) is sub and isinstance(m[1], QuantLinear)


def test_skip_and_overrides():
    qc4 = default_qconfig(4, 8, init_batches=1).with_overrides(
        {"head": default_qconfig(8, 8, init_batches=1)})
    model = quantize_model(StockMLP(), qc4, device="cpu")
    tree = convert(interop._to_torch(interop.qat_variables(model), "cpu"), qc4)
    assert tree["quantized"]["head"]["kernel"].bits == 8
    assert tree["quantized"]["dense_0"]["kernel"].bits == 4
    qc = _qcs(8)[1]
    model = quantize_model(StockMLP(), qc, skip=("head",), device="cpu")
    assert type(model.head) is nn.Linear and isinstance(model.dense_0, QuantLinear)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2), jit=False)
    for _ in range(WINDOW + 1):  # past the observer window
        step({"input": torch.randn(B, 12), "label": torch.randint(0, 4, (B,))})
    tree = interop.qat_variables(model)
    assert "head" not in tree["qparams"] and tree["params"]["head"]["kernel"].shape == (16, 4)
    served = quantize_model(StockMLP(), qc.for_serving("static"), skip=("head",),
                            device="cpu")
    interop.load_variables(served, convert(tree, qc))
    x = torch.randn(3, 12)
    with torch.no_grad():
        assert torch.allclose(served(x), make_eval_step(model)({"input": x}), rtol=0,
                              atol=1e-4)
    # a LayerNorm and a BatchNorm1d between the swapped layers carry across too
    normed = nn.Sequential(nn.Linear(4, 8), nn.LayerNorm(8), nn.BatchNorm1d(8), nn.Linear(8, 2))
    qnormed = quantize_model(normed, qc, device="cpu")
    nstep = make_train_step(qnormed, torch.optim.SGD(qnormed.parameters(), lr=1e-2), jit=False)
    for _ in range(WINDOW + 1):
        nstep({"input": torch.randn(B, 4), "label": torch.randint(0, 2, (B,))})
    served = quantize_model(normed, qc.for_serving("static"), device="cpu")
    interop.load_variables(served, convert(interop.qat_variables(qnormed), qc))
    x = torch.randn(3, 4)
    with torch.no_grad():
        assert torch.allclose(served.eval()(x), make_eval_step(qnormed)({"input": x}),
                              rtol=0, atol=1e-4)
    emb = quantize_model(StockSetupModel(), qc, device="cpu")
    assert isinstance(emb.embed, QuantEmbedding) and emb.embed.weight_fq.scale.shape == (32,)
    # paths: a Sequential's dotted names joined with '/'
    deep = nn.Sequential(nn.Sequential(nn.Linear(4, 4)), nn.Linear(4, 2))
    m = quantize_model(deep, qc, skip=("0/0",), device="cpu")
    assert type(m[0][0]) is nn.Linear and isinstance(m[1], QuantLinear)


REFUSED = {
    "conv1d": lambda: nn.Conv1d(3, 4, 3),
    "conv3d": lambda: nn.Conv3d(3, 4, 3),
    "convtranspose2d": lambda: nn.ConvTranspose2d(3, 4, 3),
    "bilinear": lambda: nn.Bilinear(3, 3, 4),
    "multiheadattention": lambda: nn.MultiheadAttention(8, 2),
    "embeddingbag": lambda: nn.EmbeddingBag(10, 4),
    "lstm": lambda: nn.LSTM(4, 4),
    "gru": lambda: nn.GRU(4, 4),
    "rnn": lambda: nn.RNN(4, 4),
    "dilated": lambda: nn.Conv2d(3, 4, 3, dilation=2),
    "reflect": lambda: nn.Conv2d(3, 4, 3, padding=1, padding_mode="reflect"),
    "max_norm": lambda: nn.Embedding(10, 4, max_norm=1.0),
    "sparse": lambda: nn.Embedding(10, 4, sparse=True),
    "scale_grad_by_freq": lambda: nn.Embedding(10, 4, scale_grad_by_freq=True),
}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refusals_name_the_path_and_skip_lifts_them(kind):
    qc = _qcs(8)[1]
    model = nn.Sequential()
    model.add_module("body", nn.Sequential(nn.Linear(4, 4)))
    model.body.add_module("odd", REFUSED[kind]())
    with pytest.raises(ValueError, match="'body/odd'"):
        quantize_model(model, qc, device="cpu")
    for mode_qc in (qc, qc.for_serving("static")):
        kept = quantize_model(model, mode_qc, skip=("odd",), device="cpu")
        assert type(kept.body.odd) is type(model.body.odd)
    assert isinstance(quantize_model(model, qc, skip=("odd",), device="cpu").body[0],
                      QuantLinear)


def test_serve_mode_swaps_in_packed_layers():
    from jaxlsq_torch.models import QuantConv, QuantDense, QuantEmbed

    qc = _qcs(4)[1].for_serving("static")
    model = quantize_model(stock_resnet18(4, widths=(8, 16), stage_sizes=(1, 1)), qc,
                           device="cpu")
    assert isinstance(model.stem, QuantConv) and isinstance(model.head, QuantDense)
    assert model.stem.padding == ((1, 1), (1, 1))
    assert model.stage1_block0.downsample.padding == ((0, 0), (0, 0))
    assert not any(p.requires_grad for p in model.parameters())
    emb = quantize_model(StockSetupModel(), qc, device="cpu")
    assert isinstance(emb.embed, QuantEmbed) and emb.embed.embedding.data.dtype == torch.int8
    fqs = [m for m in model.modules() if isinstance(m, FakeQuantize)]
    assert not fqs


# --- the losses hook ----------------------------------------------------------

class JAux(fnn.Module):
    """A dense layer writing a weighted term into ``losses``, as ``QuantMoE``
    writes its load-balance term."""
    qc: object

    @fnn.compact
    def __call__(self, x, *, training=False):
        y = JQuantDense(4, self.qc, name="dense")(x, training=training)
        aux = self.variable("losses", "aux", lambda: jnp.zeros((), jnp.float32))
        if self.is_mutable_collection("losses"):
            aux.value = 0.1 * jnp.mean(y ** 2)
        return y


class Aux(nn.Module):
    def __init__(self, qc):
        super().__init__()
        self.dense = QuantDense(16, 4, qc, path=("dense",), device="cpu")

    def forward(self, x):
        y = self.dense(x)
        sow_loss(0.1 * (y ** 2).mean())
        return y


@pytest.mark.parametrize("accum", [1, 2])
def test_losses_hook_matches_jax(accum):
    r = np.random.RandomState(3)
    x = r.randn(B, 16).astype(np.float32)
    y = r.randint(0, 4, size=B).astype(np.int32)
    jqc = jdefault_qconfig(8, 8, init_batches=1)
    jm = JAux(jqc)
    variables = jax.jit(lambda x: jm.init(jax.random.key(0), x, training=False))(x)
    assert "losses" in variables
    tx = optax.sgd(1e-2, momentum=0.9)
    state, metrics = jmake_train_step(jm, tx, accum_steps=accum, donate=False)(
        _train_state(variables, tx), {"input": jnp.asarray(x), "label": jnp.asarray(y)})
    want = np_tree({**state.params, **state.model_state})
    want.pop("losses")
    qc = default_qconfig(8, 8, init_batches=1)
    tree = np_tree({k: v for k, v in variables.items() if k != "losses"})
    for jit in (False, True):
        model = Aux(qc)
        interop.load_qat_variables(model, tree)
        # an eval forward and a plain call record nothing that a step adds
        make_eval_step(model)({"input": torch.from_numpy(r.randn(B, 16).astype(np.float32))})
        with torch.no_grad():
            model.eval()(torch.randn(2, 16))
        with collect_losses() as terms:  # recorded where something collects
            make_eval_step(model)({"input": torch.randn(2, 16)})
        assert len(terms) == 1
        model.train()
        interop.load_qat_variables(model, tree)  # the plain call above wrote the observer
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2,
                                                      momentum=0.9),
                               jit=jit, accum_steps=accum)
        loss = float(step({"input": torch.from_numpy(x),
                           "label": torch.from_numpy(y).long()})["loss"])
        assert abs(loss - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"])), jit
        mine = interop.qat_variables(model)
        for path, w in leaves(want):
            _leaf_close(get_path(mine, path), w, f"jit={jit}: {'/'.join(path)}")


def test_sow_loss_outside_a_step_is_dropped():
    qc = default_qconfig(8, 8, init_batches=1)
    model = Aux(qc)
    with collect_losses() as outer:
        with collect_losses() as inner:
            model(torch.randn(2, 16))
        assert len(inner) == 1 and not outer
    model(torch.randn(2, 16))  # nothing collects: nothing kept anywhere
    with collect_losses() as terms:
        pass
    assert terms == []
