"""``parallel.distillation_loss``, the ``losses`` hook of ``make_train_step``
(``models.layers.sow_loss``), ``utils.checkpoint`` and BatchNorm
re-estimation of stock ``nn.BatchNorm2d`` against the JAX package, on the
same seeded numpy inputs.

* ``distillation_loss`` against the JAX package's at alpha 0, 0.5 and 1 (an
  identity teacher, so both see the same teacher logits): the value and the
  gradient with respect to the student's logits within 1e-6 relative.  A
  distilled QAT ``QuantMLP`` step (a float ``QuantMLP`` teacher) against the
  JAX package's, eager and traced, leaf by leaf (the loss within 1e-5
  relative, every leaf within 2e-5 of its largest magnitude or 2e-9
  absolute below 1e-4); the teacher bit for bit unchanged.
* Checkpoints: a save and restore round-trips every leaf of the model and
  the optimizer; a run resumed after k steps equals the k + m steps of an
  uninterrupted one bit for bit, eager and traced, under SGD, AdamW and
  ``qat_optimizer``; an optimizer that has state is restored into its own
  tensors; ``latest_step`` agrees with the JAX package's on one directory
  tree; a key mismatch raises naming the keys; ``restore_or_init`` on an
  empty directory starts fresh.
* A narrow ``StockResNet18`` (widths (8, 16), one block a stage) swapped by
  ``quantize_model`` against the JAX package's ``quantize_model`` over its
  flax twin (explicit (1, 1) pads, BatchNorm momentum 0.9 and its mode from
  a module field): two steps leaf by leaf as above, the JAX step's
  activation handed over where a rounding boundary fell the other way (at
  most 1e-4 of the elements); torch's ``running_var`` takes the unbiased
  batch variance, so it is held to the JAX trajectory's batch variances
  times n / (n - 1).
* ``reestimate_batch_stats`` on a swapped stock model: each stock
  BatchNorm's running statistics are those of torch's own train-mode
  ``F.batch_norm`` over its inputs, and no quantizer tensor changes; the
  port's flax-rule ``BatchNorm`` keeps its bits.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from torch import nn

from _torch_port import Recorder, get_path, leaves, np_tree
from test_torch_quantize_model import (_close, _images, _jinit, _leaf_close, _qcs,
                                       _run_steps, _swapped, _train_state)
from jaxlsq.models import QConfig as JQConfig
from jaxlsq.models import QuantMLP as JQuantMLP
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.models import quantize_model as jquantize_model
from jaxlsq.parallel import distillation_loss as jdistillation_loss
from jaxlsq.parallel import make_train_step as jmake_train_step
from jaxlsq.utils import latest_step as jlatest_step
from jaxlsq_torch import interop
from jaxlsq_torch.lab.stock_resnet import StockResNet18, stock_resnet18
from jaxlsq_torch.models import QConfig, QuantMLP, QuantResNet, default_qconfig, quantize_model
from jaxlsq_torch.models.layers import FakeQuantize, quant_state_frozen
from jaxlsq_torch.models.quantize import QuantConv2d, QuantLinear
from jaxlsq_torch.parallel import distillation_loss, make_train_step, qat_optimizer
from jaxlsq_torch.utils import (latest_step, reestimate_batch_stats, restore_checkpoint,
                                restore_or_init, save_checkpoint)

B = 8


# --- distillation_loss ------------------------------------------------------

class JIdentity(fnn.Module):
    @fnn.compact
    def __call__(self, x, training=False):
        return x


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_distillation_loss_matches_jax(alpha):
    r = np.random.RandomState(1)
    t_logits = r.randn(B, 5).astype(np.float32) * 2
    s_logits = r.randn(B, 5).astype(np.float32) * 2
    labels = r.randint(0, 5, size=B).astype(np.int32)
    jlf = jdistillation_loss(JIdentity(), {}, alpha=alpha, temperature=2.0)
    want, want_g = jax.jit(jax.value_and_grad(lambda s: jlf(s, {
        "input": jnp.asarray(t_logits), "label": jnp.asarray(labels)})))(jnp.asarray(s_logits))
    lf = distillation_loss(nn.Identity(), alpha=alpha, temperature=2.0)
    s = torch.from_numpy(s_logits).requires_grad_(True)
    loss = lf(s, {"input": torch.from_numpy(t_logits), "label": torch.from_numpy(labels).long()})
    loss.backward()
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    g, wg = s.grad.numpy(), np.asarray(want_g)
    assert float(np.abs(g - wg).max()) <= 1e-6 * float(np.abs(wg).max())


def test_distillation_loss_arguments():
    with pytest.raises(ValueError, match="alpha"):
        distillation_loss(nn.Identity(), alpha=1.5)
    with pytest.raises(ValueError, match="alpha"):
        distillation_loss(nn.Identity(), alpha=-0.1)

    class Refuses(nn.Module):
        def forward(self, x):
            raise AssertionError("alpha == 1 runs no teacher forward")

    lf = distillation_loss(Refuses(), alpha=1.0)
    logits = torch.randn(4, 3)
    assert float(lf(logits, {"input": logits, "label": torch.zeros(4).long()})) > 0


def test_distilled_steps_match_jax():
    r = np.random.RandomState(2)
    xs = [r.randn(B, 16).astype(np.float32) for _ in range(3)]
    ys = [r.randint(0, 4, size=B).astype(np.int32) for _ in range(3)]
    jt = JQuantMLP(features=(32, 4), qconfig=JQConfig())
    tvars = jax.jit(lambda x: jt.init(jax.random.key(1), x, training=False))(xs[0])
    jqc = jdefault_qconfig(8, 8, init_batches=1)
    js = JQuantMLP(features=(32, 4), qconfig=jqc)
    svars = jax.jit(lambda x: js.init(jax.random.key(0), x, training=False))(xs[0])
    tx = optax.sgd(1e-2, momentum=0.9)
    state = _train_state(svars, tx)
    jstep = jmake_train_step(js, tx, loss_fn=jdistillation_loss(jt, tvars, alpha=0.5,
                                                                 temperature=2.0),
                             donate=False)
    teacher = QuantMLP(16, (32, 4), QConfig(), device="cpu")
    interop.load_qat_variables(teacher, np_tree(tvars))
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    qc = default_qconfig(8, 8, init_batches=1)
    models = [QuantMLP(16, (32, 4), qc, device="cpu") for _ in range(2)]
    steps = []
    for m, jit in zip(models, (False, True)):
        interop.load_qat_variables(m, np_tree(svars))
        steps.append(make_train_step(m, torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9),
                                     loss_fn=distillation_loss(teacher), jit=jit))
    recs = [Recorder() for _ in models]
    for rec, m in zip(recs, models):
        rec.attach(m)
    for i, (x, y) in enumerate(zip(xs, ys)):
        with fnn.intercept_methods(recs[0].intercept):
            state, metrics = jstep(state, {"input": jnp.asarray(x), "label": jnp.asarray(y)})
        jax.effects_barrier()
        recs[1].jax_out = copy.deepcopy(recs[0].jax_out)
        want = np_tree({**state.params, **state.model_state})
        for side, m, step in zip(("eager", "traced"), models, steps):
            loss = float(step({"input": torch.from_numpy(x),
                               "label": torch.from_numpy(y).long()})["loss"])
            assert abs(loss - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
            mine = interop.qat_variables(m)
            for path, w in leaves(want):
                _leaf_close(get_path(mine, path), w, f"{side} step {i}: {'/'.join(path)}")
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k
    assert teacher.training  # its mode is put back after each eval forward


# --- checkpoints --------------------------------------------------------------

def _net(seed=0):
    """A small stock conv net (a convolution, a BatchNorm2d, a Linear head)
    swapped by quantize_model, drawn from ``seed``."""
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)
    torch.manual_seed(seed)
    stock = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.BatchNorm2d(4), nn.ReLU(),
                          nn.Flatten(), nn.Linear(4 * 8 * 8, 4))
    return quantize_model(stock, qc, device="cpu")


OPTIMIZERS = {
    "sgd": lambda m: torch.optim.SGD(m.parameters(), lr=1e-2, momentum=0.9),
    "adamw": lambda m: torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-2),
    "qat_optimizer": lambda m: qat_optimizer(
        m, lambda ps: torch.optim.AdamW(ps, lr=1e-3)),
}


def _batches(n, seed):
    g = torch.Generator().manual_seed(seed)
    return [{"image": torch.randn(4, 3, 8, 8, generator=g),
             "label": torch.randint(0, 4, (4,), generator=g)} for _ in range(n)]


def _everything(model, opt):
    out = {f"model/{k}": v for k, v in model.state_dict().items()}
    sd = opt.state_dict()
    for path, v in _flat(sd, "optim"):
        out[path] = v
    return out


def _flat(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _equal(a, b):
    assert a.keys() == b.keys(), sorted(a.keys() ^ b.keys())[:8]
    for k in a:
        x, y = a[k], b[k]
        if torch.is_tensor(x) or torch.is_tensor(y):
            assert torch.is_tensor(x) and torch.is_tensor(y) and torch.equal(x, y), k
        else:
            assert x == y, (k, x, y)


def test_save_restore_round_trips_every_leaf(tmp_path):
    model, opt = _net(), None
    opt = OPTIMIZERS["adamw"](model)
    step = make_train_step(model, opt, jit=False)
    for b in _batches(3, 1):
        step(b)
    path = save_checkpoint(str(tmp_path), {"model": model, "optimizer": opt}, 3)
    assert os.path.basename(path) == "step_0000000003"
    assert sorted(os.listdir(path)) == ["_COMPLETE", "model.pt", "optimizer.pt"]
    fresh = _net(seed=5)
    fopt = OPTIMIZERS["adamw"](fresh)
    state, got = restore_or_init(str(tmp_path), lambda: {"model": fresh, "optimizer": fopt})
    assert got == 3 and state["model"] is fresh and state["optimizer"] is fopt
    _equal(_everything(fresh, fopt), _everything(model, opt))


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("jit", [False, True])
def test_resume_equals_the_uninterrupted_run(jit, opt_name, tmp_path):
    k, m = 2, 3  # the 2-batch observer window ends in the resumed part
    batches = _batches(k + m, 2)
    model = _net()
    opt = OPTIMIZERS[opt_name](model)
    step = make_train_step(model, opt, jit=jit)
    for i, b in enumerate(batches):
        if i == k:
            save_checkpoint(str(tmp_path), {"model": model, "optimizer": opt}, k)
        step(b)
    fresh = _net(seed=7)
    fopt = OPTIMIZERS[opt_name](fresh)
    _, got = restore_or_init(str(tmp_path), lambda: {"model": fresh, "optimizer": fopt})
    assert got == k
    fstep = make_train_step(fresh, fopt, jit=jit)
    for b in batches[k:]:
        fstep(b)
    _equal(_everything(fresh, fopt), _everything(model, opt))


def test_restore_writes_into_the_tensors_in_place(tmp_path):
    model = _net()
    opt = torch.optim.AdamW(model.parameters(), lr=torch.tensor(1e-3), weight_decay=1e-2)
    step = make_train_step(model, opt, jit=False)
    batches = _batches(4, 3)
    step(batches[0])
    save_checkpoint(str(tmp_path), {"model": model, "optimizer": opt}, 1)
    want = copy.deepcopy(_everything(model, opt))
    step(batches[1])
    tensors = [v for p in model.parameters() for v in opt.state[p].values()]
    lr = opt.param_groups[0]["lr"]
    params = [p.data_ptr() for p in model.parameters()]
    fq = next(m for m in model.modules() if isinstance(m, FakeQuantize)
              and m.cfg.otype == "activation")
    assert fq.host_state()["current_batch"] == 2
    restore_checkpoint(str(tmp_path), {"model": model, "optimizer": opt})
    assert [v for p in model.parameters() for v in opt.state[p].values()] == tensors
    assert all(a is b for a, b in zip(tensors, [v for p in model.parameters()
                                                for v in opt.state[p].values()]))
    assert opt.param_groups[0]["lr"] is lr
    assert [p.data_ptr() for p in model.parameters()] == params
    assert fq.host_state()["current_batch"] == 1  # the host mirror was refilled
    _equal(_everything(model, opt), want)


def test_latest_step_agrees_with_jax(tmp_path):
    root = str(tmp_path)
    assert latest_step(root + "/none") is None and jlatest_step(root + "/none") is None
    assert latest_step(root) is None and jlatest_step(root) is None
    for name, marked in (("step_0000000003", True), ("step_0000000007", True),
                         ("step_0000000009", False), ("step_tmp", True), ("other", True)):
        os.makedirs(os.path.join(root, name))
        if marked:
            open(os.path.join(root, name, "_COMPLETE"), "w").write("ok")
    open(os.path.join(root, "step_0000000012"), "w").write("a file")
    assert latest_step(root) == jlatest_step(root) == 7


def test_key_mismatch_names_the_keys(tmp_path):
    model = quantize_model(stock_resnet18(4, widths=(4, 8), stage_sizes=(1, 1)),
                           default_qconfig(8, 8), device="cpu")
    save_checkpoint(str(tmp_path), {"model": model}, 0)
    other = QuantResNet(4, default_qconfig(8, 8), stage_sizes=(1,), widths=(4,), device="cpu")
    before = {k: v.clone() for k, v in other.state_dict().items()}
    with pytest.raises(ValueError, match="only in checkpoint") as e:
        restore_checkpoint(str(tmp_path), {"model": other})
    ours, theirs = str(e.value).splitlines()[1:]
    assert "'model/bn_stem.running_mean'" in ours and "'model/bn_stem.mean'" in theirs
    assert ours.count("'model/") == theirs.count("'model/") == 8  # 8 named a side
    for k, v in other.state_dict().items():  # nothing was written
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="only in target"):
        restore_checkpoint(str(tmp_path), {"model": _net(), "optimizer": OPTIMIZERS["sgd"](
            _net())})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), {"model": model})


def test_restore_or_init_on_an_empty_directory(tmp_path):
    model = _net()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, step = restore_or_init(str(tmp_path), lambda: {"model": model})
    assert step == -1 and state["model"] is model
    _equal(model.state_dict(), before)


# --- the narrow stock resnet against its flax twin -------------------------

class FlaxStockBlock(fnn.Module):
    width: int
    stride: int
    train: bool

    @fnn.compact
    def __call__(self, x):
        def bn(name):
            return fnn.BatchNorm(use_running_average=not self.train, momentum=0.9,
                                 epsilon=1e-5, name=name)

        pad = ((1, 1), (1, 1))
        y = fnn.Conv(self.width, (3, 3), strides=self.stride, padding=pad, use_bias=False,
                     name="conv1")(x)
        y = fnn.relu(bn("bn1")(y))
        y = fnn.Conv(self.width, (3, 3), padding=pad, use_bias=False, name="conv2")(y)
        y = bn("bn2")(y)
        r = x
        if self.stride != 1 or x.shape[-1] != self.width:
            r = fnn.Conv(self.width, (1, 1), strides=self.stride, padding=((0, 0), (0, 0)),
                         use_bias=False, name="downsample")(x)
            r = bn("bn_down")(r)
        return fnn.relu(y + r)


class FlaxStockResNet(fnn.Module):
    """The flax twin of ``StockResNet18``: torch's (1, 1) pads, torch's
    BatchNorm momentum, the BatchNorm mode a field (the JAX package's
    ``QuantizedModel`` consumes ``training``)."""

    num_classes: int = 4
    widths: tuple = (8, 16)
    stage_sizes: tuple = (1, 1)
    train: bool = False

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(self.widths[0], (3, 3), padding=((1, 1), (1, 1)), use_bias=False,
                     name="stem")(x)
        x = fnn.BatchNorm(use_running_average=not self.train, momentum=0.9, epsilon=1e-5,
                          name="bn_stem")(x)
        x = fnn.relu(x)
        for s, (n, w) in enumerate(zip(self.stage_sizes, self.widths)):
            for b in range(n):
                x = FlaxStockBlock(w, 2 if (s > 0 and b == 0) else 1, self.train,
                                   name=f"stage{s}_block{b}")(x)
        return fnn.Dense(self.num_classes, name="head")(x.mean(axis=(1, 2)))


def test_narrow_stock_resnet_matches_its_flax_twin():
    jqc, qc = _qcs(8)
    r = np.random.RandomState(3)
    xs = [_images(r) for _ in range(2)]
    ys = [r.randint(0, 4, size=len(xs[0])).astype(np.int32) for _ in range(2)]
    variables = _jinit(jquantize_model(FlaxStockResNet(), jqc), jnp.asarray(xs[0]))
    model = _swapped(StockResNet18(4, widths=(8, 16), stage_sizes=(1, 1)), qc,
                     np_tree(variables))
    assert sum(isinstance(m, (QuantConv2d, QuantLinear)) for m in model.modules()) == 7
    sizes = {}
    for n, m in model.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            m.register_forward_hook(lambda mod, i, o, n=n: sizes.__setitem__(
                n.replace(".", "/"), i[0].numel() // i[0].shape[1]))
    steps, moved, total = _run_steps(jquantize_model(FlaxStockResNet(train=True), jqc),
                                     variables, [model], xs, ys, (False,))
    var_prev = {p[:-1]: w for p, w in leaves(np_tree(variables)["batch_stats"])
                if p[-1] == "var"}
    torch_prev = dict(var_prev)
    for i, (want_loss, want, (loss,), (mine,)) in enumerate(steps):
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (i, loss, want_loss)
        for path, w in leaves(want):
            got = get_path(mine, path)
            if path[0] == "batch_stats" and path[-1] == "var":
                # flax keeps 0.9 v + 0.1 var_b; torch 0.9 v + 0.1 var_b n / (n - 1)
                bn, n = path[1:-1], sizes["/".join(path[1:-1])]
                var_b = (w - 0.9 * var_prev[bn]) / 0.1
                expect = 0.9 * torch_prev[bn] + 0.1 * var_b * n / (n - 1)
                _close(got, expect, 1e-5, f"step {i}: {'/'.join(path)}")
                var_prev[bn], torch_prev[bn] = w, got
                assert not np.allclose(got, w, rtol=1e-7)  # the two rules do differ
            else:
                _leaf_close(got, w, f"step {i}: {'/'.join(path)}")
    assert total > 0 and moved <= 1e-4 * total, (moved, total)


# --- BatchNorm re-estimation of stock BatchNorm ---------------------------------

def _quantizer_tensors(model):
    return {f"{n}.{k}": v.detach().clone() for n, m in model.named_modules()
            if isinstance(m, FakeQuantize)
            for k, v in list(m.named_parameters()) + list(m.named_buffers())}


def test_reestimation_refreshes_stock_batchnorm():
    model = _net()
    step = make_train_step(model, OPTIMIZERS["sgd"](model), jit=False)
    for b in _batches(3, 4):
        step(b)
    bns = {n: m for n, m in model.named_modules() if isinstance(m, nn.BatchNorm2d)}
    start = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in bns.items()}
    inputs = {n: [] for n in bns}
    hooks = [m.register_forward_hook(lambda mod, i, o, n=n: inputs[n].append(i[0].clone()))
             for n, m in bns.items()]
    quant = _quantizer_tensors(model)
    model.eval()
    reestimate_batch_stats(model, torch.randn(3, 4, 3, 8, 8))
    for h in hooks:
        h.remove()
    assert not model.training
    for k, v in _quantizer_tensors(model).items():
        assert torch.equal(v, quant[k]), k
    for n, m in bns.items():
        rm, rv = (t.clone() for t in start[n])
        assert len(inputs[n]) == 3
        for x in inputs[n]:  # torch's own train-mode batch norm
            F.batch_norm(x, rm, rv, m.weight, m.bias, True, m.momentum, m.eps)
        assert torch.equal(m.running_mean, rm) and torch.equal(m.running_var, rv), n
        assert not torch.equal(rv, start[n][1]), n


def test_reestimation_keeps_the_flax_rule_batchnorm_bits():
    model = QuantResNet(4, default_qconfig(8, 8, init_batches=1), stage_sizes=(1, 1),
                        widths=(4, 8), device="cpu")
    xs = torch.randn(3, 4, 3, 8, 8)
    twin = copy.deepcopy(model)
    reestimate_batch_stats(model, xs)
    fqs = [m for m in twin.modules() if isinstance(m, FakeQuantize)]
    twin.train()
    with torch.no_grad(), quant_state_frozen(fqs):
        for x in xs:
            twin(x)
    _equal(model.state_dict(), twin.state_dict())
