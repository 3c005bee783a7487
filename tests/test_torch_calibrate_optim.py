"""The port's calibration (``models.calibrate``), its QAT optimizer partition
(``parallel.optim``), ``interop`` with every observer kind and the accuracy
lab's recipe table, against the JAX package on the same seeded numpy inputs.

* ``interop``: jaxlsq's own ``model.init`` variables of a narrow ``QuantCNN``
  (one 4-wide conv and the head) load into the port and come back leaf for
  leaf, for each of the four activation observers (the histogram's bins
  included).
* ``calibrate``: the same variables calibrated on the same batches by both
  packages (eval-mode forwards that keep what the observers write), with the
  min/max and the histogram observer (the MSE and percentile observers take
  the same path; tests/test_torch_observers_expensive.py holds them); a
  learnable-mode quantizer, which has no observer, is left as it was.  Flags
  and counters exact; ranges, qparams and bins within 1e-5 of their leaf's
  largest magnitude (the convolutions sum in another order), the histogram
  within 2e-3 of its mass (an element near a bin edge may land in the next
  bin).  ``set_static_estimate``/``enable_param_learning_all`` set jaxlsq's
  flags.
* ``qat_optimizer``: six steps of a narrow ``QuantCNN`` (widths 8 and 16,
  B = 4, 8x8, a 2-batch observer window) from jaxlsq's ``create_train_state`` state (its
  ``model.init`` jitted), the port's
  eager and traced steps beside one JAX trajectory of ``make_train_step``
  under ``qat_optimizer``: the weights on SGD (momentum 0.9), the qparams on
  the default SGD or on Adam (eps 1e-3: see ``ADAM_EPS``); every leaf within
  1e-6 (SGD) / 1e-5 (Adam) of its largest magnitude (a shift at its
  quantizer's scale), activation
  outputs handed over where a rounding boundary fell the other way
  (``_torch_port.Recorder``, at most 1e-4 of the elements).  The clip and
  the scale floor, on gradients chosen to trigger them, against optax
  within 1e-6.
* ``recipe``: every name of ``examples/recipe_sweep.py``'s ``recipes()`` and
  ``recipes_w4a8()`` (imported by path) builds the same qconfig, optimizer,
  state function and warm start; the mixed-precision recipes' plan flow
  (scout, plan, planned model) builds at a toy size.
"""

import contextlib
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from _torch_port import Recorder, get_path, leaves, np_tree
from jaxlsq.models import QuantCNN as JQuantCNN
from jaxlsq.models import QuantResNet as JQuantResNet
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.models.calibrate import calibrate as jcalibrate
from jaxlsq.models.calibrate import enable_param_learning_all as jenable_learning
from jaxlsq.models.calibrate import set_static_estimate as jset_static
from jaxlsq.parallel import make_train_step as jmake_train_step
from jaxlsq.parallel import qat_optimizer as jqat_optimizer
from jaxlsq.parallel.train import QATTrainState
from jaxlsq_torch import interop
from jaxlsq_torch.lab import accuracy_parity as ap
from jaxlsq_torch.models import (FakeQuantize, QuantCNN, QuantResNet, calibrate,
                                 default_qconfig, enable_param_learning_all,
                                 set_static_estimate)
from jaxlsq_torch.parallel import make_train_step, qat_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, CLASSES = 8, 10
KINDS = ["minmax", "mse", "percentile", "histogram"]


def _images(n, b, seed):
    r = np.random.RandomState(seed)
    return [np.maximum(r.randn(b, HW, HW, 3), -0.5).astype(np.float32) * (1 + 0.2 * i)
            for i in range(n)]


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _cnn_pair(qc_kw):
    jqc, tqc = jdefault_qconfig(**qc_kw), default_qconfig(**qc_kw)
    jm = JQuantCNN(num_classes=CLASSES, qconfig=jqc, widths=(4,))
    tm = QuantCNN(CLASSES, tqc, widths=(4,), image_size=HW, device="cpu")
    return jm, tm


def _qc_kw(kind, **kw):
    return dict(weight_bits=8, act_bits=8, per_channel_weights=True, init_batches=3,
                act_observer=kind, **kw)


@pytest.fixture(scope="module")
def cnn_variables():
    """jaxlsq's ``model.init`` variables of the narrow QuantCNN, per kind."""
    x0 = jnp.asarray(_images(1, 2, seed=1)[0])
    out = {}
    for kind in KINDS:
        jm, _ = _cnn_pair(_qc_kw(kind))
        out[kind] = _init(jm, x0)
    return out


def _init(jmodel, x0):
    """``jmodel.init(key 0, x0, training=False)``, jitted (op by op it costs
    several times the compile)."""
    return jax.jit(lambda x: jmodel.init(jax.random.key(0), x, training=False))(x0)


@pytest.mark.parametrize("kind", KINDS)
def test_interop_carries_every_observer_kind(kind, cnn_variables):
    _, tm = _cnn_pair(_qc_kw(kind))
    tree = np_tree(cnn_variables[kind])
    interop.load_qat_variables(tm, tree)
    back = interop.qat_variables(tm)
    want = list(leaves(tree))
    assert len(want) == len(list(leaves(back)))
    for path, w in want:
        np.testing.assert_array_equal(get_path(back, path), w, err_msg="/".join(path))
    has_hist = any("histogram" in p for p, _ in want)
    assert has_hist == (kind == "histogram")
    assert all(hasattr(m, "obs_hist") == (kind == "histogram" and "act_fq" in n)
               for n, m in tm.named_modules() if isinstance(m, FakeQuantize))


def _close(got, want, where, tol=1e-5):
    if want.dtype.kind in "bi":
        np.testing.assert_array_equal(got, want, err_msg=where)
        return
    if where.endswith("histogram"):
        tol = 2e-3 * max(float(want.sum()), 1.0)
    else:
        tol = tol * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol, (where, got, want)


@pytest.mark.parametrize("kind", ["minmax", "histogram", "learnable"])
def test_calibrate_matches_jax(kind, cnn_variables):
    if kind == "learnable":
        qc_kw = _qc_kw("minmax", init_mode="learnable")
        jm, tm = _cnn_pair(qc_kw)
        variables = _init(jm, jnp.asarray(_images(1, 2, 1)[0]))
    else:
        qc_kw = _qc_kw(kind)
        jm, tm = _cnn_pair(qc_kw)
        variables = cnn_variables[kind]
    interop.load_qat_variables(tm, np_tree(variables))
    batches = _images(3, 4, seed=2)
    want = np_tree(jax.jit(lambda v, xs: jcalibrate(jm, v, xs))(
        dict(variables), [jnp.asarray(b) for b in batches]))
    calibrate(tm, [_nchw(b) for b in batches])
    got = interop.qat_variables(tm)
    for path, w in leaves(want):
        _close(get_path(got, path), w, "/".join(path))
    if kind == "learnable":  # no observer: the qparams stay as they were
        for path, w in leaves(np_tree(variables["qparams"])):
            np.testing.assert_array_equal(get_path(got["qparams"], path), w)


def test_static_estimate_and_learning_flags_match_jax(cnn_variables):
    jm, tm = _cnn_pair(_qc_kw("minmax"))
    variables = cnn_variables["minmax"]
    interop.load_qat_variables(tm, np_tree(variables))
    for jfn, tfn in ((jset_static, set_static_estimate),
                     (jenable_learning, enable_param_learning_all)):
        want = np_tree(jfn(dict(variables)))
        assert tfn(tm) is tm
        got = interop.qat_variables(tm)
        for path, w in leaves(want["quant_state"]):
            np.testing.assert_array_equal(get_path(got["quant_state"], path), w)


# -------------------------------------------------------- qat_optimizer

B, STEPS, WINDOW = 4, 6, 2
MAX_MOVED = 1e-4
LR, QLR_ADAM = 1e-2, 3e-4
# Adam's eps for the qparams: at optax's 1e-8 Adam turns a per-channel scale
# gradient that cancels to summation-order noise into a step of about lr in
# either direction (ROADMAP queue A item 1's finding), 2% of a weight scale
# here; at 1e-3 such noise moves a scale by ~1e-8 while a real gradient still
# takes an Adam-normalised step
ADAM_EPS = 1e-3


def _resnet(window):
    return QuantResNet(CLASSES, default_qconfig(8, 8, per_channel_weights=True,
                                                init_batches=window),
                       stage_sizes=(1, 1), widths=(8, 16), device="cpu")


def _cnn(window):
    return QuantCNN(CLASSES, default_qconfig(8, 8, per_channel_weights=True,
                                             init_batches=window),
                    widths=(8, 16), image_size=HW, device="cpu")


@pytest.fixture(scope="module")
def resnet():
    """The JAX QuantCNN, its batches and its ``model.init`` variables."""
    r = np.random.RandomState(0)
    xs = [r.randn(B, HW, HW, 3).astype(np.float32) for _ in range(STEPS)]
    ys = [r.randint(0, CLASSES, size=B).astype(np.int32) for _ in range(STEPS)]
    jmodel = JQuantCNN(num_classes=CLASSES, widths=(8, 16), qconfig=jdefault_qconfig(
        8, 8, per_channel_weights=True, init_batches=WINDOW))
    return jmodel, xs, ys, _init(jmodel, jnp.asarray(xs[0]))


def _trajectory(resnet, make_q, tol):
    jmodel, xs, ys, variables = resnet
    tx = jqat_optimizer(optax.sgd(LR, momentum=0.9), make_q[0])
    # create_train_state, its model.init jitted
    params = {"params": variables["params"], "qparams": variables["qparams"]}
    state = QATTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          model_state={k: v for k, v in variables.items()
                                       if k not in ("params", "qparams")},
                          opt_state=tx.init(params))
    jstep = jmake_train_step(jmodel, tx, donate=False)
    ports = []
    for jit in (False, True):
        model = _cnn(WINDOW)
        interop.load_qat_variables(model, np_tree({**state.params, **state.model_state}))
        opt = qat_optimizer(model, lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9),
                            make_q[1])
        rec = Recorder()
        rec.attach(model)
        ports.append((jit, make_train_step(model, opt, jit=jit), model, rec))
    for i in range(STEPS):
        with contextlib.ExitStack() as stack:
            for *_, rec in ports:
                stack.enter_context(fnn.intercept_methods(rec.intercept))
            state, metrics = jstep(state, {"image": jnp.asarray(xs[i]),
                                           "label": jnp.asarray(ys[i])})
        jax.effects_barrier()
        jtree = np_tree({**state.params, **state.model_state})
        for jit, step, model, _ in ports:
            loss = float(step({"image": _nchw(xs[i]), "label": torch.from_numpy(ys[i]).long()})
                         ["loss"])
            want_loss = float(metrics["loss"])
            assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (jit, i, loss, want_loss)
            mine = interop.qat_variables(model)
            for path, w in leaves(jtree):
                got = get_path(mine, path)
                where = f"jit={jit} step {i}: {'/'.join(path)}"
                if w.dtype.kind in "bi":
                    np.testing.assert_array_equal(got, w, err_msg=where)
                    continue
                mag = float(np.abs(w).max())
                if path[-1] == "shift":  # -zp * scale: held at the scale's size
                    mag = max(mag, float(np.abs(get_path(jtree, path[:-1] + ("scale",))).max()))
                assert float(np.abs(got - w).max()) <= tol * max(mag, 1e-30), (where, got, w)
    for *_, rec in ports:
        assert rec.total > 0 and rec.moved <= MAX_MOVED * rec.total, (rec.moved, rec.total)


def test_qat_optimizer_sgd_matches_optax(resnet):
    _trajectory(resnet, (None, None), 1e-6)


def test_qat_optimizer_adam_matches_optax(resnet):
    _trajectory(resnet, (optax.adam(QLR_ADAM, eps=ADAM_EPS),
                 lambda ps: torch.optim.Adam(ps, lr=QLR_ADAM, eps=ADAM_EPS)), 1e-5)


class _Tiny(torch.nn.Module):
    """A weight and one per-channel quantizer's qparams."""

    def __init__(self):
        super().__init__()
        cfg = default_qconfig(8, 8, per_channel_weights=True).weight
        self.w = torch.nn.Parameter(torch.zeros(3))
        self.fq = FakeQuantize(cfg, 3, "cpu")


@pytest.mark.parametrize("case", ["clip", "floor"])
def test_qat_optimizer_clip_and_floor_match_optax(case):
    r = np.random.RandomState(4)
    p = {"w": r.randn(3).astype(np.float32),
         "scale": np.asarray([1e-3, 2e-7 if case == "floor" else 2e-2, 0.05], np.float32),
         "shift": r.randn(3).astype(np.float32) * 0.01}
    spike = 1e3 if case == "clip" else 1e-2
    grads = [{k: (r.randn(3) * (spike if k != "w" else 1.0)).astype(np.float32)
              for k in p} for _ in range(3)]
    if case == "floor":
        for g in grads:
            g["scale"][1] = 5e-5  # lr 1e-2: drives 2e-7 below eps
    tx = jqat_optimizer(optax.sgd(0.1, momentum=0.9))

    def tree(d):
        return {"params": {"w": jnp.asarray(d["w"])},
                "qparams": {"fq": {"qp": {"scale": jnp.asarray(d["scale"]),
                                          "shift": jnp.asarray(d["shift"])}}}}

    params = tree(p)
    st = tx.init(params)
    m = _Tiny()
    with torch.no_grad():
        for name, t in (("w", m.w), ("scale", m.fq.scale), ("shift", m.fq.shift)):
            t.copy_(torch.from_numpy(p[name]))
    opt = qat_optimizer(m, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9))
    clipped = projected = False
    for g in grads:
        gt = tree(g)
        norm = float(optax.global_norm(gt["qparams"]))
        clipped |= norm >= 1.0
        upd, st = tx.update(gt, st, params)
        params = optax.apply_updates(params, upd)
        for name, t in (("w", m.w), ("scale", m.fq.scale), ("shift", m.fq.shift)):
            t.grad = torch.from_numpy(g[name].copy())
        opt.step()
        projected |= bool((m.fq.scale == np.float32(np.finfo(np.float32).eps)).any())
        want = {"w": params["params"]["w"], "scale": params["qparams"]["fq"]["qp"]["scale"],
                "shift": params["qparams"]["fq"]["qp"]["shift"]}
        for name, t in (("w", m.w), ("scale", m.fq.scale), ("shift", m.fq.shift)):
            w = np.asarray(want[name])
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=0,
                                       atol=1e-6 * float(np.abs(w).max()), err_msg=name)
    assert clipped == (case == "clip")
    assert projected == (case == "floor")
    assert float(m.fq.scale.detach().min()) >= np.finfo(np.float32).eps


def test_qat_optimizer_partitions_the_parameters():
    model = _resnet(WINDOW)
    opt = qat_optimizer(model, lambda ps: torch.optim.AdamW(ps, lr=1e-3))
    qps = {id(p) for m in model.modules() if isinstance(m, FakeQuantize)
           for p in (m.scale, m.shift)}
    w_ids = {id(p) for g in opt.weights.param_groups for p in g["params"]}
    q_ids = {id(p) for g in opt.qparams.param_groups for p in g["params"]}
    assert q_ids == qps and not (w_ids & q_ids)
    assert w_ids | q_ids == {id(p) for p in model.parameters()}
    assert any(n.endswith("bn1.scale") or "bn" in n for n, p in model.named_parameters()
               if id(p) in w_ids)
    group = opt.qparams.param_groups[0]
    assert (group["lr"], group["momentum"], group["weight_decay"]) == (0.01, 0.9, 0)
    assert opt.param_groups[-1] is group and opt.param_groups[0] is opt.weights.param_groups[0]
    opt.param_groups[-1]["lr"] = 0.5
    assert opt.qparams.param_groups[0]["lr"] == 0.5
    sd = opt.state_dict()
    opt.load_state_dict(sd)


# -------------------------------------------------------------- recipes

@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """examples/recipe_sweep.py, imported by path.  The ``accuracy_parity``
    it imports is this checkout's examples/accuracy_parity.py, loaded by path
    first and taken away afterwards; the compilation cache points into a
    temporary directory, and sys.path and the cache settings are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    path = list(sys.path)
    before = sys.modules.get("accuracy_parity")
    cache = os.environ.get("JAXLSQ_COMPILE_CACHE")
    os.environ["JAXLSQ_COMPILE_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    examples = os.path.join(REPO, "examples")
    try:
        spec = importlib.util.spec_from_file_location(
            "accuracy_parity", os.path.join(examples, "accuracy_parity.py"))
        parity = sys.modules["accuracy_parity"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parity)
        spec = importlib.util.spec_from_file_location(
            "_jax_recipe_sweep", os.path.join(examples, "recipe_sweep.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if cache is None:
            os.environ.pop("JAXLSQ_COMPILE_CACHE", None)
        else:
            os.environ["JAXLSQ_COMPILE_CACHE"] = cache
        sys.path[:] = path
        if before is None:
            sys.modules.pop("accuracy_parity", None)
        else:
            sys.modules["accuracy_parity"] = before
        for k, v in saved.items():
            jax.config.update(k, v)
    # the sweep's accuracy_parity is this checkout's
    assert mod.make_batch is parity.make_batch
    return mod


def _quantizer_fields(q):
    if q is None:
        return None
    obs = q.observer
    return (q.spec.quant_min, q.spec.quant_max, q.spec.per_channel, q.otype, q.init_mode,
            q.n_batches, q.learn_params, None if obs is None else type(obs).__name__,
            None if obs is None else getattr(obs, "averaging_constant", None))


def _qconfig_fields(qc):
    return (_quantizer_fields(qc.weight), _quantizer_fields(qc.activation),
            tuple((pat, _qconfig_fields(o)) for pat, o in qc.overrides))


def _check_plan_flow(sweep, name):
    """A mixed-precision recipe's plan flow builds at a toy size: its target
    and scout are the sweep's; a narrow ``QuantCNN`` scout trained two steps,
    the plan on a 4-image batch, and the planned model's weight quantizers at
    the planned widths."""
    def model_fn(qc):
        return QuantCNN(ap.N_CLASSES, qc, widths=(4,), device="cpu")

    rec = ap.recipe(name)
    assert rec.mp_target == sweep.MP_TARGETS[name] and ap.MP_SCOUT == sweep.MP_SCOUT
    scout = ap.train(model_fn, ap.recipe(ap.MP_SCOUT), 2, 4, seed=1, device="cpu")["model"]
    planned, extra = ap.planned_recipe(rec, scout, 1, 4, "cpu")
    assert extra["n_scopes"] == 2 and 0 <= extra["n_int8"] <= 1
    assert 4.0 <= extra["avg_bits"] <= rec.mp_target
    model = model_fn(planned.qconfig)
    bits = {n.rsplit(".", 1)[0]: m.cfg.spec.quant_max for n, m in model.named_modules()
            if isinstance(m, FakeQuantize) and n.endswith("weight_fq")}
    assert sorted(bits) == ["conv_0", "head"]
    assert sum(q == 127 for q in bits.values()) == extra["n_int8"]
    assert sum(q == 7 for q in bits.values()) == 2 - extra["n_int8"]


def test_every_recipe_matches_the_sweep(sweep):
    table = {**sweep.recipes(), **sweep.recipes_w4a8()}
    assert set(table) | {"float"} == set(ap.recipe_names())
    for name, entry in table.items():
        if name.startswith("mp4_"):
            _check_plan_flow(sweep, name)
        qc, *rest = entry if isinstance(entry, tuple) else (entry,)
        rec = ap.recipe(name)
        assert _qconfig_fields(rec.qconfig) == _qconfig_fields(qc), name
        tx = rest[0].__name__ if rest else "default_tx"
        assert rec.optimizer.__name__ == tx, name
        state_fn = rest[1].__name__ if len(rest) > 1 else None
        assert (rec.state_fn.__name__ if rec.state_fn else None) == state_fn, name
        assert rec.warm_batches == (20 if name.endswith("_warm") else 0), name
        assert rec.distill == name.startswith("distill"), name
    assert ap.recipe("float").qconfig.weight is None
    with pytest.raises(ValueError, match="unknown recipe"):
        ap.recipe("combo9")


@pytest.mark.parametrize("name", ["sgdq", "learnable_warm", "static", "mse",
                                  "distill_static"])
def test_recipes_train_at_a_toy_size(name):
    """A few steps of each kind of recipe through the lab's ``train`` on the
    CPU: the optimizer partition, the warm start, the static estimate, the
    float teacher (untouched by the distilled run)."""
    def model_fn(qc):
        return QuantCNN(ap.N_CLASSES, qc, widths=(4,), device="cpu")

    teacher = None
    if ap.recipe(name).distill:
        with pytest.raises(ValueError, match="teacher"):
            ap.train(model_fn, ap.recipe(name), 1, 2, seed=1, device="cpu")
        teacher = ap.train(model_fn, ap.recipe("float"), 2, 2, seed=1, device="cpu")["model"]
        before = {k: v.clone() for k, v in teacher.state_dict().items()}
    run = ap.train(model_fn, ap.recipe(name), 3, 2, seed=1, device="cpu", teacher=teacher)
    if teacher is not None:
        assert all(torch.equal(v, before[k]) for k, v in teacher.state_dict().items())
    assert np.isfinite(run["loss"])
    opt = run["optimizer"]
    assert all(float(g["lr"]) == run["lrs"][-1] for g in opt.param_groups)
    fqs = [m for m in run["model"].modules() if isinstance(m, FakeQuantize)]
    if name.endswith("static"):
        assert not any(m.host_state()["learning_enabled"] for m in fqs)
    if name == "learnable_warm":
        acts = [m for m in fqs if m.cfg.otype == "activation"]
        # a learnable quantizer's observer is off at init: the 20 warm batches
        assert all(int(m.obs_seen) == 20 for m in acts)
        assert not any(m.host_state()["observer_enabled"] for m in acts)
    if name == "sgdq":
        assert isinstance(opt.qparams, torch.optim.SGD)
        assert isinstance(opt.weights, torch.optim.AdamW)
    if name == "mse":
        assert all(type(m.cfg.observer).__name__ == "MSEObserver" for m in fqs
                   if m.cfg.otype == "activation")
