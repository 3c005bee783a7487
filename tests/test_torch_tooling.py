"""The port's tooling against the JAX package's: quantizer and serving-size
reports, per-layer sensitivity, mixed-precision planning, torchlsq
migration and the profiling hooks.

The model is a ``QuantMLP`` (16 -> 32 -> 32 -> 16 -> 4; w4a8, per-channel
weights, full range, an observer window of one batch) drawn and trained for
four eager SGD steps by the port, then carried into the JAX package's tree
on the structure of ``jax.eval_shape`` of its ``init`` (whose keys sort as
the port's modules are ordered).  The eval batch is 64 seeded numpy rows.

* ``quantizer_report`` rows (and ``format_report``) equal to the JAX
  package's; ``serving_size_report`` of the served model equal to the JAX
  package's on its converted tree.
* ``quantizer_scopes`` (both granularities, in order), the flags written by
  ``set_fake_quant_by_scope``, and ``sensitivity_report``'s scopes, their
  order and every loss within 1e-5 (the matmul sums run in another order);
  every counter and flag and ``model.training`` bit-identical after a call,
  and after one whose loss raises.
* ``requantize_qconfig``: every spec field equal.
* ``plan_mixed_precision``: the assignment and ``avg_bits`` equal, every
  damage, uniform loss and ``planned_quant_loss`` within 1e-5; the planned
  copy's weight qparams bit-equal to the JAX package's
  ``planned_variables``; ``convert`` under the planned qconfig packs mixed
  carriers (int8 for the promoted layers, int4 for the rest) byte for byte
  as the JAX package's, and the served model's logits lie within 1e-4 of its
  served apply.
* ``load_torchlsq_state`` on the state dicts of the JAX package's
  ``tests/test_utils.py`` (numpy and torch): qparams bit-equal, flags and
  counters equal, the same ``KeyError``/``ValueError``.
* ``annotate`` (context manager and decorator), ``trace`` (a Chrome trace
  holding the spans) and ``StepTimer`` on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_tree, torch_tree_to_np
from jaxlsq.models import QuantMLP as JQuantMLP
from jaxlsq.models import default_qconfig as jdefault_qconfig
from jaxlsq.serve import convert as jconvert
from jaxlsq.utils import format_report as jformat_report
from jaxlsq.utils import load_torchlsq_state as jload_torchlsq_state
from jaxlsq.utils import plan_mixed_precision as jplan
from jaxlsq.utils import quantizer_report as jquantizer_report
from jaxlsq.utils import quantizer_scopes as jquantizer_scopes
from jaxlsq.utils import requantize_qconfig as jrequantize
from jaxlsq.utils import sensitivity_report as jsensitivity
from jaxlsq.utils import serving_size_report as jserving_size
from jaxlsq.utils import set_fake_quant_by_scope as jset_by_scope
from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantMLP, default_qconfig
from jaxlsq_torch.models.layers import FakeQuantize
from jaxlsq_torch.observers.quantizer import STATE_FIELDS
from jaxlsq_torch.parallel import make_train_step
from jaxlsq_torch.serve import convert
from jaxlsq_torch.utils import (StepTimer, annotate, format_plan, format_report,
                                format_sensitivity, load_torchlsq_state,
                                plan_mixed_precision, quantizer_report, quantizer_scopes,
                                requantize_qconfig, sensitivity_report,
                                serving_size_report, set_fake_quant_by_scope, trace)

IN, FEATURES, CLASSES = 16, (32, 32, 16, 4), 4
QKW = dict(per_channel_weights=True, init_batches=1, reduce_range=False)
TOL = 1e-5


def carry(model, jmodel, x0):
    """The port model's variables in the JAX package's tree of ``jmodel``."""
    tmpl = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), x0, training=False))
    tree = interop.qat_variables(model)

    def leaf(path, s):
        node = tree
        for k in path:
            node = node[getattr(k, "key", None) or getattr(k, "name")]
        return jnp.asarray(node, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tmpl)


def flags(model):
    return {n: [getattr(m, f).clone() for f in STATE_FIELDS]
            for n, m in model.named_modules() if isinstance(m, FakeQuantize)}


def assert_flags_equal(a, b):
    assert a.keys() == b.keys()
    for n in a:
        for x, y in zip(a[n], b[n]):
            assert torch.equal(x, y), n


@pytest.fixture(scope="module")
def mlp():
    r = np.random.RandomState(0)
    model = QuantMLP(IN, FEATURES, default_qconfig(4, 8, **QKW), device="cpu")
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.05), jit=False)
    for _ in range(4):
        step({"input": torch.from_numpy(r.randn(32, IN).astype(np.float32)),
              "label": torch.from_numpy(r.randint(0, CLASSES, 32))})
    x = r.randn(64, IN).astype(np.float32)
    y = r.randint(0, CLASSES, 64)
    jmodel = JQuantMLP(features=FEATURES, qconfig=jdefault_qconfig(4, 8, **QKW))
    tree = carry(model, jmodel, jnp.zeros((1, IN)))
    return {"model": model, "jmodel": jmodel, "tree": tree,
            "batch": {"input": torch.from_numpy(x), "label": torch.from_numpy(y)},
            "jbatch": {"input": jnp.asarray(x), "label": jnp.asarray(y)}}


def test_quantizer_report_rows_equal_jaxlsq(mlp):
    rows = quantizer_report(mlp["model"])
    want = jquantizer_report(mlp["tree"])
    assert rows == want
    assert format_report(rows, max_rows=3) == jformat_report(want, max_rows=3)
    assert [r["path"] for r in rows][:2] == ["dense_0/act_fq", "dense_0/weight_fq"]


def test_serving_size_report_equals_jaxlsq(mlp):
    qc = default_qconfig(4, 8, **QKW)
    served = QuantMLP(IN, FEATURES, qc.for_serving("static"), device="cpu")
    interop.load_variables(served, interop.qat_variables(mlp["model"]))
    jqc = jdefault_qconfig(4, 8, **QKW)
    want = jserving_size(jax.jit(lambda v: jconvert(v, jqc))(mlp["tree"]))
    got = serving_size_report(served)
    assert got == want
    assert got["packed_weights"] == len(FEATURES)


@pytest.mark.parametrize("granularity", ["layer", "quantizer"])
def test_scopes_and_flags_by_scope_equal_jaxlsq(mlp, granularity):
    model, tree = mlp["model"], mlp["tree"]
    scopes = quantizer_scopes(model, granularity)
    assert scopes == jquantizer_scopes(tree, granularity)
    before = flags(model)
    enabled = scopes[1:3]
    set_fake_quant_by_scope(model, enabled)
    jtree = jset_by_scope(tree, enabled)
    for name, m in model.named_modules():
        if isinstance(m, FakeQuantize):
            node = jtree["quant_state"]
            for k in name.split("."):
                node = node[k]
            assert bool(m.fake_quant_enabled) == bool(node["qs"]["fake_quant_enabled"]), name
    # put the flags back for the other tests
    for n, m in model.named_modules():
        if isinstance(m, FakeQuantize):
            m.fake_quant_enabled.copy_(before[n][STATE_FIELDS.index("fake_quant_enabled")])
    with pytest.raises(ValueError, match="granularity"):
        quantizer_scopes(model, "block")


@pytest.mark.parametrize("granularity", ["layer", "quantizer"])
def test_sensitivity_report_matches_jaxlsq(mlp, granularity):
    model = mlp["model"]
    before = flags(model)
    model.train()
    got = sensitivity_report(model, mlp["batch"], granularity=granularity)
    want = jsensitivity(mlp["jmodel"], mlp["tree"], mlp["jbatch"], granularity=granularity)
    assert model.training
    assert_flags_equal(before, flags(model))
    assert [r["scope"] for r in got["rows"]] == [r["scope"] for r in want["rows"]]
    for key in ("baseline_float", "baseline_quant"):
        assert abs(got[key] - want[key]) <= TOL, key
    for a, b in zip(got["rows"], want["rows"]):
        for key in ("quant_only", "quant_only_delta", "leave_one_out",
                    "leave_one_out_recovery"):
            assert abs(a[key] - b[key]) <= TOL, (a["scope"], key)
    assert format_sensitivity(got).splitlines()[1] == format_sensitivity(want).splitlines()[1]


def test_sensitivity_restores_flags_after_an_exception(mlp):
    model = mlp["model"]
    before = flags(model)
    calls = []

    def failing_loss(logits, batch):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("loss failed")
        return torch.nn.functional.cross_entropy(logits, batch["label"])

    model.eval()
    with pytest.raises(RuntimeError, match="loss failed"):
        sensitivity_report(model, mlp["batch"], loss_fn=failing_loss)
    assert not model.training
    assert_flags_equal(before, flags(model))
    model.train()


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("cfg", [dict(weight_bits=8), dict(weight_bits=4, reduce_range=False),
                                 dict(weight_bits=8, per_channel_weights=True),
                                 dict(weight_bits=4, per_channel_weights=True)])
def test_requantize_qconfig_fields_equal(cfg, bits):
    want = jrequantize(jdefault_qconfig(**cfg), bits).weight.spec
    got = requantize_qconfig(default_qconfig(**cfg), bits).weight.spec
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.fixture(scope="module")
def plans(mlp):
    out = {}
    for target in (5.0, 6.0):
        got = plan_mixed_precision(mlp["model"], mlp["batch"], bit_options=(4, 8),
                                   target_avg_bits=target)
        want = jplan(mlp["jmodel"], mlp["tree"], mlp["jbatch"], bit_options=(4, 8),
                     target_avg_bits=target)
        out[target] = (got, want)
    return out


@pytest.mark.parametrize("target", [5.0, 6.0])
def test_plan_matches_jaxlsq(mlp, plans, target):
    got, want = plans[target]
    assert got["assignment"] == want["assignment"]
    assert got["avg_bits"] == want["avg_bits"]
    assert 8 in got["assignment"].values() and 4 in got["assignment"].values()
    assert abs(got["baseline_float"] - want["baseline_float"]) <= TOL
    for b in (4, 8):
        assert abs(got["uniform"][b] - want["uniform"][b]) <= TOL
    assert [r["scope"] for r in got["rows"]] == [r["scope"] for r in want["rows"]]
    for a, b in zip(got["rows"], want["rows"]):
        assert (a["numel"], a["bits"]) == (b["numel"], b["bits"])
        for key in ("damage_4b", "damage_8b"):
            assert abs(a[key] - b[key]) <= TOL, (a["scope"], key)
    assert abs(got["planned_quant_loss"] - want["planned_quant_loss"]) <= TOL
    assert got["qconfig"].overrides and [p for p, _ in got["qconfig"].overrides] == [
        p for p, _ in want["qconfig"].overrides]
    # the planned copy: its weight scales rescaled as the JAX package's
    planned = interop.qat_variables(got["planned_model"])
    jplanned = np_tree(want["planned_variables"])
    for layer in got["assignment"]:
        for key in ("scale", "shift"):
            np.testing.assert_array_equal(planned["qparams"][layer]["weight_fq"]["qp"][key],
                                          jplanned["qparams"][layer]["weight_fq"]["qp"][key])
    assert format_plan(got).splitlines()[0] == format_plan(want).splitlines()[0]


def test_plan_leaves_the_model_as_it_was(mlp, plans):
    model = mlp["model"]
    before = flags(model)
    scales = [m.scale.clone() for m in model.modules() if isinstance(m, FakeQuantize)]
    plan_mixed_precision(model, mlp["batch"], target_avg_bits=5.0, verify=False)
    assert_flags_equal(before, flags(model))
    for s, m in zip(scales, [m for m in model.modules() if isinstance(m, FakeQuantize)]):
        assert torch.equal(s, m.scale)
    with pytest.raises(ValueError, match="two bit_options"):
        plan_mixed_precision(model, mlp["batch"], bit_options=(4,))
    with pytest.raises(ValueError, match="below the smallest"):
        plan_mixed_precision(model, mlp["batch"], target_avg_bits=3.0)


def test_mixed_carriers_converted_and_served(mlp, plans):
    got, want = plans[5.0]
    tree = interop.qat_variables(mlp["model"])
    conv = torch_tree_to_np(convert(tree, got["qconfig"]))
    jconv = np_tree(jax.jit(lambda v: jconvert(v, want["qconfig"]))(mlp["tree"]))
    for layer, bits in got["assignment"].items():
        packed = conv["quantized"][layer]["kernel"]
        assert packed["bits"] == bits == jconv["quantized"][layer]["kernel"]["bits"]
        for f in ("data", "scale", "zero_point"):
            np.testing.assert_array_equal(packed[f], jconv["quantized"][layer]["kernel"][f])
    served = QuantMLP(IN, FEATURES, got["qconfig"].for_serving("static"), device="cpu")
    interop.load_variables(served, tree)
    assert {n: served.get_submodule(n).kernel.bits for n in got["assignment"]} == \
        got["assignment"]
    jserved = dataclasses.replace(mlp["jmodel"],
                                  qconfig=want["qconfig"].for_serving("static", "xla"))
    jconverted = jax.jit(lambda v: jconvert(v, want["qconfig"]))(mlp["tree"])
    ref = np.asarray(jserved.apply(jconverted, mlp["jbatch"]["input"], training=False))
    with torch.no_grad():
        out = served(mlp["batch"]["input"]).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def _migrate_setup():
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=3)
    model = QuantMLP(8, (16, 4), qc, device="cpu")
    jmodel = JQuantMLP(features=(16, 4),
                       qconfig=jdefault_qconfig(8, 8, per_channel_weights=True,
                                                init_batches=3))
    return model, carry(model, jmodel, jnp.zeros((1, 8)))


SD = {
    "features.0.activation_post_process.scale": np.asarray([0.037]),
    "features.0.activation_post_process.shift": np.asarray([-0.5]),
    "features.0.activation_post_process.fake_quant_enabled": np.asarray([1], np.uint8),
    "features.0.activation_post_process.observer_enabled": np.asarray([0], np.uint8),
    "features.0.activation_post_process.current_batch": np.asarray([7], np.int64),
    "features.0.weight_fake_quant.scale": (0.01 + 0.001 * np.arange(16)).astype(np.float32),
    "features.0.weight_fake_quant.zero_point": np.asarray([3] * 8 + [0] * 8, np.int64),
    "head.weight_fake_quant.scale": np.asarray([0.02], np.float32),
    "head.weight_fake_quant.learning_enabled": np.asarray([0], np.uint8),
}
MAPPING = {"dense_0/act_fq": "features.0.activation_post_process",
           "dense_0/weight_fq": "features.0.weight_fake_quant",
           "head/weight_fq": "head.weight_fake_quant"}


@pytest.mark.parametrize("as_torch", [False, True])
def test_load_torchlsq_state_matches_jaxlsq(as_torch):
    model, tree = _migrate_setup()
    want = np_tree(jload_torchlsq_state(tree, SD, MAPPING))
    sd = {k: torch.from_numpy(v) for k, v in SD.items()} if as_torch else SD
    model.dense_0.act_fq.host_state()  # a filled host mirror must be invalidated
    assert load_torchlsq_state(model, sd, MAPPING) is model
    got = interop.qat_variables(model)
    for path in MAPPING:
        layer, fq = path.split("/")
        for key in ("scale", "shift"):
            np.testing.assert_array_equal(got["qparams"][layer][fq]["qp"][key],
                                          want["qparams"][layer][fq]["qp"][key])
        for f in STATE_FIELDS:
            assert (np.asarray(got["quant_state"][layer][fq]["qs"][f]).item()
                    == np.asarray(want["quant_state"][layer][fq]["qs"][f]).item()), (path, f)
    h = model.dense_0.act_fq.host_state()
    assert h["current_batch"] == 7 and not h["observer_enabled"]
    with torch.no_grad():
        assert torch.isfinite(model.eval()(torch.ones(2, 8))).all()


def test_load_torchlsq_state_errors_as_jaxlsq():
    model, tree = _migrate_setup()
    bad = {"m.scale": np.ones(5, np.float32)}  # a wrong channel count
    with pytest.raises(ValueError, match="scale shape"):
        jload_torchlsq_state(tree, bad, {"dense_0/weight_fq": "m"})
    with pytest.raises(ValueError, match="scale shape"):
        load_torchlsq_state(model, bad, {"dense_0/weight_fq": "m"})
    with pytest.raises(KeyError):
        jload_torchlsq_state(tree, {}, {"dense_0/weight_fq": "m"})
    with pytest.raises(KeyError):
        load_torchlsq_state(model, {}, {"dense_0/weight_fq": "m"})


def test_profiling_hooks_on_cpu(tmp_path):
    @annotate("jlt_decorated")
    def work(x):
        return (x @ x).sum()

    x = torch.randn(16, 16)
    timer = StepTimer(warmup=1)
    rates = []
    with trace(str(tmp_path)) as prof:
        for _ in range(4):
            with annotate("jlt_step"):
                y = work(x)
            rates.append(timer.tick(y))
    assert rates[:2] == [None, None] and all(r > 0 for r in rates[2:])
    names = {e.key for e in prof.key_averages()}
    assert {"jlt_step", "jlt_decorated"} <= names
    files = os.listdir(tmp_path)
    assert len(files) == 1 and os.path.join(str(tmp_path), files[0]) == prof.trace_path
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events if e.get("name", "").startswith("jlt_")]
    assert spans.count("jlt_step") == 4 and spans.count("jlt_decorated") == 4
