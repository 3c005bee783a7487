"""The int8 x int8 serving path of jaxlsq_torch (its plain versions, which CPU
tensors take) against the JAX package's, on the same numpy inputs:

* ``static_int8_matmul``, ``dynamic_int8_matmul`` and ``static_int8_conv``:
  the int8 activation ``x_q``, the int32 accumulator, ``rowsum(x_q)`` and
  ``colsum(w_q)`` equal; the outputs within 1e-6 of max|ref| (the same f32
  operations; jax may round a division by a constant through its
  reciprocal);
* NaN, +-inf and an all-zero input: the JAX package's float -> int8
  conversion (saturating, NaN -> 0) on both sides;
* ``QuantDense`` / ``QuantDenseGeneral`` / ``QuantConv`` served under
  ``'static_int8'`` and ``'dynamic'``, the conv's fallbacks to the
  float-simulated path and the refusals, within 1e-5 of the JAX package's;
  ``QuantCNN`` at the JAX package's own 5e-3 against its ``'static'`` and
  1e-5 against its ``'static_int8'``; a small LM's logits within 1e-4.

Variables are drawn by the port and carried into the JAX package's trees;
activation qparams are set to a realistic range (scale 0.04, zero point 64
or 128) so that the integer paths see clipping on both sides.
"""

import dataclasses
import unittest.mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.models import QuantCNN as JQuantCNN
from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as j_default_qconfig
from jaxlsq.models.layers import QuantConv as JQuantConv
from jaxlsq.models.layers import QuantDense as JQuantDense
from jaxlsq.models.layers import QuantDenseGeneral as JQuantDenseGeneral
from jaxlsq.serve import convert as jconvert
from jaxlsq.serve.matmul import dynamic_int8_matmul as j_dynamic
from jaxlsq.serve.matmul import static_int8_conv as j_conv
from jaxlsq.serve.matmul import static_int8_matmul as j_static
from jaxlsq.serve.pack import quantize_weight as j_quantize

from jaxlsq_torch import interop
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.models import (QuantCNN, QuantConv, QuantDense, QuantDenseGeneral,
                                 QuantTransformerLM, default_qconfig)
from jaxlsq_torch.serve.matmul import (LAUNCHES, act_quant_i8, conv_operands,
                                       dynamic_int8_matmul, int8_product_plain,
                                       static_int8_conv, static_int8_matmul)
from jaxlsq_torch.serve.pack import quantize_weight

from _torch_port import np_tree

RANGES = {"signed": (-128, 127, -7), "unsigned7": (0, 127, 64), "unsigned8": (0, 255, 128)}


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _spec_pair(per_channel, axis, qmin=-128, qmax=127):
    kw = dict(quant_min=qmin, quant_max=qmax, type_min=-128, type_max=127,
              per_channel=per_channel, axis=axis)
    return JSpec(**kw), QuantSpec(**kw)


def _packs(w, per_channel, affine, axis, seed, k_axis=None):
    """The same int8 pack on both sides from one numpy weight."""
    r = np.random.RandomState(seed)
    c = w.shape[axis] if per_channel else 1
    jspec, tspec = _spec_pair(per_channel, axis)
    scale = (np.abs(w).max() / 100 + 0.002 * r.rand(c)).astype(np.float32)
    shift = ((r.randn(c) * 0.01) if affine else np.zeros(c)).astype(np.float32)
    kw = {} if k_axis is None else {"k_axis": k_axis}
    jp = j_quantize(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift), jspec, bits=8, **kw)
    tp = quantize_weight(torch.as_tensor(w), torch.as_tensor(scale), torch.as_tensor(shift),
                         tspec, bits=8, **kw)
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    assert affine == bool(np.any(tp.zero_point.numpy() != 0))
    return jp, tp


# jitted once a shape (each op compiled alone costs more); under jit the
# conv's zero points are traced, so it takes its always-exact affine epilogue
_j_static = jax.jit(j_static, static_argnums=(4, 5))
_j_conv = jax.jit(lambda x, p, s, z, qmin, qmax, strides, padding, groups: j_conv(
    x, p, s, z, qmin, qmax, strides=strides, padding=padding, feature_group_count=groups),
    static_argnums=(4, 5, 6, 7, 8))


def _jax_xq(x, sx, zpx, qmin, qmax):
    """The JAX package's static activation quantization (serve/matmul.py:448-452)."""
    shift = 128.0 if qmax > 127 else 0.0
    xq = jnp.clip(jnp.round(jnp.asarray(x) / sx + zpx), qmin, qmax) - shift
    return np.asarray(xq.astype(jnp.int8))


@pytest.mark.parametrize("rng", sorted(RANGES))
@pytest.mark.parametrize("per_channel,affine", [(True, False), (False, False), (True, True)])
def test_static_int8_matmul_matches_jax(rng, per_channel, affine):
    qmin, qmax, zp = RANGES[rng]
    r = np.random.RandomState(len(rng) + 2 * per_channel + affine)
    k, n, m = 37, 24, 5
    w = (r.randn(k, n) * 0.2).astype(np.float32)
    x = (r.randn(2, m, k) * 2).astype(np.float32)
    jp, tp = _packs(w, per_channel, affine, 1, 3)
    sx = np.asarray([0.04], np.float32)
    zpx = np.asarray([zp], np.int32)
    want = _j_static(jnp.asarray(x), jp, jnp.asarray(sx), jnp.asarray(zpx), qmin, qmax)
    before = dict(LAUNCHES)
    got = static_int8_matmul(torch.as_tensor(x), tp, torch.as_tensor(sx), torch.as_tensor(zpx),
                             qmin, qmax)
    assert LAUNCHES == before  # CPU tensors take the plain versions
    _close(got.numpy(), want, 1e-6)
    # the integer parts
    xq, qx = act_quant_i8(torch.as_tensor(x).reshape(-1, k), torch.as_tensor(sx),
                          torch.as_tensor(zpx), qmin, qmax)
    jxq = _jax_xq(x.reshape(-1, k), sx[0], float(zp), qmin, qmax)
    np.testing.assert_array_equal(xq.numpy(), jxq)
    assert float(qx[1]) == zp - (128.0 if qmax > 127 else 0.0)
    acc, rs, cs = int8_product_plain(xq[None], tp.data[None])
    jacc = jax.lax.dot(jnp.asarray(jxq), jp.data, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc[0].numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(rs[0].numpy(), jxq.astype(np.int32).sum(1))
    np.testing.assert_array_equal(cs[0].numpy(), np.asarray(jp.data).astype(np.int32).sum(0))


@pytest.mark.parametrize("per_channel,affine", [(True, False), (False, False), (True, True)])
def test_dynamic_int8_matmul_matches_jax(per_channel, affine):
    r = np.random.RandomState(10 + 2 * per_channel + affine)
    k, n = 40, 12
    w = (r.randn(k, n) * 0.2).astype(np.float32)
    x = (r.randn(3, 4, k) * 1.5).astype(np.float32)
    jp, tp = _packs(w, per_channel, affine, 1, 4)
    want = j_dynamic(jnp.asarray(x), jp)
    got = dynamic_int8_matmul(torch.as_tensor(x), tp)
    _close(got.numpy(), want, 1e-6)
    xq, qx = act_quant_i8(torch.as_tensor(x).reshape(-1, k), dynamic=True)
    sx = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))) / 127.0, jnp.finfo(jnp.float32).tiny)
    jxq = np.asarray(jnp.round(jnp.asarray(x.reshape(-1, k)) / sx).astype(jnp.int8))
    assert float(qx[0]) == float(sx) and float(qx[1]) == 0.0
    np.testing.assert_array_equal(xq.numpy(), jxq)
    acc, rs, _ = int8_product_plain(xq[None], tp.data[None])
    np.testing.assert_array_equal(
        acc[0].numpy(), np.asarray(jax.lax.dot(jnp.asarray(jxq), jp.data,
                                               preferred_element_type=jnp.int32)))
    np.testing.assert_array_equal(rs[0].numpy(), jxq.astype(np.int32).sum(1))


CONVS = {  # cin, cout, groups, k, stride, padding, size
    "stem_same": (3, 8, 1, 3, 1, "SAME", 8),
    "grouped_valid": (4, 6, 2, 3, 1, "VALID", 7),
    "depthwise_s2": (6, 6, 6, 3, 2, "SAME", 8),
    "pointwise": (5, 7, 1, 1, 1, "SAME", 5),
    "pairs_s2": (4, 8, 1, 3, 2, ((1, 0), (0, 2)), 7),
}


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("case", sorted(CONVS))
def test_static_int8_conv_matches_jax(case, affine):
    cin, cout, groups, k, stride, padding, size = CONVS[case]
    r = np.random.RandomState(len(case) + affine)
    w = (r.randn(k, k, cin // groups, cout) * 0.3).astype(np.float32)
    x = (r.randn(2, size, size, cin) * 2).astype(np.float32)  # NHWC
    jp, tp = _packs(w, True, affine, 3, 5, k_axis=2)
    qmin, qmax, zp = RANGES["unsigned8"]
    sx = np.asarray([0.05], np.float32)
    zpx = np.asarray([zp], np.int32)
    kw = dict(strides=(stride, stride), padding=padding, feature_group_count=groups)
    want = _j_conv(jnp.asarray(x), jp, jnp.asarray(sx), jnp.asarray(zpx), qmin, qmax,
                   (stride, stride), padding, groups)
    xt = torch.as_tensor(x).permute(0, 3, 1, 2).contiguous()
    got = static_int8_conv(xt, tp, torch.as_tensor(sx), torch.as_tensor(zpx), qmin, qmax, **kw)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-6)
    # the integer parts: x_q, and the accumulator of the JAX package's padded conv
    xq, qx = act_quant_i8(xt, torch.as_tensor(sx), torch.as_tensor(zpx), qmin, qmax)
    jxq = _jax_xq(x, sx[0], float(zp), qmin, qmax)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), jxq)
    a, b, (imgs, ho, wo) = conv_operands(xq, qx, tp, (stride, stride), padding, groups)
    acc, rs, cs = int8_product_plain(a, b)
    if padding == "SAME":
        pads = [tuple(p) for p in jax.lax.padtype_to_pads((size, size), (k, k),
                                                           (stride, stride), "SAME")]
    else:
        pads = [(0, 0), (0, 0)] if padding == "VALID" else [tuple(p) for p in padding]
    xp = jax.lax.pad(jnp.asarray(jxq), jnp.int8(zp - 128),
                     ((0, 0, 0), (*pads[0], 0), (*pads[1], 0), (0, 0, 0)))
    jacc = np.asarray(jax.lax.conv_general_dilated(
        xp, jp.data, (stride, stride), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    ng = cout // groups
    mine = acc.reshape(groups, imgs, ho, wo, ng).permute(1, 2, 3, 0, 4).reshape(
        imgs, ho, wo, cout)
    np.testing.assert_array_equal(mine.numpy(), jacc)
    np.testing.assert_array_equal(cs.reshape(-1).numpy(),
                                  np.asarray(jp.data).astype(np.int32).sum((0, 1, 2)))
    ones = jnp.ones((k, k, cin // groups, groups), jnp.int8)  # the window sums
    jwin = np.asarray(jax.lax.conv_general_dilated(
        xp, ones, (stride, stride), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(rs.reshape(groups, imgs, ho, wo).permute(1, 2, 3, 0).numpy(),
                                  jwin)


@pytest.mark.parametrize("special", ["nan", "inf", "-inf", "zeros"])
def test_nan_inf_and_zero_inputs_match_jax(special):
    """NaN converts to 0 and +-inf saturates (static) as the JAX package's
    conversion does; a dynamic scale over a NaN or an inf is NaN or inf."""
    r = np.random.RandomState(7)
    k, n = 16, 8
    w = (r.randn(k, n) * 0.2).astype(np.float32)
    jp, tp = _packs(w, True, True, 1, 6)
    x = r.randn(3, k).astype(np.float32)
    if special == "zeros":
        x[:] = 0.0
    else:
        x[1, 5] = float(special)
    sx, zpx = np.asarray([0.04], np.float32), np.asarray([128], np.int32)
    xt = torch.as_tensor(x)
    for dynamic in (False, True):
        if dynamic:
            want = np.asarray(j_dynamic(jnp.asarray(x), jp))
            got = dynamic_int8_matmul(xt, tp).numpy()
            xq = act_quant_i8(xt, dynamic=True)[0].numpy()
        else:
            want = np.asarray(j_static(jnp.asarray(x), jp, jnp.asarray(sx), jnp.asarray(zpx),
                                       0, 255))
            got = static_int8_matmul(xt, tp, torch.as_tensor(sx), torch.as_tensor(zpx),
                                     0, 255).numpy()
            xq = act_quant_i8(xt, torch.as_tensor(sx), torch.as_tensor(zpx), 0, 255)[0].numpy()
            np.testing.assert_array_equal(xq, _jax_xq(x, sx[0], 128.0, 0, 255))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        if fin.any():
            _close(got[fin], want[fin], 1e-6)
        if special == "nan":  # NaN -> 0 on both sides
            assert xq[1, 5] == 0


def test_refusals():
    r = np.random.RandomState(8)
    w = (r.randn(8, 4) * 0.2).astype(np.float32)
    spec4 = QuantSpec(quant_min=-8, quant_max=7, type_min=-8, type_max=7)
    p4 = quantize_weight(torch.as_tensor(w), torch.tensor([0.05]), torch.zeros(1), spec4, bits=4)
    _, p8 = _packs(w, False, False, 1, 9)
    x = torch.randn(2, 8)
    one, z = torch.tensor([0.1]), torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="int8-packed"):
        static_int8_matmul(x, p4, one, z, -128, 127)
    with pytest.raises(ValueError, match="int8-packed"):
        dynamic_int8_matmul(x, p4)
    with pytest.raises(ValueError, match="per-tensor"):
        static_int8_matmul(x, p8, torch.full((8,), 0.1), torch.zeros(8, dtype=torch.int32),
                           -128, 127)
    with pytest.raises(ValueError, match="unsupported device"):
        static_int8_matmul(x.to("meta"), p8, one, z, -128, 127)


# --- layers --------------------------------------------------------------------------------

def _set_act_qparams(tree, scale=0.04, zp=64):
    """Every activation quantizer's (scale, shift) in ``tree['qparams']`` set
    so that zp = -shift / scale lands at ``zp`` (converted qparams of a
    realistic range)."""
    def walk(node):
        for key, val in node.items():
            if key == "act_fq":
                qp = val["qp"]
                qp["scale"] = np.full_like(qp["scale"], scale)
                qp["shift"] = np.full_like(qp["shift"], -zp * scale)
            elif isinstance(val, dict):
                walk(val)

    walk(tree["qparams"])
    return tree


class JNet(fnn.Module):
    qc: object
    conv: bool = True

    @fnn.compact
    def __call__(self, x, *, training=False):  # x NHWC (B, 6, 6, 4)
        if self.conv:
            x = fnn.relu(JQuantConv(8, (3, 3), self.qc, name="conv")(x, training=training))
            y = JQuantDenseGeneral(5, qconfig=self.qc, axis=(-2, -1), name="dg")(
                x, training=training)
        else:
            y = JQuantDenseGeneral(5, qconfig=self.qc, axis=(-2, -1), name="dg")(
                x, training=training)
        return JQuantDense(3, self.qc, name="dense")(fnn.relu(y), training=training)


class Net(nn.Module):
    def __init__(self, qc, conv=True):
        super().__init__()
        self.qconfig = qc  # load_variables converts a QAT tree under it
        self.has_conv = conv
        cin = 8 if conv else 4
        if conv:
            self.conv = QuantConv(4, 8, (3, 3), qc, path=("conv",), device="cpu")
        self.dg = QuantDenseGeneral((6, cin), 5, qc, axis=(-2, -1), path=("dg",), device="cpu")
        self.dense = QuantDense(5, 3, qc, path=("dense",), device="cpu")

    def forward(self, x):  # x NCHW
        if self.has_conv:
            x = torch.relu(self.conv(x))
        y = self.dg(x.permute(0, 2, 3, 1))
        return self.dense(torch.relu(y))


def _layer_models(jqc, qc, conv, seed):
    """A QAT Net drawn by the port, its tree with realistic activation
    qparams, and the JAX package's converted tree."""
    from jaxlsq_torch.models.zoo import init_qat_variables

    qat = Net(qc, conv)
    init_qat_variables(qat, seed)  # draws the conv and the dense layer
    dg = qat.dg
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed)
        dg.kernel.copy_(torch.randn(dg.kernel.shape, generator=gen) * 0.2)
        dg.weight_fq.load_quant_state(dg.weight_fq.cfg.init(dg.kernel.reshape(-1, 5)))
    tree = _set_act_qparams(interop.qat_variables(qat), zp=64)
    jtree = jax.tree.map(jnp.asarray, tree)
    return tree, jconvert(jtree, jqc)


def _serve_pair(jqc, qc, act_mode, tree, jserved, x, conv=True):
    jnet = JNet(jqc.for_serving(act_mode, "xla"), conv)
    want = jax.jit(lambda v, a: jnet.apply(v, a, training=False))(jserved, jnp.asarray(x))
    model = Net(qc.for_serving(act_mode), conv)
    interop.load_variables(model, tree)
    with torch.no_grad():
        got = model(torch.as_tensor(x).permute(0, 3, 1, 2))
    return got.numpy(), np.asarray(want), model


@pytest.mark.parametrize("act_mode", ["static_int8", "dynamic"])
def test_dense_layers_serve_int8_modes_match_jax(act_mode):
    jqc, qc = (j_default_qconfig(8, 8, per_channel_weights=True),
               default_qconfig(8, 8, per_channel_weights=True))
    tree, jserved = _layer_models(jqc, qc, False, 1)
    x = np.random.RandomState(2).randn(2, 6, 6, 4).astype(np.float32)
    got, want, _ = _serve_pair(jqc, qc, act_mode, tree, jserved, x, conv=False)
    _close(got, want, 1e-5)


def test_conv_layers_serve_static_int8_and_fallbacks_match_jax():
    """The integer conv for an int8 symmetric pack and a per-tensor
    activation; the float-simulated fallback for an int4 conv pack and for
    per-channel activation qparams (the dense layers int8 throughout)."""
    x = np.random.RandomState(3).randn(2, 6, 6, 4).astype(np.float32)
    base = (j_default_qconfig(8, 8, per_channel_weights=True),
            default_qconfig(8, 8, per_channel_weights=True))
    w4 = (j_default_qconfig(4, 8, per_channel_weights=True),
          default_qconfig(4, 8, per_channel_weights=True))
    pca = tuple(dataclasses.replace(q, activation=dataclasses.replace(
        q.activation, spec=q.activation.spec.replace(per_channel=True, axis=-1)))
        for q in base)
    import jaxlsq_torch.models.layers as layers

    calls = []

    def counted(*a, **k):
        calls.append(1)
        return static_int8_conv(*a, **k)

    for name, over in (("int", None), ("int4_conv", w4), ("per_channel_act", pca)):
        jqc, qc = base
        if over is not None:
            jqc = jqc.with_overrides({"conv": over[0]})
            qc = qc.with_overrides({"conv": over[1]})
        tree, jserved = _layer_models(jqc, qc, True, 4)
        calls.clear()
        with unittest.mock.patch.object(layers, "static_int8_conv", counted):
            got, want, _ = _serve_pair(jqc, qc, "static_int8", tree, jserved, x)
        assert len(calls) == (1 if over is None else 0), name
        _close(got, want, 1e-5)


def test_layer_refusals():
    jqc, qc = j_default_qconfig(4, 8), default_qconfig(4, 8)
    tree, _ = _layer_models(jqc, qc, False, 5)
    model = Net(qc.for_serving("static_int8"), conv=False)
    interop.load_variables(model, tree)
    with pytest.raises(ValueError, match="int8-packed"):
        model(torch.randn(2, 4, 6, 6))
    with pytest.raises(ValueError, match="dynamic"):
        QuantConv(4, 8, (3, 3), default_qconfig(8, 8).for_serving("dynamic"), device="cpu")
    pca = dataclasses.replace(qc.activation, spec=qc.activation.spec.replace(
        per_channel=True, axis=-1))
    qc8 = dataclasses.replace(default_qconfig(8, 8), activation=pca)
    dense = QuantDense(4, 3, qc8.for_serving("static_int8"), device="cpu")
    with pytest.raises(ValueError, match="per-tensor"):
        dense(torch.randn(2, 4))


def test_quant_cnn_static_int8_matches_jax():
    jqc = j_default_qconfig(8, 8, per_channel_weights=True, reduce_range=False)
    qc = default_qconfig(8, 8, per_channel_weights=True, reduce_range=False)
    qat = QuantCNN(4, qc, widths=(8, 16), image_size=16, device="cpu", seed=2)
    tree = _set_act_qparams(interop.qat_variables(qat), scale=0.03, zp=128)
    jserved = jconvert(jax.tree.map(jnp.asarray, tree), jqc)
    x = np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32)
    outs = {}
    for mode in ("static_int8", "static"):
        jm = JQuantCNN(num_classes=4, qconfig=jqc.for_serving(mode, "xla"), widths=(8, 16))
        model = QuantCNN(4, qc.for_serving(mode), widths=(8, 16), image_size=16, device="cpu")
        interop.load_variables(model, tree)
        with torch.no_grad():
            outs[mode] = model(torch.as_tensor(x).permute(0, 3, 1, 2)).numpy()
        want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, training=False))(
            jserved, jnp.asarray(x)))
        _close(outs[mode], want, 1e-5)
    np.testing.assert_allclose(outs["static_int8"], outs["static"], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("act_mode", ["static_int8", "dynamic"])
def test_lm_int8_modes_match_jax(act_mode):
    vocab, dim, depth, heads = 64, 32, 2, 4
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    jqc = j_default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    qat = QuantTransformerLM(vocab, dim, depth, heads, qc, max_len=16, device="cpu", seed=3)
    tree = _set_act_qparams(interop.qat_variables(qat), scale=0.05, zp=64)
    jm = JLM(vocab=vocab, dim=dim, depth=depth, num_heads=heads,
             qconfig=jqc.for_serving(act_mode, "xla"), max_len=16)
    jserved = jconvert(jax.tree.map(jnp.asarray, tree), jqc)
    tokens = np.random.RandomState(4).randint(0, vocab, (2, 12)).astype(np.int32)
    want = np.asarray(jax.jit(jm.apply)(jserved, jnp.asarray(tokens)))
    model = QuantTransformerLM(vocab, dim, depth, heads, qc.for_serving(act_mode), max_len=16,
                               device="cpu")
    interop.load_variables(model, np_tree(jserved))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
