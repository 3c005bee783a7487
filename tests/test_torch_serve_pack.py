"""jaxlsq_torch spec / pack / convert against the JAX package, bit for bit:
the same numpy inputs go through both, and every QuantSpec field, packed
byte, scale, zero point, dequantized value and converted tree must agree
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.golden import golden_forward as j_golden_forward
from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as j_default_qconfig
from jaxlsq.serve import convert as j_convert
from jaxlsq.serve.pack import dequantize_weight as j_dequantize
from jaxlsq.serve.pack import quantize_weight as j_quantize
from jaxlsq.serve.pack import unpack_int4 as j_unpack_int4

from jaxlsq_torch.core.golden import golden_forward
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.models import default_qconfig
from jaxlsq_torch.serve import convert, dequantize_weight, quantize_weight
from jaxlsq_torch.serve.pack import pack_int4, unpack_int4

from _torch_port import np_tree, torch_tree_to_np


def _spec_fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("reduce_range", [True, False])
def test_default_qconfig_specs_match(wbits, per_channel, reduce_range):
    jq = j_default_qconfig(wbits, 8, per_channel_weights=per_channel,
                           reduce_range=reduce_range)
    tq = default_qconfig(wbits, 8, per_channel_weights=per_channel,
                         reduce_range=reduce_range)
    assert _spec_fields(tq.weight.spec) == _spec_fields(jq.weight.spec)
    assert _spec_fields(tq.activation.spec) == _spec_fields(jq.activation.spec)
    for axis in (0, 1):
        assert (_spec_fields(tq.weight_for_axis(axis).spec)
                == _spec_fields(jq.weight_for_axis(axis).spec))
    assert tq.weight.effective_init_shift == jq.weight.effective_init_shift
    assert tq.activation.effective_init_shift == jq.activation.effective_init_shift


def test_spec_constructors_and_validation_match():
    for kw in ({"bits": 8, "signed": True, "narrow_to_bits": 7},
               {"bits": 4, "signed": True, "symmetric": True},
               {"bits": 8, "signed": False}):
        assert _spec_fields(QuantSpec.make(**kw)) == _spec_fields(JSpec.make(**kw))
    assert QuantSpec.make(8).bitness == JSpec.make(8).bitness
    with pytest.raises(ValueError):
        QuantSpec(quant_min=0, quant_max=0)
    with pytest.raises(ValueError):
        QuantSpec(quant_min=1, quant_max=5, symmetric=True)


def _weight_case(k, n, seed):
    r = np.random.RandomState(seed)
    w = (r.randn(k, n) * 0.1).astype(np.float32)
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("k", [16, 15])
def test_quantize_weight_bit_exact(bits, per_channel, k):
    n = 12
    w = _weight_case(k, n, seed=k + bits)
    r = np.random.RandomState(3)
    c = n if per_channel else 1
    scale = (np.abs(r.randn(c)) * 0.02 + 0.005).astype(np.float32)
    scale[0] = -scale[0]  # a drifted-negative learned scale freezes to |s|
    shift = (r.randn(c) * 0.01).astype(np.float32)
    jspec = JSpec.weight_default(bits, per_channel=per_channel, axis=1)
    tspec = QuantSpec.weight_default(bits, per_channel=per_channel, axis=1)
    jp = j_quantize(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift), jspec,
                    bits=bits)
    tp = quantize_weight(torch.as_tensor(w), torch.as_tensor(scale),
                         torch.as_tensor(shift), tspec, bits=bits)
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    np.testing.assert_array_equal(tp.zero_point.numpy(), np.asarray(jp.zero_point))
    assert (tp.bits, tp.axis, tp.k_axis, tp.orig_shape) == (
        jp.bits, jp.axis, jp.k_axis, tuple(jp.orig_shape))
    np.testing.assert_array_equal(dequantize_weight(tp).numpy(),
                                  np.asarray(j_dequantize(jp)))
    # dequant(pack(w)) == fake_quant(w), in the port and in the JAX package
    fq = golden_forward(torch.as_tensor(w), torch.as_tensor(scale),
                        torch.as_tensor(shift), tspec)
    np.testing.assert_array_equal(dequantize_weight(tp).numpy(), fq.numpy())
    np.testing.assert_array_equal(
        fq.numpy(), np.asarray(j_golden_forward(jnp.asarray(w), jnp.asarray(scale),
                                                jnp.asarray(shift), jspec)))


@pytest.mark.parametrize("k", [8, 7])
def test_int4_split_half_layout(k):
    """Byte row r holds k=r (low nibble) and k=r+K/2 (high nibble); odd K
    zero-pads; unpack inverts and matches the JAX package."""
    r = np.random.RandomState(k)
    q = r.randint(-8, 8, size=(k, 5)).astype(np.int8)
    p = pack_int4(torch.as_tensor(q), 0)
    half = (k + 1) // 2
    assert tuple(p.shape) == (half, 5)
    pn = p.numpy().astype(np.int32)
    lo = ((pn & 0xF) ^ 8) - 8
    hi = pn >> 4
    np.testing.assert_array_equal(lo, q[:half])
    np.testing.assert_array_equal(hi[: k - half], q[half:])
    up = unpack_int4(p, 0)
    np.testing.assert_array_equal(up.numpy()[:k], q)
    np.testing.assert_array_equal(up.numpy(), np.asarray(j_unpack_int4(
        jnp.asarray(p.numpy()), 0)))


@pytest.mark.parametrize("wbits,per_channel", [(8, False), (8, True), (4, True)])
def test_convert_tree_bit_exact(wbits, per_channel):
    """The whole converted tree of a small LM: same keys, same packed bytes,
    qparams, frozen activation qparams and pass-through params."""
    jqc = j_default_qconfig(wbits, 8, per_channel_weights=per_channel)
    model = JLM(vocab=32, dim=16, depth=2, num_heads=2, qconfig=jqc, max_len=8)
    variables = model.init(jax.random.key(wbits), jnp.zeros((1, 4), jnp.int32))
    jconv = np_tree(j_convert(variables, jqc))
    tree = np_tree(variables)
    tq = default_qconfig(wbits, 8, per_channel_weights=per_channel)
    ttree = {k: _to_torch(v) for k, v in tree.items() if k != "quant_state"}
    tconv = torch_tree_to_np(convert(ttree, tq))

    def same(a, b, path=""):
        if isinstance(a, dict):
            assert isinstance(b, dict) and set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=path)
            assert np.asarray(b).dtype == a.dtype, path
        elif isinstance(a, (tuple, list)):
            assert tuple(a) == tuple(b), path
        else:
            assert a == b, path

    # per-tensor packs carry their spec's placeholder axis in both packages
    same(jconv, tconv)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def test_convert_rejects_group_size():
    with pytest.raises(ValueError, match="weight_group_size"):
        convert({"params": {}, "qparams": {}}, default_qconfig(4, 8),
                weight_group_size=0)
