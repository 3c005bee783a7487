"""Group-wise int4 serving in jaxlsq_torch against the JAX package, on the
same numpy inputs:

* ``quantize_weight_grouped``: packed data and (G, N) scales bit-exact;
* the grouped ``dequantize_weight``: bit-exact;
* ``wo_matmul`` (its plain version, which CPU tensors take) within
  rtol = atol = 1e-5 of the JAX package's XLA path at HIGHEST precision
  (both f32, other summation orders), and within the JAX package's own
  rtol 1e-4 / atol 1e-3 of its Pallas kernel in interpret mode (that kernel
  scales a partial sum per K-block, another rounding order);
* ``convert(weight_group_size=)``: the converted tree bit-exact, with the
  JAX package's rule for which kernels group;
* the serve-mode LM with grouped weights: logits within atol = rtol = 1e-4
  (the LM tolerance of ``test_torch_serve_lm.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.models import QuantTransformerLM as JLM
from jaxlsq.models import default_qconfig as j_default_qconfig
from jaxlsq.serve import convert as j_convert
from jaxlsq.serve.matmul import wo_matmul as j_wo_matmul
from jaxlsq.serve.pack import dequantize_weight as j_dequant
from jaxlsq.serve.pack import quantize_weight_grouped as j_qwg

from jaxlsq_torch import interop
from jaxlsq_torch.models import QuantTransformerLM, default_qconfig, init_variables
from jaxlsq_torch.serve import convert
from jaxlsq_torch.serve.matmul import LAUNCHES, wo_matmul
from jaxlsq_torch.serve.pack import dequantize_weight, quantize_weight_grouped

from _torch_port import np_tree, torch_tree_to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _w(k, n, seed, hetero=True):
    r = np.random.RandomState(seed)
    w = r.randn(k, n).astype(np.float32)
    if hetero:  # outlier K-rows: the regime group-wise scales are for
        w[r.choice(k, 3, replace=False)] *= 50.0
    else:
        w *= 0.1
    return w


@pytest.mark.parametrize("bits,k,n,gs", [(4, 256, 32, 64), (4, 96, 10, 32),
                                         (4, 64, 8, 64), (8, 128, 12, 16)])
def test_quantize_weight_grouped_bit_exact(bits, k, n, gs):
    w = _w(k, n, seed=k + gs)
    jp = j_qwg(jnp.asarray(w), group_size=gs, bits=bits)
    tp = quantize_weight_grouped(torch.as_tensor(w), group_size=gs, bits=bits)
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    np.testing.assert_array_equal(tp.zero_point.numpy(), np.asarray(jp.zero_point))
    assert (tp.bits, tp.axis, tp.k_axis, tp.orig_shape, tp.group_size) == (
        jp.bits, jp.axis, jp.k_axis, tuple(jp.orig_shape), jp.group_size)
    np.testing.assert_array_equal(dequantize_weight(tp).numpy(),
                                  np.asarray(j_dequant(jp)))


def test_quantize_weight_grouped_validation():
    w = torch.as_tensor(_w(256, 32, seed=1))
    with pytest.raises(ValueError, match="divide"):
        quantize_weight_grouped(w, group_size=100)
    with pytest.raises(ValueError, match="2-D"):
        quantize_weight_grouped(torch.ones(2, 3, 4), group_size=2)
    with pytest.raises(ValueError, match="bits"):
        quantize_weight_grouped(w, group_size=64, bits=3)


@pytest.mark.parametrize("k,n,m,gs", [(512, 64, 8, 128), (768, 48, 5, 128),
                                      (256, 32, 1, 32)])
def test_grouped_wo_matmul_matches_jax(k, n, m, gs):
    w = _w(k, n, seed=m, hetero=False)  # outputs O(1), as the LM's
    x = np.random.RandomState(k).randn(m, k).astype(np.float32)
    jp = j_qwg(jnp.asarray(w), group_size=gs)
    tp = quantize_weight_grouped(torch.as_tensor(w), group_size=gs)
    before = dict(LAUNCHES)
    got = wo_matmul(torch.as_tensor(x), tp).numpy()
    assert LAUNCHES == before  # CPU tensors take the plain version
    xla = np.asarray(j_wo_matmul(jnp.asarray(x), jp, impl="xla",
                                 precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(got, xla, **TOL)
    if gs % 128 == 0 and (k // 2) % gs == 0:  # the Pallas kernel's own limits
        pallas = np.asarray(j_wo_matmul(jnp.asarray(x), jp, impl="pallas",
                                        interpret=True,
                                        precision=jax.lax.Precision.HIGHEST))
        np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def lm():
    """The JAX package's LM and a QAT variables tree of its structure, drawn
    by the port's ``init_variables`` (flax's distributions; skipping flax's
    ``init`` keeps the file fast) and handed to both sides as numpy."""
    jqc = j_default_qconfig(4, 8, init_batches=1)
    jm = JLM(vocab=64, dim=32, depth=2, num_heads=4, qconfig=jqc, max_len=16)
    tm = QuantTransformerLM(64, 32, 2, 4, default_qconfig(4, 8).for_serving("none"),
                            max_len=16, device="cpu")
    variables = torch_tree_to_np(init_variables(tm, seed=3))
    tokens = np.random.RandomState(3).randint(0, 64, (2, 10)).astype(np.int32)
    return jm, jqc, variables, tokens


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("gs", [16, 48])
def test_convert_grouped_tree_bit_exact(lm, gs):
    """K = 32 (dim) divides by 16 but not by 48: the JAX package's rule
    groups qkv/proj/mlp_up/lm_head at 16 and leaves them per-channel at 48;
    mlp_down (K = 128) groups at 16 only."""
    _, jqc, variables, _ = lm
    jconv = np_tree(j_convert(_jnp(variables), jqc, weight_group_size=gs))
    tree = {k: _to_torch(v) for k, v in variables.items()}
    tconv = torch_tree_to_np(convert(tree, default_qconfig(4, 8),
                                     weight_group_size=gs))
    _same(jconv, tconv)
    grouped = [p for p in ("qkv", "proj", "mlp_up", "mlp_down")
               if tconv["quantized"]["block0"][p]["kernel"]["group_size"]]
    assert grouped == ([] if gs == 48 else ["qkv", "proj", "mlp_up", "mlp_down"])
    assert bool(tconv["quantized"]["lm_head"]["kernel"]["group_size"]) == (gs == 16)
    assert tconv["quantized"]["tok_emb"]["embedding"]["group_size"] is None


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=path)
        assert np.asarray(b).dtype == a.dtype, path
    elif isinstance(a, (tuple, list)):
        assert tuple(a) == tuple(b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("act_mode", ["none", "static"])
def test_grouped_lm_logits_match_jax(lm, act_mode):
    jm, jqc, variables, tokens = lm
    sv = j_convert(_jnp(variables), jqc, weight_group_size=16)
    jsm = dataclasses.replace(jm, qconfig=jqc.for_serving(act_mode, "xla"))
    want = np.asarray(jsm.apply(sv, jnp.asarray(tokens)))
    tqc = default_qconfig(4, 8).for_serving(act_mode)
    from_qat = QuantTransformerLM(64, 32, 2, 4, tqc, max_len=16, device="cpu")
    interop.load_variables(from_qat, convert(_to_torch(variables), tqc,
                                             weight_group_size=16))
    from_conv = QuantTransformerLM(64, 32, 2, 4, tqc, max_len=16, device="cpu")
    interop.load_variables(from_conv, np_tree(sv))
    assert from_qat.block0.mlp_down.kernel.packed().group_size == 16
    assert tuple(from_qat.block0.mlp_down.kernel.scale.shape) == (128 // 16, 32)
    with torch.no_grad():
        for tm in (from_qat, from_conv):
            got = tm(torch.as_tensor(tokens)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for (name, a), (_, b) in zip(from_qat.state_dict().items(),
                                 from_conv.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_grouped_load_rejects_bad_packs():
    tm = QuantTransformerLM(64, 32, 1, 4, default_qconfig(4, 8).for_serving("none"),
                            max_len=16, device="cpu")
    w = torch.as_tensor(_w(32, 96, seed=2))
    tm.block0.qkv.kernel.load(quantize_weight_grouped(w, group_size=8))
    assert tm.block0.qkv.kernel.group_size == 8
    with pytest.raises(ValueError, match="layout"):  # int8 pack into an int4 layer
        tm.block0.qkv.kernel.load(quantize_weight_grouped(w, group_size=8, bits=8))
    with pytest.raises(ValueError, match="tile"):  # 12 does not divide K = 32
        tm.block0.qkv.kernel.load(dataclasses.replace(
            quantize_weight_grouped(torch.as_tensor(_w(36, 96, seed=3)), group_size=12),
            orig_shape=(32, 96)))
    tm.block0.qkv.kernel.load(quantize_weight_grouped(w, group_size=32))
    assert tuple(tm.block0.qkv.kernel.scale.shape) == (1, 96)
