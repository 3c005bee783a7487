"""jaxlsq_torch ``wo_matmul`` (its plain version, which CPU tensors take)
against the JAX package's ``wo_matmul``: the XLA path at HIGHEST precision
and the Pallas kernel in interpret mode, on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-5: both sides accumulate in f32, in different
summation orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.serve.matmul import wo_matmul as j_wo_matmul
from jaxlsq.serve.pack import quantize_weight as j_quantize

from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.serve.matmul import LAUNCHES, wo_matmul
from jaxlsq_torch.serve.pack import quantize_weight

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(bits, per_channel, k, n, m, seed):
    r = np.random.RandomState(seed)
    w = (r.randn(k, n) * 0.1).astype(np.float32)
    x = r.randn(m, k).astype(np.float32)
    c = n if per_channel else 1
    jspec = JSpec.weight_default(bits, per_channel=per_channel, axis=1)
    tspec = QuantSpec.weight_default(bits, per_channel=per_channel, axis=1)
    absmax = np.abs(w).max(axis=0) if per_channel else np.abs(w).max(keepdims=True)
    scale = (absmax / jspec.quant_max).astype(np.float32).reshape(c)
    shift = np.zeros(c, np.float32)
    jp = j_quantize(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift), jspec,
                    bits=bits)
    tp = quantize_weight(torch.as_tensor(w), torch.as_tensor(scale),
                         torch.as_tensor(shift), tspec, bits=bits)
    return x, jp, tp


# (per_channel, K): per-channel qparams with even K, per-tensor with odd K
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel,k", [(True, 48), (False, 37)])
@pytest.mark.parametrize("m", [1, 5, 40])
def test_wo_matmul_matches_jax(bits, per_channel, k, m):
    n = 24
    x, jp, tp = _case(bits, per_channel, k, n, m, seed=m * 10 + bits)
    before = dict(LAUNCHES)
    got = wo_matmul(torch.as_tensor(x), tp).numpy()
    assert LAUNCHES == before  # CPU tensors take the plain version, no launch
    xla = np.asarray(j_wo_matmul(jnp.asarray(x), jp, impl="xla",
                                 precision=jax.lax.Precision.HIGHEST))
    pallas = np.asarray(j_wo_matmul(jnp.asarray(x), jp, impl="pallas",
                                    interpret=True,
                                    precision=jax.lax.Precision.HIGHEST))
    assert got.shape == (m, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, xla, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_wo_matmul_leading_dims_and_nonzero_zero_point():
    """(B, t, K) activations flatten and come back; an affine zero point
    (not produced by convert, but legal in a PackedWeight) is honoured."""
    r = np.random.RandomState(1)
    w = (r.randn(20, 8) * 0.1).astype(np.float32)
    x = r.randn(2, 3, 20).astype(np.float32)
    jspec = JSpec(quant_min=-64, quant_max=63, type_min=-128, type_max=127,
                  per_channel=True, axis=1)
    tspec = QuantSpec(quant_min=-64, quant_max=63, type_min=-128, type_max=127,
                      per_channel=True, axis=1)
    scale = np.full(8, 0.004, np.float32)
    shift = (r.randn(8) * 0.02).astype(np.float32)
    for bits in (8,):
        jp = j_quantize(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift),
                        jspec, bits=bits)
        tp = quantize_weight(torch.as_tensor(w), torch.as_tensor(scale),
                             torch.as_tensor(shift), tspec, bits=bits)
        assert np.any(tp.zero_point.numpy() != 0)
        got = wo_matmul(torch.as_tensor(x), tp).numpy()
        want = np.asarray(j_wo_matmul(jnp.asarray(x), jp, impl="xla",
                                      precision=jax.lax.Precision.HIGHEST))
        assert got.shape == (2, 3, 8)
        np.testing.assert_allclose(got, want, **TOL)


def test_wo_matmul_rejects_bad_shapes():
    _, _, tp = _case(8, True, 16, 8, 1, seed=0)
    with pytest.raises(ValueError, match="K="):
        wo_matmul(torch.zeros(2, 15), tp)
