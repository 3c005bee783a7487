"""``wo8`` and ``wo4`` on the tensor cores (``csrc/mma_bf16.cuh`` as instanced
in ``csrc/wo_matmul.cu``), emulated on the CPU (``tests/_wo_mma.py``):

* every lane's decoded A fragment, scattered back through the k-step and
  column permutations, equals ``w - z`` for ``wo8`` and for split-half
  ``wo4`` (odd K too), at the decode form's 8 and the tiled form's 2 m16
  tiles a warp; padding positions meet x = 0;
* the int8 decode is exact for all 256 bytes at every zero point of the
  int8 carrier, and the int4 decode for all 16 nibbles at every zero point
  from -128 to 128 (the 136 + z constant of the symmetric decode would not
  be a bf16 from z = 121 up);
* the order (three exact bf16 parts of x, exact products, 64-k slices, the
  even and the odd slices folded into two f32 lanes) against
  ``wo_matmul_plain`` and against the JAX package's ``wo_matmul(...,
  impl="pallas", interpret=True, precision=HIGHEST)`` (``_wo8_kernel``,
  ``_wo4_kernel``) within 1e-5 of max|ref| at M = 1, 5, 40, per channel and
  per tensor, with nonzero zero points; within the emulation a row's bits
  at every M.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.serve.matmul import wo_matmul as j_wo_matmul
from jaxlsq.serve.pack import quantize_weight as j_quantize

from _wo_mma import bf16_round, bytes_zp, emulate, emulate_a, factors, nibbles_zp, positions
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.serve.matmul import wo_matmul_plain
from jaxlsq_torch.serve.pack import quantize_weight, unpack_int4

MS = (1, 5, 40)
# name: (bits, K, N, per-channel, zero point magnitude); the JAX package's
# kernel is traced once for each
CASES = {"wo8_pc_zp": (8, 200, 24, True, 100),
         "wo8_pt_zp": (8, 131, 24, False, 60),
         "wo4_pc_zp_odd_k": (4, 131, 24, True, 60),
         "wo4_pt_zp": (4, 256, 24, False, 5)}


def _close(got, want, rel):
    want = np.asarray(want)
    tol = rel * float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol, (float(np.abs(got - want).max()), tol)


@pytest.mark.parametrize("wt", [8, 2])
@pytest.mark.parametrize("bits,k", [(8, 512), (8, 200), (4, 512), (4, 131), (4, 1023)])
def test_a_fragments_are_w_minus_z(bits, k, wt):
    """Every position the lanes decode holds w - z of its (k, column);
    positions past K (rows past the weight, odd K's dead high nibble) are
    padding that meets x = 0."""
    n = 40
    r = np.random.RandomState(k + wt + bits)
    rows = k if bits == 8 else (k + 1) // 2
    data = r.randint(0, 256, size=(rows, n)).astype(np.uint8)  # random bytes, dead nibbles too
    zp = r.randint(-128, 128, size=n)
    a = emulate_a(data, bits, zp, wt, k)
    kk, _ = positions(bits, k)
    assert not np.isnan(a).any()
    if bits == 8:
        q = data.view(np.int8).astype(np.int64)
    else:
        s8 = data.view(np.int8).astype(np.int64)
        q = np.concatenate([(s8 << 60) >> 60, s8 >> 4])[:k]
    live = kk >= 0
    want = (q[kk[live]] - zp[None, :]).astype(np.float32)
    np.testing.assert_array_equal(a[live], want)
    # every k appears exactly once
    assert np.array_equal(np.sort(kk[live]), np.arange(k))


def test_int8_decode_is_exact_for_every_byte_and_zero_point():
    b = np.arange(256, dtype=np.uint32)
    w0 = b[:, None] * np.ones((1, 256), np.uint32)  # byte 0 of the word
    z = np.arange(-128, 128)[None, :] * np.ones((256, 1), np.int64)
    lo, hi = bytes_zp(w0, w0 << np.uint32(8), 0, z)
    want = (b.astype(np.int8).astype(np.int64)[:, None] - z).astype(np.float32)
    np.testing.assert_array_equal(lo, want)
    np.testing.assert_array_equal(hi, np.float32(0) - z.astype(np.float32))  # byte 0 of w1 is 0
    np.testing.assert_array_equal(bf16_round(want), want)  # w - z is a bf16


def test_int4_decode_is_exact_for_every_nibble_and_zero_point():
    v = np.arange(16, dtype=np.uint32)  # the nibble's bits
    signed = np.where(v >= 8, v.astype(np.int64) - 16, v.astype(np.int64))
    z = np.arange(-128, 129)
    X = v[:, None] | (((v[:, None] + 5) % 16) << np.uint32(16)) | np.uint32(0xF0F0F0F0)
    X = X * np.ones((1, z.size), np.uint32)
    lo, hi = nibbles_zp(X, z[None, :])
    np.testing.assert_array_equal(lo, (signed[:, None] - z[None, :]).astype(np.float32))
    s_hi = np.where((v + 5) % 16 >= 8, (v + 5) % 16 - 16.0, (v + 5) % 16)
    np.testing.assert_array_equal(hi, (s_hi[:, None] - z[None, :]).astype(np.float32))
    # the symmetric decode's 136 + z is not a bf16 from z = 121 up
    zc = np.arange(-128, 129, dtype=np.float32) + 136
    assert (bf16_round(zc) != zc).any() and (bf16_round(zc[:121 + 128]) == zc[:121 + 128]).all()


@functools.lru_cache(maxsize=None)
def _case(name):
    """numpy inputs, the port's pack, the JAX package's Pallas result at the
    largest M and the emulation there."""
    bits, k, n, per_channel, zmax = CASES[name]
    r = np.random.RandomState(sorted(CASES).index(name) + 11)
    w = (r.randn(k, n) * 0.1).astype(np.float32)
    x = r.randn(max(MS), k).astype(np.float32)
    c = n if per_channel else 1
    qmin, qmax = (-128, 127) if bits == 8 else (-8, 7)
    kw = dict(quant_min=qmin, quant_max=qmax, type_min=-128, type_max=127,
              per_channel=per_channel, axis=1)
    absmax = np.abs(w).max(axis=0) if per_channel else np.abs(w).max(keepdims=True)
    scale = (absmax / (qmax // 2)).astype(np.float32).reshape(c)
    zp = r.randint(-zmax, zmax + 1, size=c)
    zp[0] = zmax
    shift = (-zp * scale).astype(np.float32)
    jp = j_quantize(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift), JSpec(**kw),
                    bits=bits)
    tp = quantize_weight(torch.as_tensor(w), torch.as_tensor(scale), torch.as_tensor(shift),
                         QuantSpec(**kw), bits=bits)
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.zero_point.numpy(), np.asarray(jp.zero_point))
    assert int(tp.zero_point.abs().max()) == zmax
    pallas = np.asarray(j_wo_matmul(jnp.asarray(x), jp, impl="pallas", interpret=True,
                                    precision=jax.lax.Precision.HIGHEST))
    xt = torch.as_tensor(x)
    return xt, tp, pallas, emulate(xt, tp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_factors_are_the_plain_dequant_values(name):
    """The emulation's factors are the plain dequant's integers, w - z."""
    _, p, _, _ = _case(name)
    k = p.orig_shape[0]
    kk, _ = positions(p.bits, k)
    a = factors(p)[torch.from_numpy(kk >= 0)]
    q = p.data if p.bits == 8 else unpack_int4(p.data, 0)[:k]
    want = (q.to(torch.int32) - p.zero_point.to(torch.int32)).to(torch.float32)
    assert torch.equal(a, want[torch.from_numpy(kk[kk >= 0])])


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_order_matches_plain_and_jax(name, m):
    x, p, pallas, full = _case(name)
    got = emulate(x[:m], p)
    assert torch.equal(got, full[:m])  # a row's bits at every M
    _close(got.numpy(), wo_matmul_plain(x[:m], p).numpy(), 1e-5)
    _close(got.numpy(), pallas[:m], 1e-5)
