"""The int4 weight-only matmuls' summation orders (``csrc/wo_matmul.cu``),
emulated in torch on the CPU.

``wo4g``: 32-byte-row slices of the split-half pack, each an fmaf chain from
+0 that takes a byte row's low nibble (k = r) and then its high nibble (k =
r + ceil(K/2)), the factors exact f32 values (the nibble decoded as the
kernel decodes it, times the group's scale), the slice partials folded in
slice order from +0.  ``wo4``: the tensor-core order of ``tests/_wo_mma.py``
(three exact bf16 parts of x, exact ``w - z`` factors decoded as bf16,
64-k slices, the even and the odd slices folded into two f32 lanes, times
the scale).

* the nibble decode bit for bit against ``float(w - z)`` (numpy, every
  nibble in both halves of a byte, every 4-bit zero point; ``wo4``'s bf16
  decode);
* the emulation against ``wo_matmul_plain`` and against the JAX package's
  ``wo_matmul(..., impl="pallas", interpret=True, precision=HIGHEST)`` at
  rtol = atol = 1e-5 (f32 sums in other orders): ``wo4`` per channel with a
  nonzero zero point and per tensor with odd K, ``wo4g`` at group sizes 128
  and 256, M = 1, 5, 40;
* within the emulation a row's bits at every M.

fmaf is emulated exactly: the f64 product is exact, and where rounding the
f64 sum to f32 would round a second time at a midpoint, TwoSum's error term
picks the side.
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
from jaxlsq.serve.pack import quantize_weight_grouped as j_qwg

import _wo_mma
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.serve.matmul import wo_matmul_plain
from jaxlsq_torch.serve.pack import (dequantize_weight, quantize_weight,
                                     quantize_weight_grouped, unpack_int4)

SLICE = 32
MS = (1, 5, 40)
TOL = dict(rtol=1e-5, atol=1e-5)
MANT = 8388616  # 2^23 + 8: a biased nibble's float, less the bias (wo4g)
# name: (K, N, group size or None, per-channel, zero points nonzero); the
# JAX package's kernel is traced once for each (K, N, group size)
CASES = {"wo4_pc_zp": (131, 24, None, True, True),
         "wo4_pt_odd_k": (131, 24, None, False, False),
         "wo4g_128": (512, 40, 128, True, False),
         "wo4g_256": (512, 40, 256, True, False)}


@pytest.mark.parametrize("z", range(-8, 8))
def test_nibble_decode_is_exact(z):
    """wo4's bf16 decode (the nibble ^ 8 in the mantissa of 16.0, less 24 +
    z) of each byte's low nibble (at bits 0-3) and high nibble (shifted
    down), for all 256 bytes."""
    b = np.arange(256, dtype=np.uint32)
    q = b.astype(np.uint8).view(np.int8).astype(np.int32)
    for shift, want in ((0, ((q << 28) >> 28)), (4, q >> 4)):
        got, _ = _wo_mma.nibbles_zp(b >> np.uint32(shift), z)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      (want - z).astype(np.float32).view(np.uint32))


def _fmaf(a, b, c):
    """fmaf(a, b, c) for f32 tensors, rounded once."""
    p = a.double() * b.double()  # exact
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)  # p + c = s + e exactly
    r = s.float()
    d = s - r.double()
    nxt = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf).float())
    mid = (d != 0) & (2 * d == nxt.double() - r.double()) & (e * d > 0)
    return torch.where(mid, nxt, r)


def _factors(p):
    """(lo, hi): the f32 factors of each byte row's low and high nibble,
    (ceil(K/2), N) each, as the kernel decodes them (wo4g: the f32 decode
    times the group's scale; wo4: the bf16 decode less the zero point); the
    odd-K pad nibble's factor 0."""
    k, n = p.orig_shape
    kr = (k + 1) // 2
    if not p.group_size:
        b = (p.data.to(torch.int32) & 0xFF).numpy().astype(np.uint32)
        z = np.broadcast_to(p.zero_point.to(torch.int32).numpy(), b.shape)
        lo, hi = [torch.from_numpy(_wo_mma.nibbles_zp(b >> np.uint32(sh), z)[0])
                  for sh in (0, 4)]
        if k % 2:
            hi[-1] = 0.0
        return lo, hi
    t = (p.data.to(torch.int32) & 0xFF) ^ 0x88
    zc = torch.tensor(MANT, dtype=torch.float32)
    lo, hi = [((nib | 0x4B000000).view(torch.float32) - zc)
              for nib in (t & 0xF, (t >> 4) & 0xF)]
    s = p.scale.to(torch.float32)
    lo = lo * s[torch.arange(kr) // p.group_size]
    hi = hi * s[(torch.arange(kr) + kr) // p.group_size]
    return lo, hi


def emulate(x, p):
    """The kernel's order on f32 x (M, K) and an int4 pack (wo4: the
    tensor-core order of ``tests/_wo_mma.py``)."""
    if not p.group_size:
        return _wo_mma.emulate(x, p)
    k, n = p.orig_shape
    kr = (k + 1) // 2
    rows = -(-kr // SLICE) * SLICE
    lo, hi = _factors(p)
    xl = torch.zeros(x.shape[0], rows)
    xh = torch.zeros(x.shape[0], rows)
    xl[:, :kr] = x[:, :kr]
    xh[:, :k - kr] = x[:, kr:]
    lo = torch.cat([lo, lo.new_zeros(rows - kr, n)])
    hi = torch.cat([hi, hi.new_zeros(rows - kr, n)])
    total = torch.zeros(x.shape[0], n)
    for s0 in range(0, rows, SLICE):
        acc = torch.zeros(x.shape[0], n)
        for r in range(s0, s0 + SLICE):
            acc = _fmaf(xl[:, r:r + 1], lo[r:r + 1], acc)
            acc = _fmaf(xh[:, r:r + 1], hi[r:r + 1], acc)
        total = total + acc
    return total


@functools.lru_cache(maxsize=None)
def _case(name):
    """numpy inputs, the port's pack, the JAX package's Pallas result at the
    largest M and the emulation there."""
    k, n, gs, per_channel, zp = CASES[name]
    r = np.random.RandomState(sorted(CASES).index(name))
    w = (r.randn(k, n) * 0.1).astype(np.float32)
    x = r.randn(max(MS), k).astype(np.float32)
    if gs:
        jp = j_qwg(jnp.asarray(w), group_size=gs)
        tp = quantize_weight_grouped(torch.as_tensor(w), group_size=gs)
    else:
        c = n if per_channel else 1
        kw = dict(quant_min=-8, quant_max=7, per_channel=per_channel, axis=1)
        absmax = np.abs(w).max(axis=0) if per_channel else np.abs(w).max(keepdims=True)
        scale = (absmax / (4 if zp else 7)).astype(np.float32).reshape(c)
        shift = ((r.rand(c) - 0.5) * 6 * scale if zp else np.zeros(c)).astype(np.float32)
        jp = j_quantize(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift),
                        JSpec(**kw), bits=4)
        tp = quantize_weight(torch.as_tensor(w), torch.as_tensor(scale),
                             torch.as_tensor(shift), QuantSpec(**kw), bits=4)
        assert bool((tp.zero_point != 0).any()) == zp
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    pallas = np.asarray(j_wo_matmul(jnp.asarray(x), jp, impl="pallas", interpret=True,
                                    precision=jax.lax.Precision.HIGHEST))
    xt = torch.as_tensor(x)
    return xt, tp, pallas, emulate(xt, tp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_factors_are_the_plain_dequant(name):
    """wo4: the factor is float(w - z) exactly; wo4g: w * s rounded once,
    the plain dequant's element bit for bit."""
    _, p, _, _ = _case(name)
    k = p.orig_shape[0]
    lo, hi = _factors(p)
    got = torch.cat([lo, hi])[:k]
    if p.group_size:
        want = dequantize_weight(p)
    else:
        want = (unpack_int4(p.data, 0)[:k].to(torch.int32)
                - p.zero_point.to(torch.int32)).to(torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_order_matches_plain_and_jax(name, m):
    x, p, pallas, full = _case(name)
    got = emulate(x[:m], p)
    assert torch.equal(got, full[:m])  # a row's bits at every M
    np.testing.assert_allclose(got.numpy(), wo_matmul_plain(x[:m], p).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), pallas[:m], **TOL)
