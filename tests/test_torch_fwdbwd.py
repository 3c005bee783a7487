"""jaxlsq_torch's fused fake-quant forward + backward (``fake_quant_fwdbwd``)
and the 16-bit rule of every fake-quant entry point, against the JAX
package's Pallas path in interpret mode, on the same seeded numpy inputs.

* ``fake_quant_fwdbwd`` against ``pallas_fwdbwd`` and against the golden
  pair, at the JAX package's four fused cases
  (tests/test_pallas_kernels.py ``test_fused_fwdbwd_matches_golden``): out
  and dX bit-equal; dS/dB at that test's own ``rtol=1e-4, atol=1e-5``.
* float16 and bfloat16 inputs of the nine fake-quant entry points (the
  static forward and backward, their traced twins, per tensor and per
  channel, and the fused pair) against the Pallas kernels: out and dX
  bit-equal (both sides compute in f32 from the same 16-bit values and
  round the result once to the input's dtype), their dtypes the input's, dS
  and dB in the qparams' dtype within ``rtol=1e-4, atol=1e-5`` (f32 sums in
  another order).
* A 3-iteration headline chain (bench.py's fwd+bwd chain: out -> y, dX ->
  g, s and b stepped by 1e-6 of their gradients) at (64, 1024): the port's
  fused and split legs bit-equal to each other, and to the same chain
  through ``pallas_fwdbwd`` in y and g, with s and b within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaxlsq.core.golden import golden_backward as jgolden_backward
from jaxlsq.core.golden import golden_forward as jgolden_forward
from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.ops import pallas_kernels as pk
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.ops import (fake_quant, fake_quant_backward,
                              fake_quant_backward_traced, fake_quant_forward,
                              fake_quant_forward_traced, fake_quant_fwdbwd)

CASES = [
    ("pt_u8", dict(bits=8, signed=False), (64, 256)),
    ("pt_s8_odd", dict(bits=8, signed=True, symmetric=True), (33, 7, 5)),
    ("pc_s4", dict(bits=4, signed=True, symmetric=False, per_channel=True,
                   axis=1), (32, 24, 3)),
    ("pc_s6_ax0", dict(bits=6, signed=True, symmetric=True, per_channel=True,
                       axis=0), (17, 130)),
]


def _specs(kw):
    kw = dict(kw)
    bits = kw.pop("bits")
    return JSpec.make(bits, **kw), QuantSpec.make(bits, **kw)


def _inputs(jspec, shape, seed=7):
    r = np.random.RandomState(seed)
    x = (3 * r.randn(*shape)).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    c = shape[jspec.axis] if jspec.per_channel else 1
    s = (0.05 + 0.1 * r.rand(c)).astype(np.float32)
    b = (np.zeros(c, np.float32) if jspec.symmetric
         else (0.05 * r.randn(c)).astype(np.float32))
    return x, g, s, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return a


def _sums_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_fwdbwd_matches_pallas_fwdbwd_and_golden(case):
    _, kw, shape = case
    jspec, spec = _specs(kw)
    x, g, s, b = _inputs(jspec, shape)
    out, dx, ds, db = fake_quant_fwdbwd(_t(g), _t(x), _t(s), _t(b), spec=spec)
    jout, jdx, jds, jdb = pk.pallas_fwdbwd(jnp.asarray(g), jnp.asarray(x),
                                           jnp.asarray(s), jnp.asarray(b),
                                           spec=jspec, interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
    _sums_close(ds.numpy(), np.asarray(jds))
    _sums_close(db.numpy(), np.asarray(jdb))
    # the golden pair of the JAX package, and the port's own split pair
    wout = jgolden_forward(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jspec)
    wdx, wds, wdb = jgolden_backward(jnp.asarray(g), jnp.asarray(x),
                                     jnp.asarray(s), jnp.asarray(b), jspec)
    np.testing.assert_array_equal(out.numpy(), np.asarray(wout))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(wdx))
    _sums_close(ds.numpy(), np.asarray(wds))
    _sums_close(db.numpy(), np.asarray(wdb))
    sout = fake_quant_forward(_t(x), _t(s), _t(b), spec)
    sdx, sds, sdb = fake_quant_backward(_t(g), _t(x), _t(s), _t(b), spec)
    for a, w in ((out, sout), (dx, sdx), (ds, sds), (db, sdb)):
        assert torch.equal(a, w)


def test_fwdbwd_numel_overrides_the_grad_scale():
    jspec, spec = _specs(dict(bits=8, signed=False, per_channel=True, axis=1))
    x, g, s, b = _inputs(jspec, (16, 12))
    _, _, ds, db = fake_quant_fwdbwd(_t(g), _t(x), _t(s), _t(b), spec=spec,
                                     numel=4 * x.size)
    _, _, jds, jdb = pk.pallas_fwdbwd(jnp.asarray(g), jnp.asarray(x),
                                      jnp.asarray(s), jnp.asarray(b), spec=jspec,
                                      numel=4 * x.size, interpret=True)
    _sums_close(ds.numpy(), np.asarray(jds))
    _sums_close(db.numpy(), np.asarray(jdb))


KINDS = {
    "pt": (dict(bits=8, signed=False), (64, 128)),
    "pc": (dict(bits=8, signed=True, symmetric=True, per_channel=True, axis=0),
           (16, 8, 3, 3)),
}


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sixteen_bit_inputs_match_pallas(kind, dtype):
    kw, shape = KINDS[kind]
    jspec, spec = _specs(kw)
    x, g, s, b = _inputs(jspec, shape, seed=3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tg = _t(x).to(tdt), _t(g).to(tdt)
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    js, jb = jnp.asarray(s), jnp.asarray(b)
    flags = torch.zeros(2)

    def same(got, want, what):
        assert got.dtype == tdt, (what, got.dtype)
        np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=what)

    same(fake_quant_forward(tx, _t(s), _t(b), spec),
         pk.pallas_forward(jx, js, jb, spec=jspec, interpret=True), "forward")
    same(fake_quant_forward_traced(tx, _t(s), _t(b), flags, spec),
         pk.pallas_forward_traced(jx, js, jb, spec=jspec, eval_flag=0.0,
                                  init_flag=0.0, interpret=True), "forward_traced")
    for what, got, want in (
            ("backward", fake_quant_backward(tg, tx, _t(s), _t(b), spec),
             pk.pallas_backward(jg, jx, js, jb, spec=jspec, interpret=True)),
            ("backward_traced",
             fake_quant_backward_traced(tg, tx, _t(s), _t(b), flags, spec),
             pk.pallas_backward_traced(jg, jx, js, jb, spec=jspec, eval_flag=0.0,
                                       init_flag=0.0, interpret=True))):
        same(got[0], want[0], what)
        for a, w in zip(got[1:], want[1:]):
            assert a.dtype == torch.float32
            _sums_close(a.numpy(), np.asarray(w))
    out, dx, ds, db = fake_quant_fwdbwd(tg, tx, _t(s), _t(b), spec=spec)
    jout, jdx, jds, jdb = pk.pallas_fwdbwd(jg, jx, js, jb, spec=jspec, interpret=True)
    same(out, jout, "fwdbwd out")
    same(dx, jdx, "fwdbwd dX")
    _sums_close(ds.numpy(), np.asarray(jds))
    _sums_close(db.numpy(), np.asarray(jdb))
    # 16-bit qparams come back in their own dtype
    _, qds, qdb = fake_quant_backward(tg, tx, _t(s).to(tdt), _t(b).to(tdt), spec)
    assert qds.dtype == tdt and qdb.dtype == tdt


def test_headline_chain_matches_jax():
    """bench.py's fwd+bwd chain, 3 iterations at (64, 1024)."""
    jspec, spec = JSpec(quant_min=0, quant_max=255), QuantSpec(quant_min=0,
                                                               quant_max=255)
    r = np.random.RandomState(0)
    x = r.randn(64, 1024).astype(np.float32)
    g = r.randn(64, 1024).astype(np.float32)
    s0, b0 = np.array([0.1], np.float32), np.array([0.05], np.float32)

    def fused(y, gg, s, b):
        return fake_quant_fwdbwd(gg, y, s, b, spec=spec)

    def split(y, gg, s, b):
        y = y.detach().requires_grad_(True)
        s, b = s.detach().requires_grad_(True), b.detach().requires_grad_(True)
        out = fake_quant(y, s, b, spec)
        return (out.detach(), *torch.autograd.grad(out, (y, s, b), gg))

    legs = {}
    for name, fn in (("fused", fused), ("split", split)):
        y, gg, s, b = _t(x), _t(g), _t(s0), _t(b0)
        for _ in range(3):
            out, dx, ds, db = fn(y, gg, s, b)
            y, gg, s, b = out, dx, s - 1e-6 * ds, b - 1e-6 * db
        legs[name] = (y, gg, s, b)
    for a, w in zip(legs["fused"], legs["split"]):
        assert torch.equal(a, w)

    y, gg, s, b = (jnp.asarray(a) for a in (x, g, s0, b0))
    for _ in range(3):
        out, dx, ds, db = pk.pallas_fwdbwd(gg, y, s, b, spec=jspec, interpret=True)
        y, gg, s, b = out, dx, s - 1e-6 * ds, b - 1e-6 * db
    ty, tg, ts, tb = legs["fused"]
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(gg))
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(b), rtol=1e-6, atol=0)
