"""NaN and ±inf through the fake-quant plain versions (``core/golden.py``,
which the port runs for CPU tensors and holds its CUDA kernels to) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs: x holding NaN, +inf and -inf elements, a NaN scale and a NaN shift,
per tensor and per channel on both layouts (an OIHW weight on axis 0, a
(K, N) one on axis 1).

Every forward, static backward (train, eval, init), traced twin (the four
flag pairs) and fused forward + backward.  out and dX are bit-equal, NaN in
the same places; dS/dB are held to the bound the JAX package holds its
kernels to its own golden (rtol 2e-5, atol 1e-6, tests/test_pallas_kernels.py),
NaN and inf in the same places.  ``torch.clamp`` and ``jnp.clip`` both pass
a NaN through, so a NaN x gives a NaN out, no dX, and takes the qmax branch
of dS (``xq <= qmin`` is false).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.ops import pallas_kernels as pk
from jaxlsq_torch.core.golden import (golden_backward, golden_backward_traced,
                                      golden_forward, golden_forward_traced)
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.ops.fake_quant import fake_quant_fwdbwd

SPECS = {
    "act": (dict(quant_min=0, quant_max=127, type_min=0, type_max=255), (33, 7, 5)),
    "sym": (dict(quant_min=-127, quant_max=127, symmetric=True), (4, 65)),
    "w_oihw": (dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True,
                    axis=0), (6, 8, 3, 3)),
    "aff_oihw": (dict(quant_min=0, quant_max=255, per_channel=True, axis=0), (6, 5, 1, 1)),
    "w_kn": (dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True,
                  axis=1), (33, 6)),
    "aff_kn": (dict(quant_min=0, quant_max=127, per_channel=True, axis=1), (17, 12)),
}
# which qparam is NaN: per channel one channel each; per tensor the one qparam
QPARAMS = ("finite", "nan_scale", "nan_shift")
CASES = [(name, qp) for name in SPECS for qp in QPARAMS]
FLAG_PAIRS = ((0, 0), (1, 0), (0, 1), (1, 1))
MODES = ((False, False), (True, False), (False, True))  # (eval, init)
SPECIAL = (np.nan, np.inf, -np.inf)


@functools.lru_cache(maxsize=None)
def _inputs(name, qp):
    kw, shape = SPECS[name]
    r = np.random.RandomState(len(name) + 7 * len(qp))
    x = (r.randn(*shape) * 1.5).astype(np.float32)
    c = shape[kw["axis"]] if kw.get("per_channel") else 1
    scale = (0.01 + 0.04 * r.rand(c)).astype(np.float32)
    shift = (np.zeros(c) if kw.get("symmetric") else 0.2 * r.randn(c)).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    flat = x.reshape(-1)
    # specials spread over the tensor (every channel of a small view gets some),
    # and round-half points x / s = k + 0.5 of the first qparam
    picks = r.choice(flat.size, size=3 * max(2, flat.size // 40), replace=False)
    for k, i in enumerate(picks):
        flat[i] = SPECIAL[k % 3]
    half = r.choice(np.setdiff1d(np.arange(flat.size), picks), size=8, replace=False)
    flat[half] = (np.arange(8) - 3.5) * scale[0]
    if qp != "finite":
        (scale if qp == "nan_scale" else shift)[min(1, c - 1)] = np.nan
    return kw, x, scale, shift, g


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _pallas_static(name):
    """jaxlsq's interpreted forward, backward (train, eval, init) and fused
    kernels, one program a spec."""
    jspec = JSpec(**SPECS[name][0])
    return jax.jit(lambda g, x, s, b: (
        pk.pallas_forward(x, s, b, spec=jspec, interpret=True),
        [pk.pallas_backward(g, x, s, b, spec=jspec, eval_mode=ev, init_mode=ini,
                            interpret=True) for ev, ini in MODES],
        pk.pallas_fwdbwd(g, x, s, b, spec=jspec, interpret=True)))


@pytest.mark.parametrize("name,qp", CASES)
def test_static_plain_matches_pallas_on_nan_and_inf(name, qp):
    kw, x, scale, shift, g = _inputs(name, qp)
    spec = QuantSpec(**kw)
    tx, ts, tb, tg = _t(x, scale, shift, g)
    assert np.isnan(x).any() and np.isinf(x).any()
    pout, pbwd, pfused = _pallas_static(name)(g, x, scale, shift)
    out = golden_forward(tx, ts, tb, spec)
    _equal(out.numpy(), pout)
    assert torch.isnan(out[torch.from_numpy(np.isnan(x))]).all()
    for (eval_mode, init_mode), (pdx, pds, pdb) in zip(MODES, pbwd):
        dx, ds, db = golden_backward(tg, tx, ts, tb, spec, eval_mode=eval_mode,
                                     init_mode=init_mode)
        _equal(dx.numpy(), pdx)
        _close(ds.numpy(), pds)
        _close(db.numpy(), pdb)
    out, dx, ds, db = fake_quant_fwdbwd(tg, tx, ts, tb, spec=spec)
    pout, pdx, pds, pdb = pfused
    _equal(out.numpy(), pout)
    _equal(dx.numpy(), pdx)
    _close(ds.numpy(), pds)
    _close(db.numpy(), pdb)


@functools.lru_cache(maxsize=None)
def _pallas_traced(name):
    jspec = JSpec(**SPECS[name][0])
    return jax.jit(lambda g, x, s, b, ev, ini: (
        pk.pallas_forward_traced(x, s, b, spec=jspec, eval_flag=ev, init_flag=ini,
                                 interpret=True),
        *pk.pallas_backward_traced(g, x, s, b, spec=jspec, eval_flag=ev,
                                   init_flag=ini, interpret=True)))


@pytest.mark.parametrize("name,qp", CASES)
def test_traced_plain_matches_pallas_on_nan_and_inf(name, qp):
    kw, x, scale, shift, g = _inputs(name, qp)
    spec = QuantSpec(**kw)
    tx, ts, tb, tg = _t(x, scale, shift, g)
    fn = _pallas_traced(name)
    for ev, init in FLAG_PAIRS:
        fe, fi = torch.tensor(float(ev)), torch.tensor(float(init))
        out = golden_forward_traced(tx, ts, tb, spec, fe, fi)
        dx, ds, db = golden_backward_traced(tg, tx, ts, tb, spec, fe, fi)
        pout, pdx, pds, pdb = fn(g, x, scale, shift, jnp.float32(ev), jnp.float32(init))
        _equal(out.numpy(), pout)
        _equal(dx.numpy(), pdx)
        _close(ds.numpy(), pds)
        _close(db.numpy(), pdb)


@pytest.mark.parametrize("name", ["w_oihw", "w_kn", "act"])
def test_nan_x_takes_the_qmax_branch_and_no_dx(name):
    """One NaN x among finite values: out is NaN there and only there, dX
    is 0 there, and its dS term is the qmax branch's g (qmax - zp): dS has
    the bits it has with +inf in its place (clamped to qmax), not those
    with -inf (qmin); in init mode its channel's dS is NaN."""
    kw, shape = SPECS[name]
    spec = QuantSpec(**kw)
    r = np.random.RandomState(3)
    x = (r.randn(*shape) * 0.05).astype(np.float32)
    g = np.abs(r.randn(*shape)).astype(np.float32) + 0.5
    c = shape[kw["axis"]] if kw.get("per_channel") else 1
    scale = np.full(c, 0.01, np.float32)
    shift = np.zeros(c, np.float32)
    idx = (0,) * len(shape)  # channel 0's first element
    x_nan = x.copy()
    x_nan[idx] = np.nan
    tx, tn, ts, tb, tg = _t(x, x_nan, scale, shift, g)
    out = golden_forward(tn, ts, tb, spec)
    assert torch.isnan(out[idx]) and int(torch.isnan(out).sum()) == 1
    dx, ds, _ = golden_backward(tg, tn, ts, tb, spec)
    assert dx[idx] == 0 and not torch.isnan(ds).any()
    ends = []
    for end in (np.inf, -np.inf):
        x_end = x.copy()
        x_end[idx] = end
        ends.append(golden_backward(tg, torch.from_numpy(x_end), ts, tb, spec)[1])
    assert torch.equal(ds, ends[0]) and not torch.equal(ds, ends[1])
    _, ds_init, _ = golden_backward(tg, tn, ts, tb, spec, init_mode=True)
    assert torch.isnan(ds_init.reshape(-1)[0])
    pds = pk.pallas_backward(g, x_nan, scale, shift, spec=JSpec(**kw), interpret=True)[1]
    _close(ds.numpy(), pds)
