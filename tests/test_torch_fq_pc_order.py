"""The per-channel fake-quant backward's summation order (``fq_bwd_pc``,
``fq_bwd_pc_traced``, ``fq_fwdbwd_pc`` in ``csrc/fake_quant.cu``), emulated
on the CPU by ``tests/_fq_pc_order.py`` (every step one rounded f32 torch
operation), for both mappings of ``pc_plan``: runs (an OIHW weight on axis
0, an NCHW tensor on axis 1; one to eight warps a channel, a cluster of
blocks) and rows (a (K, N) kernel on axis 1, over one to eight blocks).

* the emulated dS/dB against ``golden_backward`` within 1e-5 of the sum of
  |terms| (sums in other orders), and against the JAX package's
  ``_pc_bwd_kernel`` / ``_pc_bwd_traced_kernel`` run in Pallas interpret
  mode (``pallas_backward`` / ``pallas_backward_traced``) within the bound
  the JAX package holds that kernel to its own golden (rtol 2e-5, atol 1e-6,
  tests/test_pallas_kernels.py): its terms differ from golden's in the last
  bits, by up to 2.5e-5 of the term sums on a 3-element channel;
* the static, traced (train and init flags) and fused variants bit for bit
  against each other: one order, the scale applied after the sum;
* the plan from the shape alone.

Each JAX program is jitted once in the module (the traced flags are
arguments, so one program serves all four flag pairs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.ops import pallas_kernels as pk

import _fq_pc_order as em
from jaxlsq_torch.core.golden import (effective_grad_scale, golden_backward,
                                      golden_backward_traced)
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.ops.fake_quant import pc_plan

SPECS = {
    "w_oihw": dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True,
                   axis=0),
    "w_kn": dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True,
                 axis=1),
    "aff_oihw": dict(quant_min=0, quant_max=255, per_channel=True, axis=0),
    "aff_kn": dict(quant_min=0, quant_max=127, per_channel=True, axis=1),
    "aff_nchw": dict(quant_min=0, quant_max=255, per_channel=True, axis=1),
}
# name: (spec, shape, the plan (warps, cluster) it takes)
CASES = {
    "runs_8_warps": ("w_oihw", (64, 256, 3, 3), (8, 1)),
    "runs_cluster": ("aff_oihw", (16, 1024, 3, 3), (8, 2)),
    "runs_4_warps": ("w_oihw", (64, 64, 3, 3), (4, 1)),
    "runs_2_warps": ("aff_oihw", (64, 32, 3, 3), (2, 1)),
    "runs_stem": ("w_oihw", (64, 3, 3, 3), (1, 1)),
    "runs_tiny": ("aff_oihw", (5, 3, 1, 1), (1, 1)),
    "runs_nchw": ("aff_nchw", (8, 16, 5, 5), (1, 1)),
    "rows_head": ("w_kn", (512, 10), (8, 8)),
    "rows_odd": ("aff_kn", (33, 300), (8, 1)),
    "rows_cluster_2": ("aff_kn", (128, 8192), (8, 2)),
    "rows_cluster_8": ("w_kn", (256, 512), (8, 8)),
}
FLAG_PAIRS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _inputs(name):
    spec_name, shape, _ = CASES[name]
    kw = SPECS[spec_name]
    r = np.random.RandomState(sum(shape))
    x = (r.randn(*shape) * 1.5).astype(np.float32)
    c = shape[kw["axis"]]
    scale = (0.01 + 0.04 * r.rand(c)).astype(np.float32)
    shift = (np.zeros(c) if kw.get("symmetric") else 0.2 * r.randn(c)).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    return kw, x, scale, shift, g


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@functools.lru_cache(maxsize=None)
def _pallas(name, init_mode):
    """jaxlsq's interpreted ``_pc_bwd_kernel`` dS/dB, one program a case and mode."""
    kw, x, scale, shift, g = _inputs(name)
    fn = jax.jit(lambda *a: pk.pallas_backward(*a, spec=JSpec(**kw), init_mode=init_mode,
                                               interpret=True)[1:])
    return [np.asarray(v) for v in fn(g, x, scale, shift)]


@functools.lru_cache(maxsize=None)
def _pallas_traced_fn(name):
    kw = SPECS[CASES[name][0]]
    return jax.jit(lambda g, x, s, b, ev, ini: pk.pallas_backward_traced(
        g, x, s, b, spec=JSpec(**kw), eval_flag=ev, init_flag=ini, interpret=True)[1:])


def _term_sums(kw, x, scale, shift, g, init_mode):
    """Per channel, |gs| times the sum of |term| of dS and of dB, in f64."""
    spec = QuantSpec(**kw)
    ds, db = em.terms(*_t(g, x, scale, shift), spec, init_mode)
    red = (0, 2)
    gs = abs(effective_grad_scale(spec, x.size, scale.size))
    return (ds.double().abs().sum(red).numpy() * gs, db.double().abs().sum(red).numpy() * gs)


def _close(got, want, tot):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= 1e-5 * tot), (err.max(), tot.max())


def _close_pallas(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_plan_takes_both_mappings(name):
    """The plan is a function of the shape alone; the cases cover runs at
    1, 2, 4 and 8 warps a channel and over a cluster, rows over 1, 2 and 8
    blocks."""
    spec_name, shape, want = CASES[name]
    outer, c, inner = em.view3(shape, SPECS[spec_name]["axis"])
    assert pc_plan(outer, c, inner) == want
    assert (inner == 1) == name.startswith("rows")


@pytest.mark.parametrize("init_mode", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_order_matches_golden_and_pallas(name, init_mode):
    kw, x, scale, shift, g = _inputs(name)
    spec = QuantSpec(**kw)
    ds, db = em.backward_sums(*_t(g, x, scale, shift), spec, init_mode)
    _, rds, rdb = golden_backward(*_t(g, x, scale, shift), spec, init_mode=init_mode)
    pds, pdb = _pallas(name, init_mode)
    tot = _term_sums(kw, x, scale, shift, g, init_mode)
    for got, golden, pallas, t in ((ds, rds, pds, tot[0]), (db, rdb, pdb, tot[1])):
        _close(got.numpy(), golden.numpy(), t)
        _close_pallas(got.numpy(), pallas)
    if kw.get("symmetric"):
        assert not db.any()


@pytest.mark.parametrize("name", list(CASES))
def test_traced_matches_pallas_traced_and_static_bits(name):
    """The traced order at the four flag pairs against
    ``golden_backward_traced`` and the interpreted ``_pc_bwd_traced_kernel``;
    in train and init mode (ev = 0) the static kernels' bits, which the
    fused kernel shares; eval mode zeros."""
    kw, x, scale, shift, g = _inputs(name)
    spec = QuantSpec(**kw)
    fn = _pallas_traced_fn(name)
    for ev, ini in FLAG_PAIRS:
        ds, db = em.backward_sums(*_t(g, x, scale, shift), spec, bool(ini), ev=ev)
        pds, pdb = (np.asarray(v) for v in fn(g, x, scale, shift, jnp.float32(ev),
                                             jnp.float32(ini)))
        _, rds, rdb = golden_backward_traced(*_t(g, x, scale, shift), spec,
                                             torch.tensor(float(ev)),
                                             torch.tensor(float(ini)))
        tot = _term_sums(kw, x, scale, shift, g, bool(ini))
        _close(ds.numpy(), rds.numpy(), tot[0])
        _close(db.numpy(), rdb.numpy(), tot[1])
        _close_pallas(ds.numpy(), pds)
        _close_pallas(db.numpy(), pdb)
        if ev:
            assert not ds.any() and not db.any()
            continue
        sds, sdb = em.backward_sums(*_t(g, x, scale, shift), spec, bool(ini))
        assert torch.equal(ds, sds) and torch.equal(db, sdb)


@pytest.mark.parametrize("name", ["runs_8_warps", "rows_cluster_8"])
def test_order_is_its_own_and_fixed(name):
    """The emulated order is not ``torch.sum``'s (so the card tests that
    hold the kernel to it bit for bit have teeth) and gives the same bits on
    every call; ``numel`` scales after the sum."""
    kw, x, scale, shift, g = _inputs(name)
    spec = QuantSpec(**kw)
    args = _t(g, x, scale, shift)
    ds, _ = em.backward_sums(*args, spec)
    _, rds, _ = golden_backward(*args, spec)
    assert not torch.equal(ds, rds)
    assert torch.equal(ds, em.backward_sums(*args, spec)[0])
    big, _ = em.backward_sums(*args, spec, numel=4 * x.size)
    gs = torch.tensor(effective_grad_scale(spec, 4 * x.size, scale.size))
    assert torch.equal(big, em.channel_sums(em.terms(*args, spec)[0]) * gs)
