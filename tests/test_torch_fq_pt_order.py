"""The per-tensor fake-quant backward's summation order (``fq_bwd_pt``,
``fq_bwd_pt_traced``, ``fq_fwdbwd_pt`` in ``csrc/fake_quant.cu``), emulated
on the CPU by ``tests/_fq_pt_order.py`` (every step one rounded f32 torch
operation): 2,048-element tiles, a block taking several in turn, lane sums
in ascending index, the pairwise trees over a warp's lanes and a block's
warps, then the last block's fold of the blocks' partials (512 to 2,048 of
them past 512 tiles).

* the emulated dS/dB against ``golden_backward`` / ``golden_backward_traced``
  within 1e-5 of gs times the sum of |terms| (sums in other orders), and
  against the JAX package's ``_pt_bwd_kernel`` / ``_pt_bwd_traced_kernel`` run
  in Pallas interpret mode (``pallas_backward`` / ``pallas_backward_traced``)
  within the bound the JAX package holds that kernel to its own golden
  (rtol 2e-5, atol 1e-6, tests/test_pallas_kernels.py);
* the static, traced (four flag pairs) and fused variants bit for bit
  against each other: one order, the scale applied after the sum;
* the grid from n alone, and the emulation's constants against the
  kernel source's.

Each JAX program is jitted once in the module: a case has one for the
static kernel's two modes and one for the traced kernel (the flags are
arguments, so one program serves all four flag pairs).
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.ops import pallas_kernels as pk

import _fq_pt_order as em
from jaxlsq_torch.core.golden import (effective_grad_scale, golden_backward,
                                      golden_backward_traced)
from jaxlsq_torch.core.spec import QuantSpec

SPECS = {
    # the activation spec of tests/test_torch_gpu.py: 0..127 in a 0..255 carrier
    "act": dict(quant_min=0, quant_max=127, type_min=0, type_max=255),
    "sym": dict(quant_min=-127, quant_max=127, symmetric=True),
    "aff": dict(quant_min=0, quant_max=255),
}
# 4,198,404 elements: 2,051 tiles, more than the 2,048 blocks can hold, over
# 512 blocks (blocks 0-2 take five, the others four)
SIZES = (1, 3, 1000, 4097, 32768, 196608, 4198404)
CASES = [(name, n) for name in SPECS for n in SIZES]
FLAG_PAIRS = ((0, 0), (1, 0), (0, 1), (1, 1))


@functools.lru_cache(maxsize=None)
def _inputs(name, n):
    kw = SPECS[name]
    r = np.random.RandomState(n + len(name))
    x = (r.randn(n) * 1.5).astype(np.float32)
    scale = (0.01 + 0.04 * r.rand(1)).astype(np.float32)
    shift = (np.zeros(1) if kw.get("symmetric") else 0.2 * r.randn(1)).astype(np.float32)
    g = r.randn(n).astype(np.float32)
    return kw, x, scale, shift, g


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@functools.lru_cache(maxsize=None)
def _pallas(name, n):
    """jaxlsq's interpreted ``_pt_bwd_kernel`` dS/dB in train and in init
    mode, one program a case."""
    kw, x, scale, shift, g = _inputs(name, n)
    fn = jax.jit(lambda *a: [pk.pallas_backward(*a, spec=JSpec(**kw), init_mode=init,
                                                interpret=True)[1:]
                             for init in (False, True)])
    return [[np.asarray(v) for v in mode] for mode in fn(g, x, scale, shift)]


@functools.lru_cache(maxsize=None)
def _pallas_traced_fn(name):
    kw = SPECS[name]
    return jax.jit(lambda g, x, s, b, ev, ini: pk.pallas_backward_traced(
        g, x, s, b, spec=JSpec(**kw), eval_flag=ev, init_flag=ini, interpret=True)[1:])


def _term_sums(kw, x, scale, shift, g, init_mode):
    """|gs| times the sum of |term| of dS and of dB, in f64."""
    spec = QuantSpec(**kw)
    ds, db = em.terms(*_t(g, x, scale, shift), spec, init_mode)
    gs = abs(effective_grad_scale(spec, x.size))
    return ds.double().abs().sum().item() * gs, db.double().abs().sum().item() * gs


def _close(got, want, tot):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.asarray(got).shape == np.asarray(want).shape
    assert np.all(err <= 1e-5 * tot), (err.max(), tot)


def _close_pallas(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=1e-6)


def test_constants_match_the_kernel_source():
    """The emulated tile, lane count and block cap are the kernel's."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "jaxlsq_torch", "csrc", "fake_quant.cu")
    with open(src) as f:
        text = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert [const(k) for k in ("kThreads", "kPtGroups", "kPtTilesABlock", "kPtMinBlocks",
                               "kPtMaxBlocks")] == [em.THREADS, em.GROUPS, em.TILES_A_BLOCK,
                                                    em.MIN_BLOCKS, em.MAX_BLOCKS]
    assert "kPtTile = kThreads * 4 * kPtGroups" in text


@pytest.mark.parametrize("n,want", [(1, 1), (2048, 1), (2049, 2), (196608, 96),
                                    (2 ** 20, 512), (2 ** 22, 512), (4198404, 512),
                                    (2 ** 23, 1024), (2 ** 24, 2048), (2 ** 26, 2048)])
def test_grid_from_n_alone(n, want):
    """A block a tile up to 512 tiles, then a quarter of the tiles within
    [512, 2,048]: past 512 tiles a block takes several in turn."""
    assert em.blocks(n) == want


@pytest.mark.parametrize("init_mode", [False, True])
@pytest.mark.parametrize("name,n", CASES)
def test_order_matches_golden_and_pallas(name, n, init_mode):
    kw, x, scale, shift, g = _inputs(name, n)
    spec = QuantSpec(**kw)
    ds, db = em.backward_sums(*_t(g, x, scale, shift), spec, init_mode)
    _, rds, rdb = golden_backward(*_t(g, x, scale, shift), spec, init_mode=init_mode)
    pds, pdb = _pallas(name, n)[init_mode]
    tot = _term_sums(kw, x, scale, shift, g, init_mode)
    for got, golden, pallas, t in ((ds, rds, pds, tot[0]), (db, rdb, pdb, tot[1])):
        _close(got.numpy(), golden.numpy(), t)
        _close_pallas(got.numpy(), pallas)
    if kw.get("symmetric"):
        assert not db.any()


@pytest.mark.parametrize("name,n", CASES)
def test_traced_matches_pallas_traced_and_static_bits(name, n):
    """The traced order at the four flag pairs against
    ``golden_backward_traced`` and the interpreted ``_pt_bwd_traced_kernel``;
    in train and init mode (ev = 0) the static kernels' bits, which the
    fused kernel shares; eval mode zeros."""
    kw, x, scale, shift, g = _inputs(name, n)
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


@pytest.mark.parametrize("name,n", [("act", 4198404), ("aff", 196608)])
def test_order_is_its_own_and_fixed(name, n):
    """The emulated order is not ``torch.sum``'s (so the card tests that
    hold the kernel to it bit for bit have teeth) and gives the same bits on
    every call; ``numel`` scales after the sum; a partial tile is the full
    tile padded with +0."""
    kw, x, scale, shift, g = _inputs(name, n)
    spec = QuantSpec(**kw)
    args = _t(g, x, scale, shift)
    ds, _ = em.backward_sums(*args, spec)
    _, rds, _ = golden_backward(*args, spec)
    assert not torch.equal(ds, rds)
    assert torch.equal(ds, em.backward_sums(*args, spec)[0])
    big, _ = em.backward_sums(*args, spec, numel=4 * n)
    gs = torch.tensor(effective_grad_scale(spec, 4 * n))
    terms = em.terms(*args, spec)[0]
    assert torch.equal(big, (em.tensor_sum(terms) * gs).reshape(1))
    padded = torch.cat([terms, torch.zeros(-n % em.TILE)])
    if em.blocks(padded.numel()) == em.blocks(n):
        assert torch.equal(em.tensor_sum(padded), em.tensor_sum(terms))


def test_slot_a_stream_and_refused_past_the_library_count(monkeypatch):
    """The wrapper keeps calls on two streams apart: a slot a (device,
    stream), the same on every call, numbered per device, and a stream past
    the library's slot count is refused."""
    import importlib
    from types import SimpleNamespace

    fq = importlib.import_module("jaxlsq_torch.ops.fake_quant")

    monkeypatch.setattr(fq, "_pt_slots", {})
    lib = SimpleNamespace(pt_slots=3)
    on = [SimpleNamespace(device=torch.device("cuda", k)) for k in (0, 1)]
    assert [fq._pt_slot(lib, on[0], st) for st in (11, 22, 0, 11, 22)] == [0, 1, 2, 0, 1]
    assert fq._pt_slot(lib, on[1], 22) == 0
    with pytest.raises(RuntimeError, match="more than 3 streams"):
        fq._pt_slot(lib, on[0], 33)
    assert fq._pt_slot(lib, on[1], 33) == 1
