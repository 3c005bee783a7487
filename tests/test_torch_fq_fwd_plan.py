"""The per-channel fake-quant forward's grid (``fq_fwd_pc``,
``fq_fwd_pc_traced`` in ``csrc/fake_quant.cu``), emulated in numpy from the
kernels' index arithmetic and :func:`fwd_plan`'s span, for both mappings:
runs (``inner > 1``: a warp takes a piece of one ``(o, c)`` run, 16-byte
groups or 4-byte elements) and rows (``inner == 1``: a warp takes a strip of
32 lanes on neighbouring channels over ``span`` rows).

* every element is written exactly once, and each work item's channel is
  ``(i // inner) % C``, at runs and rows layouts and at the 30 per-channel
  weight shapes of resnet18_cifar and the d512 LM, with 16-byte and 4-byte
  accesses;
* the plan comes from the shape alone, and the emulation's constants are the
  kernel source's;
* the kernels' arithmetic on the emulated items (s and zp once an item, NaN
  passed through the clamps) gives ``golden_forward(_traced)``'s bits and
  the JAX package's ``_pc_fwd_kernel`` / ``_pc_fwd_traced_kernel`` in Pallas
  interpret mode, bit for bit, at up to 100k elements (the forward is
  elementwise: a larger tensor proves nothing more).
"""

import functools
import importlib
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.ops import pallas_kernels as pk
from jaxlsq_torch.core.golden import golden_forward, golden_forward_traced
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.ops.fake_quant import _view3, fwd_plan

WARPS, LANES = 8, 32


def _source_consts():
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "jaxlsq_torch", "csrc", "fake_quant.cu")
    with open(src) as f:
        text = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
            for k in ("kThreads", "kFwdGroups", "kFwdRows")}, text


GROUPS = _source_consts()[0]["kFwdGroups"]  # runs: groups of 4 a lane takes
ROWS = _source_consts()[0]["kFwdRows"]  # rows: rows a lane takes at most


def writes(outer, c, inner, wide):
    """(element index, item channel) of every store of the launch, in the
    kernels' arithmetic.  ``wide``: 16-byte accesses (runs: inner % 4 == 0
    and aligned pointers; rows: c % 4 == 0 and aligned)."""
    span = fwd_plan(outer, c, inner)
    lane = np.arange(LANES)[None, :]
    idx, chan = [], []
    if inner == 1:  # rows: K = outer rows of C = c channels
        per = 4 if c % 4 == 0 else 1  # channels a lane
        assert 1 <= span <= ROWS
        strips = -(-c // (LANES * per))
        w = np.arange(-(-strips * -(-outer // span) // WARPS) * WARPS)[:, None]
        q, k0 = w % strips, (w // strips) * span
        c0 = (LANES * q + lane) * per
        live = (k0 < outer) & (c0 < c)
        for j in range(span):
            k = k0 + j
            for e in range(per):
                ok = live & (k < outer)
                idx.append((k * c + c0 + e)[ok])
                chan.append(np.broadcast_to(c0 + e, ok.shape)[ok])
        return np.concatenate(idx), np.concatenate(chan)
    pieces, runs = -(-inner // span), outer * c
    w = np.arange(-(-runs * pieces // WARPS) * WARPS)[:, None]
    run = w // pieces
    start = (w - run * pieces) * span
    ln = np.minimum(span, inner - start)
    base = run * inner + start
    live = run < runs
    if wide:
        offs = [(4 * (lane + LANES * j), t) for j in range(GROUPS) for t in range(4)]
    else:
        offs = [(lane + LANES * k, 0) for k in range(4 * GROUPS)]
    for e, t in offs:  # wide: a group stored whole when its first element is in
        ok = live & (e < ln)
        idx.append((base + e + t)[ok])
        chan.append(np.broadcast_to(run % c, ok.shape)[ok])
    return np.concatenate(idx), np.concatenate(chan)


def _can_be_wide(c, inner):
    """16-byte accesses are open to the layout (the pointers decide too)."""
    return inner % 4 == 0 if inner > 1 else c % 4 == 0


# the 30 per-channel weights (shape, axis) of resnet18_cifar (21) and the d512
# LM (9 (K, N) weights on axis 1), as wo_compare.py's fq_weight_shapes lists them
RESNET = ([((64, 3, 3, 3), 0)] + [((64, 64, 3, 3), 0)] * 4
          + [((128, 64, 3, 3), 0), ((128, 128, 3, 3), 0), ((128, 64, 1, 1), 0)]
          + [((128, 128, 3, 3), 0)] * 2
          + [((256, 128, 3, 3), 0), ((256, 256, 3, 3), 0), ((256, 128, 1, 1), 0)]
          + [((256, 256, 3, 3), 0)] * 2
          + [((512, 256, 3, 3), 0), ((512, 512, 3, 3), 0), ((512, 256, 1, 1), 0)]
          + [((512, 512, 3, 3), 0)] * 2 + [((512, 10), 1)])
LM = [((512, 1536), 1), ((512, 512), 1), ((512, 2048), 1), ((2048, 512), 1)] * 2 + [
    ((512, 8192), 1)]
LAYOUTS = [
    ((64, 3, 3, 3), 0),      # runs, inner = 27 (4-byte)
    ((16, 64, 3, 3), 0),     # runs, inner = 576: pieces of 256, 256, 64
    ((4, 300, 2, 2), 0),     # runs, inner = 1200
    ((3, 5000), 0),          # runs, inner % 4 == 0, 20 pieces
    ((2, 1, 4098), 1),       # runs, C = 1, inner % 4 == 2
    ((8, 16, 5, 5), 1),      # runs, outer > 1 (NCHW on axis 1), inner = 25
    ((3, 7, 4, 4), 1),       # runs, outer > 1, inner = 16
    ((512, 10), 1),          # rows, C = 10: a channel a lane
    ((33, 300), 1),          # rows, C = 300: 4 a lane, a partial strip
    ((512, 8192), 1),        # rows, C = 8192
    ((17, 12), 1), ((40, 1), 1), ((1,), 0), ((1, 1, 1, 1), 0), ((5, 3, 1, 1), 0),
]
SHAPES = sorted(set(LAYOUTS + RESNET + LM))


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("shape,axis", SHAPES)
def test_every_element_written_once_by_its_channel(shape, axis, wide, big, monkeypatch):
    """``big``: the plan's threshold set to 0, so runs take 256-element
    pieces (two groups a lane) as a tensor of more than 8 Mi elements does."""
    if big:
        monkeypatch.setattr(importlib.import_module("jaxlsq_torch.ops.fake_quant"),
                            "_FWD_BIG", 0)
    outer, c, inner = _view3(torch.empty(shape, device="meta"),
                             QuantSpec(quant_min=-127, quant_max=127, symmetric=True,
                                       per_channel=True, axis=axis))
    n = math.prod(shape)
    idx, chan = writes(outer, c, inner, wide and _can_be_wide(c, inner))
    assert idx.min() >= 0 and idx.max() < n
    assert np.array_equal(np.bincount(idx, minlength=n), np.ones(n, np.int64))
    assert np.array_equal(chan, (idx // inner) % c)


def test_plan_from_the_shape_alone_and_constants_match_the_source():
    consts, text = _source_consts()
    assert consts["kThreads"] == WARPS * LANES
    assert "kFwdRound = 32 * 4 * kFwdGroups" in text
    fq = importlib.import_module("jaxlsq_torch.ops.fake_quant")
    assert 2 * fq._FWD_PIECE == LANES * 4 * GROUPS  # the largest span, a round
    assert fq._FWD_ROWS == ROWS
    # runs: 128 (256 past _FWD_BIG items), at most the run rounded up to 4
    assert [fwd_plan(1, 512, 4608), fwd_plan(1, 64, 27), fwd_plan(64, 16, 25),
            fwd_plan(1, 128, 64), fwd_plan(2, 1, 2), fwd_plan(1, 8192, 8192),
            fwd_plan(1, 512, 16384), fwd_plan(1, 512, 16385)] == [
                128, 28, 28, 64, 4, 256, 128, 256]
    # rows: 2 rows an item
    assert [fwd_plan(512, 8192, 1), fwd_plan(512, 10, 1), fwd_plan(1, 1, 1)] == [2, 2, 2]
    # one view, one plan, whatever tensor or layout it came from
    for a, b in ((((512, 8192), 1), ((512, 8192, 1), 1)),
                 (((64, 3, 3, 3), 0), ((64, 27), 0))):
        views = [_view3(torch.empty(s, device="meta"), QuantSpec(
            quant_min=-127, quant_max=127, symmetric=True, per_channel=True, axis=ax))
            for s, ax in (a, b)]
        assert views[0] == views[1]
        assert fwd_plan(*views[0]) == fwd_plan(*views[1])


def _kernel_out(x, scale, shift, spec, ini=0.0):
    """The kernels' arithmetic over the emulated items: an item's s and zp
    from its channel, once an item, NaN passed through the clamps."""
    outer, c, inner = _view3(x, spec)
    idx, chan = writes(outer, c, inner, _can_be_wide(c, inner))
    a = scale.abs()
    s = torch.where(torch.isnan(a), a, torch.clamp_min(a, torch.finfo(torch.float32).eps))
    zp = torch.round(torch.clamp(-shift / s, spec.type_min, spec.type_max))
    flat = x.reshape(-1)
    out = torch.full_like(flat, 7.0)
    xi = flat[idx]
    if ini > 0:
        out[idx] = xi
    else:
        si, zi = s[chan], zp[chan]
        xq = torch.round(torch.clamp(xi / si + zi, spec.quant_min, spec.quant_max))
        out[idx] = (xq - zi) * si
    return out.reshape(x.shape)


INTERP = {
    "w_oihw": dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True, axis=0),
    "aff_oihw": dict(quant_min=0, quant_max=255, per_channel=True, axis=0),
    "w_kn": dict(quant_min=-127, quant_max=127, symmetric=True, per_channel=True, axis=1),
    "aff_nchw": dict(quant_min=0, quant_max=255, per_channel=True, axis=1),
}
INTERP_CASES = [("w_oihw", (64, 3, 3, 3)), ("w_oihw", (16, 64, 3, 3)),
                ("aff_oihw", (128, 64, 1, 1)), ("aff_oihw", (4, 300, 2, 2)),
                ("aff_nchw", (8, 16, 5, 5)), ("w_kn", (512, 10)), ("w_kn", (33, 300)),
                ("w_kn", (96, 1024))]


@functools.lru_cache(maxsize=None)
def _pallas(name):
    jspec = JSpec(**INTERP[name])
    return jax.jit(lambda x, s, b, ini: (
        pk.pallas_forward(x, s, b, spec=jspec, interpret=True),
        pk.pallas_forward_traced(x, s, b, spec=jspec, eval_flag=jnp.float32(0.0),
                                 init_flag=ini, interpret=True)))


@pytest.mark.parametrize("name,shape", INTERP_CASES)
def test_emulated_kernel_gives_golden_and_pallas_bits(name, shape):
    kw = INTERP[name]
    spec = QuantSpec(**kw)
    n = math.prod(shape)
    assert n <= 100_000
    r = np.random.RandomState(n % 1000)
    c = shape[kw["axis"]]
    scale = (0.01 + 0.04 * r.rand(c)).astype(np.float32)
    shift = (np.zeros(c) if kw.get("symmetric") else 0.2 * r.randn(c)).astype(np.float32)
    # each channel's values on its own round-half points and beyond the range
    ch = np.arange(c).reshape([-1 if a == kw["axis"] else 1 for a in range(len(shape))])
    k = r.randint(-300, 300, size=shape).astype(np.float32) + 0.5
    x = (k * scale.reshape(ch.shape)).astype(np.float32)
    x.reshape(-1)[r.choice(n, size=min(n, 30), replace=False)] = np.nan
    x.reshape(-1)[:2] = (np.inf, -np.inf)
    scale[min(2, c - 1)] = np.nan
    tx, ts, tb = (torch.from_numpy(a.copy()) for a in (x, scale, shift))
    got = _kernel_out(tx, ts, tb, spec)
    want = golden_forward(tx, ts, tb, spec)
    jout, jtr = _pallas(name)(x, scale, shift, jnp.float32(0.0))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtr))
    for ini in (0.0, 1.0):
        tr = golden_forward_traced(tx, ts, tb, spec, torch.tensor(0.0), torch.tensor(ini))
        np.testing.assert_array_equal(_kernel_out(tx, ts, tb, spec, ini).numpy(), tr.numpy())
    _, jinit = _pallas(name)(x, scale, shift, jnp.float32(1.0))
    np.testing.assert_array_equal(np.asarray(jinit), x)
