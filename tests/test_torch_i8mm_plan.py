"""The int8 x int8 product's plan and its fused path, on the CPU:

* ``i8mm_plan`` (pure Python; the kernel takes its tiles and K split as
  given): every K row owned by exactly one rank of a cluster, no rank
  empty, ranks of 128-row stages, a cluster within the portable limit of 8
  and within the stages; the tiles cover the ragged M and N edges; the
  fusion only where it was asked, up to FUSED_MAX_M rows and with the
  block's quantized rows within 32 KB; forced tiles and clusters honoured or
  refused; a wave of blocks at decode M (0.7 of one at prefill) on the
  d1024 LM's five shapes; the int32 partials of the plan's blocks folded
  over each cluster give the product exactly (a numpy emulation of the
  split);
* the fused path's plain version (``act_quant_i8_plain`` then the plain
  product, which the card's fused launch is held to bit for bit) equal to
  the JAX package's ``static_int8_matmul``, ``dynamic_int8_matmul`` and
  the MoE's ``_ExpertDense._serve_int8`` bit for bit, at decode and prefill
  M, NaN and +-inf included;
* the ``jaxlsq_torch::i8mm_fused`` operator: its CPU implementation is the
  plain version and its fake one gives the real one's shape and dtype.

Inputs are numpy arrays from a seed; each JAX function is jitted once a
shape.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from jaxlsq.core.spec import QuantSpec as JSpec
from jaxlsq.models.moe import _ExpertDense as JExpertDense
from jaxlsq.serve.matmul import dynamic_int8_matmul as j_dynamic
from jaxlsq.serve.matmul import static_int8_matmul as j_static
from jaxlsq.serve.pack import PackedWeight as JPacked
from jaxlsq.serve.pack import quantize_weight as j_quantize

import jaxlsq_torch.serve.custom_ops  # noqa: F401  (registers the operators)
from jaxlsq_torch.core.spec import QuantSpec
from jaxlsq_torch.serve import matmul as mm
from jaxlsq_torch.serve.pack import quantize_weight

D1024 = {"qkv": (1024, 3072), "proj": (1024, 1024), "mlp_up": (1024, 4096),
         "mlp_down": (4096, 1024), "lm_head": (1024, 8192)}
PLAN_SHAPES = [(m, n, k, b) for m in (1, 7, 16, 17, 33, 64, 65, 130, 256)
               for n, k in ((10, 27), (136, 1000), (1040, 1030), (4096, 4096), (1024, 131072))
               for b in (1, 8)]


def _ranges(plan, k):
    return [(r * plan.kper, min(k, (r + 1) * plan.kper)) for r in range(plan.cs)]


def _check_plan(plan, m, n, k, batch):
    assert plan.bm in mm.I8MM_ROWS and plan.bn in mm.I8MM_COLS
    assert plan.bn == 128 or plan.bm <= 64
    steps = -(-k // mm.I8MM_BK)
    assert 1 <= plan.cs <= min(mm.I8MM_MAX_CLUSTER, steps)
    assert plan.kper % mm.I8MM_BK == 0
    rng = _ranges(plan, k)
    assert rng[0][0] == 0 and rng[-1][1] == k
    assert all(lo < hi for lo, hi in rng)                      # no rank empty
    assert all(a[1] == b[0] for a, b in zip(rng, rng[1:]))    # each row once
    gx, gy, gz = plan.grid(m, n, batch)
    assert gx % plan.cs == 0 and gz == batch
    cols = gx // plan.cs
    assert (cols - 1) * plan.bn < n <= cols * plan.bn        # the ragged N edge
    assert (gy - 1) * plan.bm < m <= gy * plan.bm             # the ragged M edge


@pytest.mark.parametrize("fused", [False, True])
def test_plan_splits_k_once_and_covers_the_edges(fused):
    for m, n, k, b in PLAN_SHAPES:
        plan = mm.i8mm_plan(m, n, k, b, fused=fused)
        _check_plan(plan, m, n, k, b)
        if plan.fused:
            assert fused and m <= mm.FUSED_MAX_M and plan.bm * plan.kper <= mm._RESIDENT_MAX
        else:
            assert not fused or m > mm.FUSED_MAX_M or plan.bm * plan.kper > mm._RESIDENT_MAX
        if fused and m <= mm.FUSED_MAX_M and k <= 8192:
            assert plan.fused, (m, n, k, b)


def test_forced_tiles_and_clusters():
    m, n, k = 37, 200, 1000
    steps = -(-k // mm.I8MM_BK)
    seen = set()
    for bm in mm.I8MM_ROWS:
        for bn in mm.I8MM_COLS:
            for cs in range(1, mm.I8MM_MAX_CLUSTER + 1):
                plan = mm.i8mm_plan(m, n, k, bm=bm, bn=bn, cs=cs) if (
                    bn == 128 or bm <= 64) else None
                if plan is None:
                    with pytest.raises(ValueError, match="tile"):
                        mm.i8mm_plan(m, n, k, bm=bm, bn=bn, cs=cs)
                    continue
                assert (plan.bm, plan.bn) == (bm, bn) and plan.cs <= cs
                _check_plan(plan, m, n, k, 1)
                seen.add(plan.cs)
    # a cluster is cut to the ranks that own stages: 8 stages over 5-7 ranks are 4 of 2
    assert seen == {-(-steps // -(-steps // c)) for c in range(1, steps + 1)} == {1, 2, 3, 4, 8}
    for bad in (dict(bm=48), dict(bn=32), dict(cs=9), dict(cs=0)):
        with pytest.raises(ValueError):
            mm.i8mm_plan(m, n, k, **bad)
    with pytest.raises(ValueError, match="empty"):
        mm.i8mm_plan(0, n, k)


@pytest.mark.parametrize("m", [1, 8, 16, 64, 256])
def test_plan_gives_the_card_a_wave_on_the_d1024_shapes(m):
    """A wave of blocks (0.9 of 132 SMs) at decode M, 0.7 of one above 32
    rows, on every d1024 shape, N = 1024 included."""
    for k, n in D1024.values():
        plan = mm.i8mm_plan(m, n, k, fused=True)
        blocks = np.prod(plan.grid(m, n))
        assert blocks >= (0.9 if m <= 32 else 0.7) * 132, (m, k, n, plan)
        assert plan.fused == (m <= mm.FUSED_MAX_M)


@pytest.mark.parametrize("m,n,k,batch", [(1, 136, 1000, 1), (17, 72, 520, 3), (130, 40, 300, 2)])
def test_the_plans_split_folds_to_the_product(m, n, k, batch):
    """Each block's int32 partial over its rank's K range, folded over the
    cluster, gives a @ b exactly for every plan of these shapes."""
    r = np.random.RandomState(m + n)
    a = r.randint(-128, 128, (batch, m, k)).astype(np.int64)
    b = r.randint(-128, 128, (batch, k, n)).astype(np.int64)
    want = a @ b
    for bm in mm.I8MM_ROWS:
        for cs in range(1, mm.I8MM_MAX_CLUSTER + 1):
            plan = mm.i8mm_plan(m, n, k, batch, bm=bm, cs=min(cs, -(-k // mm.I8MM_BK)))
            gx, gy, _ = plan.grid(m, n, batch)
            got = np.zeros_like(want)
            for bx in range(gx):
                rank, col = bx % plan.cs, bx // plan.cs
                lo, hi = _ranges(plan, k)[rank]
                cols = slice(col * plan.bn, min(n, (col + 1) * plan.bn))
                for by in range(gy):
                    rows = slice(by * plan.bm, min(m, (by + 1) * plan.bm))
                    got[:, rows, cols] += a[:, rows, lo:hi] @ b[:, lo:hi, cols]
            np.testing.assert_array_equal(got, want)


# --- the fused path's plain version against the JAX package --------------------------------

_j_static = jax.jit(j_static, static_argnums=(4, 5))
_j_dynamic = jax.jit(j_dynamic)


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _inputs(m, k, n, seed, special):
    r = np.random.RandomState(seed)
    w = (r.randn(k, n) * 0.2).astype(np.float32)
    kw = dict(quant_min=-128, quant_max=127, type_min=-128, type_max=127, per_channel=True,
              axis=1)
    scale = (np.abs(w).max() / 100 + 0.002 * r.rand(n)).astype(np.float32)
    shift = (r.randn(n) * 0.01).astype(np.float32)
    jp = j_quantize(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift), JSpec(**kw), bits=8)
    tp = quantize_weight(torch.as_tensor(w), torch.as_tensor(scale), torch.as_tensor(shift),
                         QuantSpec(**kw), bits=8)
    x = (r.randn(m, k) * 2).astype(np.float32)
    if special:
        x[0, 3], x[-1, 5], x[-1, 7] = np.nan, np.inf, -np.inf
    return x, jp, tp


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("m", [1, 8, 80])
def test_fused_plain_matches_jax_static_and_dynamic_bit_for_bit(m, special):
    k, n = 96, 40
    x, jp, tp = _inputs(m, k, n, m, special)
    for qmin, qmax, zp in ((0, 255, 128), (-128, 127, -3)):
        sx, zpx = np.asarray([0.04], np.float32), np.asarray([zp], np.int32)
        want = _j_static(jnp.asarray(x), jp, jnp.asarray(sx), jnp.asarray(zpx), qmin, qmax)
        got, qx = mm._i8mm_fused(torch.as_tensor(x)[None], tp.data[None], tp.scale,
                                 tp.zero_point, torch.as_tensor(sx), torch.as_tensor(zpx),
                                 qmin, qmax, False, (0, 1), plain=True)
        _same_bits(got[0].numpy(), want)
        assert float(qx[0]) == float(sx[0]) and float(qx[1]) == zp - (128.0 if qmax > 127 else 0.0)
    want = _j_dynamic(jnp.asarray(x), jp)
    got, _ = mm._i8mm_fused(torch.as_tensor(x)[None], tp.data[None], tp.scale, tp.zero_point,
                            None, None, -128, 127, True, (0, 1), plain=True)
    _same_bits(got[0].numpy(), want)


@pytest.mark.parametrize("c", [1, 80])
def test_fused_plain_matches_jax_expert_int8_bit_for_bit(c):
    """The experts' batched product (E = 4, per-expert qparams, an unsigned
    activation range) against ``_ExpertDense._serve_int8``."""
    e, k, n = 4, 64, 24
    r = np.random.RandomState(c)
    data = r.randint(-128, 128, (e, k, n)).astype(np.int8)
    scale = (r.rand(e) * 0.01 + 0.002).astype(np.float32)
    zp = r.randint(-5, 6, e).astype(np.int32)
    x = (r.randn(e, c, k) * 2).astype(np.float32)
    x[0, 0, 3], x[-1, -1, 5], x[1, -1, 9] = np.nan, np.inf, -np.inf
    sx, zpx = np.asarray([0.05], np.float32), np.asarray([131], np.int32)
    spec = JSpec(quant_min=0, quant_max=255, type_min=0, type_max=255)
    owner = types.SimpleNamespace(path=(), qconfig=types.SimpleNamespace(
        resolve=lambda path: types.SimpleNamespace(activation=types.SimpleNamespace(spec=spec))))
    jp = JPacked(data=jnp.asarray(data), scale=jnp.asarray(scale), zero_point=jnp.asarray(zp),
                 bits=8, axis=0, k_axis=1, orig_shape=(e, k, n))
    want = jax.jit(lambda a, s, z: JExpertDense._serve_int8.__wrapped__(owner, a, jp, s, z))(
        jnp.asarray(x), jnp.asarray(sx), jnp.asarray(zpx))
    got, _ = mm._i8mm_fused(torch.as_tensor(x), torch.as_tensor(data), torch.as_tensor(scale),
                            torch.as_tensor(zp), torch.as_tensor(sx), torch.as_tensor(zpx), 0,
                            255, False, (1, 0), plain=True)
    _same_bits(got.numpy(), want)
    bmm = mm.static_int8_bmm(torch.as_tensor(x), torch.as_tensor(data), torch.as_tensor(scale),
                             torch.as_tensor(zp), torch.as_tensor(sx), torch.as_tensor(zpx), 0,
                             255)
    _same_bits(bmm.numpy(), want)


def test_fused_operator_cpu_and_fake():
    """The operator's CPU implementation is the plain version (no launch
    counted); its fake implementation gives the real one's shape and dtype,
    static and dynamic, for a matmul and an expert batch."""
    r = np.random.RandomState(5)
    before = dict(mm.LAUNCHES)
    for batch, m, k, n in ((1, 3, 40, 24), (4, 6, 32, 8)):
        x = torch.as_tensor(r.randn(batch, m, k).astype(np.float32))
        b = torch.as_tensor(r.randint(-128, 128, (batch, k, n)).astype(np.int8))
        scale = torch.as_tensor((r.rand(batch * n) * 0.01).astype(np.float32))
        zp = torch.as_tensor(r.randint(-3, 4, batch * n).astype(np.int32))
        s, z = torch.tensor([0.03]), torch.tensor([7], dtype=torch.int32)
        for args in ((s, z, -128, 127, False), (None, None, -128, 127, True)):
            op = torch.ops.jaxlsq_torch.i8mm_fused(x, b, scale, zp, *args, n, 1)
            want = mm._i8mm_fused(x, b, scale, zp, *args, (n, 1), plain=True)[0]
            assert torch.equal(op, want)
            with FakeTensorMode() as mode:
                fx, fb, fs, fz = (mode.from_tensor(t) for t in (x, b, scale, zp))
                fargs = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                              for a in args)
                fake = torch.ops.jaxlsq_torch.i8mm_fused(fx, fb, fs, fz, *fargs, n, 1)
            assert fake.shape == op.shape and fake.dtype == op.dtype == torch.float32
    assert mm.LAUNCHES == before
